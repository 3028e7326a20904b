"""The comparison that decides ``correct``, at a size a test run holds, on
the CPU: a run of each cell's configuration and mix (cut to 6,000 rows of
128 dimensions) comes out correct; the control (the reference in the
system's place at int8 rows and TF32 products) comes out not correct;
and a run with the timed path broken underneath comes out not correct,
once for each fault a search cell can have: half of the batch answered
with the other half's answers, and an answer altered where it is made;
and, for the proj cells, the ANN tables broken where they are built.
The chip look is skipped: these drive ``run.run_cell`` on the CPU."""
from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from port_bench import check, run, spec

ROWS, DIM = 6000, 128
SEED = 3_141_592_653_589
# the open loop through the micro-batcher, which no cell of BENCHMARK.json
# runs yet, driven here beside the cells so that its path stays sound
OPEN = {"name": "proj1m.served", "config": "policy1m-proj", "traffic": "served", "chips": 1,
        "why": "open loop of single requests through MicroBatcher.search_one"}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]] + [OPEN["name"]]


@pytest.fixture
def tiny(tmp_path):
    """(bench, root) of a checkout whose configurations and mixes are the
    real ones cut to a CPU-sized corpus and window."""
    saved = dict(os.environ)
    root = str(tmp_path)
    os.makedirs(f"{root}/port_bench/configs")
    os.makedirs(f"{root}/port_bench/traffic")
    bench = spec.load_benchmark()
    bench["workloads"].append(OPEN)
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        cfg["corpus"].update(rows=ROWS, dim=DIM, centers=64)
        cfg["env"]["MRAG_EMBED_DIM"] = str(DIM)
        if cfg["env"]["MRAG_VECTOR_BACKEND"] == "proj":
            cfg["env"].update(MRAG_PROJ_P="64", MRAG_IVF_NPROBE="16")
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
        shutil.copy(os.path.join(spec.HERE, "configs", cfg["lexicon"]),
                    os.path.join(root, "port_bench", "configs", cfg["lexicon"]))
    for w in bench["workloads"]:
        mix = spec.load_json(spec.mix_path(w["traffic"]))
        mix.update(pool=512, warm=64, vectors=128, sample=48)
        if mix["kind"] == "open":
            mix.update(rate=60, warmup_s=0.5)
        with open(f"{root}/port_bench/traffic/{w['traffic']}.json", "w") as f:
            json.dump(mix, f)
    yield bench, root
    os.environ.clear()
    os.environ.update(saved)


def _run(tiny, cell, seed=SEED, **kw):
    bench, root = tiny
    return run.run_cell(bench, spec.cell(bench, cell), seed, 1.0, False, device="cpu",
                        root=root, **kw)


@pytest.mark.parametrize("seed", [SEED, 2_718_281_828, 17])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell, seed):
    """On corpora of three seeds (the rows, and the ANN tables built on
    them, differ from seed to seed)."""
    res = _run(tiny, cell, seed)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0


@pytest.mark.parametrize("cell", ["exact1m.backlog", "proj1m.backlog"])
def test_the_control_is_not_correct(tiny, cell):
    bench, root = tiny
    res = _run(tiny, cell, control=True)
    cfg = spec.load_json(spec.config_path(bench, spec.cell(bench, cell)["config"], root))
    ok, shown = check.judge(res["control"], cfg["limits"])
    assert not ok, shown


def _half_batch(fn):
    """The second half of every batch answered with the first half's
    answers."""
    def broken(index, q, *a, **kw):
        out = fn(index, q, *a, **kw)
        b = q["vec"].shape[0]
        h = b // 2
        with torch.inference_mode():  # the program's outputs are inference tensors
            for t in out.values():
                if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == b and h:
                    t[h:2 * h] = t[:h].clone()
        return out
    return broken


def _altered(fn):
    """The first hit of every query scored 0.01 higher where it is made."""
    def broken(index, q, *a, **kw):
        out = fn(index, q, *a, **kw)
        with torch.inference_mode():
            out["rerank"][:, 0] += 0.01
        return out
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from mobius_rag_tpu_torch.query import engine

    monkeypatch.setattr(engine, "search_batch", fault(engine.search_batch))
    res = _run(tiny, cell)
    assert not res["correct"], res["checks"]


def _tables_fault(kind):
    """The proj build's tables broken where they are made."""
    def fault(ann):
        with torch.inference_mode():
            if kind == "proj_scaled":
                ann.proj.mul_(1.01)
            elif kind == "centroids_rolled":
                ann.centroids[: ann.base_nlist] = ann.centroids[: ann.base_nlist].roll(1, 0)
            else:
                ann.scales.mul_(2.0)
    return fault


@pytest.mark.parametrize("kind", ["proj_scaled", "centroids_rolled", "scales_doubled"])
def test_a_broken_ann_build_is_not_correct(tiny, monkeypatch, kind):
    """The reference checks the system's proj tables before it scans
    them: a projection that is not orthonormal, centroids that do not
    match the cells, or scales that do not match the rows fail."""
    from mobius_rag_tpu_torch.query import engine

    build, broken = engine.SearchEngine.ensure_ann, _tables_fault(kind)

    def ensure_ann(self):
        first = self._ann is None
        ann = build(self)
        if first and ann is not None:
            broken(ann)
        return ann

    monkeypatch.setattr(engine.SearchEngine, "ensure_ann", ensure_ann)
    res = _run(tiny, "proj1m.backlog")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_card():
    """The control at the cell's own size on the card, on three seeds
    (python3 -m port_bench.control runs the dozen)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = spec.load_benchmark()
    for w in bench["workloads"][:2]:
        cfg = spec.load_json(spec.config_path(bench, w["config"]))
        for seed in (101, 202, 303):
            res = run.run_cell(bench, w, seed, 2.0, False, control=True)
            assert res["correct"], res["checks"]
            assert not check.judge(res["control"], cfg["limits"])[0]
