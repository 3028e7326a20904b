"""Sharded serving of chip_smoke.py phase 10a's paths in two or more
checkouts, in turns on one card: 70k float32 rows over 4 shards and over a
[2, 4] grid, and the 1M bf16 store over 8 shards (exact backend, dense
gating), every shard on this card. For each path: queries/s at batch 32
sync (3 rounds of 8 searches), the host's own ms of a sync batch by stage
and the device's busy share (torch.profiler over 4 searches); the dense
engine's q/s beside them. Each checkout runs in its own process, in the
order given, with this script's copy of chip_smoke.py's store builders, so
that two versions of the engine are compared on one card under one power
limit. Needs one CUDA card.

    python3 scripts/sharded_turns.py PARENT . . PARENT
    python3 scripts/sharded_turns.py PARENT PARENT+cpu . .   # +cpu: see below
    python3 scripts/sharded_turns.py PARENT+graph .+graph .+graph PARENT+graph

Each argument is the root of a checkout (a `git archive` of a commit
unpacked under a directory .gitignore lists, or "." for this one). A
"+cpu" suffix runs that checkout with a sync search that fetches its two
packed arrays with blocking ``.cpu()`` copies, as the engine did before it
fetched through page-locked buffers and an event (``PendingFetch``). A
"+graph" suffix serves every sharded path captured (the checkout's
default on a card: one CUDA graph per key on these grids of one card)
instead of eagerly, and adds its pipelined q/s (search_pipelined over 8
batches, median of 3 rounds).

Stages of a sync batch (host clock, no synchronisation inside): prepare
(``prepare_host``, or ``prepare_batch`` in a checkout without it), program
(the sharded engine's ``run``: its refresh, host widths and the enqueue of
every shard's operators, which blocks when the card's launch queue is
full), unpack (``_finish``), assemble (``_assemble``) and wait (the rest of
the wall: the upload, the packing's enqueue, the wait for the device and
the copies to the host).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3


def _spans(engine, stages: dict) -> list:
    """Wrap the engine's (and its sharded engine's) stage methods to add
    their host time to `stages`; returns what to undo."""
    prep = "prepare_host" if hasattr(engine, "prepare_host") else "prepare_batch"
    targets = [(engine, prep, "prepare"), (engine.sharded, "run", "program"),
               (engine, "_finish", "unpack"), (engine, "_assemble", "assemble")]
    undo = []
    for obj, attr, key in targets:
        fn = getattr(obj, attr)

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            stages[_key] = stages.get(_key, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, attr, timed)
        undo.append((obj, attr))
    return undo


def _busy(engine, reqs, k: int) -> tuple[float, float]:
    """(device kernel ms, wall ms) a sync batch over 4 searches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            engine.search(reqs, k=k)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 4
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)) / 1e3 / 4
    return busy, wall


def _measure(engine, reqs, smoke, pipelined: bool = False) -> dict:
    engine.search(reqs, k=smoke.K)  # warm
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(smoke.N_BATCHES):
            engine.search(reqs, k=smoke.K)
        rounds.append(smoke.BATCH * smoke.N_BATCHES / (time.perf_counter() - t0))
    out = {"qps": sorted(rounds)[ROUNDS // 2], "rounds": rounds}
    if pipelined:
        piped = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            engine.search_pipelined([reqs] * smoke.N_BATCHES, k=smoke.K)
            piped.append(smoke.BATCH * smoke.N_BATCHES / (time.perf_counter() - t0))
        out["pipelined_qps"], out["pipelined_rounds"] = sorted(piped)[ROUNDS // 2], piped
    if engine.sharded is None:
        return out
    stages: dict = {}
    undo = _spans(engine, stages)
    try:
        t0 = time.perf_counter()
        for _ in range(smoke.N_BATCHES):
            engine.search(reqs, k=smoke.K)
        wall = time.perf_counter() - t0
    finally:
        for obj, attr in undo:
            delattr(obj, attr)
    ms = {key: v * 1e3 / smoke.N_BATCHES for key, v in stages.items()}
    ms["wait"] = wall * 1e3 / smoke.N_BATCHES - sum(ms.values())
    ms["wall"] = wall * 1e3 / smoke.N_BATCHES
    out["host_ms"] = ms
    out["busy_ms"], out["busy_wall_ms"] = _busy(engine, reqs, smoke.K)
    return out


def _cpu_fetch(engine_cls) -> None:
    """A sync search that fetches with blocking .cpu() copies."""
    def _run(self, reqs, k):
        ann, local = self._tables()
        q, exps = self.prepare_host(reqs)
        t_prep = time.perf_counter()
        packed = self._packed(q, exps, ann, local, k)
        fetched = (packed[0].cpu().numpy(), packed[1].cpu().numpy())
        return exps, self._finish(reqs, exps, fetched, k), t_prep
    engine_cls._run = _run


def one(arg: str) -> None:
    """Run the paths in the checkout `arg` names; print one JSON line."""
    root, _, variant = arg.partition("+")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch

    import mobius_rag_tpu_torch
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.parallel import ShardedEngine, make_mesh, make_serve_mesh
    from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

    if not mobius_rag_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {mobius_rag_tpu_torch.__file__}, not the checkout at {root}")
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke._sync = lambda dev: torch.cuda.synchronize()  # a checkout may lack compiled.LOCK
    if variant == "cpu":
        _cpu_fetch(SearchEngine)
    elif variant not in ("", "graph"):
        raise SystemExit(f"unknown variant {variant!r}")
    graph = variant == "graph"
    dev = "cuda"
    out = {"arg": arg}

    def sharded(name, store, lexicon, cfg, mesh, reqs):
        tse = ShardedEngine(store, mesh=mesh, cfg=cfg)
        serving = SearchEngine(store, lexicon, cfg=cfg, device=dev, sharded=tse)
        if graph:
            if not getattr(serving, "graphs", False):
                raise SystemExit(f"{arg}: {name} does not serve captured")
        elif getattr(serving, "graphs", False) and getattr(tse, "_programs", None) is not None:
            serving.graphs = False  # the eager sharded program, in every checkout
        out[name] = _measure(serving, reqs, smoke, graph)
        store.listeners.remove(tse._on_store_event)
        store.listeners.remove(serving._on_store_mutation)

    # 70k float32 rows, phase 3's store and requests
    cfg = get_config()
    store, lexicon, vectors, rng, payers = smoke.build_bench_store(cfg, dev)
    q_rows = rng.choice(len(vectors), 64, replace=False)
    q_vecs = vectors[q_rows] + 0.15 * rng.standard_normal((64, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)
    reqs = [QueryRequest(query=f"timely filing deadline for {payers[i % 3]} claims",
                         embedding=q_vecs[i]) for i in range(smoke.BATCH)]
    gc.collect()
    gc.freeze()
    out["70k dense"] = _measure(SearchEngine(store, lexicon, cfg=cfg, device=dev), reqs, smoke)
    sharded("70k S=4", store, lexicon, cfg, make_mesh(4, devices=[dev] * 4), reqs)
    sharded("70k dp2xS4", store, lexicon, cfg, make_serve_mesh(2, 4, devices=[dev] * 8), reqs)
    gc.unfreeze()
    del store, vectors
    gc.collect()
    torch.cuda.empty_cache()

    # 1M bf16 rows, phase 4's store and hybrid requests, the exact backend
    base = dataclasses.replace(
        get_config(), embed_dim=1536, vector_dtype="bfloat16", lexical_format="sparse",
        lexical_buckets=16384, tag_words=8, phrase_words=64, vector_backend="exact",
        proj_p=256, ivf_nlist=0, ivf_nprobe=64, ann_reserve_slabs=2, over_fetch=4,
        gating="dense")
    store, lexicon, vectors = smoke.build_1m_store(base, {}, dev, smoke.N_1M)
    g = torch.Generator(device=dev).manual_seed(3)
    q_rows = torch.randperm(smoke.N_1M, device=dev, generator=g)[:64]
    qv = vectors[q_rows].float() + 0.15 * torch.randn((64, 1536), device=dev, generator=g)
    qv = (qv / qv.norm(dim=1, keepdim=True)).cpu().numpy()
    hy = smoke._HYBRID_1M
    reqs = [QueryRequest(query=hy[i % len(hy)][0], payer=hy[i % len(hy)][1], embedding=qv[i])
            for i in range(smoke.BATCH)]
    gc.collect()
    gc.freeze()
    out["1M dense"] = _measure(SearchEngine(store, lexicon, cfg=base, device=dev), reqs, smoke)
    sharded("1M S=8", store, lexicon, base, make_mesh(8, devices=[dev] * 8), reqs)
    gc.unfreeze()
    print("TURN " + json.dumps(out), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return
    runs = []
    for arg in sys.argv[1:]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", arg],
                              capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            raise SystemExit(f"{arg} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(line[0][5:]))
        print(f"turn {len(runs)}: {arg} in {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"sharded sync serving in turns on {smi}: q/s at batch 32 (median of {ROUNDS} rounds "
          f"of 8 searches), host ms a batch by stage, device busy ms of the wall")
    for r in runs:
        for name, m in r.items():
            if name == "arg":
                continue
            line = f"{r['arg']}: {name}: {m['qps']:.1f} q/s sync (rounds " \
                   f"{[round(x, 1) for x in m['rounds']]})"
            if "pipelined_qps" in m:
                line += (f", {m['pipelined_qps']:.1f} pipelined (rounds "
                         f"{[round(x, 1) for x in m['pipelined_rounds']]})")
            if "host_ms" in m:
                line += "; host ms " + ", ".join(f"{k} {v:.3f}" for k, v in m["host_ms"].items())
                line += (f"; device busy {m['busy_ms']:.3f} of {m['busy_wall_ms']:.3f} ms "
                         f"({100 * m['busy_ms'] / m['busy_wall_ms']:.1f}%)")
            print(line, flush=True)
    print("TURNS " + json.dumps(runs))


if __name__ == "__main__":
    main()
