"""BENCHMARK.json against the contract it is written to, and the files it
names; the harness's imports."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from port_bench import spec

BENCH = spec.load_benchmark()
FORBIDDEN = {"jax", "jaxlib", "flax", "mobius_rag_tpu"}
SYSTEM = "mobius_rag_tpu_torch"
# the modules that touch the system under test; the rest import none of it
SYSTEM_SIDE = {"system.py", "run.py", "control.py", "sweep.py"}


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    yield from (w["name"] for w in BENCH["workloads"])
    yield from (w["config"] for w in BENCH["workloads"])
    yield from (w["traffic"] for w in BENCH["workloads"])
    for kind in ("end_to_end", "per_layer"):
        yield from (m["name"] for m in BENCH[kind])
    for c in BENCH["configs"]:
        yield from c["reduced"]


def _sources():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "port_bench.run"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert spec.NAME.match(name), name


def test_units_better_sources_and_bounds():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert spec.UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == keys, m


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    w = spec.cell(BENCH, cell)
    cfg_path = spec.config_path(BENCH, w["config"])
    assert os.path.relpath(cfg_path, spec.ROOT).startswith("port_bench/")
    cfg = spec.load_json(cfg_path)
    assert cfg["name"] == w["config"]
    assert os.path.exists(os.path.join(os.path.dirname(cfg_path), cfg["lexicon"]))
    mix = spec.load_json(spec.mix_path(w["traffic"]))
    assert mix["kind"] in ("backlog", "open")
    e2e = spec.metrics_of(BENCH, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layers = spec.metrics_of(BENCH, cell, "per_layer")
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]))
        moved = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]][0]
        assert cell in moved.get("workloads", [cell])
    for name in cfg["limits"]:
        assert cfg["limits"][name] >= 0


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("port_bench/") and os.path.exists(os.path.join(spec.ROOT, f))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(
        BENCH["workloads"])


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if os.path.basename(path) not in SYSTEM_SIDE and "tests" not in path.split(os.sep):
        assert SYSTEM not in tops, f"{path} imports the system under test"


def test_a_fresh_run_module_loads_no_jax():
    code = ("import sys, port_bench.run as r, port_bench.control, port_bench.system; "
            "import mobius_rag_tpu_torch.query.engine, mobius_rag_tpu_torch.query.microbatch; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mobius_rag_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
