"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and each per-layer metric's reader (``metrics/<name>.py``, a function
``read(ctx)`` that returns a number, or None where it finds nothing to
read). Adding a cell, a configuration, a mix or a metric adds files and
entries here; no code changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "port_bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_path(bench: dict, name: str, root: str = ROOT) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.join(root, c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def mix_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "port_bench", "traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def reader(name: str):
    """The `read(ctx)` of metrics/<name>.py (a name may hold dots, so the
    file is loaded by its path)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") a cell
    reports: those without a `workloads` list, and those whose list names
    the cell."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
