"""A benchmark cell's traced run (``port_bench.run`` with ``--trace 1``) and,
beside its result, the port's own readings of the same window: what the
recorder (``observability.RECORDER``) took while the window's profiler ran.

    python3 scripts/trace_window.py <cell> <seed> [seconds]

Prints one JSON line: the run's ``correct``, its per-layer metrics,
device seconds and breakdown (the top device operations and the idle
gaps), and the recorder's readings (``readings``): per batch, the
host's preparation and assembly (``query.prepare``, ``query.assemble``)
and each of the device program's five stages (its marks, over the batches
whose marks were read) with their sum; the share of the window the engine
starved the device (``query.starved``) and that time split by the spans
under it; the batches whose marks were read and skipped; the share of the
lexical union's (query, bucket) pairs read whose weight is nonzero, whose
postings the lexical kernel scatters (``lexical_live_pairs``; None where
the lexical arm does not run the kernels); and the captured
programs' count by key (``CapturedPrograms.captures_by_key``: warm-up's
and the window's). Run it once a process, as the benchmark does. Needs
one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mobius_rag_tpu_torch import observability as obs  # noqa: E402
from port_bench import run, spec  # noqa: E402
from port_bench import system as sysmod  # noqa: E402

# each stage's reading under the name a per-layer metric of it takes
STAGE_NAMES = {"gate": "gate_ms", "vector": "vector_arm_ms", "lexical": "lexical_arm_ms",
               "dtag": "dtag_arm_ms", "fusion": "fusion_ms"}


def readings(summary: dict, window_s: float) -> dict:
    """The readings of a recorder's `summary` (``Recorder.summary``) taken
    over a window of `window_s` seconds; None where the window recorded
    nothing to read."""
    spans, stages = summary["spans"], summary["stages"]

    def mean(tot):
        return tot["total_ms"] / tot["count"] if tot else None

    out = {"prepare_ms": mean(spans.get("query.prepare")),
           "assemble_ms": mean(spans.get("query.assemble"))}
    out.update({STAGE_NAMES[s]: mean(stages.get(s)) for s in obs.STAGES})
    parts = [out[STAGE_NAMES[s]] for s in obs.STAGES]
    out["stage_sum_ms"] = None if None in parts else sum(parts)
    starved = spans.get("query.starved", {}).get("total_ms", 0.0)
    out["starved_share"] = 100.0 * starved / 1e3 / window_s if "query.dispatch" in spans else None
    out["starved_split_ms"] = summary["children"].get("query.starved", {})
    out["marks"] = {k: summary["counts"].get(k, 0) for k in ("marks_read", "marks_skipped")}
    read = summary["counts"].get("lex_pairs_read", 0)
    out["lexical_live_pairs"] = summary["counts"].get("lex_pairs_live", 0) / read if read else None
    return out


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    name, seed = argv[0], int(argv[1])
    seconds = float(argv[2]) if len(argv) == 3 else spec.load_benchmark()["run_seconds"]
    bench = spec.load_benchmark()
    run.set_caches(spec.ROOT)
    keys: dict[str, int] = {}
    release = sysmod.System.release

    def keep_keys(system):  # the run lets its engine go before it reports
        if system.engine is not None and system.engine.graphs:
            keys.update({repr(k): n for k, n in system.engine.programs.captures_by_key.items()})
        release(system)

    sysmod.System.release = keep_keys
    obs.RECORDER.reset()
    res = run.run_cell(bench, spec.cell(bench, name), seed, seconds, True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "cell": name, "seed": seed, "card": card, "correct": res["correct"],
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "device": res["device"], "breakdown": res.get("breakdown"),
        "window": res["notes"]["window"],
        "collections": res["notes"]["collections"],
        "program": readings(obs.RECORDER.summary(), res["device"]["window_s"]),
        "captures_by_key": keys}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
