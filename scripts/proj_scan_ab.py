"""Time the proj-scan kernels of two or more checkouts in turns on one card,
at the real tables' shapes (chip_smoke.py phase 2's main_1M and main_10M,
B=32 and B=1, engine-like probes): CUDA-event time of the wrapper call,
device time by kernel (torch.profiler), and each against its plain version
bitwise. Each checkout runs in its own process, in the order given, with
this script's copy of chip_smoke.py's helpers, so that two versions of the
kernels are compared on one card under one power limit. Needs one CUDA
card.

    python3 scripts/proj_scan_ab.py PARENT . . PARENT

Each argument is the root of a checkout (a `git archive` of a commit
unpacked under a directory .gitignore lists, or "." for this one).
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (shape, nlist, pad, p, tw, gated tag level, metadata ids), chip_smoke.py phase 2
SHAPES = (("1M", 1002, 2048, 256, 8, 2, 4), ("10M", 4098, 5120, 192, 4, 1, 3))


def one(root: str) -> None:
    """Time `root`'s kernels; print one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mobius_rag_tpu_torch.ops import proj_scan
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not proj_scan.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {proj_scan.__file__}, not the checkout at {root}")
    proj_scan.build_kernel()
    g = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for shape, nlist, pad, p, tw, level, meta_ids in SHAPES:
        codes, words = smoke._gate_tables(g, nlist, pad, p, tw, meta_ids)
        for b in (32, 1):
            qmeta, qbits, q8 = smoke._gate_queries(g, b, p, tw, meta_ids)
            probe = smoke._probes(g, "engine", b, 66, nlist)
            raw = proj_scan.proj_blocks(probe, codes, q8)
            score, rid = proj_scan.proj_gated_blocks(probe, qmeta, qbits, codes, words, q8,
                                                     tw=tw, tag_level=level)
            rs, rr = proj_scan.proj_gated_blocks_reference(probe, qmeta, qbits, codes, words,
                                                           q8, tw=tw, tag_level=level)
            if not (torch.equal(raw, proj_scan.proj_blocks_reference(probe, codes, q8))
                    and torch.equal(score, rs) and torch.equal(rid, rr)):
                raise AssertionError(f"{root}: a kernel disagrees with its plain version")
            del raw, score, rid, rs, rr
            t = smoke._time_proj(probe, qmeta, qbits, codes, words, q8, tw, level, plain=False)
            for kern, r in t.items():
                out[f"{kern} main_{shape} B={b}"] = {
                    "ms": r["ms"], "device_ms": r["device_ms"], "bound_ms": r["bound_ms"]}
        del codes, words
        torch.cuda.empty_cache()
    print("AB " + json.dumps({"root": root, "times": out}), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return
    runs = []
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        if proc.returncode != 0 or not line:
            raise SystemExit(f"{root} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(line[0][3:]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"proj-scan kernels in turns on {smi} (ms per call; event = CUDA events around "
          f"the wrapper call, median of 20; device = torch.profiler, kernels only; every "
          f"run bitwise against the plain versions)")
    for key in runs[0]["times"]:
        cells = [f"{r['root']}: event {r['times'][key]['ms']:.4f}, device "
                 f"{r['times'][key]['device_ms']:.4f}" for r in runs]
        print(f"{key} (bound {runs[0]['times'][key]['bound_ms']:.4f}): " + " | ".join(cells))


if __name__ == "__main__":
    main()
