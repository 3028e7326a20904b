"""Build the proj-scan kernels with the compiler's resource report, hold
both against their plain versions on every phase-2 case of chip_smoke.py
(bitwise) and time them at the real tables' shapes. A short check for a
change to ``mobius_rag_tpu_torch/ops/csrc/proj_scan.cu``; needs one CUDA
card.

    python3 scripts/proj_scan_check.py            # report, checks, timings
    python3 scripts/proj_scan_check.py --sweep    # + other ring depths

It ends with each launch's device time by kernel (grouping, scan) from
torch.profiler at the main shapes, B=32 and B=1, beside the CUDA-event time
of the wrapper call.

``--sweep`` then builds the source once for each ring depth (3 and 4
stages in place of the shipped 2), checks each bitwise at the main shapes
and times them there, in turns with the shipped build.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mobius_rag_tpu_torch.ops import proj_scan  # noqa: E402
from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, build_library, find_nvcc  # noqa: E402

CHOICE = "constexpr int STAGES = 2;"


def _variant(tmp: str, stages: int) -> str:
    with open(proj_scan.SOURCE) as f:
        src = f.read()
    if CHOICE not in src:
        raise SystemExit("the ring depth choice is not where the sweep expects it")
    path = os.path.join(tmp, f"proj_scan_s{stages}.cu")
    with open(path, "w") as f:
        f.write(src.replace(CHOICE, f"constexpr int STAGES = {stages};"))
    return path


def _load(path: str) -> None:
    """Make the wrapper launch the library built from `path`."""
    proj_scan.SOURCE, proj_scan._LIB = path, None
    proj_scan.build_kernel()


def sweep() -> None:
    shipped = proj_scan.SOURCE
    g = torch.Generator(device="cuda").manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"shipped": shipped, **{f"{s} stages": _variant(tmp, s) for s in (3, 4)}}
        with ThreadPoolExecutor(max_workers=len(builds)) as ex:
            list(ex.map(lambda src: build_library("mrag_proj_scan", [src], find_nvcc(),
                                                  NVCC_FLAGS), builds.values()))
        for shape, nlist, pad, p, tw, level, meta_ids in (("1M", 1002, 2048, 256, 8, 2, 4),
                                                          ("10M", 4098, 5120, 192, 4, 1, 3)):
            codes, words = chip_smoke._gate_tables(g, nlist, pad, p, tw, meta_ids)
            for b in (32, 1):
                qmeta, qbits, q8 = chip_smoke._gate_queries(g, b, p, tw, meta_ids)
                probe = chip_smoke._probes(g, "engine", b, 66, nlist)
                order = list(builds) + list(reversed(builds))  # in turns, both ways
                times: dict = {}
                for name in order:
                    _load(builds[name])
                    chip_smoke._check_proj(f"{shape} B={b} {name}", probe, qmeta, qbits,
                                           codes, words, q8, tw)
                    t = chip_smoke._time_proj(probe, qmeta, qbits, codes, words, q8, tw,
                                              level, plain=False)
                    times.setdefault(name, []).append(t)
                for name, ts in times.items():
                    parts = []
                    for kern in ts[0]:
                        ms = " / ".join(f"{t[kern]['ms']:.4f}" for t in ts)
                        parts.append(f"{kern} {ms} ms (bound {ts[0][kern]['bound_ms']:.4f})")
                    chip_smoke.log(f"sweep main_{shape} B={b} {name}: " + "; ".join(parts))
            del codes, words
            torch.cuda.empty_cache()
    _load(shipped)


def breakdown() -> None:
    g = torch.Generator(device="cuda").manual_seed(9)
    for shape, nlist, pad, p, tw, level, meta_ids in (("1M", 1002, 2048, 256, 8, 2, 4),
                                                      ("10M", 4098, 5120, 192, 4, 1, 3)):
        codes, words = chip_smoke._gate_tables(g, nlist, pad, p, tw, meta_ids)
        for b in (32, 1):
            qmeta, qbits, q8 = chip_smoke._gate_queries(g, b, p, tw, meta_ids)
            probe = chip_smoke._probes(g, "engine", b, 66, nlist)
            for kern, fn in (
                    ("proj_blocks", lambda: proj_scan.proj_blocks(probe, codes, q8)),
                    ("proj_gated_blocks", lambda: proj_scan.proj_gated_blocks(
                        probe, qmeta, qbits, codes, words, q8, tw=tw, tag_level=level))):
                by = chip_smoke._device_ms_by_kernel(fn)
                chip_smoke.log(f"breakdown main_{shape} B={b} {kern}: event "
                               f"{chip_smoke._median_ms(fn):.4f} ms; device ms per call " +
                               ", ".join(f"{k} {v:.4f}" for k, v in by.items()))
        del codes, words
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="also time other ring depths")
    args = ap.parse_args()
    chip_smoke.phase0_device()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "lib.so"), proj_scan.SOURCE],
                              capture_output=True, text=True, timeout=600)
    print("\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                    if re.search(r"error|warning|registers|spill|Compiling", line)),
          flush=True)
    if proc.returncode != 0:
        raise SystemExit("the proj-scan source does not build")
    chip_smoke.phase1_build()
    chip_smoke.phase2_proj_kernels()
    if args.sweep:
        sweep()
    breakdown()


if __name__ == "__main__":
    main()
