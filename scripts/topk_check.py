"""Build the masked top-k kernel with the compiler's resource report, hold
it against its plain version on every phase-2 top-k case of chip_smoke.py
and time it at the main shapes (B=32 and B=1; C=70,144, D=1536, m=40;
float32, bfloat16 and int8 rows): CUDA-event time of the wrapper call, the
device time of each launch (pass 1 and each merge level, torch.profiler),
the bound and the library route (addmm + topk). A short check for a change
to ``mobius_rag_tpu_torch/ops/csrc/topk.cu``; needs one CUDA card.

    python3 scripts/topk_check.py                 # report, checks, timings
    python3 scripts/topk_check.py --ab OTHER.cu   # + timed in turns with another source
    python3 scripts/topk_check.py --sweep         # + pass-1 geometries and ring depths

``--ab`` builds OTHER.cu (another version of topk.cu with the same C
interface, e.g. the parent commit's) beside the package's and times both at
the main shapes in turns (other, this, this, other), each checked against
the plain version first. ``--sweep`` builds the source once for each
pass-1 variant in SWEEP (other lane tiles, warps a block, tile rows and
ring depths, by editing the constants), checks each at the main shapes and
times their pass 1 there, in turns, with the diagnostics of DIAG (timed
only: pass 1 without its FMAs, without its row copies or without its
selection).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mobius_rag_tpu_torch.ops import topk  # noqa: E402
from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc  # noqa: E402


GEOM32 = "struct Geom<32> { static constexpr int WQ = 8, WR = 1, LQ = 1, RT = 4, QTT = 4; };"
GEOM16 = "struct Geom<16> { static constexpr int WQ = 4, WR = 2, LQ = 1, RT = 2, QTT = 4; };"
GEOM8 = "struct Geom<8> { static constexpr int WQ = 2, WR = 4, LQ = 1, RT = 1, QTT = 4; };"
GEOM4 = "struct Geom<4> { static constexpr int WQ = 1, WR = 4, LQ = 1, RT = 1, QTT = 4; };"
GEOM1 = "struct Geom<1> { static constexpr int WQ = 1, WR = 4, LQ = 1, RT = 1, QTT = 1; };"
ROWS = "constexpr int TILE_ROWS = 128;"
NSTAGE = "constexpr int NSTAGE = 2;"
STEPS = "step(rs, qs, kk);"
ROW_LOOP = "for (int u = 0; u < G::ROW_CHUNKS; ++u) {"


def _geom(qt: int, wq: int, wr: int, lq: int, rt: int, qtt: int) -> str:
    return (f"struct Geom<{qt}> {{ static constexpr int WQ = {wq}, WR = {wr}, LQ = {lq}, "
            f"RT = {rt}, QTT = {qtt}; }};")


# name -> edits of the shipped source: the ring depth; a geometry as (query
# x row warps, query lanes, rows x queries a lane); 64- and 192-row tiles
TILE64 = [(ROWS, "constexpr int TILE_ROWS = 64;"), (GEOM8, _geom(8, 2, 2, 1, 1, 4)),
          (GEOM16, _geom(16, 4, 1, 1, 2, 4)), (GEOM4, _geom(4, 1, 2, 1, 1, 4)),
          (GEOM1, _geom(1, 1, 2, 1, 1, 1))]
TILE192 = [(ROWS, "constexpr int TILE_ROWS = 192;"), (GEOM32, _geom(32, 8, 1, 1, 6, 4)),
           (GEOM16, _geom(16, 4, 2, 1, 3, 4)), (GEOM8, _geom(8, 2, 2, 1, 3, 4)),
           (GEOM4, _geom(4, 1, 2, 1, 3, 4)), (GEOM1, _geom(1, 1, 2, 1, 3, 1))]
SWEEP = {
    "128 B x3": [(NSTAGE, "constexpr int NSTAGE = 3;")],
    "32: 8 q lanes": [(GEOM32, _geom(32, 1, 8, 8, 4, 4))],
    "32: 8x4 a lane, 4 warps": [(GEOM32, _geom(32, 4, 1, 2, 8, 4))],
    "32: 8x8 a lane, 2 warps": [(GEOM32, _geom(32, 2, 1, 2, 8, 8))],
    "32: 2x8 a lane": [(GEOM32, _geom(32, 4, 2, 1, 2, 8))],
    "64-row tiles, 32: 2 q lanes": TILE64 + [(GEOM32, _geom(32, 4, 1, 2, 4, 4))],
    "192-row tiles, 32: 6x4 a lane": TILE192,
}
# diagnostics, timed but wrong by design (not checked): pass 1 with the
# FMAs taken out (the copies and the selection alone), with the row copies
# taken out (the FMAs on whatever the ring holds, and the selection), and
# with the selection taken out; and the FMAs alone at other lane tiles
NO_ROWS = [(ROW_LOOP, "for (int u = 0; u < 0; ++u) {")]
SELECT = "for (int qq = warp; qq < QT && q0 + qq < B; qq += G::WARPS) {"
DIAG = {
    "no FMAs": [(STEPS, "(void)kk;")],
    "no row copies": NO_ROWS,
    "no selection": [(SELECT, "for (int qq = warp; qq < 0; qq += G::WARPS) {")],
    "no row copies, 8x4 a lane, 4 warps": NO_ROWS + SWEEP["32: 8x4 a lane, 4 warps"],
    "no row copies, 8x8 a lane, 2 warps": NO_ROWS + SWEEP["32: 8x8 a lane, 2 warps"],
    "no row copies, 192-row tiles": NO_ROWS + TILE192,
}


def sweep(cases) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from mobius_rag_tpu_torch.ops._build import build_library

    shipped = os.path.abspath(topk._SOURCE)
    with open(shipped) as f:
        src = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"shipped": shipped}
        for i, (name, edits) in enumerate({**SWEEP, **DIAG}.items()):
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"sweep: {old!r} is not in the source")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"topk_v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            builds[name] = path
        with ThreadPoolExecutor(max_workers=len(builds)) as ex:
            list(ex.map(lambda p: build_library("mrag_topk", [p], find_nvcc(), NVCC_FLAGS),
                        builds.values()))
        mains = {k: c for k, c in cases.items() if k.startswith("main")}
        for name, ((q, v, pen, ms, sc), m) in mains.items():
            times: dict = {}
            for who in list(builds) + list(reversed(builds)):
                _load(builds[who])
                if who not in DIAG:
                    chip_smoke.check_topk(name, q, v, pen, ms, sc, m)
                launches = device_ms_by_launch(
                    lambda: topk.masked_topk(q, v, pen, ms, m, row_scales=sc))
                times.setdefault(who, []).append(
                    next(t for k, t in launches if k.startswith("topk_tiles")))
            chip_smoke.log(f"sweep {name} pass 1 device ms: " + "; ".join(
                f"{who} {' / '.join(f'{t:.4f}' for t in ts)}" for who, ts in times.items()))
    _load(shipped)


def device_ms_by_launch(fn, n: int = 20) -> list[tuple[str, float]]:
    """Device ms of each kernel launch of one call of fn, in launch order
    (torch.profiler over n calls: the trace is cut into calls where its
    rarest kernel recurs, and the k-th launches of the calls of the usual
    length are averaged)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        if evs:
            break
    else:
        raise RuntimeError("the profiler recorded no device events")
    names = [ev.name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
             for ev in evs]
    # a call starts at its rarest kernel (the first of those in the trace):
    # the trace may open on the tail of the call before it
    counts = Counter(names)
    first = min(counts, key=lambda k: (counts[k], names.index(k)))
    starts = [i for i, name in enumerate(names) if name == first] + [len(evs)]
    calls = [list(range(a, b)) for a, b in zip(starts, starts[1:])]
    usual = Counter(len(c) for c in calls).most_common(1)[0][0]
    calls = [c for c in calls if len(c) == usual]
    return [(names[calls[0][k]],
             sum(evs[c[k]].time_range.elapsed_us() for c in calls) / len(calls) / 1e3)
            for k in range(usual)]


def _load(path: str) -> None:
    """Make the wrapper launch the library built from `path`."""
    topk._SOURCE, topk._LIB = path, None
    topk.build_kernel()


def _line(name, t, launches) -> str:
    parts = ", ".join(f"{k} {v:.4f}" for k, v in launches)
    return (f"{name}: event {t['ms']:.4f} ms, device {sum(v for _, v in launches):.4f} ms "
            f"({parts}), plain {t['plain_ms']:.4f}, library addmm+topk {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} by {t['bound_by']} (share of event "
            f"{t['bound_ms'] / t['ms']:.3f})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER.cu", help="also time this source in turns")
    ap.add_argument("--sweep", action="store_true", help="also time pass-1 variants")
    args = ap.parse_args()
    _, smi = chip_smoke.phase0_device()
    shipped = os.path.abspath(topk._SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "lib.so"), shipped],
                              capture_output=True, text=True, timeout=600)
    print("\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                    if re.search(r"error|warning|registers|spill|Compiling", line)),
          flush=True)
    if proc.returncode != 0:
        raise SystemExit("the top-k source does not build")
    _, seconds = topk.build_kernel()
    chip_smoke.log(f"built {shipped} in {seconds:.2f} s")

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = chip_smoke.topk_cases(g)
    for name, ((q, v, pen, ms, sc), m) in cases.items():
        err = chip_smoke.check_topk(name, q, v, pen, ms, sc, m)
        line = f"check {name} B={q.shape[0]} C={v.shape[0]} m={m} {str(v.dtype)[6:]}: " \
               f"max_abs_err {err:.3g}, ids agree"
        if name.startswith("main"):
            t = chip_smoke.time_topk(q, v, pen, ms, sc, m)
            launches = device_ms_by_launch(
                lambda: topk.masked_topk(q, v, pen, ms, m, row_scales=sc))
            line += "; " + _line(name, t, launches)
        chip_smoke.log(line)

    if args.sweep:
        sweep(cases)
    if args.ab:
        builds = {"other": os.path.abspath(args.ab), "this": shipped}
        for path in builds.values():
            _load(path)
        mains = {k: c for k, c in cases.items() if k.startswith("main")}
        for name, ((q, v, pen, ms, sc), m) in mains.items():
            for who in ("other", "this", "this", "other"):
                _load(builds[who])
                chip_smoke.check_topk(name, q, v, pen, ms, sc, m)
                t = chip_smoke.time_topk(q, v, pen, ms, sc, m)
                launches = device_ms_by_launch(
                    lambda: topk.masked_topk(q, v, pen, ms, m, row_scales=sc))
                chip_smoke.log(f"ab {who}: " + _line(name, t, launches))
        _load(shipped)
    chip_smoke.log(f"on {smi}")


if __name__ == "__main__":
    main()
