"""Build the masked top-k kernel with the compiler's resource report, show
that every bf16-row instantiation of pass 1 runs on the tensor cores (HMMA
in its SASS, ``cuobjdump -sass``), hold the kernel against its plain
version on every phase-2 top-k case of chip_smoke.py and time it at the
main shapes (B=32 and B=1, D=1536, m=40; float32, bfloat16 and int8 rows
at C=70,144; bf16 rows also at C=125,000 and 1,000,192, with float32 and
with bf16-exact queries): CUDA-event time of the wrapper call, the device
time of each launch (pass 1 and each merge level, torch.profiler), the
bound and the library routes (addmm + topk; on bf16 rows also
mm(out_dtype=float32) + add + topk). A short check for a change to
``mobius_rag_tpu_torch/ops/csrc/topk.cu``; needs one CUDA card.

    python3 scripts/topk_check.py                 # report, checks, timings
    python3 scripts/topk_check.py --ab OTHER.cu   # + timed in turns with another source
    python3 scripts/topk_check.py --sweep         # + pass-1 variants and diagnostics

``--ab`` builds OTHER.cu (another version of topk.cu with the same C
interface, e.g. the parent commit's) beside the package's and times both at
the main shapes in turns (other, this, this, other), each checked against
the plain version first; the float32- and int8-row outputs of the two must
be bitwise equal. ``--sweep`` builds the source once for each pass-1
variant in SWEEP (other lane tiles, the bf16 core's warp tiles and ring
depths, by editing the constants), checks each at the main shapes of its
row types and times their pass 1 there, in turns, with the diagnostics of
DIAG (timed only: pass 1 without its FMAs or its tensor-core slices,
without its row copies or without its selection).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mobius_rag_tpu_torch.ops import topk  # noqa: E402
from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc  # noqa: E402


GEOM32 = "struct Geom<32> { static constexpr int WQ = 8, WR = 1, LQ = 1, RT = 4, QTT = 4; };"
MGEOM32 = "struct MmaGeom<32> { static constexpr int WM = 4, WN = 2, MT = 2, NT = 2; };"
NSTAGE = "constexpr int NSTAGE = 2;"
STEPS = "step(rs, qs, kk);"
SLICES = "if (split) slice(std::true_type{}, sg);\n      else slice(std::false_type{}, sg);"
ROW_LOOP = "for (int u = 0; u < G::ROW_CHUNKS; ++u) {"


def _geom(qt: int, wq: int, wr: int, lq: int, rt: int, qtt: int) -> str:
    return (f"struct Geom<{qt}> {{ static constexpr int WQ = {wq}, WR = {wr}, LQ = {lq}, "
            f"RT = {rt}, QTT = {qtt}; }};")


def _mgeom(qt: int, wm: int, wn: int, mt: int, nt: int) -> str:
    return (f"struct MmaGeom<{qt}> {{ static constexpr int WM = {wm}, WN = {wn}, MT = {mt}, "
            f"NT = {nt}; }};")


# the row types a variant is timed on: the FMA core's, the tensor-core
# core's, or both
FMA, MMA, ALL = ("float32", "int8"), ("bfloat16",), ("float32", "int8", "bfloat16")
# name -> (edits of the shipped source, row types): the ring depth (both
# cores); the FMA core's geometry at QT=32 as (query x row warps, query
# lanes, rows x queries a lane); the tensor-core core's warp tiles (both
# keep 128-row tiles, which the selection and the mma warps assume)
SWEEP = {
    "128 B x3": ([(NSTAGE, "constexpr int NSTAGE = 3;")], ALL),
    "128 B x4": ([(NSTAGE, "constexpr int NSTAGE = 4;")], ALL),
    "32: 8 q lanes": ([(GEOM32, _geom(32, 1, 8, 8, 4, 4))], FMA),
    "32: 8x4 a lane, 4 warps": ([(GEOM32, _geom(32, 4, 1, 2, 8, 4))], FMA),
    "32: 8x8 a lane, 2 warps": ([(GEOM32, _geom(32, 2, 1, 2, 8, 8))], FMA),
    "32: 2x8 a lane": ([(GEOM32, _geom(32, 4, 2, 1, 2, 8))], FMA),
    "bf16 32: 8 warps of 1x4 tiles": ([(MGEOM32, _mgeom(32, 8, 1, 1, 4))], MMA),
    "bf16 32: 4 warps of 2x4 tiles": ([(MGEOM32, _mgeom(32, 4, 1, 2, 4))], MMA),
}
# diagnostics, timed but wrong by design (not checked): pass 1 with the
# FMAs or the tensor-core slices taken out (the copies and the selection
# alone), with the row copies taken out (the dots on whatever the ring
# holds, and the selection), and with the selection taken out; and the
# FMAs alone at other lane tiles
NO_ROWS = [(ROW_LOOP, "for (int u = 0; u < 0; ++u) {")]
SELECT = "for (int qq = warp; qq < QT && q0 + qq < B; qq += G::WARPS) {"
DIAG = {
    "no FMAs": ([(STEPS, "(void)kk;")], FMA),
    "bf16 no mma slices": ([(SLICES, "(void)split;")], MMA),
    "no row copies": (NO_ROWS, ALL),
    "no selection": ([(SELECT, "for (int qq = warp; qq < 0; qq += G::WARPS) {")], ALL),
    "no row copies, 8x4 a lane, 4 warps": (NO_ROWS + SWEEP["32: 8x4 a lane, 4 warps"][0], FMA),
    "no row copies, 8x8 a lane, 2 warps": (NO_ROWS + SWEEP["32: 8x8 a lane, 2 warps"][0], FMA),
}


def sweep(cases) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from mobius_rag_tpu_torch.ops._build import build_library

    shipped = os.path.abspath(topk._SOURCE)
    with open(shipped) as f:
        src = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"shipped": (shipped, ALL)}
        for i, (name, (edits, kinds)) in enumerate({**SWEEP, **DIAG}.items()):
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"sweep: {old!r} is not in the source")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"topk_v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            builds[name] = (path, kinds)
        with ThreadPoolExecutor(max_workers=len(builds)) as ex:
            list(ex.map(lambda b: build_library("mrag_topk", [b[0]], find_nvcc(), NVCC_FLAGS),
                        builds.values()))
        mains = {k: c for k, c in cases.items() if k.startswith("main") and "1M" not in k}
        for name, ((q, v, pen, ms, sc), m) in mains.items():
            kind = str(v.dtype)[6:]
            whos = [w for w, (_, kinds) in builds.items() if kind in kinds]
            times: dict = {}
            for who in whos + whos[::-1]:
                _load(builds[who][0])
                if who not in DIAG:
                    chip_smoke.check_topk(name, q, v, pen, ms, sc, m)
                launches = device_ms_by_launch(
                    lambda: topk.masked_topk(q, v, pen, ms, m, row_scales=sc))
                times.setdefault(who, []).append(
                    next(t for k, t in launches if k.startswith("topk_tiles")))
            chip_smoke.log(f"sweep {name} pass 1 device ms: " + "; ".join(
                f"{who} {' / '.join(f'{t:.4f}' for t in ts)}" for who, ts in times.items()))
    _load(shipped)


def sass_check(lib: str) -> None:
    """Count the tensor-core instructions (HMMA) in each pass-1
    instantiation's SASS; raise unless every bf16-row one holds some."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "topk_tiles" in name:
            counts[name] = len(re.findall(r"\bHMMA\b", part))
    for name, n in sorted(counts.items()):
        chip_smoke.log(f"sass {name}: {n} HMMA")
    bf16 = [n for name, n in counts.items() if "__nv_bfloat16" in name]
    if len(bf16) != 5 or not all(bf16):
        raise SystemExit(f"the bf16-row pass 1 is not on the tensor cores: {counts}")


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
    for _ in range(chip_smoke.PROFILE_TRIES):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        if evs:
            break
        time.sleep(0.5)
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
    device = sum(v for _, v in launches)
    mm = t["library_mm_dtype_ms"]
    return (f"{name}: event {t['ms']:.4f} ms, device {device:.4f} ms "
            f"({parts}), plain {t['plain_ms']:.4f}, library addmm+topk {t['library_ms']:.4f}"
            + ("" if mm is None else f", library mm(out_dtype=float32)+topk {mm:.4f}")
            + f", bound {t['bound_ms']:.4f} by {t['bound_by']} (share of device "
            f"{t['bound_ms'] / device:.3f})")


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
        sass_check(os.path.join(tmp, "lib.so"))
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
        # every case's outputs from both; float32 and int8 rows must agree bitwise
        for name, ((q, v, pen, ms, sc), m) in cases.items():
            out = {}
            for who in builds:
                _load(builds[who])
                out[who] = topk.masked_topk(q, v, pen, ms, m, row_scales=sc)
            same = all(torch.equal(a, b) for a, b in zip(out["other"], out["this"]))
            chip_smoke.log(f"ab {name} {str(v.dtype)[6:]}: outputs "
                           f"{'bitwise equal' if same else 'differ'}")
            if v.dtype != torch.bfloat16 and not same:
                raise SystemExit(f"ab {name}: the float32/int8 rows' outputs changed")
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
