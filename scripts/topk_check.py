"""Build the masked top-k kernel with the compiler's resource report, show
that the pass-1 instantiations (float32, bfloat16 and int8 rows, each
query tile) that the source's MMA_QT_* send to the tensor cores run there
and the others on the FMA core (HMMA in their SASS or none, ``cuobjdump
-sass``), hold the kernel against its plain version on every phase-2 top-k
case of chip_smoke.py and time it at the main shapes (B=32 and B=1,
D=1536, m=40; float32, bfloat16 and int8 rows at C=70,144; bf16 rows also
at C=125,000 and 1,000,192; each with float32 and with bf16-exact
queries): CUDA-event time of the wrapper call, the device time of each
launch (pass 1 and each merge level, torch.profiler), the bound and the
library routes (addmm + topk; on bf16 rows also mm(out_dtype=float32) +
add + topk, and on int8 rows the reference widen-to-bf16 + mm + scale +
add + topk). A short check for a change to
``mobius_rag_tpu_torch/ops/csrc/topk.cu``; needs one CUDA card.

    python3 scripts/topk_check.py                 # report, checks, timings
    python3 scripts/topk_check.py --ab OTHER.cu   # + timed in turns with another source
    python3 scripts/topk_check.py --sweep         # + pass-1 variants and diagnostics

``--ab`` builds OTHER.cu (another version of topk.cu with the same C
interface, e.g. the parent commit's) beside the package's and times both at
the main shapes in turns (other, this, this, other), each checked against
the plain version first; the bfloat16-row outputs of the two must be
bitwise equal (float32 and int8 rows are held to the plain version at
phase 2's tolerance). ``--sweep`` builds the source once for each pass-1
variant in SWEEP (either core at every query tile, ring depths, warp tiles,
register bounds, and the wave-fill grids: fewer blocks than tiles, each
walking its tiles), checks each at the main shapes and at C=125,000 for
every row type, and times their pass 1 there in turns, with the
diagnostics of DIAG (timed only: pass 1 without its dots, without its
row copies or without its selection).
Then it times both cores' pass 1 (and, with ``--ab``, OTHER's) at every
query tile (B = 32, 16, 8, 4, 1) on float32 and int8 rows with both
query kinds.
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


MGEOM32 = "struct MmaGeom<32> { static constexpr int WM = 4, WN = 2, MT = 2, NT = 2; };"
CORE_F32 = re.compile(r"constexpr int MMA_QT_F32 = \d+;")
CORE_INT8 = re.compile(r"constexpr int MMA_QT_INT8 = \d+;")
NSTAGE = "constexpr int NSTAGE = 2;"
SLICES = "if (split) slice(std::true_type{}, sg);\n        else slice(std::false_type{}, sg);"
FMA_TOO = "static constexpr bool FMA_TOO = MMA && A_PARTS == 3;"
ROWS_GEOM = "struct RowsGeom { static constexpr int WM = 8, WN = 1, MT = 1, NT = QT / 8; };"
BOUNDS = "__launch_bounds__(Tile<T, QT>::THREADS, Tile<T, QT>::MIN_BLOCKS)"
STEPS = "for (int kk = 0; kk < G::DK; kk += 4) step(rs, qs, kk);"
ROW_LOOP = "for (int u = 0; u < G::ROW_CHUNKS; ++u) {"
GRID = "  const int grid_x = n_tiles_of(C);\n"
# the blocks that fit on the card at once for one query tile
RESIDENT = """  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tile<T, QT>::THREADS, smem);
  const int resident = max(1, per_sm * sms / ((B + QT - 1) / QT));
"""
RESIDENT_GRID = RESIDENT + "  const int grid_x = min(n_tiles_of(C), resident);\n"
BALANCED_GRID = RESIDENT + ("  const int per = (n_tiles_of(C) + resident - 1) / resident;\n"
                            "  const int grid_x = (n_tiles_of(C) + per - 1) / per;\n")
# pass 1 walking its tiles with stride gridDim.x (the ring is free again
# once every warp has read its keys)
WALK = [("  const int tile = blockIdx.x;\n",
         "  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {\n"),
        ("      tied += __popc(on_h);\n    }\n  }\n}\n",
         "      tied += __popc(on_h);\n    }\n  }\n  __syncthreads();\n  }\n}\n")]


def _mgeom(qt: int, wm: int, wn: int, mt: int, nt: int) -> str:
    return (f"struct MmaGeom<{qt}> {{ static constexpr int WM = {wm}, WN = {wn}, MT = {mt}, "
            f"NT = {nt}; }};")


# name -> edits of the shipped source (every variant keeps 128-row tiles,
# which the selection and the mma warps assume; a regular expression is
# replaced where it matches): the core for float32 and int8 rows at every
# query tile; the ring depth; the warp tiles (float32 and int8 rows on
# the bf16 rows' tiles; bf16 rows' at QT=32); no register bound (int8
# rows on the tensor cores have one); float32 rows without the
# FMA core's tiles (float32 queries take 9 tensor-core products); the
# wave-fill grids: as many blocks as fit on the card, or the fewest that
# take every tile in the same number of rounds
SWEEP = {
    "cores: tensor at every QT": [(CORE_F32, "constexpr int MMA_QT_F32 = 1;"),
                                  (CORE_INT8, "constexpr int MMA_QT_INT8 = 1;")],
    "cores: FMA at every QT": [(CORE_F32, "constexpr int MMA_QT_F32 = 64;"),
                               (CORE_INT8, "constexpr int MMA_QT_INT8 = 64;")],
    "128 B x3": [(NSTAGE, "constexpr int NSTAGE = 3;")],
    "128 B x4": [(NSTAGE, "constexpr int NSTAGE = 4;")],
    "rows on the bf16 warp tiles": [(ROWS_GEOM, "struct RowsGeom : MmaGeom<QT> {};")],
    "bf16 32: 8 warps of 1x4 tiles": [(MGEOM32, _mgeom(32, 8, 1, 1, 4))],
    "bf16 32: 4 warps of 2x4 tiles": [(MGEOM32, _mgeom(32, 4, 1, 2, 4))],
    "registers: no bound": [(BOUNDS, "__launch_bounds__(Tile<T, QT>::THREADS)")],
    "float32 rows: 9 products, no FMA tiles": [(FMA_TOO, "static constexpr bool FMA_TOO = false;")],
    "grid: resident blocks": WALK + [(GRID, RESIDENT_GRID)],
    "grid: balanced rounds": WALK + [(GRID, BALANCED_GRID)],
}
# diagnostics, timed but wrong by design (not checked): pass 1 with the
# slices' dots taken out (tensor-core slices and FMA steps: the copies
# and the selection alone), with
# the row copies taken out (the dots on whatever the ring holds, and the
# selection), and with the selection taken out
SELECT = "for (int qq = warp; qq < QT && q0 + qq < B; qq += G::WARPS) {"
DIAG = {
    "no dot slices": [(SLICES, "(void)split;"), (STEPS, "(void)rs, (void)qs;")],
    "no row copies": [(ROW_LOOP, "for (int u = 0; u < 0; ++u) {")],
    "no selection": [(SELECT, "for (int qq = warp; qq < 0; qq += G::WARPS) {")],
}
# the query tiles of pass 1, by the batch that selects each
QT_BATCHES = (32, 16, 8, 4, 1)


def _pass1_ms(q, v, pen, ms, sc, m) -> float:
    launches = device_ms_by_launch(lambda: topk.masked_topk(q, v, pen, ms, m, row_scales=sc))
    return next(t for k, t in launches if k.startswith("topk_tiles"))


def _sweep_cases(cases, g) -> dict:
    """The main cases but the 1M store's, and float32 and int8 rows at one
    1M shard's C=125,000 (bf16-exact queries), where the wave-fill grids
    are judged too."""
    out = {k: c for k, c in cases.items() if k.startswith("main") and "1M" not in k}
    for dt, tag in ((torch.float32, "f32"), (torch.int8, "int8")):
        q, v, pen, ms, sc = chip_smoke.topk_inputs(g, chip_smoke.BATCH, chip_smoke.C_SHARD, 1536,
                                                   dt, live=chip_smoke.C_SHARD)
        out[f"sweep_{tag} shard qbf16"] = ((q.to(torch.bfloat16).float(), v, pen, ms, sc), 40)
    return out


def sweep(cases, g, other: str | None) -> None:
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
                pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
                if not pattern.search(text):
                    raise SystemExit(f"sweep: {pattern.pattern!r} is not in the source")
                text = pattern.sub(lambda _: new, text)
            path = os.path.join(tmp, f"topk_v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            builds[name] = path
        with ThreadPoolExecutor(max_workers=len(builds)) as ex:
            list(ex.map(lambda path: build_library("mrag_topk", [path], find_nvcc(), NVCC_FLAGS),
                        builds.values()))
        for name, ((q, v, pen, ms, sc), m) in _sweep_cases(cases, g).items():
            times: dict = {}
            for who in list(builds) + list(builds)[::-1]:
                _load(builds[who])
                if who not in DIAG:
                    chip_smoke.check_topk(name, q, v, pen, ms, sc, m)
                times.setdefault(who, []).append(_pass1_ms(q, v, pen, ms, sc, m))
            chip_smoke.log(f"sweep {name} pass 1 device ms: " + "; ".join(
                f"{who} {' / '.join(f'{t:.4f}' for t in ts)}" for who, ts in times.items()))
        # the two cores (and OTHER's pass 1) at every query tile
        cores = {who: builds[who] for who in ("shipped", "cores: tensor at every QT",
                                              "cores: FMA at every QT")}
        if other is not None:
            cores["other"] = other
        for name in ("main_f32", "main_f32 qbf16", "main_int8", "main_int8 qbf16"):
            (q, v, pen, ms, sc), m = cases[name]
            for b in QT_BATCHES:
                args = (q[:b].contiguous(), v, pen[:b].contiguous(), ms[:b].contiguous(), sc, m)
                times = {}
                for who in list(cores) + list(cores)[::-1]:
                    _load(cores[who])
                    chip_smoke.check_topk(name, *args)
                    times.setdefault(who, []).append(_pass1_ms(*args))
                chip_smoke.log(f"sweep by query tile {name} B={b}: pass 1 device ms " + "; ".join(
                    f"{who} {' / '.join(f'{t:.4f}' for t in ts)}" for who, ts in times.items()))
    _load(shipped)


def sass_check(lib: str, source: str) -> None:
    """Count the tensor-core instructions (HMMA) in each pass-1
    instantiation's SASS (three row types, five query tiles); raise unless
    those that the source's MMA_QT_* send to the tensor cores hold some and
    the others (the FMA core) none."""
    with open(source) as f:
        text = f.read()
    first = {"f": int(re.search(r"MMA_QT_F32 = (\d+);", text).group(1)),
             "a": int(re.search(r"MMA_QT_INT8 = (\d+);", text).group(1)),
             "13__nv_bfloat16": 1}  # the mangled row types: float, signed char, bf16
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, wrong = {}, []
    for part in out.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        found = re.search(r"topk_tilesI(f|a|13__nv_bfloat16)Li(\d+)E", name)
        if found:
            n = counts[name] = len(re.findall(r"\bHMMA\b", part))
            mma = int(found.group(2)) >= first[found.group(1)]
            chip_smoke.log(f"sass {name}: {n} HMMA ({'tensor-core' if mma else 'FMA'} core)")
            if bool(n) != mma:
                wrong.append(name)
    if len(counts) != 15 or wrong:
        raise SystemExit(f"pass-1 instantiations on the wrong core: {wrong} of {counts}")


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
    mm_name = ("reference widen+mm(out_dtype=float32)*scale+topk" if "int8" in name
               else "library mm(out_dtype=float32)+topk")
    return (f"{name}: event {t['ms']:.4f} ms, device {device:.4f} ms "
            f"({parts}), plain {t['plain_ms']:.4f}, library addmm+topk {t['library_ms']:.4f}"
            + ("" if mm is None else f", {mm_name} {mm:.4f}")
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
        sass_check(os.path.join(tmp, "lib.so"), shipped)
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
        sweep(cases, g, args.ab and os.path.abspath(args.ab))
    if args.ab:
        builds = {"other": os.path.abspath(args.ab), "this": shipped}
        for path in builds.values():
            _load(path)
        # every case's outputs from both: bfloat16 rows must agree bitwise
        # (float32 and int8 rows were held to the plain version above)
        for name, ((q, v, pen, ms, sc), m) in cases.items():
            out = {}
            for who in builds:
                _load(builds[who])
                out[who] = topk.masked_topk(q, v, pen, ms, m, row_scales=sc)
            same = all(torch.equal(a, b) for a, b in zip(out["other"], out["this"]))
            chip_smoke.log(f"ab {name} {str(v.dtype)[6:]}: outputs "
                           f"{'bitwise equal' if same else 'differ'}")
            if v.dtype == torch.bfloat16 and not same:
                raise SystemExit(f"ab {name}: the bfloat16 rows' outputs changed")
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
