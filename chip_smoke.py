"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's
CUDA kernels from the checkout, holds each against its plain PyTorch
version at the main paths' shapes, then drives the strategy-a hybrid
query path (``mobius_rag_tpu_torch.query.engine.SearchEngine.search``):
on a 70,000-chunk x 1536-dim corpus with the exact backend over float32
rows (phase 3) and over int8 rows (phase 3b), on a 1,000,000-chunk
corpus with the proj ANN backend under dense and candidate-local filter
gating (phase 4), and on the 10M-chunk host-residency configuration:
proj codes on the card, int8 rows in host RAM, the funnel and the exact
host re-rank (phase 5; N is cut to 5M or 2M when the time or the host's
RAM would not hold 10M, and the cut is printed).

    python3 chip_smoke.py

Progress and numbers go to stdout. The line before the last is a JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
not 0 and no result line is printed. Needs one CUDA card; it does not
fall back to the CPU.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# The reference operating point (bench.py): corpus size, batch, k.
N_CHUNKS = 70_000
K = 10
BATCH = 32
N_BATCHES = 8
KERNEL_SOURCE = "mobius_rag_tpu_torch/ops/csrc/topk.cu"
KERNEL_REPLACES = "mobius_rag_tpu/ops/topk.py:151"  # _topk_kernel
PROJ_SOURCE = "mobius_rag_tpu_torch/ops/csrc/proj_scan.cu"
PROJ_REPLACES = "mobius_rag_tpu/ops/pallas_proj.py:41"  # _kernel
GATED_REPLACES = "mobius_rag_tpu/ops/pallas_proj.py:141"  # _gated_kernel
TOL_VALS = 1e-4  # float32 summation order over D=1536
TIE_GAP = 1e-5  # ids must agree wherever neighbouring values differ by more
# Phase 4: bench_1m_e2e.py's corpus and the proj backend's 1M operating
# point (ops/proj.py: nprobe 64, batch 32).
N_1M = 1_000_000
N_CENTERS = 4096
FEATURIZE_EVERY = 50
HIT_TOL = 1e-3  # dense vs local rerank scores (test_gating.py's bound)
SCRIPT_LIMIT_S = 1200  # the whole script's time limit, kernel builds included
# Data-sheet peaks of one NVIDIA H100 SXM at 700 W: HBM bytes/s, and
# operations/s by the inputs' type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase0_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return name, smi.splitlines()[0]


def phase1_build() -> None:
    """Build every kernel library at once: one nvcc per source, started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from mobius_rag_tpu_torch.ops import proj_scan, topk

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {src: ex.submit(mod.build_kernel)
                for src, mod in ((KERNEL_SOURCE, topk), (PROJ_SOURCE, proj_scan))}
        seconds = {src: fut.result()[1] for src, fut in futs.items()}
    for src, sec in seconds.items():
        log(f"phase 1: built {src} with nvcc in {sec:.2f} s")
    log(f"phase 1: both builds and loads took {time.perf_counter() - t0:.2f} s")


def _compare(kv, ki, rv, ri) -> float:
    """Max |value difference|; raises unless values agree within TOL_VALS
    and ids agree wherever neighbouring reference values are not tied."""
    err = (kv - rv).abs().max().item()
    tied = (rv[:, 1:] - rv[:, :-1]).abs() <= TIE_GAP
    strict = torch.ones_like(ri, dtype=torch.bool)
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    bad = ((ki != ri) & strict).sum().item()
    if not err <= TOL_VALS or bad:
        raise AssertionError(f"kernel disagrees with plain version: "
                             f"max_abs_err={err} mismatched ids={bad}")
    return err


def _median_ms(fn, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def topk_inputs(g, b, c, d, dtype, gate=0.3, live=None, pen_form="bc", min_sim=True,
                dup=False):
    """Masked top-k inputs on the card: unit rows (int8: quantized with the
    store's per-row scales; `dup`: every row one row, so every score ties),
    unit queries, a penalty gating `gate` of the rows (and every row from
    `live` on), min_sim 0.02 on odd queries. Returns (q, v, pen, min_sim,
    scales)."""
    from mobius_rag_tpu_torch.ops.quant import quantize_rows
    from mobius_rag_tpu_torch.ops.topk import NEG_INF

    v = torch.randn(1 if dup else c, d, device="cuda", generator=g).expand(c, d)
    v = v / v.norm(dim=1, keepdim=True)
    scales = None
    if dtype == torch.int8:
        v, scales = quantize_rows(v)
    v = v.to(dtype).contiguous()
    q = torch.randn(b, d, device="cuda", generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    shape = (b, c) if pen_form == "bc" else (c,)
    pen = torch.where(torch.rand(shape, device="cuda", generator=g) < gate, NEG_INF, 0.0)
    if live is not None:
        pen[..., live:] = NEG_INF
    ms = torch.where(torch.arange(b, device="cuda") % 2 == 1, 0.02, 0.0) \
        if min_sim else None
    return q, v, pen.contiguous(), ms, scales


C_MAIN = 70_144  # capacity of the 70,000-row store


def topk_cases(g) -> dict:
    """name -> (inputs, m): the main paths' shapes (B=32 and B=1, float32,
    bfloat16 and int8 rows) and the edges: C=1000 with one query whose every
    row is gated, m=1024, fewer live rows than m, a [C] penalty, every row
    one row (all scores tie), m=128 and m=129 on either side of pass 1's
    partial width."""
    cases = {}
    for b in (BATCH, 1):
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.int8, "int8")):
            name = f"main_{tag}" + ("" if b == BATCH else " B=1")
            cases[name] = (topk_inputs(g, b, C_MAIN, 1536, dt, live=N_CHUNKS), 40)
    cases.update({
        "C=1000": (topk_inputs(g, 4, 1000, 1536, torch.float32), 40),
        "m=1024": (topk_inputs(g, 8, 4096, 1536, torch.float32), 1024),
        "fewer_live_than_m": (topk_inputs(g, 4, 2048, 1536, torch.float32, live=25), 40),
        "penalty[C]": (topk_inputs(g, 4, 3000, 1536, torch.float32, pen_form="c",
                                   min_sim=False), 40),
        "all scores tie": (topk_inputs(g, 4, 5000, 1536, torch.float32, gate=0.0,
                                       dup=True), 40),
        "m=128": (topk_inputs(g, 8, 20_000, 1536, torch.float32), 128),
        "m=129": (topk_inputs(g, 8, 20_000, 1536, torch.float32), 129),
        "int8 m=1024": (topk_inputs(g, 8, 4096, 1536, torch.int8), 1024),
        "int8 penalty[C]": (topk_inputs(g, 4, 3000, 1536, torch.int8, pen_form="c",
                                        min_sim=False), 40),
        "int8 C=1000": (topk_inputs(g, 4, 1000, 1536, torch.int8), 40),
    })
    for name in ("C=1000", "int8 C=1000"):
        cases[name][0][2][1] = -1e30  # one query with every row gated
    return cases


def check_topk(name, q, v, pen, ms, sc, m) -> float:
    """The kernel against its plain version on one case; returns the max
    |value difference|."""
    from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk, masked_topk_reference

    kv, ki = masked_topk(q, v, pen, ms, m, row_scales=sc)
    torch.cuda.synchronize()
    rv, ri = masked_topk_reference(q, v, pen, ms, m, row_scales=sc)
    err = _compare(kv, ki, rv, ri)
    if name.endswith("C=1000") and bool((kv[1] > NEG_INF / 2).any()):
        raise AssertionError(f"{name}: a query whose every row is gated has a live row")
    if name == "all scores tie" and not torch.equal(
            ki, torch.arange(m, dtype=torch.int32, device=ki.device).expand_as(ki)):
        raise AssertionError(f"{name}: tied rows not in row order")
    return err


def time_topk(q, v, pen, ms, sc, m) -> dict:
    """Median-of-20 event times of the kernel, its plain version and the
    library route; the kernels' device time (profiler); the bound."""
    from mobius_rag_tpu_torch.ops.topk import masked_topk, masked_topk_reference

    def kern():
        return masked_topk(q, v, pen, ms, m, row_scales=sc)

    t_k = _median_ms(kern)
    by = _device_ms_by_kernel(kern)
    t_p = _median_ms(lambda: masked_topk_reference(q, v, pen, ms, m, row_scales=sc))
    # the library route: one addmm over the rows widened to float32 (the
    # float32 rows as they are), then topk; its tie order is not stable.
    # Two calls; a single call only for float32 rows.
    vf = v.float() if sc is None else v.float() * sc[:, None]
    t_l = _median_ms(lambda: torch.topk(torch.addmm(pen, q, vf.T), m, dim=1))
    del vf
    return {"ms": t_k, "device_ms": sum(by.values()), "by_kernel": by, "plain_ms": t_p,
            "library_ms": t_l, **_topk_bound(q, v, pen, m)}


def phase2_kernel() -> dict:
    """The masked top-k kernel against its plain version: float32 and
    bfloat16 rows, and the int8-row form with real per-row scales (the
    store's quantization), at the main paths' shapes and the edges; the
    main shapes timed."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"fp": 0.0, "int8": 0.0}
    timing = {}
    for name, ((q, v, pen, ms, sc), m) in topk_cases(g).items():
        err = check_topk(name, q, v, pen, ms, sc, m)
        form = "int8" if v.dtype == torch.int8 else "fp"
        worst[form] = max(worst[form], err)
        line = f"phase 2: {name} B={q.shape[0]} C={v.shape[0]} m={m} " \
               f"{str(v.dtype)[6:]}: max_abs_err={err:.3g} ids agree"
        if name.startswith("main"):
            t = timing[name] = time_topk(q, v, pen, ms, sc, m)
            by = ", ".join(f"{k} {x:.4f}" for k, x in t["by_kernel"].items())
            line += (f"; kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}: {by}), plain "
                     f"{t['plain_ms']:.4f} ms, library addmm+topk {t['library_ms']:.4f} ms "
                     f"(float32 rows{'' if v.dtype == torch.float32 else ', widened first'}; "
                     f"median of 20); bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
                     f"(share {t['bound_ms'] / t['ms']:.3f})")
        log(line)
    return {"max_abs_err": worst["fp"], "max_abs_err_int8": worst["int8"],
            "timing": timing}


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _topk_bound(q, v, pen, m) -> dict:
    """Rows, queries and penalty read once, m (value, id) pairs written;
    2·B·C·D operations at the rows' type (int8 rows against bf16-rounded
    queries are exact on the bf16 tensor cores)."""
    b, d = q.shape
    c = v.shape[0]
    nbytes = c * d * v.element_size() + q.numel() * 4 + pen.numel() * 4 + b * m * 8
    if v.dtype == torch.int8:
        nbytes += c * 4  # row scales
    kind = {torch.float32: "float32"}.get(v.dtype, "bfloat16")
    return _bound(nbytes, 2.0 * b * c * d, kind)


def _ri(g, lo, hi, shape):
    return torch.randint(lo, hi, shape, device="cuda", generator=g,
                         dtype=torch.int64).to(torch.int32)


def _gate_tables(g, nlist, pad, p, tw=8, meta_ids=4, step=32):
    """Random proj tables: codes [nlist, pad, p] over the full int8 range
    and the gate pack words [nlist, W, pad] with small metadata ids, the
    valid and regulator flags, a float scale, a row id and sparse tag
    bits. Made `step` clusters at a time, so that the int64 draws stay a
    few hundred MB at the 10M tables' 4.0 GB of codes."""
    from mobius_rag_tpu_torch.ops.proj import gate_widths

    w_full, _ = gate_widths(tw)
    codes = torch.empty((nlist, pad, p), dtype=torch.int8, device="cuda")
    words = torch.zeros((nlist, w_full, pad), dtype=torch.int32, device="cuda")
    for lo in range(0, nlist, step):
        n = min(step, nlist - lo)
        codes[lo:lo + n] = _ri(g, -127, 128, (n, pad, p)).to(torch.int8)
        wd = words[lo:lo + n]
        wd[:, 0] = _ri(g, 0, meta_ids, (n, pad)) | (_ri(g, 0, 2, (n, pad)) << 16)
        wd[:, 1] = (_ri(g, 0, 3, (n, pad)) | (_ri(g, 0, 8, (n, pad)).clamp(max=1) << 16)
                    | (_ri(g, 0, 2, (n, pad)) << 17))
        wd[:, 2] = (torch.rand((n, pad), device="cuda", generator=g) * 1e-2).view(torch.int32)
        wd[:, 3] = _ri(g, 0, 1 << 20, (n, pad))
        shape = (n, 3 * tw, pad)
        wd[:, 4:4 + 3 * tw] = (_ri(g, 0, 1 << 30, shape) & _ri(g, 0, 1 << 30, shape)
                               & _ri(g, 0, 1 << 30, shape))
    return codes, words


def _gate_queries(g, b, p, tw=8, meta_ids=4):
    """One query per tag mode (plus "any"/"none" filters): qmeta [B, 8],
    qbits [B, 3·tw], q8 [B, p]. Where B > 1, query 0 has a payer no slot
    has, no inherited authority and strict/auto mode: every one of its
    slots is gated."""
    q8 = _ri(g, -127, 128, (b, p)).to(torch.int8)
    qmeta = torch.stack([_ri(g, 0, meta_ids, (b,)), _ri(g, 0, 2, (b,)), _ri(g, 0, 3, (b,)),
                         torch.arange(b, device="cuda", dtype=torch.int32) % 3,
                         _ri(g, 0, 2, (b,)), _ri(g, 0, 2, (b,)), _ri(g, 0, 2, (b,)),
                         _ri(g, 0, 2, (b,))], 1)
    qmeta[1::4, :3] = 0xFFFE  # "any" payer, state and program
    if b > 1:
        qmeta[0, 0], qmeta[0, 3], qmeta[0, 5] = 0xFFFD, 0, 0
    qbits = _ri(g, 0, 1 << 30, (b, 3 * tw)) & _ri(g, 0, 1 << 30, (b, 3 * tw))
    return qmeta.contiguous(), qbits.contiguous(), q8


def _probes(g, kind, b, n_probe, nlist):
    """probe [B, P] int32. "random": uniform with duplicates; "one": every
    probe on one cluster; "low": only clusters 0-9 (the rest unprobed);
    "engine": as the engine probes, P-2 distinct base cells per query then
    the 2 reserved slabs (the last two clusters) for every query."""
    if kind == "random":
        return _ri(g, 0, nlist, (b, n_probe))
    if kind == "one":
        return torch.full((b, n_probe), nlist // 2, dtype=torch.int32, device="cuda")
    if kind == "low":
        return _ri(g, 0, min(10, nlist), (b, n_probe))
    base = nlist - 2
    cells = torch.argsort(torch.rand((b, base), device="cuda", generator=g), dim=1)
    reserved = torch.arange(base, nlist, device="cuda").expand(b, 2)
    return torch.cat([cells[:, :n_probe - 2], reserved], 1).to(torch.int32).contiguous()


def _w_rows(level: int, tw: int) -> int:
    """Gate word rows the gated scan reads at a tag level."""
    return 4 + (0, tw, 3 * tw)[level]


def _proj_bound(probe, nlist, pad, p, level=None, tw=0) -> dict:
    """Each distinct probed block read once (p code bytes, and gated the
    level's word rows, per slot), the probes and queries once, each output
    written once; 2·B·P·pad·p int8 operations. `level` None: proj_blocks."""
    b, n_probe = probe.shape
    distinct = int(torch.unique(probe.clamp(0, nlist - 1)).numel())
    per_slot = p + (0 if level is None else 4 * _w_rows(level, tw))
    nbytes = distinct * pad * per_slot + probe.numel() * 4 + b * p
    nbytes += b * n_probe * pad * (4 if level is None else 8)
    if level is not None:
        nbytes += b * (8 + 3 * tw) * 4
    return dict(_bound(nbytes, 2.0 * b * n_probe * pad * p, "int8"), distinct=distinct)


def _check_proj(name, probe, qmeta, qbits, codes, words, q8, tw) -> tuple[float, list]:
    """Both proj kernels against their plain versions: raw dots bitwise,
    gated scores and row ids bitwise at tag levels 0, 1 and 2."""
    from mobius_rag_tpu_torch.ops.proj_scan import (
        group_probes, group_probes_reference, proj_blocks, proj_blocks_reference,
        proj_gated_blocks, proj_gated_blocks_reference)

    nlist = codes.shape[0]
    for got, want in zip(group_probes(probe, nlist), group_probes_reference(probe, nlist)):
        if not torch.equal(got, want):
            raise AssertionError(f"the grouping kernel disagrees with its plain twin ({name})")
    raw = proj_blocks(probe, codes, q8)
    torch.cuda.synchronize()
    ref = proj_blocks_reference(probe, codes, q8)
    worst = (raw - ref).abs().max().item()
    if not torch.equal(raw, ref):
        raise AssertionError(f"proj_blocks disagrees with its plain version ({name})")
    del raw, ref
    live = []
    for level in (0, 1, 2):
        score, rid = proj_gated_blocks(probe, qmeta, qbits, codes, words, q8,
                                       tw=tw, tag_level=level)
        torch.cuda.synchronize()
        rs, rr = proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8,
                                             tw=tw, tag_level=level)
        worst = max(worst, (score - rs).abs().max().item())
        if not (torch.equal(score, rs) and torch.equal(rid, rr)):
            raise AssertionError(f"proj_gated_blocks disagrees with its plain "
                                 f"version ({name}, tag_level {level})")
        if probe.shape[0] > 1 and (score[0] > -1e29).any():
            raise AssertionError("a query whose every slot is gated has a live slot")
        live.append(round((rs > -1e29).float().mean().item(), 4))
    return worst, live


def _device_ms_by_kernel(fn, n: int = 20) -> dict:
    """Device ms per call of each kernel that fn launches (torch.profiler
    over n calls): the CUDA-event time of a call also holds the host's
    enqueue while the card waits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if events:
            break
    by: dict = {}
    for ev in events:
        name = ev.name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
        by[name] = by.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    return by


def _time_proj(probe, qmeta, qbits, codes, words, q8, tw, level, plain) -> dict:
    """Median-of-20 CUDA-event times of both kernels (the gated one at
    `level`), their device time by kernel (profiler), their plain
    versions' event times when `plain`, and their bounds."""
    from mobius_rag_tpu_torch.ops.proj_scan import (
        proj_blocks, proj_blocks_reference, proj_gated_blocks,
        proj_gated_blocks_reference)

    nlist, pad, p = codes.shape
    calls = {"proj_blocks": (lambda: proj_blocks(probe, codes, q8), None),
             "proj_gated_blocks": (lambda: proj_gated_blocks(
                 probe, qmeta, qbits, codes, words, q8, tw=tw, tag_level=level), level)}
    out = {}
    for kern, (fn, lvl) in calls.items():
        by = _device_ms_by_kernel(fn)
        out[kern] = {"ms": _median_ms(fn), "device_ms": sum(by.values()), "by_kernel": by,
                     **_proj_bound(probe, nlist, pad, p, lvl, tw)}
    if plain:
        out["proj_blocks"]["plain_ms"] = _median_ms(
            lambda: proj_blocks_reference(probe, codes, q8))
        out["proj_gated_blocks"]["plain_ms"] = _median_ms(
            lambda: proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8,
                                                tw=tw, tag_level=level))
    return out


def _time_line(name, b, n_probe, level, t) -> str:
    parts = []
    for kern, r in t.items():
        lv = f" (level {level})" if kern == "proj_gated_blocks" else ""
        pl = f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""
        by = ", ".join(f"{k} {v:.4f}" for k, v in r["by_kernel"].items())
        parts.append(f"{kern}{lv} {r['ms']:.4f} ms{pl}, bound {r['bound_ms']:.4f} ms by "
                     f"{r['bound_by']} (share {r['bound_ms'] / r['ms']:.3f}; device "
                     f"{r['device_ms']:.4f} ms per call: {by}; share "
                     f"{r['bound_ms'] / r['device_ms']:.3f})")
    return (f"phase 2: proj {name} B={b} P={n_probe} ({t['proj_blocks']['distinct']} distinct "
            f"clusters; event times median of 20): " + "; ".join(parts))


# (name, B, P, nlist, pad, p, tw, probes): held bitwise, not timed. Ragged
# pads, p=32/36/37/192/256, one cluster for every probe, duplicates inside
# one query's list, clusters nobody probes, B=1, and B=33 (the reserved
# slabs' group spans several member tiles).
PROJ_CHECKS = [
    ("p=192", 8, 10, 40, 512, 192, 8, "random"), ("p=36", 4, 6, 9, 300, 36, 8, "random"),
    ("p=37", 3, 5, 7, 100, 37, 8, "random"), ("p=32", 6, 5, 10, 256, 32, 8, "random"),
    ("pad=520", 5, 7, 11, 520, 64, 8, "random"),
    ("one cluster for all", 8, 4, 6, 300, 64, 8, "one"),
    ("duplicates in a list", 5, 8, 3, 260, 128, 8, "random"),
    ("unprobed clusters", 4, 5, 50, 256, 64, 8, "low"),
    ("B=1", 1, 7, 20, 384, 192, 4, "random"),
    ("B=33", 33, 6, 12, 256, 256, 8, "engine"),
    # k-sliced items (p over 256 bytes; 768 was past the one-stage layout's
    # shared memory for the gated scan) and the grouping's counters in
    # scratch (nlist over the 19,349 it counts in shared memory)
    ("p=1536", 4, 3, 5, 64, 1536, 8, "random"), ("p=768", 4, 3, 5, 256, 768, 8, "random"),
    ("nlist=20000", 8, 6, 20_000, 32, 64, 8, "random"),
]


def phase2_proj_kernels() -> dict:
    """The two proj-scan kernels against their plain versions, bitwise, on
    every case; timed with bounds at the real tables' shapes under
    engine-like probes (64 distinct base cells + the 2 reserved slabs per
    query), at B=32 and B=1: main_1M (nlist 1,000 + 2, pad 2,048, p=256,
    tw 8; the gated kernel at tag level 2) and main_10M (nlist 4,096 + 2,
    pad 5,120, p=192, tw 4; level 1, the level a payer filter with j-tags
    reads). The random-with-duplicates probes of the 1M shape and the
    nlist=200 stand-in of the 10M shape are kept as continuity timings."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for name, b, n_probe, nlist, pad, p, tw, kind in PROJ_CHECKS:
        codes, words = _gate_tables(g, nlist, pad, p, tw)
        qmeta, qbits, q8 = _gate_queries(g, b, p, tw)
        probe = _probes(g, kind, b, n_probe, nlist)
        err, live = _check_proj(name, probe, qmeta, qbits, codes, words, q8, tw)
        worst = max(worst, err)
        log(f"phase 2: proj {name} B={b} P={n_probe} nlist={nlist} pad={pad} p={p}: raw "
            f"dots bitwise; gated scores and row ids bitwise at tag levels 0/1/2 (live "
            f"share {live})")

    timing = {}
    # (shape, nlist, pad, p, tw, level, meta_ids, probe kinds)
    shapes = [("1M", 1002, 2048, 256, 8, 2, 4), ("10M", 4098, 5120, 192, 4, 1, 3),
              ("10M stand-in", 200, 5120, 192, 4, 1, 3)]
    for shape, nlist, pad, p, tw, level, meta_ids in shapes:
        t0 = time.perf_counter()
        codes, words = _gate_tables(g, nlist, pad, p, tw, meta_ids)
        torch.cuda.synchronize()
        log(f"phase 2: proj tables {shape}: nlist {nlist}, pad {pad}, p {p}, tw {tw}: codes "
            f"{codes.numel() / 1e9:.2f} GB, words {words.numel() * 4 / 1e9:.2f} GB, made in "
            f"{time.perf_counter() - t0:.1f} s")
        runs = [("random_1M", BATCH, "random", True)] if shape == "1M" else []
        if shape == "10M stand-in":
            runs = [("stand-in_10M", BATCH, "random", False)]
        else:
            runs += [(f"main_{shape}", BATCH, "engine", True), (f"main_{shape} B=1", 1,
                                                                 "engine", False)]
        for name, b, kind, plain in runs:
            qmeta, qbits, q8 = _gate_queries(g, b, p, tw, meta_ids)
            probe = _probes(g, kind, b, 66, nlist)
            err, live = _check_proj(name, probe, qmeta, qbits, codes, words, q8, tw)
            worst = max(worst, err)
            t = _time_proj(probe, qmeta, qbits, codes, words, q8, tw, level, plain)
            timing[name] = t
            log(f"phase 2: proj {name} nlist={nlist} pad={pad} p={p} tw={tw}: bitwise at "
                f"tag levels 0/1/2 (live share {live})")
            log(_time_line(name, b, 66, level, t))
        del codes, words
        torch.cuda.empty_cache()

    from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks

    codes = torch.full((12, 32, 128), 127, dtype=torch.int8, device="cuda")
    q8 = torch.full((4, 128), -127, dtype=torch.int8, device="cuda")
    probe = _ri(g, 0, 12, (4, 5))
    raw = proj_blocks(probe, codes, q8)
    if not bool((raw == float(128 * 127 * -127)).all()):
        raise AssertionError("proj_blocks is not exact at the +-127 extremes")
    log("phase 2: proj_blocks exact at the +-127 extremes (p=128)")
    return {"max_abs_err": worst, "timing": timing}


def build_bench_store(cfg):
    """bench.py's corpus (bench.py:59-97), same seed and draw order, in the
    port's ChunkStore on the card. Returns (store, lexicon, vectors, rng,
    payers)."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
    from mobius_rag_tpu_torch.testing import sample_lexicon

    rng = np.random.default_rng(7)
    lexicon = sample_lexicon()
    vectors = rng.standard_normal((N_CHUNKS, cfg.embed_dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    payers = ["sunshine_health", "aetna", "molina", ""]
    recs = []
    for i in range(N_CHUNKS):
        r = ChunkRecord(
            chunk_id=f"c{i}", doc_id=f"doc{i % 7000}", source_id=f"s{i}",
            text=f"policy paragraph {i} covering claims filing and authorization "
                 f"requirements for plan {i % 97}.",
            embedding=vectors[i],
            payer=payers[i % len(payers)], state="FL",
            authority_level=int(rng.integers(0, 5)),
            filename=f"doc{i % 7000}.pdf",
        )
        r.lexical_weights = {}
        r.d_tags = [int(rng.integers(0, 12))]
        recs.append(r)
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    store = ChunkStore(cfg, capacity=N_CHUNKS, device="cuda")
    lex_sample = np.zeros((64, cfg.lexical_buckets), np.float32)
    for i, r in enumerate(recs[:64]):
        for b, w in r.lexical_weights.items():
            lex_sample[i, b % cfg.lexical_buckets] += w
    store.bulk_load(recs, vectors=vectors, lexical=lex_sample)
    torch.cuda.synchronize()
    return store, lexicon, vectors, rng, payers


def phase3_slice(smi: str, vector_dtype: str = "float32") -> dict:
    """The exact backend on bench.py's corpus: float32 rows (phase 3), or
    the same corpus stored as int8 rows on the card (phase 3b), which
    runs the masked top-k kernel's int8-row form."""
    import dataclasses

    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.ops.topk import masked_topk, masked_topk_reference
    from mobius_rag_tpu_torch.query.engine import (
        QueryRequest, SearchEngine, arm_candidates, filter_masks, gate_penalty)

    cfg = get_config()
    if (cfg.embed_dim, cfg.lexical_buckets, cfg.vector_backend, cfg.lexical_format,
            cfg.vector_dtype) != (1536, 16384, "exact", "dense", "float32"):
        raise RuntimeError(f"not the reference configuration: {cfg} "
                           "(unset the MRAG_* variables)")
    cfg = dataclasses.replace(cfg, vector_dtype=vector_dtype)
    name = "phase 3" if vector_dtype == "float32" else "phase 3b"
    t0 = time.perf_counter()
    store, lexicon, vectors, rng, payers = build_bench_store(cfg)
    log(f"{name}: {vector_dtype} store of {store.size} rows, capacity {store.capacity}, "
        f"D={cfg.embed_dim}, H={cfg.lexical_buckets} built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = SearchEngine(store, lexicon, cfg=cfg, device="cuda")

    nq = 64
    q_rows = rng.choice(N_CHUNKS, nq, replace=False)
    q_vecs = vectors[q_rows] + 0.15 * rng.standard_normal(
        (nq, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)
    oracle = torch.from_numpy(q_vecs).cuda().double() @ \
        torch.from_numpy(vectors).cuda().double().T
    exact = torch.argsort(-oracle, dim=1)[:, :K].cpu().numpy()
    del oracle
    recall_reqs = [QueryRequest(query="claims filing authorization requirements",
                                embedding=q_vecs[i], tag_mode="none", mode="recall")
                   for i in range(nq)]
    bench_reqs = [QueryRequest(query=f"timely filing deadline for {payers[i % 3]} claims",
                               embedding=q_vecs[i % nq]) for i in range(BATCH)]

    # ---- the main path, counted ------------------------------------------
    masked_topk.launches = 0
    batches = 0
    recalls = []
    for off in range(0, nq, BATCH):
        results = engine.search(recall_reqs[off:off + BATCH], k=K)
        batches += 1
        for bi, res in enumerate(results):
            got = {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
            recalls.append(len(got & set(map(int, exact[off + bi]))) / K)
    recall = float(np.mean(recalls))
    hybrid = engine.search(bench_reqs, k=K)
    batches += 1
    for res in hybrid:
        if not res.hits:
            raise AssertionError(f"no hits for {res.query!r}")
        for h in res.hits:
            if not (np.isfinite(h.score) and 0.0 <= h.score <= 1.0):
                raise AssertionError(f"bad rerank score {h.score}")
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    singles = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search(one, k=K)
        singles.append((time.perf_counter() - t0) * 1e3)
    batches += 11
    piped = engine.search_pipelined([bench_reqs, bench_reqs], k=K)
    batches += 2
    launches = masked_topk.launches
    # ---- end of the counted run ------------------------------------------

    if launches != batches:
        raise AssertionError(f"kernel launched {launches} times for {batches} batches")
    if [[h.chunk_id for h in r.hits] for r in piped[0]] != \
            [[h.chunk_id for h in r.hits] for r in hybrid]:
        raise AssertionError("search_pipelined disagrees with search")
    if vector_dtype == "float32" and recall < 0.99:
        raise AssertionError(f"vector-arm recall@{K} {recall} < 0.99")

    # the vector arm's m candidates against the plain version on one batch
    q, _ = engine.prepare_batch(bench_reqs)
    m = min(K * cfg.over_fetch, store.capacity)
    with torch.inference_mode():
        q = dict(q, vec=q["vec"].float())
        vals, gidx, _, _ = arm_candidates(store.index, q, K, m)
        strict, relaxed, open_mask, _ = filter_masks(store.index, q)
        penalty = gate_penalty(strict, relaxed, open_mask, q, K)
        scales = store.index.vec_scales if vector_dtype == "int8" else None
        rv, ri = masked_topk_reference(q["vec"], store.index.vectors, penalty,
                                       q["min_sim"], m, row_scales=scales)
    _compare(vals[0], gidx[0], rv, ri)

    qps = float(np.median(rounds))
    single_ms = float(np.median(singles))
    log(f"{name}: vector-arm recall@{K} vs exact fp64 oracle {recall:.4f} ({nq} queries)")
    log(f"{name}: {len(hybrid)} hybrid requests, every one with hits; kernel "
        f"launches {launches} == search batches {batches}; vector-arm "
        f"candidates equal the plain version on one batch")
    log(f"{name}: {qps:.1f} queries/s at batch {BATCH} (sync, median of "
        f"{[round(x, 1) for x in rounds]}), single query {single_ms:.3f} ms "
        f"(median of 10) on {smi}")
    return {"launches": launches, "recall": recall, "qps": qps, "single_ms": single_ms}

# ---------------------------------------------------------------------------
# phase 4: the proj backend at 1M rows, dense and candidate-local gating
# ---------------------------------------------------------------------------

_TEXT_1M = "policy paragraph on claims filing and authorization requirements."
# (query, payer): payer filters with strict gating; the corpus has no
# j-tags, so every one auto-relaxes to its d-tag. A row of payer p carries
# d-tag i % 12 with i % 4 == p, so the last request's filter admits no row.
_HYBRID_1M = [("timely filing deadline for sunshine_health claims", "sunshine_health"),
              ("claim appeals deadline for aetna", "aetna"),
              ("prior authorization requirements for molina claims", "molina"),
              ("behavioral health outpatient therapy for aetna", "aetna"),
              ("timely filing deadline for molina claims", "molina")]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class _Spans:
    """Records (start, end) host times, synchronised, of the calls to the
    wrapped functions and classmethods (restored on exit)."""

    def __init__(self, targets, dev: str):
        self.targets, self.dev = targets, dev
        self.spans: dict = {}
        self.saved = []

    def _wrap(self, key, fn):
        def wrapped(*a, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(self.dev)
            self.spans.setdefault(key, []).append((t0, time.perf_counter()))
            return out
        return wrapped

    def __enter__(self):
        for owner, name, key in self.targets:
            orig = owner.__dict__[name]
            self.saved.append((owner, name, orig))
            if isinstance(orig, classmethod):
                setattr(owner, name, classmethod(self._wrap(key, orig.__func__)))
            else:
                setattr(owner, name, self._wrap(key, orig))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)

    def total(self, key) -> float:
        return sum(t1 - t0 for t0, t1 in self.spans.get(key, []))


def build_1m_store(cfg, stages: dict, dev: str, n_rows: int):
    """bench_1m_e2e.py's corpus (bench_1m_e2e.py:64-108), made on the card
    from a seeded torch.Generator: 4,096 unit centers plus 0.05 N(0, 1)
    noise per dimension, normalized, bf16; payers cycling, state FL,
    authority i % 5, d-tags [i % 12], doc i % 70,000; every 50th record
    featurized with the sample lexicon (sparse postings)."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
    from mobius_rag_tpu_torch.testing import sample_lexicon

    d = cfg.embed_dim
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(11)
    centers = torch.randn((N_CENTERS, d), device=dev, generator=g)
    centers /= centers.norm(dim=1, keepdim=True)
    vectors = torch.empty((n_rows, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_rows, 125_000):
        n = min(125_000, n_rows - lo)
        rows = torch.randint(0, N_CENTERS, (n,), device=dev, generator=g)
        v = centers[rows] + 0.05 * torch.randn((n, d), device=dev, generator=g)
        vectors[lo:lo + n] = (v / v.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    del centers, rows, v
    _sync(dev)
    stages["corpus on the card"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lexicon = sample_lexicon()
    payers = ["sunshine_health", "aetna", "molina", ""]
    empty = np.zeros(0, np.float32)  # the rows come as one device tensor
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 70_000}", source_id=f"s{i}",
                        text=_TEXT_1M, embedding=empty, payer=payers[i & 3], state="FL",
                        authority_level=i % 5, d_tags=[i % 12])
            for i in range(n_rows)]
    for r in recs[::FEATURIZE_EVERY]:
        featurize_chunk(r, lexicon, cfg)
    stages["records"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = ChunkStore(cfg, capacity=n_rows, device=dev)
    store.bulk_load(recs, vectors=vectors)
    _sync(dev)
    stages["bulk_load"] = time.perf_counter() - t0
    return store, lexicon, vectors


def _exact_top(vectors: torch.Tensor, q: torch.Tensor, k: int) -> np.ndarray:
    """Exact fp64 cosine top-k of q [n, D] over the bf16 rows, blockwise."""
    qd = q.double()
    best_v, best_i = None, None
    for lo in range(0, vectors.shape[0], 125_000):
        s = qd @ vectors[lo:lo + 125_000].double().T
        v, i = torch.topk(s, k, dim=1)
        i = i + lo
        if best_v is not None:
            v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy()


def _device_busy_share(engine, reqs, dev, n: int = 4) -> tuple[float, float, dict]:
    """torch.profiler over n searches: (device kernel ms per search, wall
    ms per search, kernel ms per search by name for the top entries).
    Sums the device-side events only (the CPU-side operator events carry
    their kernels' time too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(dev).type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.search(reqs, k=K)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0] or ev.name[:40]
            by_name[name] = by_name.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    proj_ms = sum(v for key, v in by_name.items() if key.startswith("proj_"))
    return sum(by_name.values()), wall, top, proj_ms


def _probed(engine, reqs) -> torch.Tensor:
    """The probe array [B, P] the proj scan of one search of `reqs` takes
    (its distinct clusters are what the scan must read, once each)."""
    from mobius_rag_tpu_torch.ops import proj as proj_mod

    probes = []
    saved = (proj_mod.proj_blocks, proj_mod.proj_gated_blocks)

    def recorded(fn):
        def wrapped(probe, *a, **kw):
            probes.append(probe.clone())
            return fn(probe, *a, **kw)
        return wrapped

    proj_mod.proj_blocks, proj_mod.proj_gated_blocks = (recorded(f) for f in saved)
    try:
        engine.search(reqs, k=K)
    finally:
        proj_mod.proj_blocks, proj_mod.proj_gated_blocks = saved
    return probes[0]


def _path_bound(engine, reqs, level) -> str:
    """The proj scan's bound on one search of `reqs` at the tables' shapes
    (level None: proj_blocks), as phase 2 counts it."""
    probe = _probed(engine, reqs)
    ann = engine._ann
    r = _proj_bound(probe, ann.nlist, ann.pad, ann.bytes_per_row, level, engine.cfg.tag_words)
    lv = "proj_blocks" if level is None else f"proj_gated_blocks at tag level {level}"
    return (f"the hybrid batch probes {r['distinct']} distinct clusters; {lv} bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")


def _drive_path(engine, recall_reqs, exact, self_reqs, self_rows, bench_reqs) -> dict:
    """The counted run of one path: recall, self-hit, hybrid, qps rounds,
    single queries and one search_pipelined. Returns its numbers, its
    results and the launch counts."""
    from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks, proj_gated_blocks
    from mobius_rag_tpu_torch.ops.topk import masked_topk

    proj_blocks.launches = proj_gated_blocks.launches = masked_topk.launches = 0
    batches = 0
    recalls = []
    for off in range(0, len(recall_reqs), BATCH):
        results = engine.search(recall_reqs[off:off + BATCH], k=K)
        batches += 1
        for bi, res in enumerate(results):
            got = {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
            recalls.append(len(got & set(map(int, exact[off + bi]))) / K)
    self_res = engine.search(self_reqs, k=K)
    batches += 1
    self_hit = float(np.mean([int(row) in {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
                              for row, res in zip(self_rows, self_res)]))
    hybrid = engine.search(bench_reqs, k=K)
    batches += 1
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    singles = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search(one, k=K)
        singles.append((time.perf_counter() - t0) * 1e3)
    batches += 11
    piped = engine.search_pipelined([bench_reqs, bench_reqs], k=K)
    batches += 2
    return {"batches": batches, "recall": float(np.mean(recalls)), "self_hit": self_hit,
            "hybrid": hybrid, "piped": piped, "qps": float(np.median(rounds)),
            "rounds": rounds, "single_ms": float(np.median(singles)),
            "launches": {"proj_blocks": proj_blocks.launches,
                         "proj_gated_blocks": proj_gated_blocks.launches,
                         "masked_topk": masked_topk.launches}}


def _hits(res):
    return [(h.chunk_id, h.score) for h in res.hits]


def phase4_proj(smi: str, dev: str = "cuda", n_rows: int = N_1M) -> dict:
    import dataclasses
    import tempfile

    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.index import ivf as ivf_mod
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.ops import proj as proj_mod
    from mobius_rag_tpu_torch.ops.proj import ProjGate
    from mobius_rag_tpu_torch.ops.proj_scan import (proj_blocks_reference,
                                                      proj_gated_blocks_reference)
    from mobius_rag_tpu_torch.ops.topk import NEG_INF
    from mobius_rag_tpu_torch.query.engine import (
        QueryRequest, SearchEngine, arm_candidates, filter_masks, gate_penalty,
        lexical_raw)
    from mobius_rag_tpu_torch.query.gating import DTagPostings

    base = dataclasses.replace(
        get_config(), embed_dim=1536, vector_dtype="bfloat16", lexical_format="sparse",
        lexical_buckets=16384, tag_words=8, phrase_words=64, vector_backend="proj",
        proj_p=256, ivf_nlist=0, ivf_nprobe=64, ann_reserve_slabs=2, over_fetch=4)
    cfg_a = dataclasses.replace(base, gating="dense")
    cfg_b = dataclasses.replace(base, gating="local")
    stages: dict = {}
    t_all = time.perf_counter()
    store, lexicon, vectors = build_1m_store(cfg_a, stages, dev, n_rows)
    fill = store._lex_fill
    log(f"phase 4: store of {store.size} rows, capacity {store.capacity}; sparse postings "
        f"P={store._lex_cols_np.shape[1]}, {int((fill > 0).sum())} buckets in use, "
        f"{int((fill > cfg_a.lexical_postings_init).sum())} grown past "
        f"{cfg_a.lexical_postings_init}")
    engine_a = SearchEngine(store, lexicon, cfg=cfg_a, device=dev)
    engine_b = SearchEngine(store, lexicon, cfg=cfg_b, device=dev)
    targets = [(ivf_mod, "_kmeans", "k-means"), (ivf_mod, "_topj_block", "capacity assign"),
               (ivf_mod, "_capacity_assign", "capacity assign"),
               (ivf_mod, "_fill_members", "capacity assign"), (ProjGate, "build", "gate pack"),
               (DTagPostings, "build", "d-tag postings")]
    with _Spans(targets, dev) as sp:
        t0 = time.perf_counter()
        ann = engine_a.ensure_ann()
        _sync(dev)
        t_ann = time.perf_counter() - t0
        # path B serves the same tables, carried over through the ann file
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            engine_a.save_ann(f"{tmp}/ann.npz")
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine_b.load_ann(f"{tmp}/ann.npz")
            _sync(dev)
            t_load = time.perf_counter() - t0
        engine_b._ensure_local_structs(engine_b.ensure_ann())
    for key in ("k-means", "capacity assign", "gate pack", "d-tag postings"):
        stages[key] = sp.total(key)
    stages["PCA + encode"] = t_ann - stages["k-means"] - stages["capacity assign"]
    log(f"phase 4: tables nlist={ann.nlist} (base {ann.base_nlist}, spill slabs "
        f"{ann.reserve_start - ann.base_nlist}, reserved {ann.nlist - ann.reserve_start}), "
        f"pad={ann.pad}, p={ann.bytes_per_row}; ann file save {t_save:.2f} s, "
        f"load {t_load:.2f} s")
    log("phase 4: build stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # requests: recall (corpus rows + 0.15 noise, as phase 3), self-hit
    # (exact corpus rows), hybrid (payer filters, strict with auto-relax)
    g = torch.Generator(device=dev).manual_seed(3)
    nq = 64
    q_rows = torch.randperm(n_rows, device=dev, generator=g)[:nq]
    qv = vectors[q_rows].float() + 0.15 * torch.randn((nq, cfg_a.embed_dim), device=dev,
                                                      generator=g)
    qv /= qv.norm(dim=1, keepdim=True)
    exact = _exact_top(vectors, qv, K)
    q_np = qv.cpu().numpy()
    recall_reqs = [QueryRequest(query="claims filing authorization requirements",
                                embedding=q_np[i], tag_mode="none", mode="recall")
                   for i in range(nq)]
    self_rows = np.arange(0, n_rows, n_rows // BATCH)[:BATCH]
    self_np = vectors[torch.from_numpy(self_rows).to(dev)].float().cpu().numpy()
    self_reqs = [QueryRequest(query="claims filing authorization", embedding=self_np[i],
                              tag_mode="none", mode="recall") for i in range(BATCH)]
    bench_reqs = [QueryRequest(query=_HYBRID_1M[i % len(_HYBRID_1M)][0],
                               payer=_HYBRID_1M[i % len(_HYBRID_1M)][1],
                               embedding=q_np[i % nq]) for i in range(BATCH)]

    # ---- the main path, counted, once per gating --------------------------
    runs = {}
    for path, engine, kernel in (("A", engine_a, "proj_blocks"),
                                 ("B", engine_b, "proj_gated_blocks")):
        r = _drive_path(engine, recall_reqs, exact, self_reqs, self_rows, bench_reqs)
        other = "proj_gated_blocks" if kernel == "proj_blocks" else "proj_blocks"
        on_card = torch.device(dev).type == "cuda"  # the CPU runs the plain versions
        if on_card and (r["launches"][kernel] != r["batches"] or r["launches"][other]
                        or r["launches"]["masked_topk"]):
            raise AssertionError(f"path {path}: launches {r['launches']} for "
                                 f"{r['batches']} search batches")
        runs[path] = r
    # ---- end of the counted runs -------------------------------------------

    ra, rb = runs["A"], runs["B"]
    for path, r in runs.items():
        if [_hits(x) for x in r["piped"][0]] != [_hits(x) for x in r["hybrid"]]:
            raise AssertionError(f"path {path}: search_pipelined disagrees with search")
        for res in r["hybrid"]:
            for h in res.hits:
                if not (np.isfinite(h.score) and 0.0 <= h.score <= 1.0):
                    raise AssertionError(f"path {path}: bad rerank score {h.score}")

    # one batch: the arms under both gatings, and the gate's admissions
    m = min(K * cfg_a.over_fetch, store.capacity)
    qa, exps = engine_a.prepare_batch(bench_reqs)
    qb, _ = engine_b.prepare_batch(bench_reqs)
    local = engine_b._ensure_local_structs(engine_b._ann)
    with torch.inference_mode():
        qa = dict(qa, vec=qa["vec"].float())
        qb = dict(qb, vec=qb["vec"].float())
        va, ia, _, sa = arm_candidates(store.index, qa, K, m, ann=engine_a._ann,
                                       nprobe=engine_a.effective_nprobe)
        vb, ib, _, sb = arm_candidates(store.index, qb, K, m, ann=engine_b._ann,
                                       nprobe=engine_b.effective_nprobe, local=local,
                                       tag_level=engine_b._batch_tag_level(exps))
        strict, relaxed, open_mask, _ = filter_masks(store.index, qa)
        penalty = gate_penalty(strict, relaxed, open_mask, qa, K)
        admitted = (penalty > NEG_INF / 2).sum(dim=1).cpu().numpy()
        lex_admitted = ((lexical_raw(store.index, qa) > 0)
                        & (penalty > NEG_INF / 2)).sum(dim=1).cpu().numpy()
        # the plain version of each path's vector-arm function, same inputs
        plain = {}
        saved = (proj_mod.proj_blocks, proj_mod.proj_gated_blocks)
        proj_mod.proj_blocks = proj_blocks_reference
        proj_mod.proj_gated_blocks = proj_gated_blocks_reference
        try:
            plain["A"] = arm_candidates(store.index, qa, K, m, ann=engine_a._ann,
                                        nprobe=engine_a.effective_nprobe)
            plain["B"] = arm_candidates(store.index, qb, K, m, ann=engine_b._ann,
                                        nprobe=engine_b.effective_nprobe, local=local,
                                        tag_level=engine_b._batch_tag_level(exps))
        finally:
            proj_mod.proj_blocks, proj_mod.proj_gated_blocks = saved
    for path, (v, i) in (("A", (va, ia)), ("B", (vb, ib))):
        pv, pi = plain[path][0], plain[path][1]
        live = pv[0] > NEG_INF / 2
        if not (torch.equal(live, v[0] > NEG_INF / 2) and torch.equal(v[0][live], pv[0][live])
                and torch.equal(i[0][live], pi[0][live])):
            raise AssertionError(f"path {path}: vector-arm candidates differ from the "
                                 "plain version's")
    # dense vs local: every arm's live candidates, the strict counts
    for arm, name in enumerate(("vector", "lexical", "d-tag")):
        live = va[arm] > NEG_INF / 2
        if not (torch.equal(live, vb[arm] > NEG_INF / 2)
                and torch.equal(va[arm][live], vb[arm][live])
                and torch.equal(ia[arm][live], ib[arm][live])):
            raise AssertionError(f"dense and local gating disagree on the {name} arm")
    if not torch.equal(sa[:, 0], sb[:, 0]):
        raise AssertionError("dense and local strict counts differ")
    # dense vs local: the hits. Local gating gives the other arms'
    # candidates a lexical signal only from the lexical arm's top m
    # (gating.lex_signal_join, the JAX package's contract), so hits must
    # match wherever the gate admits at most m lexical matches.
    under = [b for b in range(BATCH) if lex_admitted[b] <= m]
    for b in range(BATCH):
        a_res, b_res = ra["hybrid"][b], rb["hybrid"][b]
        if a_res.telemetry["strict_count"] != b_res.telemetry["strict_count"]:
            raise AssertionError(f"request {b}: strict counts differ")
        if admitted[b] > 0 and not a_res.hits:
            raise AssertionError(f"request {b}: the gate admits {admitted[b]} rows "
                                 "but there are no hits")
        if b in under:
            ha, hb = _hits(a_res), _hits(b_res)
            if {c for c, _ in ha} != {c for c, _ in hb} or any(
                    abs(x[1] - y[1]) > HIT_TOL for x, y in zip(ha, hb)):
                raise AssertionError(f"request {b}: dense and local hits differ: {ha} {hb}")
    log(f"phase 4: dense and local gating agree on all three arms' live candidates "
        f"(vector arm bitwise) and on the strict counts of {BATCH} hybrid requests; "
        f"hits equal (scores within {HIT_TOL}) on the {len(under)} requests whose "
        f"gate admits <= m={m} lexical matches (the other {BATCH - len(under)} admit "
        f"{sorted(set(int(x) for x in lex_admitted if x > m))}); gate admits "
        f"{sorted(set(int(x) for x in admitted))} rows")
    log("phase 4: each path's vector-arm candidates with the kernel equal the plain "
        "version's on one batch (ids identical, values bitwise on live entries)")

    for path, engine in (("A", engine_a), ("B", engine_b)):
        r = runs[path]
        busy, wall, top, proj_ms = _device_busy_share(engine, bench_reqs, dev)
        level = None if path == "A" else engine_b._batch_tag_level(exps)
        log(f"phase 4: path {path}: {_path_bound(engine, bench_reqs, level)}; proj kernels' "
            f"device time {proj_ms:.4f} ms per batch")
        log(f"phase 4: path {path} ({engine.cfg.gating} gating): launches {r['launches']} "
            f"for {r['batches']} batches; vector-arm recall@{K} vs exact fp64 oracle "
            f"{r['recall']:.4f} ({nq} queries); self-hit@{K} {r['self_hit']:.4f} "
            f"({BATCH} corpus rows); {r['qps']:.1f} queries/s at batch {BATCH} (rounds "
            f"{[round(x, 1) for x in r['rounds']]}); single query {r['single_ms']:.3f} ms "
            f"(median of 10); device busy {busy:.3f} of {wall:.3f} ms per batch "
            f"({100 * busy / wall:.1f}%), by kernel (ms/batch) "
            + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + f" on {smi}")

    # publish + delete through the incremental reserved-slab path
    rng = np.random.default_rng(5)
    emb = rng.standard_normal(cfg_a.embed_dim).astype(np.float32)
    emb /= np.linalg.norm(emb)
    text = "Xylophone rider reimburses tuning forks within 45 days."
    tables = (id(engine_a._ann), id(engine_b._ann))
    store.publish_document("fresh-doc", [ChunkRecord(
        chunk_id="fresh-1", doc_id="fresh-doc", source_id="fresh-s1", text=text,
        embedding=emb, payer="sunshine_health", state="FL")])

    def served(engine, payer, tag_mode):
        res = engine.search(QueryRequest(query=text, embedding=emb, payer=payer,
                                         tag_mode=tag_mode), k=K)[0]
        return any(h.chunk_id == "fresh-1" for h in res.hits)

    for engine in (engine_a, engine_b):
        if not served(engine, "sunshine_health", "none"):
            raise AssertionError(f"{engine.cfg.gating}: a published row is not served")
        if served(engine, "molina", "strict"):
            raise AssertionError(f"{engine.cfg.gating}: the payer filter admits a "
                                 "published row of another payer")
    store.delete_by_document("fresh-doc")
    for engine in (engine_a, engine_b):
        if served(engine, "sunshine_health", "none"):
            raise AssertionError(f"{engine.cfg.gating}: a deleted row is still served")
    if (id(engine_a._ann), id(engine_b._ann)) != tables or \
            engine_a._ann_cursor != 1 or engine_b._ann_cursor != 1:
        raise AssertionError("the publish and delete did not go through the "
                             "incremental reserved-slab path")
    log("phase 4: a published document is served under its payer filter and not "
        "under another payer's, and gone after its delete, on both paths, through "
        "the reserved slabs (no rebuild)")
    log(f"phase 4: {time.perf_counter() - t_all:.1f} s")
    return {"launches": {"proj_blocks": ra["launches"]["proj_blocks"],
                         "proj_gated_blocks": rb["launches"]["proj_gated_blocks"]},
            "build_s_per_m": (stages["records"] + stages["bulk_load"]) / (n_rows / 1e6)}


# ---------------------------------------------------------------------------
# phase 5: the 10M two-stage path (host residency: proj codes on the card,
# int8 rows in host RAM, funnel + exact host re-rank)
# ---------------------------------------------------------------------------

N_CUTS = (10_000_000, 5_000_000, 2_000_000)  # config 5, then the allowed cuts
AMPS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12)  # bench_10m.py:173, one per graded copy
PAYERS_10M = ["sunshine_health", "aetna", "molina"]
INGEST_DOCS, INGEST_CHUNKS = 20, 50
GEN_BLOCK = 250_000  # corpus rows made on the card per step
ORACLE_BLOCK = 250_000  # rows per block of the exact oracle scan
COS_TOL = 1e-6  # native re-rank cosines vs a numpy recompute
_TEXT_10M = "policy paragraph on claims and authorization."


def _mem_gib() -> tuple[float, float]:
    """(MemTotal, MemAvailable) of the host in GiB."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            info[key] = int(val.split()[0]) / 2**20
    return info["MemTotal"], info["MemAvailable"]


def _choose_n(build_s_per_m: float, elapsed: float) -> tuple[int, str]:
    """The largest of N_CUTS whose build fits the script's time and the
    host's RAM: records + bulk_load at phase 4's measured rate plus ~6 s
    per 1M rows for corpus, oracle and the ANN build, and ~1.2 KB of
    host RAM per record beside the int8 matrix (pinned, rounded up to a
    power of two by the allocator)."""
    total, avail = _mem_gib()
    budget = 0.75 * SCRIPT_LIMIT_S - elapsed - 60.0
    why = []
    for n in N_CUTS:
        t_need = n / 1e6 * (build_s_per_m + 6.0)
        ram_need = (2 ** np.ceil(np.log2(n * 1536)) + n * (1200 + 130)) / 2**30 + 4.0
        if t_need <= budget and ram_need <= 0.9 * avail:
            reason = "" if n == N_CUTS[0] else "; ".join(why)
            return n, reason
        why.append(f"N={n:,} needs ~{t_need:.0f} s of build (records + bulk_load at "
                   f"{build_s_per_m:.1f} s per 1M rows, measured in phase 4) against "
                   f"{budget:.0f} s left, and ~{ram_need:.0f} GiB of host RAM against "
                   f"{avail:.0f} GiB available of {total:.0f}")
    return N_CUTS[-1], "; ".join(why) + " (2M is the floor)"


def _make_corpus(hv: np.ndarray, sca: np.ndarray, nb: int, dev: str) -> None:
    """bench_10m.py:166-191's graded near-duplicate tiling, made on the card:
    nb seeded random base rows quantized to int8 with |v| <= 115, then ten
    copies, copy t of base b at row t·nb + b with uniform integer noise in
    [-AMPS[t], AMPS[t]] per element; each row's scale is 1/‖row‖. Written
    block by block into the host matrix `hv` and the scales `sca`."""
    d = hv.shape[1]
    g = torch.Generator(device=dev).manual_seed(17)
    base = torch.empty((nb, d), dtype=torch.int8, device=dev)
    for lo in range(0, nb, GEN_BLOCK):
        hi = min(lo + GEN_BLOCK, nb)
        f = torch.randn((hi - lo, d), device=dev, generator=g)
        f = f / torch.clamp(f.abs().amax(dim=1, keepdim=True), min=1e-9)
        base[lo:hi] = torch.round(f * 115.0).to(torch.int8)
    for t, amp in enumerate(AMPS):
        for lo in range(0, nb, GEN_BLOCK):
            hi = min(lo + GEN_BLOCK, nb)
            x = base[lo:hi].to(torch.int16)
            if amp:
                x = x + torch.randint(-amp, amp + 1, x.shape, device=dev, generator=g,
                                      dtype=torch.int16)
            norms = torch.sqrt((x.float() ** 2).sum(dim=1))
            torch.from_numpy(hv[t * nb + lo:t * nb + hi]).copy_(x.to(torch.int8))
            torch.from_numpy(sca[t * nb + lo:t * nb + hi]).copy_(1.0 / torch.clamp(norms,
                                                                                   min=1.0))


def _oracle(hv, sca, qv, q_tgt, n: int, nb: int, dev: str):
    """bench_10m.py:227-271: the exact top-K of each query under its
    family-payer filter, scanning the int8 matrix streamed up block by
    block (float32 dot, then the row's scale), merged on the host."""
    best_v = np.full((len(qv), K), -1e30, np.float32)
    best_i = np.zeros((len(qv), K), np.int64)
    qd = torch.from_numpy(qv).to(dev)
    tgt = torch.from_numpy(q_tgt).to(dev)
    for off in range(0, n, ORACLE_BLOCK):
        hi = min(off + ORACLE_BLOCK, n)
        blk = torch.from_numpy(hv[off:hi]).to(dev, non_blocking=True).float()
        s = (qd @ blk.T) * torch.from_numpy(sca[off:hi]).to(dev)[None, :]
        fam_payer = (torch.arange(off, hi, device=dev) % nb) % 3
        s = torch.where(fam_payer[None, :] == tgt[:, None], s, -1e30)
        v, i = torch.topk(s, K, dim=1)
        allv = np.concatenate([best_v, v.cpu().numpy()], axis=1)
        alli = np.concatenate([best_i, i.cpu().numpy() + off], axis=1)
        top = np.argsort(-allv, axis=1, kind="stable")[:, :K]
        best_v = np.take_along_axis(allv, top, axis=1)
        best_i = np.take_along_axis(alli, top, axis=1)
    return best_v, best_i


def phase5_host(smi: str, dev: str = "cuda", n_rows: int | None = None,
                build_s_per_m: float = 17.0, elapsed: float = 0.0, **overrides) -> dict:
    """The 10M two-stage path through SearchEngine: bench_10m.py:38-58's
    configuration at full width on a seeded synthetic graded near-duplicate
    corpus (the trained-encoder cache it reads is not in the repo).
    `n_rows` and `overrides` (config fields) are for rehearsals off the
    card; on the card N is the largest of N_CUTS that fits."""
    import dataclasses
    import gc

    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.index import ivf as ivf_mod
    from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
    from mobius_rag_tpu_torch.ops import proj as proj_mod
    from mobius_rag_tpu_torch.ops.proj import PackedProj, ProjGate
    from mobius_rag_tpu_torch.ops.proj_scan import (proj_blocks, proj_gated_blocks,
                                                      proj_gated_blocks_reference)
    from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk
    from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, arm_candidates
    from mobius_rag_tpu_torch.query.gating import DTagPostings
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon
    from mobius_rag_tpu_torch.utils import native

    on_card = torch.device(dev).type == "cuda"
    config5 = dict(
        embed_dim=1536, vector_residency="host", vector_dtype="int8", vector_backend="proj",
        proj_p=192, lexical_format="sparse", lexical_buckets=16384, phrase_words=8,
        tag_words=4, ivf_nlist=4096, ivf_nprobe=64, over_fetch=8, host_funnel=1024,
        gating="auto", ann_reserve_slabs=2)
    cfg = dataclasses.replace(get_config(), **{**config5, **overrides})
    if n_rows is None:
        n, cut = _choose_n(build_s_per_m, elapsed)
    else:
        n, cut = n_rows, f"N={n_rows:,} given"
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=30).stdout.strip().replace("\n", " | ")
    log(f"phase 5: N={n:,}" + (f" (cut: {cut})" if cut else " (config 5's full depth)")
        + f"; free -g: {free}")
    nb = n // 10
    d = cfg.embed_dim
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages: dict = {}
    t_all = time.perf_counter()

    # ---- corpus, made on the card, into the store's page-locked matrix ----
    t0 = time.perf_counter()
    store = ChunkStore(cfg, capacity=n + INGEST_DOCS * INGEST_CHUNKS + 64, device=dev)
    hv = store.host_vectors
    sca = np.empty(n, np.float32)
    _make_corpus(hv, sca, nb, dev)
    stages["corpus"] = time.perf_counter() - t0

    # ---- queries (dequantized base rows of families the query's payer
    # owns, plus 0.02 N(0, 1) per dimension) and the exact oracle, first,
    # while the card is empty ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    q_tgt = (np.arange(BATCH) % 3).astype(np.int64)
    fams = rng.integers(0, nb // 3, BATCH) * 3 + q_tgt  # family f has payer f % 3
    qv = hv[fams].astype(np.float32) * sca[fams][:, None]
    qv += 0.02 * rng.standard_normal((BATCH, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    best_v, best_i = _oracle(hv, sca, qv, q_tgt, n, nb, dev)
    stages["oracle"] = time.perf_counter() - t0

    # ---- records and bulk_load (the int8 matrix is adopted, not copied) ----
    gc.disable()  # 10M records: no collector passes over them while they are made
    t0 = time.perf_counter()
    lexicon = sample_lexicon()
    empty = np.zeros(0, np.float32)
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 1_000_000}", source_id=f"s{i}",
                        text=_TEXT_10M, embedding=empty, payer=PAYERS_10M[(i % nb) % 3],
                        state="FL", authority_level=0, d_tags=[(i % nb) % 12])
            for i in range(n)]
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    stages["records"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.bulk_load(recs, vectors=hv)
    store.host_scales[:n] = sca
    _sync(dev)
    stages["bulk_load"] = time.perf_counter() - t0
    del recs
    gc.freeze()
    gc.enable()
    if store.host_vectors is not hv:
        raise AssertionError("bulk_load copied the host matrix instead of adopting it")

    # ---- the ANN build from the host matrix, stage by stage ----
    engine = SearchEngine(store, lexicon, cfg=cfg, device=dev)
    targets = [(ivf_mod.IVFIndex, "build_host", "build_host"),
               (ivf_mod.IVFIndex, "build", "build"),
               (ivf_mod, "_kmeans", "k-means"), (ivf_mod, "_capacity_assign", "assign"),
               (ivf_mod, "_fill_members", "fill"),
               (PackedProj, "from_ivf", "PCA + encode"), (ProjGate, "build", "gate pack"),
               (DTagPostings, "build", "d-tag postings")]
    with _Spans(targets, dev) as sp:
        ann = engine.ensure_ann()
        engine._ensure_local_structs(ann)
    (b0, _), = sp.spans["build_host"]
    (_, km1), = sp.spans["k-means"]
    (as0, _), = sp.spans["assign"]
    (_, fill1), = sp.spans["fill"]
    stages.update({"build_host sample + k-means": km1 - b0, "(k-means alone)": sp.total("k-means"),
                   "assignment stream": as0 - km1, "capacity assign": fill1 - as0})
    for key in ("PCA + encode", "gate pack", "d-tag postings"):
        stages[key] = sp.total(key)
    log(f"phase 5: tables nlist={ann.nlist} (base {ann.base_nlist}, spill slabs "
        f"{ann.reserve_start - ann.base_nlist}, reserved {ann.nlist - ann.reserve_start}), "
        f"pad={ann.pad}, p={ann.bytes_per_row}; local gating "
        f"{engine._local_gating_active()} (gating=auto under host residency)")
    if not engine._local_gating_active():
        raise AssertionError("gating=auto is not local under host residency")

    # requests: recall (empty text: the lexical and d-tag arms are dead, as
    # bench_10m.py:336-347), hybrid (payer filters, strict)
    recall_reqs = [QueryRequest(query="", embedding=qv[i], tag_mode="strict",
                                payer=PAYERS_10M[q_tgt[i]]) for i in range(BATCH)]
    bench_reqs = [QueryRequest(query=f"timely filing for {PAYERS_10M[i % 3]} claims",
                               embedding=qv[i], tag_mode="strict",
                               payer=PAYERS_10M[i % 3]) for i in range(BATCH)]

    def probe(doc_emb, payer):
        return QueryRequest(query="", embedding=doc_emb, tag_mode="strict", payer=payer)

    # ---- the main path, counted ---------------------------------------------
    proj_blocks.launches = proj_gated_blocks.launches = masked_topk.launches = 0
    native.gather_cos.native_calls = 0
    batches = 0
    recall_res = engine.search(recall_reqs, k=K)
    hybrid = engine.search(bench_reqs, k=K)
    batches += 2
    sync_rounds, pipe_rounds = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        sync_rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    for _ in range(3):
        t0 = time.perf_counter()
        piped = engine.search_pipelined([bench_reqs] * N_BATCHES, k=K)
        pipe_rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    singles = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search(one, k=K)
        singles.append((time.perf_counter() - t0) * 1e3)
    batches += 11
    # streaming ingest between searches (bench_10m.py:396-416): each new
    # document is probed by its own first chunk under its payer's filter
    # and under another payer's
    incremental = []
    real_try = engine._try_ann_incremental

    def counted_try():
        ok = real_try()
        incremental.append(ok)
        return ok

    engine._try_ann_incremental = counted_try
    probes = []
    t0 = time.perf_counter()
    with _Spans(targets[:2], dev) as ingest_sp:
        for doc in range(INGEST_DOCS):
            texts = [f"new policy bulletin {doc}-{i} on prior authorization limits."
                     for i in range(INGEST_CHUNKS)]
            embs = hash_embed(texts)
            embs /= np.linalg.norm(embs, axis=1, keepdims=True)
            store.add_chunks([ChunkRecord(
                chunk_id=f"live{doc}-c{i}", doc_id=f"live_doc_{doc}", source_id=f"live{doc}-s{i}",
                text=texts[i], embedding=embs[i], payer="sunshine_health", state="FL")
                for i in range(INGEST_CHUNKS)])
            res = engine.search([probe(embs[0], "sunshine_health"), probe(embs[0], "aetna")]
                                + bench_reqs[2:], k=K)
            probes.append((doc, res[0], res[1]))
            batches += 1
        t_ing = time.perf_counter() - t0
        store.delete_by_document("live_doc_0")
        first = hash_embed(["new policy bulletin 0-0 on prior authorization limits."])[0]
        gone = engine.search([probe(first / np.linalg.norm(first), "sunshine_health")]
                             + bench_reqs[1:], k=K)[0]
        batches += 1
    engine._try_ann_incremental = real_try
    launches = {"proj_gated_blocks": proj_gated_blocks.launches,
                "proj_blocks": proj_blocks.launches, "masked_topk": masked_topk.launches}
    native_calls = native.gather_cos.native_calls
    # ---- end of the counted run ---------------------------------------------

    if on_card and (launches["proj_gated_blocks"] != batches or launches["proj_blocks"]
                    or launches["masked_topk"]):
        raise AssertionError(f"launches {launches} for {batches} search batches")
    if native.get_lib() is not None and native_calls != batches:
        raise AssertionError(f"the native gather served {native_calls} of {batches} "
                             "re-ranked batches")
    if on_card and native.get_lib() is None:
        raise AssertionError("the native re-rank library did not build on the card machine")
    for doc, mine, other in probes:
        if not any(h.doc_id == f"live_doc_{doc}" for h in mine.hits):
            raise AssertionError(f"inserted document {doc} is not served under its filter")
        if any(h.doc_id.startswith("live_doc") for h in other.hits):
            raise AssertionError(f"inserted document {doc} is served under another payer")
    if any(h.doc_id == "live_doc_0" for h in gone.hits):
        raise AssertionError("a deleted document is still served")
    if ingest_sp.spans or engine._ann is not ann or not all(incremental) \
            or len(incremental) < INGEST_DOCS or engine._ann_cursor != INGEST_DOCS * INGEST_CHUNKS:
        raise AssertionError(f"ingest did not go through the incremental path "
                             f"(builds {ingest_sp.spans}, incremental {incremental}, "
                             f"cursor {engine._ann_cursor})")
    if [_hits(x) for x in piped[0]] != [_hits(x) for x in hybrid]:
        raise AssertionError("search_pipelined disagrees with search")
    for reqs, results in ((recall_reqs, recall_res), (bench_reqs, hybrid)):
        for req, r in zip(reqs, results):
            for h in r.hits:
                if store.record(h.row).payer != req.payer:
                    raise AssertionError(f"a hit of payer {store.record(h.row).payer!r} "
                                         f"under the filter {req.payer!r}")
                if not (np.isfinite(h.score) and 0.0 <= h.score <= 1.0):
                    raise AssertionError(f"bad rerank score {h.score}")
    if not all(r.hits for r in hybrid):
        raise AssertionError("a hybrid request has no hits")

    # one batch: the vector-arm candidates with the kernel and the plain
    # version, and the re-ranked cosines against a numpy recompute
    q, exps = engine.prepare_batch(bench_reqs)
    kd, fw = engine._device_k(K), engine._device_funnel(K)
    m_fuse = min(2 * kd, store.capacity)
    m = max(m_fuse, fw)
    local = engine._ensure_local_structs(engine.ensure_ann())
    kw = dict(m_other=m_fuse, ann=engine._ann, nprobe=engine.effective_nprobe, local=local,
              tag_level=engine._batch_tag_level(exps))
    with torch.inference_mode():
        qf = dict(q, vec=q["vec"].float())
        v, i, _, _ = arm_candidates(store.index, qf, kd, m, **kw)
        saved = proj_mod.proj_gated_blocks
        proj_mod.proj_gated_blocks = proj_gated_blocks_reference
        try:
            pv, pi, _, _ = arm_candidates(store.index, qf, kd, m, **kw)
        finally:
            proj_mod.proj_gated_blocks = saved
    live = pv[0] > NEG_INF / 2
    if not (torch.equal(live, v[0] > NEG_INF / 2) and torch.equal(v[0][live], pv[0][live])
            and torch.equal(i[0][live], pi[0][live])):
        raise AssertionError("vector-arm candidates differ from the plain version's")
    _, out, _ = engine._run(bench_reqs, K)
    alive = out["rerank"] > NEG_INF / 2
    idx = np.clip(out["idx"], 0, n - 1)
    qn = engine._embeddings(bench_reqs)
    want = np.einsum("bkd,bd->bk", store.host_vectors[idx].astype(np.float32)
                     * store.host_scales[idx][..., None], qn)
    cos_err = float(np.abs(out["cos"][alive] - want[alive]).max())
    if not cos_err <= COS_TOL:
        raise AssertionError(f"re-ranked cosines differ from the numpy recompute by {cos_err}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if peak >= n * d:
        raise AssertionError(f"peak device memory {peak} >= the {n}x{d} int8 matrix")

    # recall@K (bench_10m.py:348-379): by id, tie-aware, by family
    rec_id, rec_tie, rec_fam = [], [], []
    for qi, r in enumerate(recall_res):
        rows = np.asarray([h.row for h in r.hits], np.int64)
        rec_id.append(len(set(rows.tolist()) & set(best_i[qi].tolist())) / K)
        sc = (store.host_vectors[rows].astype(np.float32) @ qv[qi]) * store.host_scales[rows]
        floor = best_v[qi, K - 1] - 1e-6 * abs(best_v[qi, K - 1])
        rec_tie.append(float((np.isin(rows, best_i[qi]) | (sc >= floor)).sum()) / K)
        fam_o = {int(x) % nb for x in best_i[qi]}
        rec_fam.append(len({int(x) % nb for x in rows} & fam_o) / max(len(fam_o), 1))

    # the host re-rank and merged_topk per batch, then the profiler
    with _Spans([(SearchEngine, "_host_rerank", "host re-rank"),
                 (proj_mod, "merged_topk", "merged_topk")], dev) as timed:
        for _ in range(4):
            engine.search(bench_reqs, k=K)
    timed = {key: [(t1 - t0) * 1e3 for t0, t1 in spans]
             for key, spans in timed.spans.items()}
    busy, wall, top, proj_ms = _device_busy_share(engine, bench_reqs, dev)
    path_bound = _path_bound(engine, bench_reqs, engine._batch_tag_level(exps))

    log("phase 5: build stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    log(f"phase 5: host int8 matrix {store.host_vectors.nbytes / 1e9:.2f} GB "
        f"({store.host_vectors.shape[0]:,} x {d}); peak device memory "
        f"{peak / 2**30:.2f} GiB (< the {n * d / 2**30:.2f} GiB an [N, D] int8 buffer "
        f"would take)")
    log(f"phase 5: recall@{K} vs the exact oracle: by id {np.mean(rec_id):.4f}, tie-aware "
        f"{np.mean(rec_tie):.4f}, family {np.mean(rec_fam):.4f} ({BATCH} filtered queries)")
    log(f"phase 5: launches {launches} for {batches} batches; native re-rank calls "
        f"{native_calls}; vector-arm candidates equal the plain version's on one batch; "
        f"re-ranked cosines within {cos_err:.2g} of numpy; every hit passes its payer "
        f"filter; search_pipelined == search")
    log(f"phase 5: {np.median(sync_rounds):.1f} queries/s sync (rounds "
        f"{[round(x, 1) for x in sync_rounds]}), {np.median(pipe_rounds):.1f} pipelined "
        f"({[round(x, 1) for x in pipe_rounds]}) at batch {BATCH}; single query "
        f"{np.median(singles):.3f} ms (median of 10); host re-rank "
        f"{np.median(timed['host re-rank']):.3f} ms per batch, merged_topk "
        f"{np.median(timed['merged_topk']):.3f} ms per batch (medians of 4, synchronised)")
    log(f"phase 5: device busy {busy:.3f} of {wall:.3f} ms per batch "
        f"({100 * busy / wall:.1f}%), by kernel (ms/batch) "
        + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + f" on {smi}")
    log(f"phase 5: {path_bound}; proj kernels' device time {proj_ms:.4f} ms per batch")
    log(f"phase 5: streaming ingest {INGEST_DOCS * INGEST_CHUNKS} chunks in {t_ing:.2f} s = "
        f"{INGEST_DOCS * INGEST_CHUNKS / t_ing:.1f} chunks/s with a search after each "
        f"document; every document served under its payer only, through the reserved "
        f"slabs (no k-means rebuild); the deleted one gone")
    log(f"phase 5: {time.perf_counter() - t_all:.1f} s")
    return {"launches": launches["proj_gated_blocks"], "n": n}


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase0_device()
    phase1_build()
    k = phase2_kernel()
    kp = phase2_proj_kernels()
    s = phase3_slice(smi)
    s8 = phase3_slice(smi, "int8")
    p4 = phase4_proj(smi)
    p5 = phase5_host(smi, build_s_per_m=p4["build_s_per_m"],
                     elapsed=time.perf_counter() - t_start)
    kernels = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, timing, runs, err in (("masked_topk", "main_f32", s, "max_abs_err"),
                                    ("masked_topk_int8", "main_int8", s8, "max_abs_err_int8")):
        t, t1 = k["timing"][timing], k["timing"][f"{timing} B=1"]
        f32 = name == "masked_topk"  # one library call on the same inputs only for f32 rows
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": KERNEL_REPLACES, "launches": runs["launches"],
                        "max_abs_err": k[err], **{key: t[key] for key in keys},
                        "library_ms": t["library_ms"] if f32 else None,
                        "device_ms": t["device_ms"], "ms_B1": t1["ms"],
                        "device_ms_B1": t1["device_ms"], "plain_ms_B1": t1["plain_ms"],
                        "bound_ms_B1": t1["bound_ms"],
                        "library_ms_B1": t1["library_ms"] if f32 else None})
    launches = dict(p4["launches"])
    launches["proj_gated_blocks"] += p5["launches"]  # phase 4 path B and phase 5
    for name, replaces in (("proj_blocks", PROJ_REPLACES),
                           ("proj_gated_blocks", GATED_REPLACES)):
        t = kp["timing"]["main_1M"][name]
        entry = {"name": name, "route": "cuda", "source": PROJ_SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": kp["max_abs_err"], **{key: t[key] for key in keys},
                 "library_ms": None}  # no PyTorch call computes a gathered int8 block dot
        t10 = kp["timing"]["main_10M"][name]
        entry.update(device_ms=t["device_ms"], ms_10M=t10["ms"], plain_ms_10M=t10["plain_ms"],
                     bound_ms_10M=t10["bound_ms"], device_ms_10M=t10["device_ms"])
        kernels.append(entry)
    log(f"command time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
