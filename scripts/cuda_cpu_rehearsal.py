"""Rehearse the port's CUDA kernels on the CPU, where there is no nvcc and
no card: compile a kernel source with g++ against ``scripts/cuda_cpu_shim.h``
(one std::thread per CUDA thread; see the header for what it models) and
hold its C entry points against the plain PyTorch versions at small
shapes. It checks indexing, fragment layouts and arithmetic, not speed.

    python3 scripts/cuda_cpu_rehearsal.py proj        # ops/csrc/proj_scan.cu
    python3 scripts/cuda_cpu_rehearsal.py topk        # ops/csrc/topk.cu
    python3 scripts/cuda_cpu_rehearsal.py lexical     # ops/csrc/lexical.cu
    python3 scripts/cuda_cpu_rehearsal.py topk --source other.cu
    python3 scripts/cuda_cpu_rehearsal.py topk --bf16 # the bf16-row cases alone
    python3 scripts/cuda_cpu_rehearsal.py topk --f32-int8  # the float32/int8-row cases

The source is rewritten for g++ on the way: every device function whose
body holds inline ``asm`` is dropped (the shim defines the same names:
``smem_addr``, ``cp_async``, ``cp_async_commit``, ``cp_async_wait*``,
``ldmatrix_x4``, ``mma_s8``, ``mma_bf16``), ``extern
__shared__`` arrays point at the launch's dynamic shared memory, and
``k<<<cfg>>>(args)`` becomes a call of the shim's launcher.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SHIM = os.path.join(ROOT, "scripts", "cuda_cpu_shim.h")
CSRC = os.path.join(ROOT, "mobius_rag_tpu_torch", "ops", "csrc")
_DEVICE_FN = re.compile(r"(?:template\s*<[^;{}]*?>\s*)?__device__[^;{}]*?\)\s*\{")


def _drop_asm_functions(src: str) -> str:
    out, pos = [], 0
    for m in _DEVICE_FN.finditer(src):
        if m.start() < pos:
            continue
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        if "asm" in src[m.end():i]:
            out.append(src[pos:m.start()])
            pos = i
    out.append(src[pos:])
    return "".join(out)


def translate(src: str) -> str:
    src = re.sub(r"#include <(cuda_runtime|cuda_bf16)\.h>\n", "", src)
    src = _drop_asm_functions(src)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(shim_blk->dyn);", src)
    src = re.sub(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\(", r"shim_launch(shim_cfg(\2), \1, ",
                 src, flags=re.S)
    return f'#include "{SHIM}"\n' + src


def build(source: str, tmp: str) -> ctypes.CDLL:
    cpp = os.path.join(tmp, os.path.basename(source) + ".cpp")
    with open(source) as f, open(cpp, "w") as g:
        g.write(translate(f.read()))
    lib = os.path.join(tmp, "lib.so")
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                           "-ffp-contract=off", "-Wno-unknown-pragmas", "-o", lib, cpp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ refused {source}:\n{proc.stderr[-6000:]}")
    return ctypes.CDLL(lib)


def _p(t):
    return None if t is None else t.data_ptr()


def rehearse_proj(lib) -> None:
    from mobius_rag_tpu_torch.ops.proj import gate_widths
    from mobius_rag_tpu_torch.ops.proj_scan import (group_probes_reference,
                                                      proj_blocks_reference,
                                                      proj_gated_blocks_reference)

    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.mrag_proj_blocks.argtypes = [p_, p_, p_, p_, p_, i_, i_, i_, i_, i_, p_]
    lib.mrag_proj_gated_blocks.argtypes = [p_] * 9 + [i_] * 8 + [p_]
    lib.mrag_proj_group.argtypes = [p_, p_, i_, i_, i_, p_]
    lib.mrag_proj_scratch_ints.argtypes = [i_, i_, i_]
    lib.mrag_proj_scratch_ints.restype = ctypes.c_longlong
    lib.mrag_proj_record_ints.restype = i_
    g = torch.Generator().manual_seed(0)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(torch.int32)

    # (name, B, P, nlist, pad, p, tw)
    cases = [("p=64", 3, 4, 6, 130, 64, 2), ("p=37", 2, 3, 5, 40, 37, 2),
             ("p=300 (two slices)", 3, 3, 4, 64, 300, 2),
             ("p=1536 (six slices)", 2, 3, 4, 32, 1536, 2),
             ("p=4100 (query slices)", 2, 2, 3, 20, 4100, 1),
             ("B=33 p=512", 33, 3, 5, 24, 512, 2),
             ("nlist=20000", 3, 4, 20000, 8, 32, 1)]
    for name, b, n_probe, nlist, pad, p, tw in cases:
        probe = ri(0, nlist, (b, n_probe))
        if b > 1:
            probe[1] = probe[0]  # shared clusters
        codes = ri(-127, 128, (nlist, pad, p)).to(torch.int8)
        q8 = ri(-127, 128, (b, p)).to(torch.int8)
        w_full, _ = gate_widths(tw)
        words = ri(-2**31, 2**31 - 1, (nlist, w_full, pad))
        words[:, 2] = torch.rand((nlist, pad), generator=g).view(torch.int32)
        qmeta = torch.stack([ri(0, 3, (b,)) for _ in range(4)] +
                            [ri(0, 2, (b,)) for _ in range(4)], 1).contiguous()
        qbits = ri(0, 2**31 - 1, (b, 3 * tw))
        n_scr = lib.mrag_proj_scratch_ints(b, n_probe, nlist)
        scratch = torch.full((n_scr,), -7, dtype=torch.int32)
        assert lib.mrag_proj_group(_p(probe), _p(scratch), b, n_probe, nlist, None) == 0
        bp, recw = b * n_probe, lib.mrag_proj_record_ints()
        n_groups = int(scratch[bp * (recw + 1)])
        rec = scratch[:n_groups * recw].view(n_groups, recw)
        got = (scratch[bp * recw:bp * (recw + 1)], rec[:, 0].contiguous(),
               torch.cat([rec[:, 1], rec.new_full((1,), bp)]))
        for x, y in zip(got, group_probes_reference(probe, nlist)):
            assert torch.equal(x, y), f"{name}: grouping"
        out = torch.full((b, n_probe, pad), 7.0)
        assert lib.mrag_proj_blocks(_p(probe), _p(codes), _p(q8), _p(scratch), _p(out), b,
                                    n_probe, nlist, pad, p, None) == 0
        assert torch.equal(out, proj_blocks_reference(probe, codes, q8)), f"{name}: raw dots"
        for level in (0, 1, 2):
            score = torch.full((b, n_probe, pad), 7.0)
            rowid = torch.full((b, n_probe, pad), 7, dtype=torch.int32)
            assert lib.mrag_proj_gated_blocks(
                _p(probe), _p(qmeta), _p(qbits), _p(codes), _p(words), _p(q8), _p(scratch),
                _p(score), _p(rowid), b, n_probe, nlist, pad, p, w_full, tw, level, None) == 0
            rs, rr = proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8,
                                                 tw=tw, tag_level=level)
            assert torch.equal(score, rs) and torch.equal(rowid, rr), f"{name}: level {level}"
        print(f"proj {name}: grouping, raw dots and gated levels 0/1/2 bitwise", flush=True)


# (name, B, C, D, m, row type, penalty form, special): special "dup" and
# "equal" put rows and queries on a 1/8 grid (every dot exact, ties exact),
# "few" leaves 25 live rows, "gated" gates every row of query 1; "qbf16"
# rounds the queries to bf16 (the engine's queries: one query part a
# k-step), "qmixed" every other one, "qhalf" the first half of each;
# other cases keep float32 queries, which take all three parts of the
# split.
TOPK_CASES = [
    ("f32", 5, 700, 64, 40, torch.float32, "bc", None),
    ("B=1", 1, 900, 64, 40, torch.float32, "bc", None),
    ("B=9", 9, 300, 32, 12, torch.float32, "bc", None),
    ("B=33", 33, 260, 32, 7, torch.float32, "c", None),
    ("int8", 4, 600, 64, 40, torch.int8, "bc", None),
    ("m=128", 3, 1200, 32, 128, torch.float32, "bc", None),
    ("m=129", 3, 1200, 32, 129, torch.float32, "bc", None),
    ("m=700", 2, 1500, 32, 700, torch.float32, "c", None),
    ("C=m", 2, 150, 32, 150, torch.float32, "bc", None),
    ("duplicates", 3, 800, 32, 40, torch.float32, "bc", "dup"),
    ("all equal", 2, 700, 32, 40, torch.float32, "c", "equal"),
    ("few live", 3, 900, 32, 40, torch.float32, "bc", "few"),
    ("all gated", 3, 500, 32, 40, torch.float32, "bc", "gated"),
    # at least m tiles of 128 rows: the threshold merge
    ("select", 4, 2000, 32, 10, torch.float32, "bc", None),
    ("select int8", 3, 1300, 64, 8, torch.int8, "c", None),
    ("select B=1", 1, 1300, 32, 8, torch.float32, "bc", None),
    ("select B=20", 20, 1300, 32, 8, torch.float32, "bc", None),
    ("select ties", 2, 1300, 32, 8, torch.float32, "c", "equal"),
    ("select duplicates", 3, 1300, 32, 8, torch.float32, "bc", "dup"),
    ("select few live", 3, 1300, 32, 8, torch.float32, "bc", "few"),
    ("select all gated", 3, 1300, 32, 8, torch.float32, "bc", "gated"),
    ("select m=128", 2, 16400, 32, 128, torch.float32, "bc", None),
    ("select overflow", 2, 13200, 32, 40, torch.float32, "c", "equal"),
    # D past a k-slice and not a multiple of a 16-byte copy
    ("D=36", 3, 300, 36, 10, torch.float32, "bc", None),
    ("D=36 int8", 3, 300, 36, 10, torch.int8, "bc", None),
    ("D=132 int8", 2, 1500, 132, 9, torch.int8, "bc", None),
    # bf16 rows on the tensor cores: every query tile (32, 16, 8, 4, 1),
    # both query kinds and a tile that mixes them, D under one k-step,
    # past a k-slice and not a multiple of 16, ties, a [C] penalty, and the
    # threshold merge
    ("bf16", 4, 600, 64, 40, torch.bfloat16, "bc", None),
    ("bf16 q bf16", 4, 600, 64, 40, torch.bfloat16, "bc", "qbf16"),
    ("bf16 B=5 mixed", 5, 300, 64, 12, torch.bfloat16, "bc", "qmixed"),
    ("bf16 B=12", 12, 300, 64, 10, torch.bfloat16, "c", None),
    ("bf16 B=33 mixed", 33, 260, 32, 7, torch.bfloat16, "c", "qmixed"),
    ("bf16 B=1", 1, 400, 64, 10, torch.bfloat16, "bc", None),
    ("bf16 B=1 q bf16", 1, 400, 64, 10, torch.bfloat16, "c", "qbf16"),
    ("bf16 D=20", 3, 300, 20, 10, torch.bfloat16, "bc", None),
    ("bf16 D=20 q bf16", 3, 300, 20, 10, torch.bfloat16, "c", "qbf16"),
    ("bf16 D=36", 3, 300, 36, 10, torch.bfloat16, "bc", None),
    ("bf16 D=1540", 2, 140, 1540, 5, torch.bfloat16, "bc", "qmixed"),
    ("bf16 ties", 2, 700, 32, 40, torch.bfloat16, "c", "equal"),
    ("select bf16", 3, 1300, 64, 8, torch.bfloat16, "bc", None),
]
BF16_CASES = [c for c in TOPK_CASES if c[5] == torch.bfloat16]
# float32 and int8 rows: every query tile (float32 rows on the tensor
# cores from MMA_QT_F32 = 32 queries a tile, int8 rows from 4; the FMA
# core below), each with float32 queries (float32 rows: the FMA slices;
# int8: 3 products a k-step), the engine's bf16-exact ones (3; 1), a tile
# mixing both, and
# queries bf16-exact in their first half of D only (the choice changes
# from slice to slice); D under one k-step (20), past a float32 slice
# (36), past an int8 slice (132), long and not a multiple of 16 (1540);
# ties, a [C] penalty and the threshold merge
F32_INT8_CASES = [
    ("f32 B=32 half", 32, 300, 64, 10, torch.float32, "bc", "qhalf"),
    ("f32 B=20 D=36 q bf16", 20, 300, 36, 10, torch.float32, "c", "qbf16"),
    ("f32 B=17 D=20 mixed", 17, 200, 20, 10, torch.float32, "bc", "qmixed"),
    ("f32 B=12 mixed", 12, 300, 64, 10, torch.float32, "c", "qmixed"),
    ("f32 B=5", 5, 300, 64, 12, torch.float32, "bc", None),
    ("f32 B=3 q bf16", 3, 300, 64, 10, torch.float32, "bc", "qbf16"),
    ("f32 B=1 q bf16", 1, 400, 64, 10, torch.float32, "bc", "qbf16"),
    ("f32 D=1540 mixed", 2, 140, 1540, 5, torch.float32, "bc", "qmixed"),
    ("f32 D=132 half", 3, 300, 132, 10, torch.float32, "bc", "qhalf"),
    ("f32 ties", 17, 700, 32, 40, torch.float32, "c", "equal"),
    ("select f32 q bf16", 17, 700, 64, 5, torch.float32, "bc", "qbf16"),
    ("int8 B=32 q bf16", 32, 300, 64, 10, torch.int8, "bc", "qbf16"),
    ("int8 B=12", 12, 300, 64, 10, torch.int8, "c", None),
    ("int8 B=5 mixed", 5, 300, 64, 12, torch.int8, "bc", "qmixed"),
    ("int8 B=3 q bf16", 3, 300, 64, 10, torch.int8, "bc", "qbf16"),
    ("int8 B=1 q bf16", 1, 400, 64, 10, torch.int8, "bc", "qbf16"),
    ("int8 B=1", 1, 400, 64, 10, torch.int8, "c", None),
    ("int8 D=20 q bf16", 3, 300, 20, 10, torch.int8, "bc", "qbf16"),
    ("int8 D=36 mixed", 3, 300, 36, 10, torch.int8, "c", "qmixed"),
    ("int8 D=132 q bf16", 2, 500, 132, 9, torch.int8, "bc", "qbf16"),
    ("int8 D=1540 mixed", 2, 140, 1540, 5, torch.int8, "bc", "qmixed"),
    ("int8 D=260 half", 2, 300, 260, 10, torch.int8, "c", "qhalf"),
    ("int8 ties", 2, 700, 32, 40, torch.int8, "c", "equal"),
    ("select int8 q bf16", 3, 1300, 64, 8, torch.int8, "c", "qbf16"),
]
TOPK_CASES += F32_INT8_CASES


def rehearse_topk(lib, cases=TOPK_CASES) -> None:
    from mobius_rag_tpu_torch.ops.quant import quantize_rows
    from mobius_rag_tpu_torch.ops.topk import NEG_INF, bf16_parts, masked_topk_reference

    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.mrag_masked_topk.argtypes = [p_, p_, i_, p_, p_, ctypes.c_longlong, p_,
                                     i_, i_, i_, i_, p_, p_, p_, p_]
    lib.mrag_topk_scratch_elems.argtypes = [i_, i_, i_]
    lib.mrag_topk_scratch_elems.restype = ctypes.c_longlong
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    g = torch.Generator().manual_seed(0)
    for name, b, c, d, m, dtype, pen_form, special in cases:
        v = torch.randn(c, d, generator=g)
        v = v / v.norm(dim=1, keepdim=True)
        if special in ("dup", "equal"):  # a 1/8 grid: every dot exact, ties exact
            v = torch.randint(-2, 3, (c, d), generator=g).float() / 8
        if special == "dup":
            v[c // 2:] = v[:c - c // 2]
        if special == "equal":
            v[:] = v[0]
        scales = None
        if dtype == torch.int8:
            v, scales = quantize_rows(v)
        v = v.to(dtype).contiguous()
        q = torch.randn(b, d, generator=g)
        q = q / q.norm(dim=1, keepdim=True)
        if special in ("dup", "equal"):
            q = torch.randint(-2, 3, (b, d), generator=g).float() / 8
        if special == "qbf16":
            q = q.to(torch.bfloat16).float()
        if special == "qmixed":
            q[1::2] = q[1::2].to(torch.bfloat16).float()
        if special == "qhalf":
            q[:, :d // 2] = q[:, :d // 2].to(torch.bfloat16).float()
        if special not in ("qbf16", "dup", "equal"):
            assert bool(bf16_parts(q[0])[2].ne(0).any()), f"{name}: no query needs 3 parts"
        shape = (b, c) if pen_form == "bc" else (c,)
        pen = torch.where(torch.rand(shape, generator=g) < 0.3, NEG_INF, 0.0)
        if special == "equal":
            pen.zero_()
        if special == "few":
            pen[..., 25:] = NEG_INF
        if special == "gated":
            pen[1] = NEG_INF
        ms = torch.where(torch.arange(b) % 2 == 1, 0.02, -float("inf")).float()
        scratch = torch.empty((lib.mrag_topk_scratch_elems(b, c, m),), dtype=torch.int64)
        vals = torch.empty((b, m))
        idx = torch.empty((b, m), dtype=torch.int32)
        rc = lib.mrag_masked_topk(_p(q), _p(v), kinds[dtype], _p(scales), _p(pen),
                                  c if pen.dim() == 2 else 0, _p(ms), b, c, d, m,
                                  _p(scratch), _p(vals), _p(idx), None)
        assert rc == 0, f"{name}: rc {rc}"
        rv, ri_ = masked_topk_reference(q, v, pen.contiguous(), ms, m, row_scales=scales)
        err = (vals - rv).abs().max().item()
        tied = (rv[:, 1:] - rv[:, :-1]).abs() <= 1e-5
        strict = torch.ones_like(ri_, dtype=torch.bool)
        strict[:, 1:] &= ~tied
        strict[:, :-1] &= ~tied
        bad = ((idx != ri_) & strict).sum().item()
        assert err <= 1e-4 and not bad, f"{name}: max_abs_err {err}, {bad} ids differ"
        if special in ("dup", "equal"):
            assert torch.equal(idx, ri_), f"{name}: the tie order differs"
        print(f"topk {name} B={b} C={c} m={m}: max_abs_err {err:.2e}, ids agree", flush=True)


# (name, B, C, H, P, U, live columns, m, special). Every case names a
# bucket with fill P and one with fill 0, puts row 7 in three of query 0's
# buckets, gives every query zero weights on some live columns, pads the
# union past its live columns (bucket 0 at weight 0) and gates as
# engine.gate_penalty does (-0.0 open, NEG_INF gated). Specials: "ties"
# (every posting and query weight 1: rows with the same buckets tie), "few"
# (fewer live rows than m), "gated" (query 1 all gated: its scored rows,
# then the rest, in row order), "dead" (query 1 names no bucket), "holes"
# (scrubbed postings, -1 between filled ones), "cancel" (a row's +x and -x
# sum to 0: touched, unscored), "plus0" (open rows +0.0), "late" (only
# rows past the dead fill's first 8,192 pass the gate).
LEX_CASES = [
    ("U=16", 3, 300, 40, 32, 16, 12, 10, None),
    ("U=64", 3, 600, 100, 16, 64, 50, 20, None),
    ("U=128", 2, 900, 160, 8, 128, 128, 40, None),
    ("ties", 3, 400, 40, 32, 16, 10, 40, "ties"),
    ("few live", 3, 2000, 30, 8, 16, 4, 40, "few"),
    ("all gated", 3, 500, 40, 16, 16, 8, 40, "gated"),
    ("no live bucket", 3, 300, 40, 16, 16, 8, 10, "dead"),
    ("holes", 2, 300, 40, 32, 16, 10, 10, "holes"),
    ("cancel", 2, 200, 20, 16, 16, 6, 10, "cancel"),
    ("open +0.0", 2, 300, 40, 16, 16, 10, 10, "plus0"),
    ("m=C", 2, 60, 20, 8, 16, 10, 60, None),
    ("m=700", 2, 3000, 64, 64, 64, 40, 700, None),
    ("m=2500 (three rounds)", 2, 6000, 80, 256, 64, 64, 2500, None),
    ("many touched", 2, 5000, 64, 256, 16, 16, 5, None),
    ("late fill", 2, 20000, 20, 8, 16, 4, 40, "late"),
]


def lexical_case(case, g):
    """One LEX_CASES case's inputs: (weights [B, U], buckets [U] int32,
    cols [H, P] int32, wts [H, P] bf16, penalty [B, C], m)."""
    from mobius_rag_tpu_torch.ops.topk import NEG_INF

    name, b, c, h, p, u, live_u, m, special = case
    fill = torch.randint(0, p + 1, (h,), generator=g)
    fill[1], fill[2] = p, 0
    if special == "few":
        fill.clamp_(max=2)
        fill[1] = 2
    cols = torch.full((h, p), -1, dtype=torch.int32)
    wts = torch.zeros((h, p))
    for bk in range(h):
        n = int(fill[bk])
        cols[bk, :n] = torch.randperm(c, generator=g)[:n].to(torch.int32)
        wts[bk, :n] = torch.rand(n, generator=g) * 2 + 0.01
    perm = torch.randperm(h - 1, generator=g)[:live_u] + 1
    perm[:2] = torch.tensor([1, 2])  # fill P and fill 0 are live
    live = perm[:live_u]
    for bk in live[2:5].tolist():  # row 7 in three of query 0's buckets
        cols[bk, 0], wts[bk, 0] = 7, 0.5
    if special == "holes":
        hole = torch.rand((h, p), generator=g) < 0.3
        cols[hole], wts[hole] = -1, 0.0
        cols[1, p // 2:] = -1  # a run of holes, then postings past it
        cols[1, -1], wts[1, -1] = 11, 0.75
    if special == "ties":
        wts = (cols >= 0).float()
    if special == "cancel":
        cols[live[2], 1], wts[live[2], 1] = 13, 0.5
        cols[live[3], 1], wts[live[3], 1] = 13, -0.5
    buckets = torch.zeros(u, dtype=torch.int32)
    buckets[:live_u] = live.to(torch.int32)
    weights = torch.zeros((b, u))
    weights[:, :live_u] = torch.rand((b, live_u), generator=g) * 3 + 0.1
    weights[:, :live_u][torch.rand((b, live_u), generator=g) < 0.3] = 0.0
    weights[0, :5] = torch.rand(5, generator=g) + 0.5  # row 7's buckets and fill P
    if special == "ties":
        weights = (weights > 0).float()
    if special == "cancel":
        weights[:, 2:4] = 1.0
    if special == "dead":
        weights[1] = 0.0
    gate = (torch.rand((b, c), generator=g) > 0.3).float()
    if special == "gated":
        gate[1] = 0.0
    if special == "late":
        gate[:, :15000] = 0.0
    penalty = (1.0 - gate) * NEG_INF
    if special == "plus0":
        penalty = torch.where(gate > 0, 0.0, NEG_INF)
    return weights, buckets, cols, wts.to(torch.bfloat16), penalty.contiguous(), m


def rehearse_lexical(lib, cases=LEX_CASES) -> None:
    from mobius_rag_tpu_torch.ops.lexical import lexical_signals, lexical_topk_reference

    p_, i_, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mrag_lex_topk.argtypes = [p_, p_, p_, p_, p_, i_, i_, i_, ll, i_, p_, p_, p_, ll, p_, p_,
                                  p_]
    g = torch.Generator().manual_seed(0)
    for case in cases:
        name = case[0]
        weights, buckets, cols, wts, pen, m = lexical_case(case, g)
        b, u = weights.shape
        c = pen.shape[1]
        cap = min(c, u * cols.shape[1])
        acc = torch.full((b, c), 7.0, dtype=torch.float64)
        touched = torch.full((b, cap), -7, dtype=torch.int64)
        counts = torch.full((b,), -7, dtype=torch.int32)
        vals = torch.full((b, m), 7.0)
        idx = torch.full((b, m), -7, dtype=torch.int64)
        rc = lib.mrag_lex_topk(_p(weights), _p(buckets), _p(cols), _p(wts), _p(pen), b, u,
                               cols.shape[1], c, m, _p(acc), _p(touched), _p(counts), cap,
                               _p(vals), _p(idx), None)
        assert rc == 0, f"{name}: rc {rc}"
        rv, ri_, lex = lexical_topk_reference(weights, buckets, cols, wts, pen, m)
        assert torch.equal(vals.view(torch.int32), rv.view(torch.int32)), f"{name}: values"
        assert torch.equal(idx, ri_), f"{name}: ids"
        first = torch.arange(min(c, 512)).expand(b, -1)  # rows 7 and 13 among them
        rows = torch.cat([ri_, first, torch.randint(0, c, (b, 20), generator=g)],
                         dim=1).contiguous()
        sig = lexical_signals(acc, rows)
        want = torch.gather(lex, 1, rows)
        assert torch.equal(sig.view(torch.int32), want.view(torch.int32)), f"{name}: signals"
        live = int((rv > 0).sum())
        print(f"lexical {name} B={b} C={c} U={u} m={m}: {live} live of {b * m}, "
              f"{int(counts.sum())} rows touched; values, ids and signals bitwise", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=["proj", "topk", "lexical"])
    ap.add_argument("--source", help="the .cu file (default: the package's)")
    ap.add_argument("--bf16", action="store_true", help="topk: only the bf16-row cases")
    ap.add_argument("--f32-int8", action="store_true",
                    help="topk: only F32_INT8_CASES (float32 and int8 rows)")
    args = ap.parse_args()
    source = args.source or os.path.join(
        CSRC, {"proj": "proj_scan.cu", "topk": "topk.cu", "lexical": "lexical.cu"}[args.kernel])
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(source, tmp)
        if args.kernel == "proj":
            rehearse_proj(lib)
        elif args.kernel == "lexical":
            rehearse_lexical(lib)
        else:
            rehearse_topk(lib, BF16_CASES if args.bf16 else
                          F32_INT8_CASES if args.f32_int8 else TOPK_CASES)


if __name__ == "__main__":
    main()
