"""Rehearse the port's CUDA kernels on the CPU, where there is no nvcc and
no card: compile a kernel source with g++ against ``scripts/cuda_cpu_shim.h``
(one std::thread per CUDA thread; see the header for what it models) and
hold its C entry points against the plain PyTorch versions at small
shapes. It checks indexing, fragment layouts and arithmetic, not speed.

    python3 scripts/cuda_cpu_rehearsal.py proj        # ops/csrc/proj_scan.cu
    python3 scripts/cuda_cpu_rehearsal.py topk        # ops/csrc/topk.cu
    python3 scripts/cuda_cpu_rehearsal.py topk --source other.cu

The source is rewritten for g++ on the way: every device function whose
body holds inline ``asm`` is dropped (the shim defines the same names:
``smem_addr``, ``cp_async``, ``cp_async_commit``, ``cp_async_wait*``,
``ldmatrix_x4``, ``mma_s8``), ``extern __shared__`` arrays point at the
launch's dynamic shared memory, and ``k<<<cfg>>>(args)`` becomes a call of
the shim's launcher.
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


def rehearse_topk(lib) -> None:
    from mobius_rag_tpu_torch.ops.quant import quantize_rows
    from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk_reference

    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.mrag_masked_topk.argtypes = [p_, p_, i_, p_, p_, ctypes.c_longlong, p_,
                                     i_, i_, i_, i_, p_, p_, p_, p_]
    lib.mrag_topk_scratch_elems.argtypes = [i_, i_, i_]
    lib.mrag_topk_scratch_elems.restype = ctypes.c_longlong
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    g = torch.Generator().manual_seed(0)
    # (name, B, C, D, m, row type, penalty form, special)
    cases = [("f32", 5, 700, 64, 40, torch.float32, "bc", None),
             ("B=1", 1, 900, 64, 40, torch.float32, "bc", None),
             ("B=9", 9, 300, 32, 12, torch.float32, "bc", None),
             ("B=33", 33, 260, 32, 7, torch.float32, "c", None),
             ("bf16", 4, 600, 64, 40, torch.bfloat16, "bc", None),
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
             ("select bf16", 3, 1300, 64, 8, torch.bfloat16, "bc", None),
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
             ("D=36 bf16", 3, 300, 36, 10, torch.bfloat16, "bc", None),
             ("D=36 int8", 3, 300, 36, 10, torch.int8, "bc", None),
             ("D=132 int8", 2, 1500, 132, 9, torch.int8, "bc", None)]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=["proj", "topk"])
    ap.add_argument("--source", help="the .cu file (default: the package's)")
    args = ap.parse_args()
    source = args.source or os.path.join(
        CSRC, "proj_scan.cu" if args.kernel == "proj" else "topk.cu")
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(source, tmp)
        (rehearse_proj if args.kernel == "proj" else rehearse_topk)(lib)


if __name__ == "__main__":
    main()
