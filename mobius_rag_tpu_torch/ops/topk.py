"""Masked cosine top-m over the device-resident chunk matrix.

The port of ``mobius_rag_tpu/ops/topk.py:_topk_kernel`` (the Pallas fused
masked cosine top-k) and of the same math the JAX engine inlines in its
vector arm (``engine.py:477-485``):

    cos[b, c]   = (q[b]·v[c]) · s[c]
    score[b, c] = cos[b, c] + penalty[b, c] + (NEG_INF if cos[b, c] < min_sim[b])

and the top-``m`` of each row of ``score``, in descending order, the lower
row index first among equal scores (``lax.top_k``'s order). The rows are
float32, bfloat16 or int8; ``s`` is the int8 rows' per-row dequant scale
(``row_scales``, the store's ``vec_scales``), absent otherwise — the JAX
dense arm's arithmetic (``engine.py:277-279``): cast, dot, then the scale.

- :func:`masked_topk_reference` is the plain PyTorch version: one matmul
  in full float32 and a stable sort. The tests and the on-card comparison
  use it.
- :func:`masked_topk` dispatches on where the tensors lie: on the CPU it
  calls the plain version, on a CUDA device it launches the hand-written
  Hopper kernel (``ops/csrc/topk.cu``) or raises. It never falls back.
  ``masked_topk.launches`` counts kernel launches.
- :func:`topk_stable` is the order-exact top-k the engine uses for every
  other selection (lexical arm, d-tag arm, fusion).
"""
from __future__ import annotations

import ctypes
import os

import torch

from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, build_library, find_nvcc

NEG_INF = -1e30
# Widest m the kernel takes: each merge block keeps m of the 4096 keys it
# sorts, so the merge tree shrinks by at least 4x a level.
MAX_M = 1024

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "topk.cu")
_LIB: ctypes.CDLL | None = None


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, the lower index first among
    equal values (``jax.lax.top_k``'s order). Returns (values, int64 ids)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def merged_topk(vals: torch.Tensor, ids: torch.Tensor, k: int,
                approx_recall: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a flat candidate pool: vals/ids [B, S] → [B, k]
    (``mobius_rag_tpu.ops.topk.merged_topk``). Pools narrower than k are
    padded with (NEG_INF, id 0); among equal values the lower position
    wins. ``approx_recall`` > 0 (the JAX package's ``approx_max_k``) is
    not ported: the JAX configuration keeps it off by measurement."""
    if approx_recall:
        raise NotImplementedError(
            "approximate top-k (MRAG_ANN_APPROX_TOPK > 0) is not ported; "
            "the JAX configuration keeps it off by measurement (config.py:104-119)")
    b, s = vals.shape
    if s < k:
        vals = torch.cat([vals, vals.new_full((b, k - s), NEG_INF)], dim=1)
        ids = torch.cat([ids, ids.new_zeros((b, k - s))], dim=1)
    v, pos = topk_stable(vals, k)
    return v, torch.gather(ids, 1, pos)


def masked_topk_reference(queries: torch.Tensor, vectors: torch.Tensor,
                          penalty: torch.Tensor, min_sim: torch.Tensor | None,
                          m: int, row_scales: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: queries [B, D] f32, vectors [C, D] f32/bf16/int8,
    penalty [B, C] or [C] f32, min_sim [B] f32 or None, row_scales [C] f32
    or None → (vals [B, m] f32, idx [B, m] int32)."""
    cos = queries.float() @ vectors.float().T  # [B, C], full float32
    if row_scales is not None:
        cos = cos * row_scales[None, :]
    scores = cos + penalty
    if min_sim is not None:
        scores = scores + torch.where(cos < min_sim[:, None], NEG_INF, 0.0)
    vals, idx = topk_stable(scores, m)
    return vals, idx.to(torch.int32)


def build_kernel() -> tuple[ctypes.CDLL, float]:
    """Build (at first use) and load the kernel library. Returns (library,
    seconds spent compiling, 0.0 when it was already built)."""
    global _LIB
    path, seconds = build_library("mrag_topk", [_SOURCE], find_nvcc(), NVCC_FLAGS)
    if _LIB is None:
        lib = ctypes.CDLL(path)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.mrag_masked_topk.argtypes = [p, p, i, p, p, ctypes.c_longlong, p,
                                         i, i, i, i, p, p, p, p]
        lib.mrag_masked_topk.restype = i
        lib.mrag_topk_scratch_elems.argtypes = [i, i, i]
        lib.mrag_topk_scratch_elems.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB, seconds


# vec_kind argument of mrag_masked_topk
_VEC_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(queries, vectors, penalty, min_sim, m, row_scales):
    if queries.dim() != 2 or vectors.dim() != 2 or queries.shape[1] != vectors.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and vectors "
                         f"{tuple(vectors.shape)} must be [B, D] and [C, D]")
    b, c = queries.shape[0], vectors.shape[0]
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if vectors.dtype not in _VEC_KIND:
        raise TypeError(f"vectors must be float32, bfloat16 or int8, got {vectors.dtype}")
    if row_scales is not None and (row_scales.dtype != torch.float32
                                   or tuple(row_scales.shape) != (c,)):
        raise ValueError("row_scales must be float32 [C]")
    if penalty.dtype != torch.float32 or tuple(penalty.shape) not in ((b, c), (c,)):
        raise ValueError(f"penalty must be float32 [B, C] or [C], got "
                         f"{penalty.dtype} {tuple(penalty.shape)}")
    if min_sim is not None and (min_sim.dtype != torch.float32
                                or tuple(min_sim.shape) != (b,)):
        raise ValueError("min_sim must be float32 [B]")
    if not 1 <= m <= min(c, MAX_M) or b < 1:
        raise ValueError(f"need 1 <= m <= min(C, {MAX_M}) and B >= 1 "
                         f"(m={m}, C={c}, B={b})")
    devices = {t.device for t in (queries, vectors, penalty, min_sim, row_scales)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def masked_topk(queries: torch.Tensor, vectors: torch.Tensor,
                penalty: torch.Tensor, min_sim: torch.Tensor | None,
                m: int, row_scales: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-m (see the module docstring). On CPU tensors the
    plain version; on CUDA tensors the Hopper kernel, launched on the
    current stream. Returns (vals [B, m] f32 descending, idx [B, m] int32)."""
    _check(queries, vectors, penalty, min_sim, m, row_scales)
    device = queries.device
    if device.type == "cpu":
        return masked_topk_reference(queries, vectors, penalty, min_sim, m, row_scales)
    if device.type != "cuda":
        raise ValueError(f"masked_topk runs on cpu or cuda tensors, not {device}")
    for name, t in (("queries", queries), ("vectors", vectors), ("penalty", penalty),
                    ("row_scales", row_scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.shape[1] % 4:
        raise ValueError(f"the kernel needs D % 4 == 0, got D={queries.shape[1]}")
    lib = _LIB or build_kernel()[0]
    b, d = queries.shape
    c = vectors.shape[0]
    if min_sim is None:
        min_sim = torch.full((b,), float("-inf"), dtype=torch.float32, device=device)
    min_sim = min_sim.contiguous()
    scratch = torch.empty((lib.mrag_topk_scratch_elems(b, c, m),),
                          dtype=torch.int64, device=device)
    vals = torch.empty((b, m), dtype=torch.float32, device=device)
    idx = torch.empty((b, m), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mrag_masked_topk(
            queries.data_ptr(), vectors.data_ptr(), _VEC_KIND[vectors.dtype],
            None if row_scales is None else row_scales.data_ptr(),
            penalty.data_ptr(), c if penalty.dim() == 2 else 0,
            min_sim.data_ptr(), b, c, d, m,
            scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"masked_topk kernel launch failed: CUDA error {rc}")
    masked_topk.launches += 1
    return vals, idx


masked_topk.launches = 0
