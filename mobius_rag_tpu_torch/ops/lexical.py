"""The sparse lexical arm under a dense gate: each query's postings
scatter-added in float64 and its stable top-m.

For a batch's union of hashed buckets ``buckets`` [U] and per-query IDF
weights ``weights`` [B, U] over the store's sparse postings (``cols``
[H, P] int32 rows, -1 a pad; ``wts`` [H, P] bfloat16):

    lex[b, r]   = Σ over u, j with cols[buckets[u], j] == r of
                  weights[b, u] · wts[buckets[u], j]   (float32 products,
                                                        summed in float64,
                                                        rounded once)
    score[b, r] = (lex[b, r] if lex[b, r] > 0 else NEG_INF) + penalty[b, r]

and the top-``m`` of each row of ``score``, descending, the lower row
first among equal scores (``lax.top_k``'s order). The JAX package runs it
as plain ``jnp`` (``mobius_rag_tpu/query/engine.py`` ``lexical_raw``); no
TPU kernel stands behind it.

- :func:`lexical_scores_reference` and :func:`lexical_topk_reference` are
  the plain PyTorch version: every product of the union, [B, U·P],
  ``index_add_`` into a [B, C + 1] float64 buffer, a stable sort of every
  row. The engine's CPU path and the tests use them.
- :func:`lexical_topk` dispatches on where the tensors lie: on the CPU the
  plain version, on a CUDA device the hand-written Hopper kernels
  (``ops/csrc/lexical.cu``: a scatter of the live (query, bucket) pairs'
  postings and a selection over the rows they touched) or it raises. It
  never falls back. ``lexical_topk.launches`` counts kernel launches.
- :func:`lexical_signals` reads the lexical score of any rows from what
  :func:`lexical_topk` returned (the signal of the three arms'
  candidates): a gather, on either device.

The penalty holds 0 and NEG_INF alone (``engine.gate_penalty``'s values).
"""
from __future__ import annotations

import ctypes
import os

import torch

from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, build_library, find_nvcc
from mobius_rag_tpu_torch.ops.topk import NEG_INF, topk_stable

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "lexical.cu")
_LIB: ctypes.CDLL | None = None


def lexical_scores_reference(weights: torch.Tensor, buckets: torch.Tensor,
                             cols: torch.Tensor, wts: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of the scores: [B, C] float32 (pads add into a column
    past C, dropped)."""
    buckets = buckets.long()
    cl = cols[buckets]  # [U, P]
    wl = wts[buckets]
    seg = torch.where(cl >= 0, cl, c).reshape(-1).long()
    vals = (weights[:, :, None] * wl[None].float()).reshape(weights.shape[0], -1)
    out = torch.zeros((vals.shape[0], c + 1), dtype=torch.float64, device=vals.device)
    return out.index_add_(1, seg, vals.double())[:, :c].float()


def lexical_topk_reference(weights: torch.Tensor, buckets: torch.Tensor, cols: torch.Tensor,
                           wts: torch.Tensor, penalty: torch.Tensor, m: int
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (vals [B, m] f32, idx [B, m] int64, lex [B, C] f32)."""
    lex = lexical_scores_reference(weights, buckets, cols, wts, penalty.shape[1])
    vals, idx = topk_stable(torch.where(lex > 0, lex, NEG_INF) + penalty, m)
    return vals, idx, lex


def build_kernel() -> tuple[ctypes.CDLL, float]:
    """Build (at first use) and load the kernel library. Returns (library,
    seconds spent compiling, 0.0 when it was already built)."""
    global _LIB
    path, seconds = build_library("mrag_lexical", [_SOURCE], find_nvcc(), NVCC_FLAGS)
    if _LIB is None:
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mrag_lex_topk.argtypes = [p, p, p, p, p, i, i, i, ll, i, p, p, p, ll, p, p, p]
        lib.mrag_lex_topk.restype = i
        _LIB = lib
    return _LIB, seconds


def _check(weights, buckets, cols, wts, penalty, m):
    if weights.dim() != 2 or buckets.dim() != 1 or buckets.shape[0] != weights.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} and buckets {tuple(buckets.shape)} "
                         "must be [B, U] and [U]")
    if cols.dim() != 2 or cols.shape != wts.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and wts {tuple(wts.shape)} must be [H, P]")
    if penalty.dim() != 2 or penalty.shape[0] != weights.shape[0]:
        raise ValueError(f"penalty {tuple(penalty.shape)} must be [B, C]")
    if (weights.dtype, cols.dtype, wts.dtype, penalty.dtype) != (
            torch.float32, torch.int32, torch.bfloat16, torch.float32):
        raise TypeError("weights and penalty must be float32, cols int32, wts bfloat16")
    if not 1 <= m <= penalty.shape[1]:
        raise ValueError(f"need 1 <= m <= C (m={m}, C={penalty.shape[1]})")
    devices = {t.device for t in (weights, buckets, cols, wts, penalty)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def lexical_topk(weights: torch.Tensor, buckets: torch.Tensor, cols: torch.Tensor,
                 wts: torch.Tensor, penalty: torch.Tensor, m: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lexical arm's top-m (see the module docstring). Returns (vals
    [B, m] f32 descending, idx [B, m] int64, scores): on CPU tensors the
    plain version, scores its [B, C] float32 lex; on CUDA tensors the
    Hopper kernels on the current stream, scores their [B, C] float64 sums
    (-0.0 where no posting landed). Read scores through
    :func:`lexical_signals`."""
    _check(weights, buckets, cols, wts, penalty, m)
    device = weights.device
    if device.type == "cpu":
        return lexical_topk_reference(weights, buckets, cols, wts, penalty, m)
    if device.type != "cuda":
        raise ValueError(f"lexical_topk runs on cpu or cuda tensors, not {device}")
    for name, t in (("weights", weights), ("cols", cols), ("wts", wts), ("penalty", penalty)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _LIB or build_kernel()[0]
    b, u = weights.shape
    p = cols.shape[1]
    c = penalty.shape[1]
    cap = min(c, u * p)
    buckets = buckets.to(torch.int32).contiguous()
    acc = torch.empty((b, c), dtype=torch.float64, device=device)
    touched = torch.empty((b, cap), dtype=torch.int64, device=device)
    counts = torch.empty((b,), dtype=torch.int32, device=device)
    vals = torch.empty((b, m), dtype=torch.float32, device=device)
    idx = torch.empty((b, m), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mrag_lex_topk(weights.data_ptr(), buckets.data_ptr(), cols.data_ptr(),
                               wts.data_ptr(), penalty.data_ptr(), b, u, p, c, m,
                               acc.data_ptr(), touched.data_ptr(), counts.data_ptr(), cap,
                               vals.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lexical_topk kernel launch failed: CUDA error {rc}")
    lexical_topk.launches += 1
    return vals, idx, acc


lexical_topk.launches = 0


def lexical_signals(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The lexical score of `rows` [B, n] (int64) from :func:`lexical_topk`'s
    scores: [B, n] float32, +0.0 where no posting landed (the kernels'
    untouched -0.0 plus +0.0), the plain version's bit for bit."""
    return torch.gather(scores, 1, rows).float() + 0.0
