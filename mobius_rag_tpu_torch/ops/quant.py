"""int8 row quantization and the cluster-packed table fill (the port of
``mobius_rag_tpu.ops.quant``).

- :func:`quantize_rows` (through :func:`_quantize_block`): symmetric
  per-row max-abs int8, ``scale = max_abs / 127`` (1.0 for a zero row),
  the row DIVIDED by its scale, rounded half to even, clipped to ±127 —
  the JAX package's arithmetic step for step, so both give the same int8
  values and scales bit for bit. XLA rewrites a division by the constant
  127 into a product with its float32 reciprocal (``INV127``), so the
  scale is that product here too; the division by the scale stays a
  division.
- :func:`cosine_topk_int8`: the masked top-k over an int8 matrix with an
  int8-quantized query. The JAX package's is an XLA function off the
  engine's path (only its tests call it); this is its plain torch form.
- :func:`fill_cluster_packed`: blockwise encode into final-shape buffers.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from mobius_rag_tpu_torch.ops.topk import topk_stable


def fill_cluster_packed(nlist: int, pad: int,
                        enc: Callable[[int, int], Sequence[torch.Tensor]],
                        out_dtypes: Sequence[torch.dtype], out_widths: Sequence[int],
                        *, block: int = 65536) -> tuple[torch.Tensor, ...]:
    """Encode all ``nlist*pad`` cluster slots blockwise into preallocated
    final-shape buffers, so the peak is one buffer plus one block.

    ``enc(lo, hi)`` returns one tensor per output for flat slots [lo, hi)
    (shape [hi-lo, w], or [hi-lo] when the width is 0 → a per-slot
    [nlist, pad] output). Blocks are pad-aligned and exactly ``cpb*pad``
    wide; when ``cpb`` does not divide ``nlist`` the final block shifts
    back to overlap the previous one, so ``enc`` must be deterministic —
    the JAX package's blocking, kept so both fill the same slots."""
    cpb = max(1, min(nlist, block // max(pad, 1)))

    def buf_shape(w):
        return (nlist, pad) if w == 0 else (nlist, pad, w)

    if nlist <= cpb:  # small corpus: a single encode
        outs = enc(0, nlist * pad)
        return tuple(o.reshape(buf_shape(w)).to(dt)
                     for o, w, dt in zip(outs, out_widths, out_dtypes))
    bufs = None
    for c in range(0, nlist, cpb):
        c = min(c, nlist - cpb)  # final partial block: shift back
        blks = enc(c * pad, (c + cpb) * pad)
        if bufs is None:
            bufs = tuple(torch.zeros(buf_shape(w), dtype=dt, device=blk.device)
                         for w, dt, blk in zip(out_widths, out_dtypes, blks))
        for buf, blk in zip(bufs, blks):
            buf[c:c + cpb].copy_(blk.reshape((cpb,) + buf.shape[1:]))
    return bufs


# float32(1/127): what XLA multiplies by for `x / 127.0`.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_block(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, D] any float → (int8 [n, D], scales [n] f32)."""
    v32 = v.float()
    max_abs = v32.abs().amax(dim=1)
    scale = torch.where(max_abs > 0, max_abs * INV127, torch.ones_like(max_abs))
    q = torch.clamp(torch.round(v32 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(vectors: torch.Tensor, *, block: int = 131072
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float → (int8 values [N, D], per-row scales [N] f32), on the
    tensor's device, in row blocks so the transient float32 copy stays
    one block."""
    n = vectors.shape[0]
    if n <= block:
        return _quantize_block(vectors)
    q = torch.empty(vectors.shape, dtype=torch.int8, device=vectors.device)
    s = torch.empty((n,), dtype=torch.float32, device=vectors.device)
    for off in range(0, n, block):
        q[off:off + block], s[off:off + block] = _quantize_block(vectors[off:off + block])
    return q, s


def cosine_topk_int8(values: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                     penalty: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over an int8 matrix: scores[b, n] = (q8[b] · values[n])
    · q_scale[b] · scales[n] + penalty[n], with the query quantized like a
    row. The int8 products are summed exactly in float64 (|sum| ≤ 127²·D,
    far below 2^53), then rounded once to float32, as the JAX package
    converts its int32 sum. Returns
    (vals [B, k] f32, idx [B, k] int32), the lower row first on ties."""
    qv = queries.float()
    q_max = qv.abs().amax(dim=1)
    q_scale = torch.where(q_max > 0, q_max * INV127, torch.ones_like(q_max))
    q_int = torch.clamp(torch.round(qv / q_scale[:, None]), -127, 127)
    acc = (q_int.double() @ values.double().T).float()  # [B, N], exact sums
    scores = acc * q_scale[:, None] * scales[None, :] + penalty[None, :]
    vals, idx = topk_stable(scores, k)
    return vals, idx.to(torch.int32)
