"""Cluster-packed table fill (the port of
``mobius_rag_tpu.ops.quant.fill_cluster_packed``). ``quantize_rows`` and
``cosine_topk_int8`` wait for int8 row storage (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


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
