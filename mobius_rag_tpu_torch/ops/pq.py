"""Product quantization, the pq vector backend (the port of
``mobius_rag_tpu.ops.pq``).

Each row splits into M subvectors of ds = D/M dims; a row's code is one
byte per subvector, the nearest of K = 256 codewords (L2) of that
subspace's codebook. Scoring is inner-product ADC against per-query
lookup tables, LUT[m, j] = q_m · C[m, j]; with residual codes (IVFADC,
the default) the codes quantize x − centroid(x) and the search adds
q · centroid of the probed cluster.

- :func:`train_pq`: M independent Lloyd k-means problems on a row
  sample, batched over the subspaces.
- :func:`encode_pq` / :func:`_encode_block`: blockwise argmin codes.
- :class:`PackedPQ`: the codes in PackedIVF's cluster-contiguous layout
  (spill rows in synthetic always-probed slabs). ``from_ivf`` takes the
  rows as a tensor on the tables' device, or as the host int8 matrix of
  host residency (numpy): rows are then gathered on the host, uploaded
  raw and dequantized on the device.
- :func:`pq_search_packed`: probed masked top-k over the codes; the
  selection is the probe scans' seeded stable top-k
  (``index.ivf.seeded_topk``). :func:`pq_search_reranked`: ADC
  candidates, then an exact re-rank from host rows.
- :func:`pad_shard_pq` / :func:`stack_shard_pq`: per-shard tables on one
  common layout, for the sharded engine.

Random draws come from ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages train on the same rows. The JAX
package's products here are XLA ops outside any Pallas kernel; they are
torch ops here (TF32 off). Transients that scale with the subspace count
(the training distances, the encode distances, the LUT gathers) are
computed a group of subspaces or probes at a time: each subspace's and
each probe's result is independent of the others, so the grouping
changes no value.
"""
from __future__ import annotations

import numpy as np
import torch

from mobius_rag_tpu_torch.index.ivf import (_packed_dims, _slab_layout, _tensors, probe_cells,
                                            rehome_cells, seeded_topk, stack_tables)
from mobius_rag_tpu_torch.ops.quant import fill_cluster_packed
from mobius_rag_tpu_torch.ops.topk import NEG_INF, topk_stable

K_CODES = 256  # one byte per subvector
# Elements of one subspace group's [S, K] distance block in training and
# of one group's [B, m, K] block in encoding; of one probe group's code
# gather in the search.
_GROUP_ELEMS = 1 << 28
_LUT_ELEMS = 1 << 26
_TRAIN_SAMPLE = 100_000


def effective_m(d: int, m_requested: int) -> int:
    """The largest usable subvector count: the requested M when it divides
    D, else 16-dim (then 8, 4, 32, 2) subvectors."""
    if d % m_requested == 0:
        return m_requested
    for ds in (16, 8, 4, 32, 2):
        if d % ds == 0:
            return d // ds
    return 1


def _pq_kmeans(sub: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations, one problem per subspace: sub [M, S, ds] training
    subvectors, init [M, K, ds] → codebooks [M, K, ds] float32. Assignment
    by the dot trick (argmin of |c|² − 2 x·c, the first codeword on ties);
    an empty codeword keeps its value."""
    m, s, ds = sub.shape
    kk = init.shape[1]
    group = max(1, _GROUP_ELEMS // max(s * kk, 1))
    out = []
    for lo in range(0, m, group):
        x, c = sub[lo:lo + group].float(), init[lo:lo + group].float()
        g = x.shape[0]
        for _ in range(iters):
            c2 = (c * c).sum(dim=2)[:, None, :]
            assign = torch.argmin(c2 - 2.0 * torch.bmm(x, c.transpose(1, 2)), dim=2)
            sums = torch.zeros((g, kk, ds), dtype=torch.float32, device=x.device)
            sums.scatter_add_(1, assign[..., None].expand(g, s, ds), x)
            counts = torch.zeros((g, kk), dtype=torch.float32, device=x.device)
            counts.scatter_add_(1, assign, torch.ones_like(assign, dtype=torch.float32))
            c = torch.where(counts[..., None] > 0,
                            sums / torch.clamp(counts[..., None], min=1.0), c)
        out.append(c)
    return torch.cat(out)


def train_pq(vectors, m: int, *, iters: int = 12, sample: int = _TRAIN_SAMPLE,
             seed: int = 0) -> torch.Tensor:
    """PQ codebooks [M, K, ds] trained on a row sample of `vectors` [N, D]
    (a tensor, or numpy trained on the CPU). D must divide into m."""
    vectors = torch.as_tensor(vectors)
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    ds = d // m
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    x = vectors[torch.from_numpy(rows).to(vectors.device)].float()
    sub = x.reshape(-1, m, ds).transpose(0, 1)  # [M, S, ds]
    init_rows = rng.choice(sub.shape[1], size=K_CODES, replace=sub.shape[1] < K_CODES)
    init = sub[:, torch.from_numpy(init_rows).to(vectors.device)]
    return _pq_kmeans(sub, init, iters)


def _encode_block(block: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """block [B, D] float32 → codes [B, M] uint8 (argmin L2 per subvector)."""
    b = block.shape[0]
    m, kk, ds = codebooks.shape
    sub = block.reshape(b, m, ds)
    c2 = (codebooks * codebooks).sum(dim=2)[None]  # [1, M, K]
    group = max(1, _GROUP_ELEMS // max(b * kk, 1))
    codes = torch.empty((b, m), dtype=torch.uint8, device=block.device)
    for lo in range(0, m, group):
        dots = torch.einsum("bmd,mkd->bmk", sub[:, lo:lo + group], codebooks[lo:lo + group])
        codes[:, lo:lo + group] = torch.argmin(c2[:, lo:lo + group] - 2.0 * dots,
                                               dim=2).to(torch.uint8)
    return codes


def encode_pq(vectors, codebooks: torch.Tensor, *, block: int = 65536) -> np.ndarray:
    """[N, D] → [N, M] uint8 codes, encoded blockwise on the codebooks'
    device and assembled on the host."""
    vectors = torch.as_tensor(vectors)
    n = vectors.shape[0]
    out = np.empty((n, codebooks.shape[0]), np.uint8)
    for off in range(0, n, block):
        blk = vectors[off:off + block].to(codebooks.device).float()
        out[off:off + blk.shape[0]] = _encode_block(blk, codebooks).cpu().numpy()
    return out


class PackedPQ:
    """Cluster-contiguous PQ codes over an IVF layout (PackedIVF's block
    shape, with M-byte codes in place of D-byte int8 rows)."""

    FIELDS = ("centroids", "codes", "codebooks", "valid", "rowids")

    def __init__(self, centroids, codes, codebooks, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None,
                 residual: bool = True):
        self.centroids = centroids  # [nlist, D] f32
        self.codes = codes  # [nlist, pad, M] uint8
        self.codebooks = codebooks  # [M, K, ds] f32
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32
        self.nlist = int(nlist)
        self.pad = int(pad)
        self.base_nlist = int(base_nlist if base_nlist is not None else nlist)
        self.residual = bool(residual)  # codes quantize x − centroid(x)

    @property
    def aux(self) -> tuple[int, int, int, bool]:
        return (self.nlist, self.pad, self.base_nlist, self.residual)

    @property
    def bytes_per_row(self) -> int:
        return int(self.codes.shape[-1])

    @classmethod
    def from_numpy(cls, arrays: dict, aux, device) -> "PackedPQ":
        """Tables handed over as numpy arrays under the JAX package's field
        names and pytree aux (nlist, pad, base_nlist, residual)."""
        return cls(**_tensors(arrays, cls.FIELDS, device), nlist=aux[0], pad=aux[1],
                   base_nlist=aux[2], residual=aux[3])

    @classmethod
    def from_ivf(cls, ivf, vectors, *, m: int = 96, iters: int = 12, row_scales=None,
                 seed: int = 0, residual: bool = True, block: int = 65536) -> "PackedPQ":
        """Train codebooks and pack the codes cluster-contiguously, on the
        device of `ivf`'s tables. `vectors` [N, D] is a tensor there, or
        the host int8 matrix of host residency (numpy); `row_scales`
        dequantizes int8 rows. Spill rows fold into synthetic slabs whose
        centroids are their members' normalized mean. `block` bounds the
        slots encoded at once."""
        dev = ivf.centroids.device
        if isinstance(vectors, np.ndarray):
            host_rows = torch.from_numpy(vectors)
            host_scales = None if row_scales is None else np.asarray(row_scales)

            def rows_f32(idx: np.ndarray) -> torch.Tensor:
                idx = np.asarray(idx, np.int64)
                out = host_rows.index_select(0, torch.from_numpy(idx)).to(dev).float()
                if host_scales is not None:
                    out = out * torch.from_numpy(host_scales[idx]).to(dev)[:, None]
                return out
        else:
            scales = None if row_scales is None else torch.as_tensor(row_scales, device=dev)

            def rows_f32(idx: np.ndarray) -> torch.Tensor:
                ti = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
                out = vectors[ti].float()
                if scales is not None:
                    out = out * scales[ti][:, None]
                return out

        rowids, valid, spill, extra = _slab_layout(ivf)
        nlist, pad = ivf.nlist + extra, ivf.pad
        # every centroid, the spill slabs' included, before encoding: a
        # residual code needs its row's centroid
        cents = ivf.centroids.cpu().numpy().astype(np.float32)
        extra_cents = []
        for e in range(extra):
            mvec = rows_f32(spill[e * pad:(e + 1) * pad]).cpu().numpy().mean(axis=0)
            extra_cents.append(mvec / max(np.linalg.norm(mvec), 1e-6))
        if extra_cents:
            cents = np.concatenate([cents, np.stack(extra_cents)], axis=0)
        cents_dev = torch.from_numpy(np.ascontiguousarray(cents)).to(dev)
        valid_dev, rowids_dev = torch.from_numpy(valid).to(dev), torch.from_numpy(rowids).to(dev)

        flat = rowids.reshape(-1)
        flat_cell = np.repeat(np.arange(nlist), pad)
        flat_valid = valid.reshape(-1) > 0
        if not flat_valid.any():  # an empty (sub)corpus
            ds = vectors.shape[1] // m
            return cls(cents_dev, torch.zeros((nlist, pad, m), dtype=torch.uint8, device=dev),
                       torch.zeros((m, K_CODES, ds), dtype=torch.float32, device=dev),
                       valid_dev, rowids_dev, nlist, pad, base_nlist=ivf.nlist,
                       residual=residual)

        def encode_src(slots: np.ndarray) -> torch.Tensor:
            rows = rows_f32(flat[slots])
            if residual:
                rows = rows - cents_dev[torch.from_numpy(flat_cell[slots]).to(dev)]
            return rows

        rng = np.random.default_rng(seed)
        live_slots = np.flatnonzero(flat_valid)
        pick = np.sort(rng.choice(live_slots, size=min(_TRAIN_SAMPLE, len(live_slots)),
                                  replace=False))
        codebooks = train_pq(encode_src(pick), m, iters=iters, sample=len(pick), seed=seed)
        (codes,) = fill_cluster_packed(
            nlist, pad, lambda lo, hi: (_encode_block(encode_src(np.arange(lo, hi)),
                                                      codebooks),),
            (torch.uint8,), (m,), block=block)
        return cls(cents_dev, codes, codebooks, valid_dev, rowids_dev, nlist, pad,
                   base_nlist=ivf.nlist, residual=residual)


def pad_shard_pq(shards: "list[PackedPQ]") -> "list[PackedPQ]":
    """Each shard's PQ tables on the common layout of a shard stack (see
    ``index.ivf.pad_shard_packed``). Every shard keeps its own codebooks."""
    base, nlist, pad = _packed_dims(shards)
    m, residual = shards[0].codes.shape[-1], shards[0].residual
    out = []
    for sh in shards:
        if sh.residual != residual or sh.codes.shape[-1] != m:
            raise ValueError("shards disagree on the PQ code width or residual mode")
        nb = sh.base_nlist
        out.append(PackedPQ(rehome_cells(sh.centroids, nb, base, nlist),
                            rehome_cells(sh.codes, nb, base, nlist, pad), sh.codebooks,
                            rehome_cells(sh.valid, nb, base, nlist, pad),
                            rehome_cells(sh.rowids, nb, base, nlist, pad),
                            nlist, pad, base_nlist=base, residual=residual))
    return out


def stack_shard_pq(shards: "list[PackedPQ]") -> PackedPQ:
    """Per-shard PQ tables stacked along a leading shard axis (the JAX
    package's ``stack_shard_pq``)."""
    padded = pad_shard_pq(shards)
    p0 = padded[0]
    return stack_tables(padded, nlist=p0.nlist, pad=p0.pad, base_nlist=p0.base_nlist,
                        residual=p0.residual)


def pq_search_packed(ppq: PackedPQ, queries: torch.Tensor, penalty: torch.Tensor,
                     k: int, nprobe: int):
    """Probed masked top-k over the PQ codes (ADC). penalty indexes global
    row ids, [C] shared or [B, C] per query. A slot scores
    Σ_m LUT[m, code_m] (+ q·centroid of its cell when residual) + penalty
    + (1 − valid) · NEG_INF. Returns (scores [B, k] f32, row ids [B, k]
    int32)."""
    b = queries.shape[0]
    q32 = queries.float()
    if penalty.dim() == 1:
        penalty = penalty[None, :].expand(b, penalty.shape[0])
    m, kk, ds = ppq.codebooks.shape
    cscores, probe = probe_cells(q32, ppq.centroids, ppq.base_nlist, ppq.nlist, nprobe)
    lut = torch.einsum("bmd,mkd->bmk", q32.reshape(b, m, ds), ppq.codebooks).reshape(b, -1)
    code_base = torch.arange(m, device=q32.device) * kk
    n_probe, pad = probe.shape[1], ppq.pad
    group = max(1, _LUT_ELEMS // max(b * pad * m, 1))
    parts = []
    for lo in range(0, n_probe, group):
        pc = probe[:, lo:lo + group]  # [B, g]
        idx = ppq.codes[pc].long() + code_base  # [B, g, pad, M]
        s = torch.gather(lut, 1, idx.reshape(b, -1)).reshape(idx.shape).sum(dim=3)
        if ppq.residual:  # IVFADC: q·x ≈ q·centroid + q·residual
            s = s + torch.gather(cscores, 1, pc)[..., None]
        rid = ppq.rowids[pc]
        pen = torch.gather(penalty, 1, rid.reshape(b, -1).long()).reshape(rid.shape)
        parts.append(s + pen + (1.0 - ppq.valid[pc]) * NEG_INF)
    return seeded_topk(torch.cat(parts, dim=1).reshape(b, -1),
                       ppq.rowids[probe].reshape(b, -1), k)


def _rerank_scores(cand_vecs: torch.Tensor, cand_scales: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """[B, R, D] candidate rows (any type) x [B, D] queries → [B, R],
    times the rows' scales."""
    s = torch.einsum("brd,bd->br", cand_vecs.float(), queries.float())
    return s * cand_scales


def pq_search_reranked(ppq: PackedPQ, queries: torch.Tensor, penalty: torch.Tensor,
                       k: int, nprobe: int, host_vectors: np.ndarray,
                       host_scales: np.ndarray | None = None, over_fetch: int = 10):
    """Two-stage PQ search: the ADC top k·over_fetch on the device, then an
    exact re-rank of those candidates against their rows gathered from the
    host matrix (dead ADC candidates stay dead). Returns (scores [B, k],
    row ids [B, k] int32)."""
    dev = queries.device
    cand_vals, cand_idx = pq_search_packed(ppq, queries, penalty, k * over_fetch, nprobe)
    idx_np = cand_idx.cpu().numpy()
    scales = (host_scales[idx_np] if host_scales is not None
              else np.ones(idx_np.shape, np.float32))
    scores = _rerank_scores(torch.from_numpy(host_vectors[idx_np]).to(dev),
                            torch.from_numpy(np.asarray(scales, np.float32)).to(dev),
                            queries)
    scores = torch.where(cand_vals > NEG_INF / 2, scores, NEG_INF)
    vals, pos = topk_stable(scores, k)
    return vals, torch.gather(cand_idx, 1, pos).to(torch.int32)
