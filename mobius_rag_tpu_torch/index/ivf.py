"""IVF (inverted-file) index: coarse clustering and the probed scans (the
port of ``mobius_rag_tpu.index.ivf``).

k-means runs on the device as blockwise cosine Lloyd iterations; rows are
then placed by the capacity-constrained multi-choice pass into padded
member tables (cluster pad aligned to 512 slots), with a spill list for
rows no choice could take. Random draws come from ``numpy`` with the JAX
package's seed and draw order, so both packages start from the same rows.
``build_host`` clusters a host-resident int8 matrix (host residency):
k-means on an uploaded sample, then the assignment streams the matrix up
block by block, so the device never holds more than one block of it.

- :func:`ivf_search` (backend ``ivf``): the row-gather scan. Each query
  scores the rows of its probed clusters and the spill list, gathered
  from the chunk matrix and widened to float32, in chunks of queries that
  bound the gathered block.
- :class:`PackedIVF` + :func:`ivf_search_packed` (backend ``packed``):
  each cluster's rows re-quantized to int8 into one contiguous
  ``[pad, D]`` block (spill rows folded into synthetic always-probed
  slabs). The block dots are int8 x int8 summed exactly in int32, which is
  ``ops.proj_scan.proj_blocks`` at p = D (the Hopper proj kernel on a
  card); the epilogue and the selection follow the JAX package's order.
- :func:`calibrate_nprobe`: the smallest nprobe of a ladder whose
  recall@k against the exact scan clears a target (auto-nprobe).
- :func:`pad_shard_ivf`, :func:`pad_shard_packed` and their ``stack_shard_*``
  forms: per-shard tables on one common layout, for the sharded engine.

Both probed scans select as the JAX package's scan over probes does: its
carry starts as k (NEG_INF, row 0) seeds and every step keeps the stable
top-k of [carry ‖ block], which equals one stable top-k over [seeds ‖
probe 0 ‖ probe 1 ‖ …]. A gated slot scores exactly NEG_INF or less and
loses to the seeds, so where fewer than k rows are live the answer pads
with row 0 at NEG_INF.
"""
from __future__ import annotations

import numpy as np
import torch

from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks
from mobius_rag_tpu_torch.ops.quant import INV127, _quantize_block, fill_cluster_packed
from mobius_rag_tpu_torch.ops.topk import NEG_INF, merged_topk, topk_stable
from mobius_rag_tpu_torch.utils import round_up

# Row-block width of the assignment product: bounds the [block, nlist]
# score matrix and the block's float32 copy.
_KM_BLOCK = 131072
# Rows per stable sort in _topj_block: bounds the [rows, nlist] sort's
# values, int64 ids and scratch (12 GB for a 250,000-row block at nlist
# 4096 without it).
_TOPJ_ROWS = 32768
# Bytes of gathered rows (native type plus their float32 copy) one chunk
# of ivf_search's queries may hold: at 1M rows, nprobe 32 and pad 2,048 a
# query gathers 65,536 rows, so the whole batch at once would be ~20 GB.
_GATHER_BYTES = 1 << 31
# Exact-oracle rows per block in calibrate_nprobe.
_ORACLE_BLOCK = 131_072


def _tensors(arrays: dict, fields, device) -> dict:
    """numpy arrays by field name → tensors on `device` (copies)."""
    return {f: torch.from_numpy(np.array(arrays[f])).to(device) for f in fields}


def _aligned_pad(raw: int) -> int:
    """Cluster pad width: a multiple of 8, and of 512 once clusters are
    big. The member-table layout, and with it the proj tables and their
    saved files, depends on this alignment."""
    if raw > 512:
        return round_up(raw, 512)
    return max(8, round_up(raw, 8))


def _kmeans(vectors: torch.Tensor, init_idx: torch.Tensor, nlist: int,
            iters: int) -> torch.Tensor:
    """Blockwise Lloyd iterations on the vectors' device. vectors [N, D]
    L2-normalized (cosine k-means: assignment by max dot, the first
    centroid on ties; centroids re-normalized; an empty cell keeps its
    centroid). Returns the centroids [nlist, D] float32. The JAX version
    pads N to whole blocks and subtracts the zero rows' count again; this
    one walks the real rows only, which sums the same values."""
    n, d = vectors.shape
    dev = vectors.device
    centroids = vectors[init_idx.long()].float()
    for _ in range(iters):
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((nlist,), dtype=torch.float32, device=dev)
        for off in range(0, n, _KM_BLOCK):
            blk = vectors[off:off + _KM_BLOCK].float()
            a = torch.argmax(blk @ centroids.T, dim=1)
            sums.index_add_(0, a, blk)
            counts += torch.bincount(a, minlength=nlist).float()
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1.0), centroids)
        norm = torch.linalg.norm(new, dim=1, keepdim=True)
        centroids = new / torch.clamp(norm, min=1e-6)
    return centroids


def _topj_block(centroids: torch.Tensor, block: torch.Tensor, j: int):
    """Top-j nearest centroids per row of one block: ([B, j] scores, [B, j]
    ids), the lower centroid id first on ties. Rows go through in
    _TOPJ_ROWS pieces (a row's result does not depend on the others)."""
    vals = torch.empty((block.shape[0], j), dtype=torch.float32, device=block.device)
    idx = torch.empty((block.shape[0], j), dtype=torch.int32, device=block.device)
    for lo in range(0, block.shape[0], _TOPJ_ROWS):
        v, i = topk_stable(block[lo:lo + _TOPJ_ROWS].float() @ centroids.T, j)
        vals[lo:lo + _TOPJ_ROWS], idx[lo:lo + _TOPJ_ROWS] = v, i
    return vals, idx


def _capacity_assign(choice_idx: np.ndarray, choice_val: np.ndarray,
                     nlist: int, cap: int) -> np.ndarray:
    """Greedy capacity-constrained multi-choice placement (numpy, as in the
    JAX package). choice_idx/choice_val [N, J]: each row's J nearest
    centroids in descending affinity. Round j places still-pending rows
    into their j-th choice while that cluster has < cap members; within a
    round, rows with higher affinity win the remaining slots. Returns the
    final cell per row, -1 for rows unplaced after J rounds (the spill)."""
    n, j_max = choice_idx.shape
    cells = np.full(n, -1, np.int64)
    occ = np.zeros(nlist, np.int64)
    pending = np.arange(n)
    for j in range(j_max):
        if not len(pending):
            break
        c = choice_idx[pending, j].astype(np.int64)
        v = choice_val[pending, j]
        order = np.lexsort((-v, c))  # by cluster, best affinity first
        cs = c[order]
        slot = np.arange(len(cs)) - np.searchsorted(cs, cs, side="left")
        fits = (slot + occ[cs]) < cap
        cells[pending[order[fits]]] = cs[fits]
        occ += np.bincount(cs[fits], minlength=nlist)
        pending = pending[order[~fits]]
    return cells


def _fill_members(live_rows: np.ndarray, cells_live: np.ndarray, nlist: int,
                  pad: int):
    """Member tables from the capacity-assigned cells (occupancy <= pad by
    construction); rows with cell -1 go to the spill list every query
    scans. Returns numpy (members, member_valid, spill, spill_valid)."""
    placed = cells_live >= 0
    rows_p = live_rows[placed].astype(np.int64)
    cells_p = cells_live[placed]
    order = np.argsort(cells_p, kind="stable")
    rows_sorted = rows_p[order]
    cells = cells_p[order]
    slot = np.arange(len(cells)) - np.searchsorted(cells, cells, side="left")
    members = np.zeros((nlist, pad), np.int32)
    member_valid = np.zeros((nlist, pad), np.float32)
    members[cells, slot] = rows_sorted
    member_valid[cells, slot] = 1.0
    spill = live_rows[~placed].astype(np.int64)
    n_spill = round_up(max(len(spill), 1), 8)
    spill_arr = np.zeros(n_spill, np.int32)
    spill_val = np.zeros(n_spill, np.float32)
    spill_arr[: len(spill)] = spill
    spill_val[: len(spill)] = 1.0
    return members, member_valid, spill_arr, spill_val


class IVFIndex:
    """IVF tables over an existing chunk matrix, on its device."""

    FIELDS = ("centroids", "members", "member_valid", "spill", "spill_valid")

    def __init__(self, centroids, members, member_valid, spill, spill_valid,
                 nlist: int, pad: int):
        self.centroids = centroids  # [nlist, D] f32
        self.members = members  # [nlist, pad] i32 row ids (0 where invalid)
        self.member_valid = member_valid  # [nlist, pad] f32
        self.spill = spill  # [n_spill] i32 rows every query scans
        self.spill_valid = spill_valid  # [n_spill] f32
        self.nlist = int(nlist)
        self.pad = int(pad)

    @classmethod
    def build(cls, vectors: torch.Tensor, valid: np.ndarray | None = None, *,
              nlist: int | None = None, iters: int = 10, pad_factor: float = 2.0,
              seed: int = 0, choices: int = 16) -> "IVFIndex":
        """Cluster the rows of `vectors` [N, D] (on any device) whose
        `valid` > 0. nlist defaults to max(16, sqrt(live rows)); the
        k-means init rows are drawn by ``np.random.default_rng(seed)``
        exactly as the JAX package draws them."""
        n, d = vectors.shape
        dev = vectors.device
        valid_np = (np.asarray(valid) > 0) if valid is not None else np.ones(n, bool)
        n_live = int(valid_np.sum())
        nlist = nlist or max(16, int(np.sqrt(max(n_live, 1))))
        if n_live == 0:
            # empty (sub)corpus: zero centroids score 0, no members, no
            # spill — the probed scan returns nothing live
            nlist = max(int(nlist), 1)
            return cls(torch.zeros((nlist, d), dtype=torch.float32, device=dev),
                       torch.zeros((nlist, 8), dtype=torch.int32, device=dev),
                       torch.zeros((nlist, 8), dtype=torch.float32, device=dev),
                       torch.zeros((8,), dtype=torch.int32, device=dev),
                       torch.zeros((8,), dtype=torch.float32, device=dev),
                       nlist=nlist, pad=8)
        nlist = min(nlist, max(n_live, 1))

        rng = np.random.default_rng(seed)
        live_rows = np.flatnonzero(valid_np)
        init = rng.choice(live_rows, size=nlist, replace=n_live < nlist)
        centroids = _kmeans(vectors, torch.as_tensor(init, device=dev), nlist, iters)

        pad = _aligned_pad(int(pad_factor * max(n_live, 1) / nlist))
        j = int(min(choices, nlist))
        ch_v = np.empty((n, j), np.float32)
        ch_i = np.empty((n, j), np.int32)
        for off in range(0, n, _KM_BLOCK):
            vv, ii = _topj_block(centroids, vectors[off:off + _KM_BLOCK], j)
            ch_v[off:off + vv.shape[0]] = vv.cpu().numpy()
            ch_i[off:off + ii.shape[0]] = ii.cpu().numpy()
        cells_live = _capacity_assign(ch_i[live_rows], ch_v[live_rows], nlist, pad)
        members, member_valid, spill_arr, spill_val = _fill_members(
            live_rows, cells_live, nlist, pad)
        return cls(centroids, torch.from_numpy(members).to(dev),
                   torch.from_numpy(member_valid).to(dev),
                   torch.from_numpy(spill_arr).to(dev),
                   torch.from_numpy(spill_val).to(dev), nlist=nlist, pad=pad)

    @classmethod
    def build_host(cls, host_vectors: np.ndarray, host_scales: np.ndarray,
                   valid: np.ndarray | None = None, *, device, nlist: int | None = None,
                   iters: int = 10, pad_factor: float = 2.0, seed: int = 0,
                   sample: int = 500_000, block: int = 250_000,
                   choices: int = 16) -> "IVFIndex":
        """Cluster a host-resident int8 matrix [N, D] (with its per-row
        scales) on `device`: k-means on an uploaded, dequantized row
        sample, then the assignment streams the matrix up in `block`-row
        pieces. The sample and the k-means init come from
        ``np.random.default_rng(seed)`` in the JAX package's order (the
        sample rows, then ``init``). Peak device memory is the sample plus
        one block; host-to-device traffic is one pass over the int8 bytes
        (page-locked arrays upload asynchronously)."""
        n, d = host_vectors.shape
        dev = torch.device(device)
        valid_np = (np.asarray(valid) > 0) if valid is not None else np.ones(n, bool)
        n_live = int(valid_np.sum())
        nlist = nlist or max(16, int(np.sqrt(max(n_live, 1))))
        if n_live == 0:
            return cls.build(torch.zeros((8, d), dtype=torch.float32, device=dev),
                             np.zeros(8), nlist=nlist)
        nlist = min(nlist, n_live)
        rng = np.random.default_rng(seed)
        live_rows = np.flatnonzero(valid_np)
        pick = np.sort(rng.choice(live_rows, size=min(sample, n_live), replace=False))

        def up_f32(rows8: np.ndarray, scales: np.ndarray) -> torch.Tensor:
            v = torch.from_numpy(rows8).to(dev, non_blocking=True).float()
            return v * torch.from_numpy(scales).to(dev, non_blocking=True)[:, None]

        sv = up_f32(host_vectors[pick], host_scales[pick])
        init = rng.choice(len(pick), size=nlist, replace=len(pick) < nlist)
        centroids = _kmeans(sv, torch.as_tensor(init, device=dev), nlist, iters)
        del sv

        pad = _aligned_pad(int(pad_factor * max(n_live, 1) / nlist))
        j = int(min(choices, nlist))
        ch_v = np.empty((n, j), np.float32)
        ch_i = np.empty((n, j), np.int32)
        for off in range(0, n, block):
            hi = min(off + block, n)
            vv, ii = _topj_block(centroids, up_f32(host_vectors[off:hi],
                                                   host_scales[off:hi]), j)
            ch_v[off:hi] = vv.cpu().numpy()
            ch_i[off:hi] = ii.cpu().numpy()
        cells_live = _capacity_assign(ch_i[live_rows], ch_v[live_rows], nlist, pad)
        members, member_valid, spill_arr, spill_val = _fill_members(
            live_rows, cells_live, nlist, pad)
        return cls(centroids, torch.from_numpy(members).to(dev),
                   torch.from_numpy(member_valid).to(dev),
                   torch.from_numpy(spill_arr).to(dev),
                   torch.from_numpy(spill_val).to(dev), nlist=nlist, pad=pad)

    @property
    def spill_count(self) -> int:
        return int(self.spill_valid.sum().item())

    @property
    def aux(self) -> tuple[int, int]:
        return (self.nlist, self.pad)

    @classmethod
    def from_numpy(cls, arrays: dict, aux, device) -> "IVFIndex":
        """Tables handed over as numpy arrays under the JAX package's field
        names and pytree aux (nlist, pad): a ``jax.device_get`` of a JAX
        ``IVFIndex`` or an ``ann_io`` file."""
        return cls(**_tensors(arrays, cls.FIELDS, device), nlist=aux[0], pad=aux[1])


class PackedIVF:
    """Cluster-contiguous int8 rows (backend ``packed``): each cluster's
    members re-quantized per row into one ``[pad, D]`` block, with the
    row-id map back to global rows."""

    FIELDS = ("centroids", "values", "scales", "valid", "rowids")

    def __init__(self, centroids, values, scales, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None):
        self.centroids = centroids  # [nlist, D] f32
        self.values = values  # [nlist, pad, D] int8
        self.scales = scales  # [nlist, pad] f32
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32 global row ids
        self.nlist = int(nlist)
        self.pad = int(pad)
        # real (k-means) clusters; the cells past it are spill slabs every
        # query probes
        self.base_nlist = int(base_nlist if base_nlist is not None else nlist)

    @property
    def aux(self) -> tuple[int, int, int]:
        return (self.nlist, self.pad, self.base_nlist)

    @classmethod
    def from_numpy(cls, arrays: dict, aux, device) -> "PackedIVF":
        """Tables handed over as numpy arrays under the JAX package's field
        names and pytree aux (nlist, pad, base_nlist): a ``jax.device_get``
        of a JAX ``PackedIVF`` or an ``ann_io`` file."""
        return cls(**_tensors(arrays, cls.FIELDS, device), nlist=aux[0], pad=aux[1],
                   base_nlist=aux[2])

    @classmethod
    def from_ivf(cls, ivf: IVFIndex, vectors: torch.Tensor, *, row_scales=None,
                 block: int = 65536) -> "PackedIVF":
        """Quantize and pack the member rows of `ivf` (rows of `vectors`
        [N, D], on the tables' device). Spill rows fold into synthetic
        slabs whose centroids are their members' normalized mean. When the
        rows are already int8, pass their per-row scales as `row_scales`:
        re-quantizing int8 patterns gives scale ~1 and would drop the rows'
        magnitudes."""
        dev = ivf.centroids.device
        vectors = torch.as_tensor(vectors, device=dev)
        d = vectors.shape[1]
        rowids, valid, spill, extra = _slab_layout(ivf)
        nlist, pad = ivf.nlist + extra, ivf.pad
        flat_ids = torch.from_numpy(rowids.reshape(-1).astype(np.int64)).to(dev)
        scl = (torch.as_tensor(row_scales, dtype=torch.float32, device=dev)
               if row_scales is not None
               else torch.ones((vectors.shape[0],), dtype=torch.float32, device=dev))

        def quant_rows(lo: int, hi: int):
            rows = flat_ids[lo:hi]
            q, s = _quantize_block(vectors[rows])
            return q, s * scl[rows]

        values, scales = fill_cluster_packed(nlist, pad, quant_rows,
                                             (torch.int8, torch.float32), (d, 0),
                                             block=block)
        # the spill slabs' centroids: the mean of their raw rows (float32,
        # numpy's pairwise sum, as the JAX package takes it on the host)
        cents = ivf.centroids.cpu().numpy().astype(np.float32)
        extra_cents = []
        for e in range(extra):
            seg = torch.from_numpy(spill[e * pad:(e + 1) * pad].astype(np.int64)).to(dev)
            mvec = vectors[seg].float().cpu().numpy().mean(axis=0)
            extra_cents.append(mvec / max(np.linalg.norm(mvec), 1e-6))
        if extra_cents:
            cents = np.concatenate([cents, np.stack(extra_cents)], axis=0)
        return cls(torch.from_numpy(np.ascontiguousarray(cents)).to(dev), values, scales,
                   torch.from_numpy(valid).to(dev), torch.from_numpy(rowids).to(dev),
                   nlist, pad, base_nlist=ivf.nlist)


def _slab_layout(ivf: IVFIndex):
    """The packed tables' slot layout from an IVFIndex: (rowids, valid)
    [nlist + extra, pad] numpy with the spill rows folded into `extra`
    synthetic slabs after the k-means cells, the live spill rows, extra."""
    members = ivf.members.cpu().numpy()
    mvalid = ivf.member_valid.cpu().numpy()
    spill = ivf.spill.cpu().numpy()[ivf.spill_valid.cpu().numpy() > 0]
    pad = ivf.pad
    extra = int(np.ceil(len(spill) / pad)) if len(spill) else 0
    nlist = ivf.nlist + extra
    rowids = np.zeros((nlist, pad), np.int32)
    valid = np.zeros((nlist, pad), np.float32)
    rowids[: ivf.nlist] = members
    valid[: ivf.nlist] = mvalid
    for e in range(extra):
        seg = spill[e * pad:(e + 1) * pad]
        rowids[ivf.nlist + e, : len(seg)] = seg
        valid[ivf.nlist + e, : len(seg)] = 1.0
    return rowids, valid, spill, extra


def probe_cells(q32: torch.Tensor, centroids: torch.Tensor, base_nlist: int,
                nlist: int, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(centroid scores [B, nlist], probed cells [B, P] int64): the
    top-nprobe k-means cells (the lower cell first on ties), then every
    spill slab past ``base_nlist``."""
    b = q32.shape[0]
    cscores = q32 @ centroids.T
    _, probe = topk_stable(cscores[:, :base_nlist], min(nprobe, base_nlist))
    if nlist > base_nlist:
        spill_cells = torch.arange(base_nlist, nlist, device=probe.device)
        probe = torch.cat([probe, spill_cells[None, :].expand(b, nlist - base_nlist)], dim=1)
    return cscores, probe


def seeded_topk(scores: torch.Tensor, rowids: torch.Tensor, k: int):
    """The probe scans' selection: the stable top-k of [k (NEG_INF, row 0)
    seeds ‖ scores] over [B, S] scores and their row ids (see the module
    docstring). Returns (vals [B, k] f32, row ids [B, k] int32)."""
    b = scores.shape[0]
    vals = torch.cat([scores.new_full((b, k), NEG_INF), scores], dim=1)
    ids = torch.cat([rowids.new_zeros((b, k)), rowids], dim=1)
    v, pos = topk_stable(vals, k)
    return v, torch.gather(ids, 1, pos).to(torch.int32)


def ivf_search_packed(pivf: PackedIVF, queries: torch.Tensor, penalty: torch.Tensor,
                      k: int, nprobe: int):
    """Probed masked top-k over the packed int8 layout. penalty indexes
    global row ids, [C] shared or [B, C] per query. The query is quantized
    per row to int8; each probed block's dots are int8 x int8 summed in
    int32 (``proj_blocks``), then scaled: acc · row scale · query scale +
    penalty + (1 − valid) · NEG_INF, the JAX package's order. Returns
    (scores [B, k] f32, row ids [B, k] int32)."""
    b = queries.shape[0]
    q32 = queries.float()
    if penalty.dim() == 1:
        penalty = penalty[None, :].expand(b, penalty.shape[0])
    q_max = q32.abs().amax(dim=1)
    q_scale = torch.where(q_max > 0, q_max * INV127, torch.ones_like(q_max))
    q_int = torch.clamp(torch.round(q32 / q_scale[:, None]), -127, 127).to(torch.int8)
    _, probe = probe_cells(q32, pivf.centroids, pivf.base_nlist, pivf.nlist, nprobe)
    acc = proj_blocks(probe.to(torch.int32).contiguous(), pivf.values,
                      q_int.contiguous())  # [B, P, pad]
    sc, ok, rid = pivf.scales[probe], pivf.valid[probe], pivf.rowids[probe]
    pen = torch.gather(penalty, 1, rid.reshape(b, -1).long()).reshape(rid.shape)
    s = acc * sc * q_scale[:, None, None] + pen + (1.0 - ok) * NEG_INF
    return seeded_topk(s.reshape(b, -1), rid.reshape(b, -1), k)


def ivf_search(ivf: IVFIndex, vectors: torch.Tensor, queries: torch.Tensor,
               penalty: torch.Tensor, k: int, nprobe: int,
               row_scales: torch.Tensor | None = None):
    """Probed masked top-k over the chunk matrix itself: each query scores
    the rows of its nprobe nearest clusters and the spill list, gathered
    from `vectors` [C, D] (any type) and widened to float32, times
    `row_scales` for int8 rows, plus penalty ([C] or [B, C]), NEG_INF on
    invalid slots. Queries go through in chunks so the gathered rows stay
    within _GATHER_BYTES. Returns (scores [B, k] f32, row ids [B, k]
    int32), the lower candidate position first on ties."""
    b = queries.shape[0]
    q32 = queries.float()
    if penalty.dim() == 1:
        penalty = penalty[None, :].expand(b, penalty.shape[0])
    cscores = q32 @ ivf.centroids.T
    _, probe = topk_stable(cscores, min(nprobe, ivf.nlist))
    n_spill = ivf.spill.shape[0]
    cand = torch.cat([ivf.members[probe].reshape(b, -1),
                      ivf.spill[None, :].expand(b, n_spill)], dim=1)
    cand_ok = torch.cat([ivf.member_valid[probe].reshape(b, -1),
                         ivf.spill_valid[None, :].expand(b, n_spill)], dim=1)
    s_len, d = cand.shape[1], vectors.shape[1]
    step = max(1, _GATHER_BYTES // max(s_len * d * (vectors.element_size() + 4), 1))
    vals, idx = [], []
    for lo in range(0, b, step):
        rows = cand[lo:lo + step].long()
        s = torch.bmm(vectors[rows].float(), q32[lo:lo + step, :, None])[..., 0]
        if row_scales is not None:
            s = s * row_scales[rows]
        s = s + torch.gather(penalty[lo:lo + step], 1, rows) \
            + (1.0 - cand_ok[lo:lo + step]) * NEG_INF
        v, i = merged_topk(s, rows, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx).to(torch.int32)


_NPROBE_LADDER = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


def calibrate_nprobe(ann, vectors: torch.Tensor, queries, *, k: int = 10,
                     target_recall: float = 0.95, row_scales=None,
                     search_fn=None) -> dict:
    """Probe-until-recall calibration: the smallest ladder nprobe whose
    recall@k against the exact scan of the same matrix, on the given query
    sample, clears `target_recall` (the full probe when none does).
    Returns the pick and the whole curve. The exact oracle scans the
    matrix in blocks (no float32 copy of the whole corpus) and merges them
    on the host, first occurrence of a row kept, as the JAX package does."""
    dev = vectors.device
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    b, n = q.shape[0], vectors.shape[0]
    ob = min(_ORACLE_BLOCK, n)
    scl = (torch.as_tensor(row_scales, dtype=torch.float32, device=dev)
           if row_scales is not None else None)
    best_v = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    for lo in range(0, n, ob):
        lo_c = min(lo, n - ob)  # the tail block re-reads an overlap
        s = q @ vectors[lo_c:lo_c + ob].float().T
        if scl is not None:
            s = s * scl[lo_c:lo_c + ob][None, :]
        v, i = topk_stable(s, k)
        allv = np.concatenate([best_v, v.cpu().numpy()], axis=1)
        alli = np.concatenate([best_i, i.cpu().numpy().astype(np.int64) + lo_c], axis=1)
        order = np.argsort(-allv, axis=1)
        for qi in range(b):
            seen, vv, ii = set(), [], []
            for oi in order[qi]:
                row = alli[qi, oi]
                if row in seen:
                    continue
                seen.add(row)
                vv.append(allv[qi, oi])
                ii.append(row)
                if len(vv) == k:
                    break
            best_v[qi], best_i[qi] = vv, ii
    exact_sets = [set(map(int, row)) for row in best_i]
    penalty = torch.zeros((n,), dtype=torch.float32, device=dev)
    if search_fn is None:
        if isinstance(ann, IVFIndex):
            def search_fn(npx):
                return ivf_search(ann, vectors, q, penalty, k, npx, scl)
        else:
            def search_fn(npx):
                return ivf_search_packed(ann, q, penalty, k, npx)
    nlist = getattr(ann, "base_nlist", ann.nlist)
    curve = []
    chosen = None
    for npx in _NPROBE_LADDER:
        npx = min(npx, nlist)
        _, idx = search_fn(npx)
        recall = float(np.mean([len(exact_sets[i] & set(map(int, row))) / k
                                for i, row in enumerate(idx.cpu().numpy())]))
        curve.append({"nprobe": npx, "recall": round(recall, 4)})
        if recall >= target_recall and chosen is None:
            chosen = npx
        if npx >= nlist:
            break
    if chosen is None:  # the target is out of reach: the full probe
        chosen = min(_NPROBE_LADDER[-1], nlist)
    return {"nprobe": chosen, "target_recall": target_recall, "k": k,
            "sample_queries": b, "curve": curve}


# ---------------------------------------------------------------------------
# Per-shard tables (parallel/sharded.py)
# ---------------------------------------------------------------------------

def rehome_cells(t: torch.Tensor, nb: int, base: int, nlist: int,
                 pad: int | None = None) -> torch.Tensor:
    """A shard's per-cell table [n, ...] (or [n, sh_pad, ...] with ``pad``)
    on the common layout of a shard stack: zeros of [nlist(, pad), ...]
    with its first ``nb`` (k-means) cells at [0, nb) and its synthetic
    slabs re-homed at [base, base + n − nb)."""
    lead = (nlist,) if pad is None else (nlist, pad)
    out = t.new_zeros(lead + tuple(t.shape[len(lead):]))
    cols = slice(None) if pad is None else slice(0, t.shape[1])
    out[:nb, cols] = t[:nb]
    out[base:base + t.shape[0] - nb, cols] = t[nb:]
    return out


def stack_tables(padded: list, **aux):
    """Per-shard tables of one class, already on a common layout, stacked
    along a leading shard axis on the first shard's device."""
    cls = type(padded[0])
    dev = padded[0].centroids.device
    return cls(**{f: torch.stack([getattr(p, f).to(dev) for p in padded])
                  for f in cls.FIELDS}, **aux)


def pad_shard_ivf(shards: "list[IVFIndex]") -> "list[IVFIndex]":
    """Each shard's IVF tables padded to the shards' common (nlist, pad,
    spill length), on its own device: padded centroids are zero (score 0
    against any query, so a padded cell can take a probe from a real cell
    that scores below 0), padded member slots and spill entries invalid,
    so probing them returns NEG_INF, never a wrong row. The sharded scan
    serves the padded tables, as the JAX package's stacked tables do."""
    nlist = max(s.nlist for s in shards)
    pad = max(s.pad for s in shards)
    n_spill = max(s.spill.shape[0] for s in shards)
    out = []
    for sh in shards:
        c = rehome_cells(sh.centroids, sh.nlist, sh.nlist, nlist)
        m = rehome_cells(sh.members, sh.nlist, sh.nlist, nlist, pad)
        mv = rehome_cells(sh.member_valid, sh.nlist, sh.nlist, nlist, pad)
        sp = sh.spill.new_zeros(n_spill)
        sp[: sh.spill.shape[0]] = sh.spill
        sv = sh.spill_valid.new_zeros(n_spill)
        sv[: sh.spill_valid.shape[0]] = sh.spill_valid
        out.append(IVFIndex(c, m, mv, sp, sv, nlist=nlist, pad=pad))
    return out


def stack_shard_ivf(shards: "list[IVFIndex]") -> IVFIndex:
    """Per-shard IVF tables stacked along a leading shard axis, padded as
    :func:`pad_shard_ivf` pads them (the JAX package's ``stack_shard_ivf``)."""
    padded = pad_shard_ivf(shards)
    return stack_tables(padded, nlist=padded[0].nlist, pad=padded[0].pad)


def _packed_dims(shards) -> tuple[int, int, int]:
    """(base, nlist, pad) of a stack of packed tables: the largest k-means
    cell count, then room for the most synthetic slabs any shard has."""
    base = max(s.base_nlist for s in shards)
    extra = max(s.nlist - s.base_nlist for s in shards)
    return base, base + extra, max(s.pad for s in shards)


def pad_shard_packed(shards: "list[PackedIVF]") -> "list[PackedIVF]":
    """Each shard's packed tables on the common layout (see
    :func:`pad_shard_ivf`): base_nlist unifies to the largest, each shard's
    spill slabs move to [base, base + extra); cells a shard does not have
    are zero centroids over invalid slots."""
    base, nlist, pad = _packed_dims(shards)
    out = []
    for sh in shards:
        nb = sh.base_nlist
        out.append(PackedIVF(rehome_cells(sh.centroids, nb, base, nlist),
                             *(rehome_cells(getattr(sh, f), nb, base, nlist, pad)
                               for f in ("values", "scales", "valid", "rowids")),
                             nlist=nlist, pad=pad, base_nlist=base))
    return out


def stack_shard_packed(shards: "list[PackedIVF]") -> PackedIVF:
    """Per-shard packed tables stacked along a leading shard axis (the JAX
    package's ``stack_shard_packed``)."""
    padded = pad_shard_packed(shards)
    p0 = padded[0]
    return stack_tables(padded, nlist=p0.nlist, pad=p0.pad, base_nlist=p0.base_nlist)
