"""IVF (inverted-file) coarse clustering (the port of
``mobius_rag_tpu.index.ivf``: ``_aligned_pad``, ``_kmeans``,
``_topj_block``, ``_capacity_assign``, ``_fill_members``, ``IVFIndex``,
``IVFIndex.build`` and ``IVFIndex.build_host``).

k-means runs on the device as blockwise cosine Lloyd iterations; rows are
then placed by the capacity-constrained multi-choice pass into padded
member tables (cluster pad aligned to 512 slots), with a spill list for
rows no choice could take. Random draws come from ``numpy`` with the JAX
package's seed and draw order, so both packages start from the same rows.
``build_host`` clusters a host-resident int8 matrix (host residency):
k-means on an uploaded sample, then the assignment streams the matrix up
block by block, so the device never holds more than one block of it.

Not ported yet: ``PackedIVF``, ``ivf_search*``, ``calibrate_nprobe`` and
the shard stacking (ROADMAP queue 1, items 9 and 14).
"""
from __future__ import annotations

import numpy as np
import torch

from mobius_rag_tpu_torch.ops.topk import topk_stable
from mobius_rag_tpu_torch.utils import round_up

# Row-block width of the assignment product: bounds the [block, nlist]
# score matrix and the block's float32 copy.
_KM_BLOCK = 131072
# Rows per stable sort in _topj_block: bounds the [rows, nlist] sort's
# values, int64 ids and scratch (12 GB for a 250,000-row block at nlist
# 4096 without it).
_TOPJ_ROWS = 32768


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
