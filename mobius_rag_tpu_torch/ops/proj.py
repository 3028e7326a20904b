"""Projected-residual int8 ANN codes, the proj vector backend (the port
of ``mobius_rag_tpu.ops.proj``):

    code(x)  = int8( P (x − centroid(x)) )          # P: [p, D] PCA rows
    score(q) ≈ q·centroid + (Pq) · dequant(code)    # one int8 dot per slot

- :class:`PackedProj`: cluster-contiguous codes over an IVF layout, with
  spill slabs (rows no cluster took) and empty reserved slabs (streaming
  inserts), both always probed. The projection is the top-p principal
  subspace of the coarse residuals (blockwise covariance, ``eigh``).
- :func:`proj_search_packed`: probed top-k under an additive [B, C]
  penalty (dense gating); its block dots are ``ops.proj_scan.proj_blocks``.
- :class:`ProjGate` + :func:`proj_search_gated`: the filter gate packed
  in the codes' cluster layout and evaluated on the probed blocks
  (candidate-local gating); ``ops.proj_scan.proj_gated_blocks``.
- :func:`scatter_slots`, :func:`invalidate_slots`, :func:`encode_reserved`:
  the in-place halves of the engine's incremental insert/delete path.
- :func:`pad_shard_proj` / :func:`stack_shard_proj`: per-shard tables on
  one common layout, for the sharded engine.

The probe selection, the int8 query projection and the final
``merged_topk`` are torch ops around the kernels, as the JAX package
computes them outside its Pallas kernels. Bitsets and gate words are
int32 bit patterns; every shift is masked (``>>`` on int32 is
arithmetic). Under host residency ``from_ivf`` gathers the rows from the
host int8 matrix, uploads them and dequantizes on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from mobius_rag_tpu_torch.index.ivf import (_packed_dims, _slab_layout, probe_cells,
                                            rehome_cells, stack_tables)
from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks, proj_gated_blocks
from mobius_rag_tpu_torch.ops.quant import INV127, fill_cluster_packed
from mobius_rag_tpu_torch.ops.topk import NEG_INF, merged_topk

# Fixed covariance blocking: the float32 summation order pins the eigh
# input, so the projection does not depend on the encode `block`.
_COV_BLOCK = 65536
_ANY16, _NONE16, _EMPTY16 = 0xFFFE, 0xFFFD, 0xFFFF
_VALID_BIT, _REG_BIT = 1 << 16, 1 << 17


class PackedProj:
    """Cluster-contiguous int8 projected-residual codes on one device."""

    FIELDS = ("centroids", "proj", "codes", "scales", "valid", "rowids")

    def __init__(self, centroids, proj, codes, scales, valid, rowids,
                 nlist: int, pad: int, base_nlist: int | None = None,
                 reserve_start: int | None = None):
        self.centroids = centroids  # [nlist, D] f32
        self.proj = proj  # [p, D] f32 orthonormal rows
        self.codes = codes  # [nlist, pad, p] int8
        self.scales = scales  # [nlist, pad] f32 dequant scales
        self.valid = valid  # [nlist, pad] f32
        self.rowids = rowids  # [nlist, pad] i32 global row ids
        self.nlist = int(nlist)
        self.pad = int(pad)
        self.base_nlist = int(base_nlist if base_nlist is not None else nlist)
        # first reserved (streaming-insert) slab; == nlist when none
        self.reserve_start = int(reserve_start if reserve_start is not None else nlist)
        # host mirrors of the slot layout (the engine's row → slot map)
        self.build_rowids: np.ndarray | None = None
        self.build_valid: np.ndarray | None = None

    @property
    def aux(self) -> tuple[int, int, int, int]:
        return (self.nlist, self.pad, self.base_nlist, self.reserve_start)

    @property
    def bytes_per_row(self) -> int:
        return int(self.codes.shape[-1])

    @classmethod
    def from_numpy(cls, arrays: dict, aux, device) -> "PackedProj":
        """Tables handed over as numpy arrays under the JAX package's field
        names and pytree aux (nlist, pad, base_nlist[, reserve_start]) —
        a ``jax.device_get`` of a JAX ``PackedProj`` or an ``ann_io``
        file. Sets the host slot mirrors, as the JAX ``load_ann`` does."""
        aux = tuple(int(a) for a in aux)
        tensors = {f: torch.from_numpy(np.array(arrays[f])).to(device) for f in cls.FIELDS}
        obj = cls(**tensors, nlist=aux[0], pad=aux[1], base_nlist=aux[2],
                  reserve_start=aux[3] if len(aux) > 3 else None)
        obj.build_rowids = np.array(arrays["rowids"], np.int32)
        obj.build_valid = np.array(arrays["valid"], np.float32)
        return obj

    @classmethod
    def from_ivf(cls, ivf, vectors, *, p: int = 256, row_scales=None,
                 sample: int = 200_000, seed: int = 0, block: int = 65536,
                 reserve_slabs: int = 0) -> "PackedProj":
        """Fit the residual PCA and encode every slot cluster-contiguously.
        `vectors` [N, D] is a tensor on the tables' device, or the host
        int8 matrix of host residency (numpy): its rows are gathered on
        the host, uploaded and dequantized on the device of the IVF
        tables. `row_scales` (a tensor, or numpy beside a host matrix)
        dequantizes int8 rows. Overflow (spill) rows fold into synthetic
        always-probed slabs; ``reserve_slabs`` appends that many empty
        always-probed slabs (zero centroid, valid 0) as streaming-insert
        headroom."""
        d = vectors.shape[1]
        p = int(min(p, d))
        if isinstance(vectors, np.ndarray):
            dev = ivf.centroids.device
            host_rows = torch.from_numpy(vectors)
            host_scales = None if row_scales is None else np.asarray(row_scales)

            def rows_f32(idx: np.ndarray) -> torch.Tensor:
                idx = np.asarray(idx)
                out = host_rows.index_select(0, torch.from_numpy(idx.astype(np.int64)))
                out = out.to(dev).float()
                if host_scales is not None:
                    out = out * torch.from_numpy(host_scales[idx]).to(dev)[:, None]
                return out
        else:
            dev = vectors.device

            def rows_f32(idx: np.ndarray) -> torch.Tensor:
                ti = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
                out = vectors[ti].float()
                if row_scales is not None:
                    out = out * row_scales[ti][:, None]
                return out

        rowids, valid, spill, extra = _slab_layout(ivf)
        pad = ivf.pad
        nlist = ivf.nlist + extra + reserve_slabs
        if reserve_slabs:
            rowids = np.concatenate([rowids, np.zeros((reserve_slabs, pad), np.int32)])
            valid = np.concatenate([valid, np.zeros((reserve_slabs, pad), np.float32)])

        cents = ivf.centroids.cpu().numpy().astype(np.float32)
        for e in range(extra):
            mvec = rows_f32(spill[e * pad:(e + 1) * pad]).mean(dim=0).cpu().numpy()
            cents = np.concatenate(
                [cents, (mvec / max(np.linalg.norm(mvec), 1e-6))[None]], axis=0)
        if reserve_slabs:
            # zero centroids: a reserved slot's code is the row's projection
            cents = np.concatenate([cents, np.zeros((reserve_slabs, d), np.float32)])
        cents_dev = torch.from_numpy(np.ascontiguousarray(cents)).to(dev)

        flat = rowids.reshape(-1)
        flat_cell = np.repeat(np.arange(nlist), pad)
        flat_valid = valid.reshape(-1) > 0
        valid_dev = torch.from_numpy(valid).to(dev)
        rowids_dev = torch.from_numpy(rowids).to(dev)

        def finish(proj, codes, scales):
            obj = cls(cents_dev, proj, codes, scales, valid_dev, rowids_dev, nlist, pad,
                      base_nlist=ivf.nlist, reserve_start=nlist - reserve_slabs)
            obj.build_rowids, obj.build_valid = rowids, valid
            return obj

        if not flat_valid.any():  # empty (sub)corpus
            return finish(torch.eye(p, d, dtype=torch.float32, device=dev),
                          torch.zeros((nlist, pad, p), dtype=torch.int8, device=dev),
                          torch.zeros((nlist, pad), dtype=torch.float32, device=dev))

        # ---- residual PCA: blockwise covariance, eigh on the device ----
        rng = np.random.default_rng(seed)
        live_slots = np.flatnonzero(flat_valid)
        pick = np.sort(rng.choice(live_slots, size=min(sample, len(live_slots)),
                                  replace=False))
        cov = torch.zeros((d, d), dtype=torch.float32, device=dev)
        for off in range(0, len(pick), _COV_BLOCK):
            sl = pick[off:off + _COV_BLOCK]
            r = rows_f32(flat[sl]) - cents_dev[torch.as_tensor(flat_cell[sl], device=dev)]
            cov = cov + r.T @ r
        _, evecs = torch.linalg.eigh(cov)  # ascending eigenvalues
        proj = evecs[:, -p:].T.contiguous()  # [p, D] top principal rows

        # ---- encode every slot into final-shape buffers ----
        def enc(lo: int, hi: int):
            sl = np.arange(lo, hi)
            r = rows_f32(flat[sl]) - cents_dev[torch.as_tensor(flat_cell[sl], device=dev)]
            return _quantize_projected(r @ proj.T)

        codes, scales = fill_cluster_packed(nlist, pad, enc, (torch.int8, torch.float32),
                                            (p, 0), block=block)
        return finish(proj, codes, scales)


def pad_shard_proj(shards: "list[PackedProj]") -> "list[PackedProj]":
    """Each shard's proj tables on the common layout of a shard stack (see
    ``index.ivf.pad_shard_packed``). Every shard keeps its own projection
    and centroids; the padded tables have no reserved slabs."""
    base, nlist, pad = _packed_dims(shards)
    p = shards[0].codes.shape[-1]
    out = []
    for sh in shards:
        if sh.codes.shape[-1] != p:
            raise ValueError("shards disagree on the projection width")
        nb = sh.base_nlist
        out.append(PackedProj(rehome_cells(sh.centroids, nb, base, nlist), sh.proj,
                              *(rehome_cells(getattr(sh, f), nb, base, nlist, pad)
                                for f in ("codes", "scales", "valid", "rowids")),
                              nlist=nlist, pad=pad, base_nlist=base))
    return out


def stack_shard_proj(shards: "list[PackedProj]") -> PackedProj:
    """Per-shard proj tables stacked along a leading shard axis (the JAX
    package's ``stack_shard_proj``)."""
    padded = pad_shard_proj(shards)
    p0 = padded[0]
    return stack_tables(padded, nlist=p0.nlist, pad=p0.pad, base_nlist=p0.base_nlist)


def _quantize_projected(pr: torch.Tensor):
    """Symmetric per-row int8 of projected rows [n, p] → (int8 [n, p],
    scales [n] f32): round half to even, as ``jnp.round``; the scale is
    the product with float32(1/127), as XLA computes ``mx / 127.0``."""
    mx = torch.clamp(pr.abs().amax(dim=1), min=1e-9)
    scale = mx * INV127
    return torch.round(pr / scale[:, None]).to(torch.int8), scale


# ---------------------------------------------------------------------------
# Incremental mutation (streaming publish/delete without a k-means rebuild).
# The engine owns the bookkeeping (row → slot map, reserved-slot cursor);
# these update the tables in place.
# ---------------------------------------------------------------------------

def scatter_slots(pp: PackedProj, cells: torch.Tensor, slots: torch.Tensor,
                  new_codes, new_scales, new_valid, new_rowids) -> None:
    """Write encoded rows into (cell, slot) positions, in place."""
    c, s = cells.long(), slots.long()
    pp.codes[c, s] = new_codes
    pp.scales[c, s] = new_scales
    pp.valid[c, s] = new_valid
    pp.rowids[c, s] = new_rowids


def invalidate_slots(pp: PackedProj, cells: torch.Tensor, slots: torch.Tensor) -> None:
    """Mask deleted rows' slots (codes stay; NEG_INF gating is enough)."""
    pp.valid[cells.long(), slots.long()] = 0.0


def encode_reserved(proj: torch.Tensor, rows_f32: torch.Tensor):
    """Encode rows for a reserved slab (zero centroid: the code is the
    projection of the row itself)."""
    return _quantize_projected(rows_f32 @ proj.T)


# ---------------------------------------------------------------------------
# Candidate-local gating: the filter gate in the codes' cluster layout
# ---------------------------------------------------------------------------

def gate_widths(tw: int) -> tuple[int, int]:
    """(full word count W, metadata+j prefix W01) of the slot-word array,
    both rounded up to multiples of 8 (the JAX package's layout). Word rows:
    0 payer|state · 1 program|flags · 2 scale (f32 bits) · 3 rowid ·
    4..4+tw j · 4+tw..4+2tw d · 4+2tw..4+3tw p · zero padding."""
    base = 4 + 3 * tw
    w = -(-base // 8) * 8
    w01 = min(w, -(-(4 + tw) // 8) * 8)
    return w, w01


def _enc16(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 0, _EMPTY16, v) & _EMPTY16


class ProjGate:
    """Cluster-layout eligibility pack for a PackedProj table: one
    word-major array ``words [nlist, W, pad]`` int32 (layout in
    :func:`gate_widths`). Word-major keeps a lane per slot reading
    consecutive addresses in the gated kernel, and the dequant scale and
    row id ride in the same pack."""

    def __init__(self, words: torch.Tensor, tw: int):
        self.words, self.tw = words, int(tw)

    @staticmethod
    def pack_rows(index, rows: torch.Tensor) -> torch.Tensor:
        """Per-row packed gate words [n, 2 + 3TW] int32 for `rows` of the
        DeviceIndex; rows outside [0, C) pack as invalid."""
        rid = rows.to(torch.long)
        c = index.valid.shape[0]
        safe = torch.clamp(rid, 0, c - 1)
        payer_raw = index.payer[safe]
        w0 = _enc16(payer_raw) | (_enc16(index.state[safe]) << 16)
        valid = (index.valid[safe] > 0) & (rid >= 0) & (rid < c)
        reg = (index.authority[safe] >= 0.999) & (payer_raw < 0)
        w1 = (_enc16(index.program[safe])
              | (valid.to(torch.int32) << 16) | (reg.to(torch.int32) << 17))
        return torch.cat([w0[:, None], w1[:, None], index.j_tags[safe],
                          index.d_tags[safe], index.p_tags[safe]], dim=1)

    @staticmethod
    def slot_words(packed: torch.Tensor, scales: torch.Tensor, rowids: torch.Tensor,
                   tw: int) -> torch.Tensor:
        """[n, W] slot words from pack_rows output, the per-slot dequant
        scales (float32 bits in word 2) and row ids (word 3)."""
        w, _ = gate_widths(tw)
        n = packed.shape[0]
        out = torch.cat([packed[:, :2],
                         scales.to(torch.float32).contiguous().view(torch.int32)[:, None],
                         rowids.to(torch.int32)[:, None], packed[:, 2:]], dim=1)
        if out.shape[1] < w:
            out = torch.cat([out, out.new_zeros((n, w - out.shape[1]))], dim=1)
        return out

    @classmethod
    def build(cls, pp: PackedProj, index) -> "ProjGate":
        tw = index.j_tags.shape[1]
        nlist, pad = pp.rowids.shape
        packed = cls.pack_rows(index, pp.rowids.reshape(-1))
        # slots without a live row carry valid=0 whatever row id they hold
        slot_ok = pp.valid.reshape(-1) > 0
        packed[:, 1] = torch.where(slot_ok, packed[:, 1], packed[:, 1] & ~_VALID_BIT)
        flat = cls.slot_words(packed, pp.scales.reshape(-1), pp.rowids.reshape(-1), tw)
        return cls(flat.reshape(nlist, pad, -1).transpose(1, 2).contiguous(), tw)

    def scatter(self, cells, slots, packed, scales, rowids) -> None:
        """Write freshly packed rows into (cell, slot) positions, in place
        (the engine's incremental insert path)."""
        vals = ProjGate.slot_words(packed, scales, rowids, self.tw)
        self.words[cells.long(), :, slots.long()] = vals

    def invalidate(self, cells, slots) -> None:
        c, s = cells.long(), slots.long()
        self.words[c, 1, s] = self.words[c, 1, s] & ~_VALID_BIT


def encode_qmeta(q: dict, strict_ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query gate parameters: qmeta [B, 8] int32 (payer, state,
    program, tag_mode, strict_ok, inherit, has_j, has_dp) and qbits
    [B, 3TW] int32 (the j/d/p bitset words, already int32 bit patterns).
    Metadata ids re-encode into the pack's u16 space: -1 "any" → 0xFFFE,
    -2 "unknown value, match nothing" → 0xFFFD, both distinct from the
    slot-side 0xFFFF "no value". has_j/has_dp test for any set bit, as the
    port's dense filter gate does."""

    def enc(col):
        v = q[col].to(torch.int32)
        return torch.where(v == -1, _ANY16, torch.where(v < 0, _NONE16, v))

    has_j = (q["j_bits"] != 0).any(dim=1)
    has_dp = (q["d_bits"] != 0).any(dim=1) | (q["p_bits"] != 0).any(dim=1)
    qmeta = torch.stack([
        enc("payer"), enc("state"), enc("program"),
        q["tag_mode"].to(torch.int32), strict_ok.to(torch.int32),
        (q["inherit_authority"] > 0).to(torch.int32),
        has_j.to(torch.int32), has_dp.to(torch.int32)], dim=1)
    qbits = torch.cat([q["j_bits"], q["d_bits"], q["p_bits"]], dim=1).to(torch.int32)
    return qmeta.contiguous(), qbits.contiguous()


def meta_ok_from_words(meta_blk: torch.Tensor, qmeta: torch.Tensor):
    """Metadata eligibility from packed gate words: meta_blk [B or 1, S, 2]
    int32 against qmeta [B, 8] → (meta_ok, valid) bool, broadcast [B, S]."""
    e0, e1 = meta_blk[..., 0], meta_blk[..., 1]
    payer, state = e0 & 0xFFFF, (e0 >> 16) & 0xFFFF
    program = e1 & 0xFFFF
    valid = ((e1 >> 16) & 1) > 0
    reg = ((e1 >> 17) & 1) > 0
    qp, qs, qg = qmeta[:, 0:1], qmeta[:, 1:2], qmeta[:, 2:3]
    inherit = qmeta[:, 5:6] > 0
    ok = (((qp == _ANY16) | (payer == qp) | (inherit & reg))
          & ((qs == _ANY16) | (state == qs))
          & ((qg == _ANY16) | (program == qg)))
    return ok, valid


def _gate_blocks_xla(meta_blk, jw_blk, dpw_blk, qmeta, qbits, tw: int,
                     tag_level: int) -> torch.Tensor:
    """The plain gate (``mobius_rag_tpu.ops.proj._gate_blocks_xla``): meta
    [B, S, 2] (+ j words [B, S, TW], d/p words [B, S, 2TW]) → bool [B, S].
    Shared by the gated kernel's plain version and the candidate-local
    lexical and d-tag arms, so every consumer computes the same gate."""
    ok, valid = meta_ok_from_words(meta_blk, qmeta)
    tm = qmeta[:, 3:4]
    strict_ok = qmeta[:, 4:5] > 0
    has_j, has_dp = qmeta[:, 6:7] > 0, qmeta[:, 7:8] > 0
    strict = valid & ok
    relaxed = valid & ok
    if tag_level >= 1:
        j_ov = torch.zeros_like(valid)
        for w in range(tw):
            j_ov = j_ov | ((jw_blk[..., w] & qbits[:, w:w + 1]) != 0)
        strict = strict & (j_ov | ~has_j)
    if tag_level >= 2:
        dp_ov = torch.zeros_like(valid)
        for w in range(tw):
            dp_ov = dp_ov | ((dpw_blk[..., w] & qbits[:, tw + w:tw + w + 1]) != 0)
            dp_ov = dp_ov | ((dpw_blk[..., tw + w] & qbits[:, 2 * tw + w:2 * tw + w + 1]) != 0)
        relaxed = relaxed & (dp_ov | ~has_dp)
    auto = torch.where(strict_ok, strict, strict | relaxed)
    return torch.where(tm == 0, auto, torch.where(tm == 1, relaxed, valid))


# ---------------------------------------------------------------------------
# Probed searches
# ---------------------------------------------------------------------------

def _probe_and_quantize(pp: PackedProj, queries: torch.Tensor, nprobe: int):
    """Centroid scores [B, nlist], probed cells [B, P] int32 (top-nprobe
    base cells, lower id first on ties, then every spill and reserved
    slab), the int8 query projection [B, p] and its scales [B]."""
    q32 = queries.float()
    cscores, probe = probe_cells(q32, pp.centroids, pp.base_nlist, pp.nlist, nprobe)
    qp = q32 @ pp.proj.T
    q_scale = torch.clamp(qp.abs().amax(dim=1), min=1e-9) * INV127
    q8 = torch.round(qp / q_scale[:, None]).to(torch.int8)
    return cscores, probe.to(torch.int32).contiguous(), q8.contiguous(), q_scale


def proj_search_packed(pp: PackedProj, queries: torch.Tensor, penalty: torch.Tensor,
                       k: int, nprobe: int, approx: float = 0.0):
    """Probed masked top-k over the projected-residual codes. penalty
    indexes global row ids, [C] shared or [B, C] per query. Returns
    (scores [B, k], row ids [B, k] int32); scores approximate cosine for
    eligible rows."""
    b = queries.shape[0]
    if penalty.dim() == 1:
        penalty = penalty[None, :].expand(b, penalty.shape[0])
    cscores, probe, q8, q_scale = _probe_and_quantize(pp, queries, nprobe)
    raw = proj_blocks(probe, pp.codes, q8)  # [B, P, pad]
    pl = probe.long()
    sc, ok, rid = pp.scales[pl], pp.valid[pl], pp.rowids[pl]
    cs = torch.gather(cscores, 1, pl)
    pen = torch.gather(penalty, 1, rid.reshape(b, -1).long()).reshape(rid.shape)
    s = (raw * sc * q_scale[:, None, None] + cs[..., None] + pen
         + (1.0 - ok) * NEG_INF)
    nv, ni = merged_topk(s.reshape(b, -1), rid.reshape(b, -1), k, approx)
    return nv, ni.to(torch.int32)


def proj_search_gated(pp: PackedProj, gate_words: torch.Tensor, queries: torch.Tensor,
                      qmeta: torch.Tensor, qbits: torch.Tensor, k: int, nprobe: int,
                      approx: float = 0.0, tag_level: int = 2, tw: int = 8):
    """Probed top-k with the filter gate evaluated on the streamed cluster
    blocks: the [B, C]-free form of :func:`proj_search_packed`.
    ``gate_words`` is ``ProjGate.words``; qmeta/qbits from
    :func:`encode_qmeta` (strict_ok folded in); ``tag_level`` bounds the
    gate word rows read (0/1: metadata + j words, 2: all)."""
    b = queries.shape[0]
    cscores, probe, q8, q_scale = _probe_and_quantize(pp, queries, nprobe)
    gated, rid = proj_gated_blocks(probe, qmeta, qbits, pp.codes, gate_words, q8,
                                   tw=tw, tag_level=tag_level)
    cs = torch.gather(cscores, 1, probe.long())
    s = torch.where(gated > NEG_INF / 2,
                    gated * q_scale[:, None, None] + cs[..., None], NEG_INF)
    nv, ni = merged_topk(s.reshape(b, -1), rid.reshape(b, -1), k, approx)
    return nv, ni.to(torch.int32)
