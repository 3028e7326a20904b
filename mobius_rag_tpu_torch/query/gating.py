"""Candidate-local filter gating and arm scans (the port of
``mobius_rag_tpu.query.gating``): the [B, C]-free form of the hybrid
query program, for the proj backend under ``MRAG_GATING=local``.

- :func:`strict_counts`: the one corpus-wide pass that remains (the
  auto-relax branch needs the global strict-eligible count); exact counts.
- :func:`lexical_candidates_local`: scores only the rows in the query
  buckets' postings, gates them through the packed-word gate
  (``ops.proj._gate_blocks_xla``) and selects in postings space.
- :class:`DTagPostings` + :func:`dtag_candidates_local`: a per-tag,
  authority-ranked inverted index with the metadata gate words packed next
  to the postings.
- :func:`lex_signal_join`: the lexical signal of the other arms'
  candidates by id-join against the lexical arm's list (0 outside it —
  the JAX package's documented contract).

Every sort is stable (``jnp.argsort`` and ``lax.top_k`` keep the lower
position first; ``torch.argsort`` does only when asked), so positions tie
as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from mobius_rag_tpu_torch.ops.proj import ProjGate, _gate_blocks_xla, meta_ok_from_words
from mobius_rag_tpu_torch.ops.topk import NEG_INF, topk_stable

MAX_QUERY_DTAGS = 16
_INT32_MAX = 2**31 - 1
# Rows per block of the strict count: bounds the [B, block] transients.
_COUNT_BLOCK = 262_144
# Tags per block of the d-tag postings build: bounds the [tags, C] scores.
_DTAG_BLOCK = 16


def query_dtag_ids(tag_ids: list[int], tag_words: int) -> np.ndarray:
    """The first MAX_QUERY_DTAGS in-range d-tag ids of a query, -1
    padded (prepare_query attaches this as q["d_tag_ids"] for the
    candidate-local d-tag arm)."""
    out = np.full(MAX_QUERY_DTAGS, -1, np.int32)
    keep = [t for t in tag_ids if 0 <= t < tag_words * 32]
    out[: min(len(keep), MAX_QUERY_DTAGS)] = keep[:MAX_QUERY_DTAGS]
    return out


def batch_tag_level(q_np: dict) -> int:
    """How many gate word rows a prepared batch needs (host side): 0 = no
    query carries tag bits, 1 = j bits only, 2 = d/p bits present."""
    if np.asarray(q_np["d_bits"]).any() or np.asarray(q_np["p_bits"]).any():
        return 2
    return 1 if np.asarray(q_np["j_bits"]).any() else 0


def _strict_block(valid, payer, state, program, authority, j_tags, q) -> torch.Tensor:
    """The strict mask over one row block: [B, S] bool (filter_masks'
    strict semantics)."""

    def col_match(col, want):  # [S] vs [B] → [B, S]
        return (want[:, None] == -1) | (col[None, :] == want[:, None])

    regulator = (authority[None, :] >= 0.999) & (payer[None, :] < 0)
    payer_ok = col_match(payer, q["payer"]) | ((q["inherit_authority"][:, None] > 0)
                                               & regulator)
    meta_ok = payer_ok & col_match(state, q["state"]) & col_match(program, q["program"])
    j_ov = torch.zeros_like(meta_ok)
    for w in range(j_tags.shape[1]):
        j_ov |= (j_tags[None, :, w] & q["j_bits"][:, w:w + 1]) != 0
    has_j = (q["j_bits"] != 0).any(dim=1)[:, None]
    return (valid[None, :] > 0) & meta_ok & (j_ov | ~has_j)


def strict_counts(index, q: dict) -> torch.Tensor:
    """Global strict-eligible row count per query [B] float32, without a
    [B, C] buffer (row blocks of _COUNT_BLOCK). A count of exact boolean
    conditions: equal to filter_masks' strict.sum(axis=1)."""
    c = index.valid.shape[0]
    total = torch.zeros(q["payer"].shape[0], dtype=torch.int64, device=index.valid.device)
    for lo in range(0, c, _COUNT_BLOCK):
        sl = slice(lo, lo + _COUNT_BLOCK)
        total += _strict_block(index.valid[sl], index.payer[sl], index.state[sl],
                               index.program[sl], index.authority[sl], index.j_tags[sl],
                               q).sum(dim=1)
    return total.to(torch.float32)


def rows_gate(index, qmeta, qbits, rows: torch.Tensor, tag_level: int) -> torch.Tensor:
    """Full gate (strict/relaxed/auto + tag_mode) for row ids: rows [S]
    (shared by the batch) or [B, S] → bool [B, S]. Rows outside [0, C)
    gate False."""
    packed = ProjGate.pack_rows(index, rows.reshape(-1))  # [n, 2+3TW]
    tw = index.j_tags.shape[1]
    lead = tuple(rows.shape)  # explicit widths: rows may be empty (no buckets)
    meta = packed[:, :2].reshape(lead + (2,))
    jw = packed[:, 2:2 + tw].reshape(lead + (tw,))
    dpw = packed[:, 2 + tw:].reshape(lead + (2 * tw,))
    if rows.dim() == 1:  # shared rows: broadcast over the batch
        meta, jw, dpw = meta[None], jw[None], dpw[None]
    return _gate_blocks_xla(meta, jw, dpw, qmeta, qbits, tw, tag_level)


def _pad_to(vals, idx, m):
    b, s = vals.shape
    if m <= s:
        return vals, idx
    return (torch.cat([vals, vals.new_full((b, m - s), NEG_INF)], dim=1),
            torch.cat([idx, idx.new_zeros((b, m - s))], dim=1))


def _lex_best(vals):
    return torch.where(vals > NEG_INF / 2, vals, 0.0).amax(dim=1)


def lexical_candidates_local(index, q: dict, qmeta, qbits, m: int, tag_level: int):
    """Lexical arm over the postings union only. Returns (vals [B, m],
    idx [B, m] int32, lex_best [B]) with the dense arm's semantics: score
    = Σ_buckets weight·posting; rows with score <= 0 or failing the gate
    are NEG_INF; lex_best = the best live score (the rerank normalizer).
    Each row's postings are summed in float64 (``index_add_``), so the
    float32 score is the exactly rounded sum whatever order the device's
    atomics take, and equals the dense path's (engine.lexical_raw)."""
    lw = q["lex_weights"]
    c = index.valid.shape[0]
    dev = index.valid.device
    if "lex_cols" not in index.fields:
        # dense [H, C] layout: nothing bounds the candidates, so score
        # densely and gate every row (reachable only when local gating is
        # forced on a dense-lexical corpus)
        from mobius_rag_tpu_torch.query.engine import lexical_raw

        lraw = lexical_raw(index, q)
        gate = rows_gate(index, qmeta, qbits, torch.arange(c, device=dev), tag_level)
        scores = torch.where((lraw > 0) & gate, lraw, NEG_INF)
        vals, idx = _pad_to(*topk_stable(scores, min(m, c)), m)
        return vals, idx.to(torch.int32), _lex_best(vals)
    buckets = q["lex_buckets"].long()
    cols = index.lex_cols[buckets]  # [U, P]
    wts = index.lex_wts[buckets]
    b = lw.shape[0]
    s = cols.numel()
    ids = torch.where(cols.reshape(-1) < 0, c, cols.reshape(-1)).long()  # pads → c
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]  # grouped by row id, pads last
    contrib = (lw[:, :, None] * wts[None].float()).reshape(b, s)
    contrib_s = contrib[:, order]
    first = torch.ones(s, dtype=torch.bool, device=dev)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1  # group index per posting
    scores = torch.zeros((b, s), dtype=torch.float64, device=dev).index_add_(
        1, seg, contrib_s.double()).float()
    # representative row per group; groups past the last hold c (dead).
    # A scatter, not a boolean-mask index, so the device never reports a
    # count to the host: repeats write the dead id c to a spare slot s.
    grows = torch.full((s + 1,), c, dtype=torch.int64, device=dev)
    grows.scatter_(0, torch.where(first, seg, s), torch.where(first, ids_s, c))
    grows = grows[:s]
    live = grows < c
    gate = rows_gate(index, qmeta, qbits, torch.clamp(grows, max=c - 1), tag_level)
    lex_scores = torch.where(live[None, :] & (scores > 0) & gate, scores, NEG_INF)
    vals, pos = topk_stable(lex_scores, min(m, s))
    # dead positions may name row c; clamp so later gathers stay in range
    idx = torch.clamp(grows[pos], max=c - 1)
    vals, idx = _pad_to(vals, idx, m)
    return vals, idx.to(torch.int32), _lex_best(vals)


class DTagPostings:
    """Authority-ranked per-tag row lists with the metadata gate words
    packed alongside: rows [T, Pd] int32 (-1 pad), auth [T, Pd] f32, meta
    [T, 2, Pd] int32 (ProjGate word layout, word-major). T = tag_words·32.

    A tag with more than Pd live members keeps its top Pd by (authority
    desc, row asc) — the dense arm's order — so results are identical
    whenever a tag's membership fits Pd."""

    def __init__(self, rows, auth, meta, pd: int):
        self.rows, self.auth, self.meta, self.pd = rows, auth, meta, int(pd)

    @classmethod
    def build(cls, index, pd: int = 4096) -> "DTagPostings":
        tw = index.d_tags.shape[1]
        t = tw * 32
        c = index.valid.shape[0]
        dev = index.valid.device
        pd = int(min(pd, c))
        rows_parts, auth_parts = [], []
        live = index.valid > 0
        for lo in range(0, t, _DTAG_BLOCK):
            tags = torch.arange(lo, min(lo + _DTAG_BLOCK, t), device=dev)
            words = index.d_tags[:, tags // 32]  # [C, n]
            member = ((words >> (tags % 32).to(torch.int32)) & 1) != 0
            score = torch.where(member.T & live[None, :], index.authority[None, :], NEG_INF)
            vals, rows = topk_stable(score, pd)
            rows = torch.where(vals > NEG_INF / 2, rows, -1)
            rows_parts.append(rows.to(torch.int32))
            auth_parts.append(torch.where(rows >= 0, vals, 0.0))
        rows = torch.cat(rows_parts)
        auth = torch.cat(auth_parts)
        packed = ProjGate.pack_rows(index, torch.clamp(rows.reshape(-1), min=0))
        meta = packed[:, :2].reshape(t, pd, 2)
        meta[..., 1] = torch.where(rows >= 0, meta[..., 1], meta[..., 1] & ~(1 << 16))
        return cls(rows, auth, meta.transpose(1, 2).contiguous(), pd)

    def as_tuple(self):
        return (self.rows, self.auth, self.meta)


def dtag_candidates_local(dtp: tuple, q: dict, qmeta, m: int):
    """D-tag arm over the per-tag postings: candidates = the union of the
    query's tags' lists, scored authority+1 under valid & meta_ok (the
    dense dtag_raw semantics). A row listed under several of the query's
    tags counts once, at its first position. Returns (vals [B, m], idx
    [B, m] int32)."""
    t_rows, t_auth, t_meta = dtp
    tag_ids = q["d_tag_ids"]  # [B, Tq] int32, -1 pads
    t = t_rows.shape[0]
    safe = torch.clamp(tag_ids, 0, t - 1).long()
    rows = torch.where((tag_ids >= 0)[..., None], t_rows[safe], -1)  # [B, Tq, Pd]
    auth = t_auth[safe]
    meta = t_meta[safe]  # [B, Tq, 2, Pd]
    b, tq, pd = rows.shape
    s = tq * pd
    rows_f = rows.reshape(b, s)
    meta_f = meta.movedim(2, -1).reshape(b, s, 2)
    meta_ok, valid = meta_ok_from_words(meta_f, qmeta)
    score = torch.where((rows_f >= 0) & valid & meta_ok, auth.reshape(b, s) + 1.0, NEG_INF)
    # dedup across tags: sort ids, mark repeats, scatter the mask back
    order = torch.argsort(torch.where(rows_f < 0, _INT32_MAX, rows_f), dim=1, stable=True)
    ids_s = torch.gather(rows_f, 1, order)
    rep = torch.zeros((b, s), dtype=torch.bool, device=rows_f.device)
    rep[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    dup = torch.zeros_like(rep).scatter_(1, order, rep)
    score = torch.where(dup, NEG_INF, score)
    vals, pos = topk_stable(score, min(m, s))
    idx = torch.gather(rows_f, 1, pos)
    vals, idx = _pad_to(vals, idx, m)
    return vals, torch.clamp(idx, min=0).to(torch.int32)


def lex_signal_join(cand_idx: torch.Tensor, lex_idx: torch.Tensor,
                    lex_vals: torch.Tensor) -> torch.Tensor:
    """Per-candidate lexical raw score by id-join against the lexical arm's
    list: cand_idx [B, M], lex_idx/lex_vals [B, R] → [B, M] float32 (0 where
    the candidate is outside the list)."""
    live = lex_vals > NEG_INF / 2
    eq = (cand_idx[:, :, None] == lex_idx[:, None, :]) & live[:, None, :]
    return torch.einsum("bmr,br->bm", eq.float(), torch.where(live, lex_vals, 0.0))
