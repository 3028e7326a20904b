"""The hybrid retrieval pipeline ("strategy a") in PyTorch (the port of
``mobius_rag_tpu.query.engine``).

Per batch of queries:

  prepare      host: lexicon expansion, tokenizing, IDF, bitsets
  filter gate  [B, C] strict/relaxed/open masks with strict→relaxed
               auto-relax → an additive penalty (dense gating)
  vector arm   exact backend: masked cosine top-m through
               ops.topk.masked_topk (a Hopper kernel on a CUDA device);
               ANN backends: a probed scan of the store's IVF clusters —
               ivf (rows gathered from the chunk matrix), packed (int8
               cluster blocks, the proj_blocks Hopper kernel at p = D),
               pq (residual PQ codes, ADC), proj (int8 projected
               residuals, the Hopper kernels of ops.proj_scan)
  lexical arm  [B, U] × [U, C] over the batch's union of hashed buckets
               (dense layout) or a scatter-add over their postings (sparse)
  d-tag arm    d-tag bitset overlap, authority-scored
  signals      per-candidate gathers + bit tests
  fusion       RRF k=60 over the candidate union, v1.3 weighted rerank
  assembly     host: records, confidence labels, neighbours, traces

Candidate-local gating (proj backend, ``MRAG_GATING=local``, and
``auto`` under host residency) replaces the [B, C] gate and arms: the
gate is evaluated inside the gated probed scan, the lexical arm scores
only its postings, the d-tag arm reads per-tag postings, and the strict
count comes from a host cache (``query.gating``).

Host residency (``MRAG_VECTOR_RESIDENCY=host``, the 10M configuration;
backend proj or pq) serves in two stages. The device program runs at
``kd = k·over_fetch`` fused candidates and widens the vector arm to a
funnel of the top ``MRAG_HOST_FUNNEL`` ANN candidates, whose rerank
signals ride the
output (``wide_outputs``, bf16 pairs in float32 columns). With no dense
rows on the device the vector arm's approximate score, clipped to
[0, 1], stands in for the cosine in fusion. Then ``_host_rerank``
recomputes the exact cosine of the fused and funnel candidates from the
host int8 matrix (``utils.native.gather_cos``), rescores, dedups and
keeps the top k — host numpy, line for line the JAX engine's.

Semantics follow the JAX engine line by line; where torch differs:

- bitsets are int32 bit patterns (see index/store.py): bit tests use
  ``!= 0``, and shifts are masked with ``& 1``;
- every selection goes through ``ops.topk.topk_stable`` (or the kernel),
  which keeps ``lax.top_k``'s lower-index-first order among ties;
- queries are rounded to bf16 (round-to-nearest-even, as the JAX engine
  sends them) and widened to float32 on the device;
- each arm's candidate cosine is a gather of its rows, as the JAX
  engine's ANN branch does (``_cand_cos``), since no dense cosine exists;
- fusion skips the JAX engine's per-arm re-sort (``engine.py:620``): each
  arm's list arrives in top-k order, on one device from its own scan and
  under sharding from ``merge_shard_lists``, which re-sorts the shards'
  [3, S, B, m] lists once;
- the lexical bucket union is prepared as the JAX engine pads it
  (``_BUCKET_PADS``: 128, 512, 2,048, then the bucket count; pad columns
  name bucket 0 at weight 0), but the device program reads fewer columns,
  since in the sparse layout every pad column scans its bucket's whole
  postings row: on a card the live ones rounded up to a power of two
  (:func:`_union_width`; a captured program, ``query/compiled.py``, is
  kept per width, as the JAX program is compiled per width), on the CPU
  exactly the live ones;
- the sparse lexical arm sums each row's postings in float64, so its
  float32 score does not depend on the order of the device's atomics;
- the JAX engine's ``optimization_barrier`` sequencing of the ANN arms and
  ``_sync_ann`` are dropped: eager PyTorch runs each arm once, in order,
  and frees its transients through the stream-ordered allocator.

Float32 matmuls run in full float32 (TF32 is switched off in the
package's ``__init__``).

On a card the device program of a batch (the queries' bf16 cast,
:func:`search_batch`, :func:`pack_device`) is one CUDA graph, captured
once per batch shape and replayed (``query/compiled.py``: the port of
the JAX engine's ``_search_compiled``); ``graphs=False`` runs it eagerly,
one operator at a time, as the CPU always does.

``search_pipelined`` overlaps batches on a card: it prepares and
enqueues every batch's device program, packing and non-blocking copies
of its two output arrays into page-locked host buffers, each batch
closed by a CUDA event, before it waits for any; then it takes the
batches in order (wait on the event, unpack, host re-rank, assemble), so
one batch's host work runs while later batches run on the device.
Nothing on that path reads a device value back: the prepared batch goes
up as one non-blocking copy from page-locked memory (into the graph's
static inputs), and the strict counts of candidate-local gating run on a
stream of their own, whose event is the only thing the host waits for.

An optional cross-encoder (``cross_encoder``, e.g.
``models.cross_encoder.CrossEncoderModel``) rescores each result's hits
on the host after assembly and re-sorts them stably by its logit; the
confidence label still comes from the linear rerank score.

Sharded serving (``sharded=`` a ``parallel.ShardedEngine`` over the same
store): the device program runs per shard over a grid of devices and the
shards' candidate lists merge on the engine's device; the merged output
has this engine's schema, so results carry the global arm traces and
strict counts (the JAX sharded engine ships the fused subset only, with
empty traces and a strict count of -1). Gating is dense under sharding.
On a card the sharded program is captured too, in the sharded engine's
own cache: one CUDA graph per key on a grid whose devices are all this
engine's card, one per device and stage, joined between devices by CUDA
events, on a grid over several cards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sqlite3
import time
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.index.ivf import (IVFIndex, PackedIVF, calibrate_nprobe,
                                            ivf_search, ivf_search_packed)
from mobius_rag_tpu_torch.index.store import ChunkStore, DeviceIndex, pack_bits
from mobius_rag_tpu_torch.ingest.featurize import query_lexical_weights
from mobius_rag_tpu_torch.ops.pq import PackedPQ, effective_m, pq_search_packed
from mobius_rag_tpu_torch.ops.proj import (PackedProj, ProjGate, encode_qmeta,
                                           encode_reserved, invalidate_slots,
                                           proj_search_gated, proj_search_packed,
                                           scatter_slots)
from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk, topk_stable
from mobius_rag_tpu_torch.query import gating
from mobius_rag_tpu_torch.query.compiled import (LOCK, CapturedPrograms, ProgramsByDevice,
                                               tables_held, to_device)
from mobius_rag_tpu_torch.query.gating import query_dtag_ids
from mobius_rag_tpu_torch.query.lexicon import Lexicon, LexiconExpansion
from mobius_rag_tpu_torch.utils import native

# Rerank weights, reranker v1.3 (see the JAX engine for their derivation).
W_SIM, W_AUTH, W_LEN, W_JPD, W_COV = 0.25, 0.10, 0.05, 0.20, 0.55

# Max coverage-phrase slots per query.
MAX_PHRASE_SLOTS = 64

_MODES = ("corpus", "precision", "recall")
# Per-mode arm weights in RRF (vector, lexical, dtag): precision is
# lexical-dominant, recall vector-dominant with no confidence floor.
_MODE_ARM_WEIGHTS = {
    "corpus": (1.0, 1.0, 0.5),
    "precision": (0.5, 1.0, 0.7),
    "recall": (1.0, 0.6, 0.3),
}
# Mode-default minimum confidence floor.
MODE_MIN_LABEL = {"corpus": "low", "precision": "low", "recall": "abstain"}

# Per-candidate signal channels carried through fusion:
# cos, lex_raw, auth, len, jpd, cov.
N_SIG = 6

# Widths the batch's lexical bucket union is padded to (the JAX engine's
# ``_BUCKET_PADS``); past the largest, the bucket count.
_BUCKET_PADS = (128, 512, 2048)
# The fewest union columns a card's device program reads (see _union_width).
_MIN_UNION_READ = 16


@dataclasses.dataclass
class QueryRequest:
    """One search request."""

    query: str
    embedding: np.ndarray | None = None  # [D]; required unless embed_fn is set
    mode: str = "corpus"
    payer: str = ""
    state: str = ""
    program: str = ""
    min_similarity: float = 0.0
    tag_mode: str = "strict"  # strict | relaxed | none
    # a payer filter also admits payer-unaffiliated regulator rows
    # (authority_level 4) when set
    inherit_authority: bool = True


@dataclasses.dataclass
class SearchHit:
    row: int
    chunk_id: str
    doc_id: str
    text: str
    score: float  # rerank score in [0, 1]
    similarity: float  # best-arm cosine
    signals: dict[str, float]
    metadata: dict[str, Any]
    # adjacent same-document chunks attached for synthesis context
    neighbors: list[dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SearchResult:
    query: str
    hits: list[SearchHit]
    confidence_label: str
    expansion: LexiconExpansion
    telemetry: dict[str, Any]


_BACKENDS = ("exact", "ivf", "packed", "pq", "proj")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"vector backend {backend!r} must be exact|ivf|packed|pq|proj")


def _confidence_label(score: float, cfg: Config) -> str:
    if score >= cfg.confidence_high:
        return "high"
    if score >= cfg.confidence_medium:
        return "medium"
    if score >= cfg.confidence_low:
        return "low"
    return "abstain"


# ---------------------------------------------------------------------------
# The device pipeline
# ---------------------------------------------------------------------------

def _unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 bit patterns → [..., W, 32] int32 {0, 1}. The shift
    is arithmetic on int32, so the `& 1` is what keeps bit 31 right."""
    r = torch.arange(32, dtype=torch.int32, device=bits.device)
    return (bits[..., None] >> r) & 1


def _popcount(bits: torch.Tensor) -> torch.Tensor:
    """Set bits per row: [..., W] int32 → [...] float32."""
    return _unpack_bits(bits).sum(dim=(-2, -1)).float()


def _overlap(bits: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """Any-bit overlap between chunk bitsets [C, W] and query bitsets
    [B, W] → [B, C] {0, 1} float32. `!= 0`, not `> 0`: a word with bit 31
    set is negative as int32. Loops over the small word axis: a single
    [B, C, W] AND reduced over W took more device time on an H100 (its
    reduction over an 8-wide inner axis; PERF.md) than the 3·W launches
    of the loop."""
    acc = torch.zeros((qbits.shape[0], bits.shape[0]), dtype=torch.bool,
                      device=bits.device)
    for w in range(bits.shape[1]):
        acc |= (bits[:, w][None, :] & qbits[:, w][:, None]) != 0
    return acc.float()


def _any_bits(qbits: torch.Tensor) -> torch.Tensor:
    """[B, W] → [B, 1] float32: 1 where any bit is set."""
    return (qbits != 0).any(dim=1, keepdim=True).float()


def filter_masks(index: DeviceIndex, q: dict):
    """Eligibility masks [B, C]: (strict, relaxed, open, meta_ok).
    strict = metadata AND j-tags (when the query has any); relaxed =
    metadata AND d/p-tag join (the auto-relax target); open = validity.
    Every mask is {0, 1} float32, so products and maxima are exact in any
    order: the [B, C] buffers are multiplied in place and freed as soon as
    they are read for the last time (at 10M rows and B = 32 each is 1.28
    GB)."""
    valid = index.valid  # [C] f32

    def col_match(col, want):  # [C] i32 vs [B] i32 (-1 = any, -2 = none)
        return torch.where(want[:, None] == -1, 1.0,
                           (col[None, :] == want[:, None]).float())

    # payer-unaffiliated regulator-grade rows pass a payer filter when the
    # query allows inheritance
    regulator = ((index.authority[None, :] >= 0.999)
                 & (index.payer[None, :] < 0)).float()
    meta_ok = torch.maximum(col_match(index.payer, q["payer"]),
                            q["inherit_authority"][:, None] * regulator)
    meta_ok.mul_(col_match(index.state, q["state"]))
    meta_ok.mul_(col_match(index.program, q["program"]))  # [B, C]
    has_j = _any_bits(q["j_bits"])
    has_dp = torch.maximum(_any_bits(q["d_bits"]), _any_bits(q["p_bits"]))
    strict = torch.where(has_j > 0, _overlap(index.j_tags, q["j_bits"]), 1.0)
    strict.mul_(meta_ok).mul_(valid[None, :])
    dp_ok = _overlap(index.d_tags, q["d_bits"])
    dp_ok = torch.maximum(dp_ok, _overlap(index.p_tags, q["p_bits"]))
    relaxed = torch.where(has_dp > 0, dp_ok, 1.0)
    del dp_ok
    relaxed.mul_(meta_ok).mul_(valid[None, :])
    open_mask = valid[None, :].expand_as(meta_ok).contiguous()
    return strict, relaxed, open_mask, meta_ok


def gate_penalty(strict, relaxed, open_mask, q: dict, k: int, strict_total=None):
    """Per-query tag_mode gating with strict→relaxed auto-relax → the
    additive penalty [B, C] (0 eligible, NEG_INF gated)."""
    if strict_total is None:
        strict_total = strict.sum(dim=1, keepdim=True)
    auto = torch.where(strict_total >= k, strict, torch.maximum(strict, relaxed))
    tm = q["tag_mode"][:, None]
    gate = torch.where(tm == 1, relaxed, open_mask)
    gate = torch.where(tm == 0, auto, gate)
    del auto
    # (1 − gate) · NEG_INF, in place: gate is {0, 1}
    return gate.neg_().add_(1.0).mul_(NEG_INF)


def lexical_raw(index: DeviceIndex, q: dict) -> torch.Tensor:
    """Lexical arm raw scores [B, C]. Dense layout: gather the batch's
    union of touched buckets [U, C] and contract with the per-query IDF
    weights [B, U]. Sparse layout: scatter-add the union buckets'
    postings [U, P] into per-row scores, summed in float64 and rounded
    once (the same value query.gating's local arm computes)."""
    buckets = q["lex_buckets"].long()
    if "lex_cols" in index.fields:
        c = index.capacity
        cols = index.lex_cols[buckets]  # [U, P]
        wts = index.lex_wts[buckets]
        seg = torch.where(cols >= 0, cols, c).reshape(-1).long()  # pads → bin c
        vals = (q["lex_weights"][:, :, None] * wts[None].float()).reshape(
            q["lex_weights"].shape[0], -1)
        out = torch.zeros((vals.shape[0], c + 1), dtype=torch.float64, device=vals.device)
        return out.index_add_(1, seg, vals.double())[:, :c].float()
    bucket_rows = index.lexical[buckets].float()  # [U, C]
    return q["lex_weights"] @ bucket_rows


def dtag_raw(index: DeviceIndex, q: dict, meta_ok) -> torch.Tensor:
    """D-tag arm scores [B, C]: authority-ranked tag membership under the
    metadata filter."""
    member = _overlap(index.d_tags, q["d_bits"])
    live = index.authority[None, :] + 1.0
    out = torch.where(member > 0, live, NEG_INF)
    del member
    # the same three terms, summed in the same order, in place
    out += (1.0 - index.valid[None, :]) * NEG_INF
    out += (1.0 - meta_ok) * NEG_INF
    return out


def _bit_at(bits: torch.Tensor, word: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """bits [B, M, W] int32, word/bit [B, S] → [B, M, S] float32 {0, 1}."""
    b, m, _ = bits.shape
    s = word.shape[1]
    w = torch.gather(bits, 2, word.long()[:, None, :].expand(b, m, s))
    return ((w >> bit[:, None, :]) & 1).float()


def candidate_signals(index: DeviceIndex, q: dict, cand: torch.Tensor):
    """Per-candidate rerank signals (auth, len, jpd, cov) for candidate
    rows `cand` [B, M] (int64)."""
    auth = index.authority[cand]
    lsig = index.length_score[cand]

    # jpd: fraction of the query's d-tags the chunk carries
    inter = index.d_tags[cand] & q["d_bits"][:, None, :]  # [B, M, W]
    jpd_hits = _popcount(inter)
    q_dcount = _popcount(q["d_bits"])[:, None]
    jpd = torch.where(q_dcount > 0,
                      torch.minimum(jpd_hits / torch.clamp(q_dcount, min=1.0),
                                    torch.ones_like(jpd_hits)),
                      0.0)

    # coverage: selectivity-weighted phrase presence with binary j-tag
    # doc credit (v1.3 unified coverage)
    phrase_present = _bit_at(index.phrase_bits[cand], q["slot_word"], q["slot_bit"])
    jtag_present = _bit_at(index.j_tags[cand], q["slot_jword"], q["slot_jbit"])
    s_isj = q["slot_isj"][:, None, :]
    s_w = q["slot_weight"][:, None, :]  # 0 for inactive slots
    present = torch.where(s_isj > 0, torch.maximum(jtag_present, phrase_present),
                          phrase_present)
    cov_num = (present * s_w).sum(dim=2)
    cov_den = q["slot_weight"].sum(dim=1)[:, None]
    cov = torch.where(cov_den > 0, cov_num / torch.clamp(cov_den, min=1e-6), 0.0)
    return auth, lsig, jpd, cov


def rerank_score(sim, auth, lsig, jpd, cov, has_jpd, has_cov):
    """Reranker v1.3 weighted sum, normalized to [0, 1]."""
    w_jpd = W_JPD * has_jpd
    w_cov = W_COV * has_cov
    max_w = W_SIM + W_AUTH + W_LEN + w_jpd + w_cov
    return (W_SIM * sim + W_AUTH * auth + W_LEN * lsig + w_jpd * jpd
            + w_cov * cov) / torch.clamp(max_w, min=1e-6)


def _cand_cos(index: DeviceIndex, qvec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-candidate cosine via a row gather [B, m, D], times the rows'
    scales (1.0 unless int8)."""
    vecs = index.vectors[idx].float()
    return torch.einsum("bmd,bd->bm", vecs, qvec) * index.vec_scales[idx]


def ann_search(index: DeviceIndex, ann, qvec: torch.Tensor, penalty: torch.Tensor,
               m: int, nprobe: int, approx: float = 0.0):
    """The vector arm's probed top-m over the ANN tables (dense gating:
    ``penalty`` [B, C]), by the tables' class, as the JAX engine
    dispatches (``engine.py:509-531``). Returns (vals [B, m], ids [B, m]);
    for an eligible row the value is its (approximate) cosine."""
    if isinstance(ann, IVFIndex):
        return ivf_search(ann, index.vectors, qvec, penalty, m, nprobe, index.vec_scales)
    if isinstance(ann, PackedProj):
        return proj_search_packed(ann, qvec, penalty, m, nprobe, approx)
    if isinstance(ann, PackedPQ):
        return pq_search_packed(ann, qvec, penalty, m, nprobe)
    if isinstance(ann, PackedIVF):
        return ivf_search_packed(ann, qvec, penalty, m, nprobe)
    raise TypeError(f"unknown ANN tables {type(ann).__name__}")


def _min_sim_filter(vec_vals: torch.Tensor, q: dict) -> torch.Tensor:
    """The vector arm's min_sim post-filter over an ANN result (for an
    eligible row the returned value is its approximate cosine)."""
    return vec_vals + torch.where(vec_vals < q["min_sim"][:, None], NEG_INF, 0.0)


def arm_candidates(index: DeviceIndex, q: dict, k: int, m: int, *,
                   m_other: int | None = None, ann=None,
                   nprobe: int = 32, approx: float = 0.0, local=None,
                   tag_level: int = 2, strict_total: torch.Tensor | None = None,
                   offset: int = 0):
    """The three arms' top-m candidates and their rerank signals.

    ``ann`` None is the exact backend (the masked cosine top-m); ANN tables
    (IVFIndex, PackedIVF, PackedPQ, PackedProj) run the vector arm as
    their probed scan (:func:`ann_search`). ``local``
    (proj only) is (ProjGate words, DTagPostings tuple): candidate-local
    gating, with no [B, C] buffer; ``tag_level`` bounds the gate words
    read. ``m_other`` (default m) caps the lexical and d-tag arm widths;
    their lists are padded back to m with dead entries.

    On one shard of a sharded index (dense gating): ``strict_total`` [B, 1]
    is the strict count over every shard, so that every shard takes the
    same auto-relax branch (the JAX engine's ``psum``), and ``offset`` (the
    shard's first global row) is added to the returned row ids.

    Returns (vals [3, B, m] f32, gidx [3, B, m] int32, sigs [3, B, m,
    N_SIG] f32, strict_total [B, 1])."""
    m_oth = min(m_other or m, m)
    if local is not None:
        if strict_total is not None or offset:
            raise ValueError("candidate-local gating is single-device")
        if not isinstance(ann, PackedProj):
            raise ValueError("candidate-local gating needs a PackedProj ann")
        gate_words, dtag_t = local
        # the host-cached count (SearchEngine._strict_totals) when present
        strict_local = q["strict_total"] if "strict_total" in q \
            else gating.strict_counts(index, q)
        strict_total = strict_local[:, None]
        qmeta, qbits = encode_qmeta(q, strict_local >= k)
        vec_vals, vec_idx = proj_search_gated(
            ann, gate_words, q["vec"], qmeta, qbits, m, nprobe, approx, tag_level,
            tw=index.j_tags.shape[1])
        vec_vals = _min_sim_filter(vec_vals, q)
        lex_vals, lex_idx, _ = gating.lexical_candidates_local(
            index, q, qmeta, qbits, m_oth, tag_level)
        dtag_vals, dtag_idx = gating.dtag_candidates_local(dtag_t, q, qmeta, m_oth)

        def lex_sig_of(idx):
            return gating.lex_signal_join(idx, lex_idx, lex_vals)
    else:
        strict, relaxed, open_mask, meta_ok = filter_masks(index, q)
        if strict_total is None:
            strict_total = strict.sum(dim=1, keepdim=True)
        penalty = gate_penalty(strict, relaxed, open_mask, q, k, strict_total)
        # [B, C] each and read no more: freed before the arms' transients
        del strict, relaxed, open_mask
        if ann is None:
            scales = index.vec_scales if index.vectors.dtype == torch.int8 else None
            vec_vals, vec_idx = masked_topk(q["vec"], index.vectors, penalty,
                                            q["min_sim"], m, row_scales=scales)
        else:
            vec_vals, vec_idx = ann_search(index, ann, q["vec"], penalty, m, nprobe, approx)
            vec_vals = _min_sim_filter(vec_vals, q)
        lex = lexical_raw(index, q)
        lex_vals, lex_idx = topk_stable(torch.where(lex > 0, lex, NEG_INF) + penalty, m_oth)
        dtag_vals, dtag_idx = topk_stable(dtag_raw(index, q, meta_ok), m_oth)

        def lex_sig_of(idx):
            return torch.gather(lex, 1, idx)

    # No dense rows on the device (host residency): the vector arm's
    # approximate score, clipped to [0, 1], stands in for its candidates'
    # cosine and the other arms' carry 0; the host re-rank recomputes the
    # exact cosine of every fused candidate.
    have_dense = index.vectors.shape[0] == index.valid.shape[0]
    out_vals, out_idx, out_sigs = [], [], []
    for arm, (vals, idx) in enumerate(((vec_vals, vec_idx), (lex_vals, lex_idx),
                                       (dtag_vals, dtag_idx))):
        idx = idx.long()
        auth, lsig, jpd, cov = candidate_signals(index, q, idx)
        if have_dense:
            cand_cos = _cand_cos(index, q["vec"], idx)
        elif arm == 0:
            cand_cos = torch.clamp(vals, 0.0, 1.0)
        else:
            cand_cos = torch.zeros_like(vals)
        sig = torch.stack([cand_cos, lex_sig_of(idx),
                           auth, lsig, jpd, cov], dim=-1)  # [B, m', N_SIG]
        pad = m - vals.shape[1]
        if pad:  # an arm ran at m_other < m: dead-pad back to m
            b = vals.shape[0]
            vals = torch.cat([vals, vals.new_full((b, pad), NEG_INF)], dim=1)
            idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=1)
            sig = torch.cat([sig, sig.new_zeros((b, pad, N_SIG))], dim=1)
        out_vals.append(vals)
        out_idx.append(idx + offset)
        out_sigs.append(sig)
    return (torch.stack(out_vals), torch.stack(out_idx).to(torch.int32),
            torch.stack(out_sigs), strict_total)


def merge_shard_lists(vals, gidx, sigs, r: int):
    """The sharded merge's per-arm global re-sort: the shards' lists
    [3, S, B, m] (sigs [3, S, B, m, N_SIG]) → each arm's top r of its S·m
    candidates, [3, B, r]. The lists are laid shard-major and shard s owns
    rows below shard s + 1's, so the stable selection keeps the lower
    global row first among equal scores, as one device does."""
    n_arms, s, b, m = vals.shape
    vals = vals.permute(0, 2, 1, 3).reshape(n_arms, b, s * m)
    gidx = gidx.permute(0, 2, 1, 3).reshape(n_arms, b, s * m)
    sigs = sigs.permute(0, 2, 1, 3, 4).reshape(n_arms, b, s * m, N_SIG)
    top = [topk_stable(vals[a], r) for a in range(n_arms)]
    pos = torch.stack([p for _, p in top])  # [3, B, r]
    return (torch.stack([v for v, _ in top]), torch.gather(gidx, 2, pos),
            torch.gather(sigs, 2, pos[..., None].expand(-1, -1, -1, N_SIG)))


def fuse_and_rerank(vals, gidx, sigs, q, k: int, rrf_k: int, m_global: int | None = None):
    """RRF + rerank over the UNION of the per-arm candidate lists (no
    [B, C] buffer: duplicates are summed through a [B, 3r, 3r] pairwise
    match). vals/gidx [3, B, m] (each arm already in top-k order: a
    sharded index's lists go through :func:`merge_shard_lists` first),
    sigs [3, B, m, N_SIG]. Each arm contributes its first r =
    min(m_global, m) candidates (m_global: the fusion pool, default m)."""
    n_arms, _, m = vals.shape
    m_global = m if m_global is None else m_global
    r = min(m_global, m)
    lex_vals_all = vals[1]
    vals, gidx, sigs = vals[:, :, :r], gidx[:, :, :r], sigs[:, :, :r]
    dev = vals.device
    ranks = torch.arange(r, dtype=torch.float32, device=dev)[None, :]
    cand_parts, contrib_parts = [], []
    for a in range(n_arms):
        live = (vals[a] > NEG_INF / 2).float()
        w = q["arm_weights"][:, a:a + 1]
        cand_parts.append(torch.where(
            live > 0, gidx[a].long(), -1 - a * r - ranks.long()))  # dead ids never match
        contrib_parts.append(live * w / (rrf_k + ranks + 1.0))
    u_idx = torch.cat(cand_parts, dim=1)  # [B, 3r]
    u_contrib = torch.cat(contrib_parts, dim=1)
    u_sig = torch.cat(list(sigs), dim=1)  # [B, 3r, N_SIG]
    u_live = (u_contrib > 0).float()

    eq = (u_idx[:, :, None] == u_idx[:, None, :]).float()  # [B, 3r, 3r]
    rrf_sum = torch.einsum("bij,bj->bi", eq, u_contrib)
    first = torch.argmax(eq, dim=2)  # first occurrence of each id
    is_first = (first == torch.arange(u_idx.shape[1], device=dev)[None, :]).float()
    fused = torch.where(is_first * u_live > 0, rrf_sum, NEG_INF)

    # rerank as many fused candidates as the fusion pool holds
    cand_rrf, pos = topk_stable(fused, min(m_global, fused.shape[1]))
    cand_idx = torch.gather(u_idx, 1, pos)
    cand_sig = torch.gather(u_sig, 1, pos[..., None].expand(-1, -1, N_SIG))

    cos_c, lex_c = cand_sig[..., 0], cand_sig[..., 1]
    auth_c, len_c = cand_sig[..., 2], cand_sig[..., 3]
    jpd_c, cov_c = cand_sig[..., 4], cand_sig[..., 5]
    # lexical normalizer = best LIVE (gate-passing) lexical score
    lex_best = torch.where(lex_vals_all > NEG_INF / 2, lex_vals_all, 0.0).max(dim=1).values
    lexn = torch.clamp(lex_c / torch.clamp(lex_best[:, None], min=1e-6), 0.0, 1.0)
    sim = torch.clamp(torch.maximum(cos_c, lexn), 0.0, 1.0)

    has_jpd = _any_bits(q["d_bits"])
    has_cov = (q["slot_weight"].sum(dim=1) > 0).float()[:, None]
    rerank = rerank_score(sim, auth_c, len_c, jpd_c, cov_c, has_jpd, has_cov)
    rerank = torch.where(cand_rrf > NEG_INF / 2, rerank, NEG_INF)

    top_vals, tpos = topk_stable(rerank, k)

    def take(x):
        return torch.gather(x, 1, tpos)

    return {
        "idx": take(cand_idx).to(torch.int32),
        "rerank": top_vals,
        "sim": take(sim),
        "cos": take(cos_c),
        "auth": take(auth_c),
        "len": take(len_c),
        "jpd": take(jpd_c),
        "cov": take(cov_c),
        "rrf": take(cand_rrf),
        "lexn": take(lexn),
    }


@torch.inference_mode()
def search_batch(index: DeviceIndex, q: dict, k: int, over_fetch: int,
                 rrf_k: int, ann=None, nprobe: int = 32,
                 approx: float = 0.0, local=None, tag_level: int = 2,
                 funnel: int = 0) -> dict[str, torch.Tensor]:
    """All arms, fusion and rerank for one prepared batch; the output
    tensors stay on the index's device (see pack_out). ``ann``/``nprobe``/
    ``approx``/``local``/``tag_level`` select the vector backend and the
    gating, as in :func:`arm_candidates`.

    ``funnel`` > 0 (host residency): `k` arrives already over-fetched
    (the engine's ``_device_k``), so the fusion pool per arm is 2k, not
    k·over_fetch again (the JAX engine measured what compounding costs,
    ``engine.py:714-724``); the vector arm widens to the funnel and its
    top-funnel candidates and signals join the outputs (wide_outputs)."""
    c = index.capacity
    m_fuse = min(2 * k if funnel else k * over_fetch, c)
    w = min(funnel, c)
    m = max(m_fuse, w)
    # Queries arrive bf16-rounded (see prepare_batch); widen once.
    q = dict(q, vec=q["vec"].float())
    vals, gidx, sigs, strict_total = arm_candidates(
        index, q, k, m, m_other=m_fuse, ann=ann, nprobe=nprobe, approx=approx,
        local=local, tag_level=tag_level)
    out = fuse_and_rerank(vals, gidx, sigs, q, k, rrf_k, m_fuse)
    out.update({
        "vec_idx": gidx[0][:, : k * 2],
        "vec_vals": vals[0][:, : k * 2],
        "lex_idx": gidx[1][:, : k * 2],
        "lex_vals": vals[1][:, : k * 2],
        "dtag_idx": gidx[2][:, : k * 2],
        "dtag_vals": vals[2][:, : k * 2],
        "strict_count": strict_total[:, 0],
    })
    if w:
        out.update(wide_outputs(vals, gidx, sigs, w))
    return out


def wide_outputs(vals, gidx, sigs, w: int) -> dict:
    """The funnel block: the vector arm's top-w ids and the host re-rank's
    signal inputs (all but the exact cosine it recomputes). The vector
    arm's list is already in score order, so its first w are the funnel."""
    lex_best = torch.where(vals[1] > NEG_INF / 2, vals[1], 0.0).max(dim=1).values
    wsig = sigs[0][:, :w]
    return {
        "wide_vals": vals[0][:, :w],
        "wide_lexn": torch.clamp(wsig[..., 1] / torch.clamp(lex_best[:, None], min=1e-6),
                                 0.0, 1.0),
        "wide_auth": wsig[..., 2],
        "wide_len": wsig[..., 3],
        "wide_jpd": wsig[..., 4],
        "wide_cov": wsig[..., 5],
        "wide_idx": gidx[0][:, :w],
    }


# Output packing layout: (key, width-multiplier-of-k) per dtype class;
# strict_count rides the int pack as an extra column.
_OUT_F = (("rerank", 1), ("sim", 1), ("cos", 1), ("auth", 1), ("len", 1),
          ("jpd", 1), ("cov", 1), ("rrf", 1), ("lexn", 1),
          ("vec_vals", 2), ("lex_vals", 2), ("dtag_vals", 2))
_OUT_I = (("idx", 1), ("vec_idx", 2), ("lex_idx", 2), ("dtag_idx", 2))
# The funnel block appended under host residency (width w, not k-based).
_WIDE_F = ("wide_vals", "wide_lexn", "wide_auth", "wide_len", "wide_jpd", "wide_cov")


def _pack_wide(out: dict) -> torch.Tensor:
    """The funnel's 6·w signals as bf16 (round to nearest even), element
    2i in the low and 2i+1 in the high half of float32 column i: [B, 3w].
    The JAX engine's layout bit for bit; the host re-rank's scores depend
    on these bf16 values."""
    wf = torch.cat([out[key] for key in _WIDE_F], dim=1).to(torch.bfloat16)
    u16 = wf.view(torch.int16).to(torch.int32) & 0xFFFF
    return (u16[:, 0::2] | (u16[:, 1::2] << 16)).view(torch.float32)


def _unpack_wide(block: np.ndarray, w: int) -> dict[str, np.ndarray]:
    """Host inverse of _pack_wide: [B, 3w] float32 → the six wide_*
    arrays as float32 (each bf16 widened by a 16-bit shift)."""
    u32 = np.ascontiguousarray(block).view(np.uint32)
    u16 = np.empty((u32.shape[0], u32.shape[1] * 2), np.uint32)
    u16[:, 0::2] = u32 & np.uint32(0xFFFF)
    u16[:, 1::2] = u32 >> np.uint32(16)
    flat = (u16 << np.uint32(16)).view(np.float32)  # [B, 6w]
    return {key: flat[:, i * w:(i + 1) * w] for i, key in enumerate(_WIDE_F)}


def pack_device(out: dict, w: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Device outputs → two arrays on the same device (one float32, one
    int32), so a batch needs two device→host copies instead of sixteen.
    With a funnel of width `w` its block rides both."""
    packed_f = torch.cat([out[key] for key, _ in _OUT_F]
                         + ([_pack_wide(out)] if w else []), dim=1)
    packed_i = torch.cat([out[key] for key, _ in _OUT_I]
                         + [out["strict_count"][:, None].to(torch.int32)]
                         + ([out["wide_idx"]] if w else []), dim=1)
    return packed_f, packed_i


def pack_out(out: dict, w: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """pack_device, then both arrays to the host, waiting for them."""
    packed_f, packed_i = pack_device(out, w)
    return packed_f.cpu().numpy(), packed_i.cpu().numpy()


class PendingFetch:
    """The two packed output arrays of a dispatched batch on their way to
    the host. On a card: non-blocking copies into page-locked buffers,
    enqueued on the current stream behind the batch's program, and an
    event after them; :meth:`wait` waits for that event alone. On the CPU
    the arrays are already on the host."""

    def __init__(self, packed: tuple[torch.Tensor, torch.Tensor]):
        self.done = None
        self.host = packed
        if packed[0].device.type == "cuda":
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                              for t in packed)
            for h, t in zip(self.host, packed):
                h.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()

    def wait(self) -> tuple[np.ndarray, np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return self.host[0].numpy(), self.host[1].numpy()


class PreparedBatch(dict):
    """A prepared batch on the host (``SearchEngine.prepare_host``): its
    numpy arrays by name, and ``union``, how many leading columns of its
    lexical union are live buckets (the rest are pads)."""

    def __init__(self, arrays: dict[str, np.ndarray], union: int):
        super().__init__(arrays)
        self.union = union


class DeviceBatch(dict):
    """``SearchEngine.prepare_batch``'s tensors by name, and ``host``, the
    :class:`PreparedBatch` they were uploaded from: what the engine's
    device program takes."""

    def __init__(self, tensors: dict[str, torch.Tensor], host: PreparedBatch):
        super().__init__(tensors)
        self.host = host


def _union_width(union: int, u: int) -> int:
    """The lexical union columns a card's device program reads: the
    `union` live ones rounded up to a power of two, at least
    _MIN_UNION_READ, at most the padded width `u`. The columns past them
    are pads (bucket 0 at weight 0): in the sparse layout each adds its
    bucket's whole postings row of zeros to the arms' scans, so reading
    them costs device time in proportion to `u` (at 1M rows 8,192 postings
    a column) and changes no score; in the dense layout the [B, U] x
    [U, C] product may move by an ulp. A power of two keeps the captured
    programs few."""
    return min(u, max(_MIN_UNION_READ, 1 << max(union - 1, 0).bit_length()))


def _cut_union(q: PreparedBatch, w: int) -> dict[str, np.ndarray]:
    """`q`'s arrays with the lexical union cut to its first `w` columns."""
    return dict(q, lex_buckets=q["lex_buckets"][:w], lex_weights=q["lex_weights"][:, :w])


def _bf16(q: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`q` with its queries rounded to bf16 (round-to-nearest-even, as the
    JAX engine ships them)."""
    return dict(q, vec=q["vec"].to(torch.bfloat16))


def unpack_out(fetched, k: int, w: int = 0) -> dict[str, np.ndarray]:
    """Host inverse of pack_out: numpy views under the JAX engine's key
    schema."""
    packed_f, packed_i = np.asarray(fetched[0]), np.asarray(fetched[1])
    out: dict[str, np.ndarray] = {}
    off = 0
    for key, mult in _OUT_F:
        out[key] = packed_f[:, off:off + mult * k]
        off += mult * k
    if w:
        out.update(_unpack_wide(packed_f[:, off:off + 3 * w], w))
    off = 0
    for key, mult in _OUT_I:
        out[key] = packed_i[:, off:off + mult * k]
        off += mult * k
    out["strict_count"] = packed_i[:, off]
    if w:
        out["wide_idx"] = packed_i[:, off + 1:off + 1 + w]
    return out


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

class SearchEngine:
    """Host-side handle: prepares query arrays, runs the device pipeline
    on the store's device, assembles results.

    ``graphs``: None (the default) serves each batch as a captured CUDA
    graph on a card and eagerly on the CPU; False runs the program eagerly
    on a card too; True on the CPU raises. A capture or replay that fails
    raises (``query/compiled.py``). Under a sharded engine the graphs are
    its own: one a key on a grid whose devices are all this engine's, one
    per device and stage on a grid over several devices."""

    def __init__(self, store: ChunkStore, lexicon: Lexicon | None = None,
                 cfg: Config | None = None, embed_fn=None, telemetry=None,
                 sharded=None, vector_backend: str | None = None,
                 device="cuda", graphs: bool | None = None):
        self.cfg = cfg or get_config()
        backend = vector_backend or self.cfg.vector_backend
        _check_backend(backend)
        self.device = torch.device(device)
        if store.device != self.device:
            raise ValueError(f"engine device {self.device} != store device "
                             f"{store.device}")
        self.store = store
        self.lexicon = lexicon
        self.embed_fn = embed_fn  # (list[str]) -> np.ndarray [B, D]
        # observability.TelemetryStore (or None): a search_events row per result
        self.telemetry = telemetry
        # query-embedding LRU (repeated queries skip re-embedding)
        self._embed_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._embed_cache_max = 256
        # prepared-query LRU, keyed on the request's string fields and
        # invalidated by store writes and lexicon growth
        self._prep_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._prep_cache_max = 1024
        # Vector-arm backend (exact|ivf|packed|pq|proj). ANN tables build
        # lazily on the first search; store mutations after that are applied
        # in place (_try_ann_incremental, proj) or force a rebuild.
        self.vector_backend = backend
        self._ann = None
        self._ann_generation = -1
        self._ann_nprobe: int | None = None
        self._ann_calibration: dict | None = None  # the last auto-nprobe run
        # optional rescoring stage over each result's hits (see the setter)
        self._cross_encoder = None
        self._ann_events: list[tuple[str, list[int]]] = []
        self._ann_stale_hard = False
        self._ann_slot_of_row: np.ndarray | None = None  # row → flat slot
        self._ann_cursor = 0  # next free flat slot of the reserved region
        # candidate-local gating structures (query/gating.py)
        self._ann_gate: ProjGate | None = None
        self._dtag_postings: gating.DTagPostings | None = None
        self._dtag_stale = False
        # host strict-count cache (filter signature → global count)
        self._strict_cache: "OrderedDict[tuple, float]" = OrderedDict()
        # the stream of the strict counts on a card (made at first use)
        self._count_stream: torch.cuda.Stream | None = None
        # parallel.ShardedEngine over the same store: the device program then
        # runs over its device grid, for every caller of this engine (agent,
        # API). The backend propagates into it, or is inherited from it.
        self.sharded = sharded
        if sharded is not None:
            if sharded.store is not store:
                raise ValueError("the sharded engine must wrap this engine's store")
            if vector_backend is not None:
                sharded.set_vector_backend(vector_backend)
            else:
                self.vector_backend = sharded.vector_backend
        # the captured device programs (query/compiled.py), made when first on
        self._programs: CapturedPrograms | None = None
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.graphs = graphs
        store.listeners.append(self._on_store_mutation)

    @property
    def graphs(self) -> bool:
        """Whether batches run as captured CUDA graphs (see the class
        docstring); settable, so one engine can serve both ways in turns."""
        return self._graphs

    @graphs.setter
    def graphs(self, on: bool) -> None:
        if on:
            self.programs  # made now: raises off a card
        self._graphs = bool(on)

    @property
    def programs(self) -> CapturedPrograms | ProgramsByDevice:
        """The captured programs this engine's batches replay, made at first
        use: the attached sharded engine's own (``ShardedEngine.
        captured_programs``: one per device over a grid of several), else
        this engine's. Raises off a card."""
        if self.sharded is not None:
            return self.sharded.captured_programs()
        if self._programs is None:
            self._programs = CapturedPrograms(self.device)
        return self._programs

    # -- vector-arm backend -------------------------------------------------

    def set_vector_backend(self, backend: str) -> None:
        _check_backend(backend)
        if backend != self.vector_backend:
            self.vector_backend = backend
            self._ann = None
            self._ann_generation = -1
            self._reset_ann_incremental()
        if self.sharded is not None:
            self.sharded.set_vector_backend(backend)

    def _on_store_mutation(self, event: str, rows: list[int]) -> None:
        """ChunkStore listener: queue row mutations for the incremental ANN
        path. D-tag postings staleness is decided here, while the records
        of deleted rows can still be checked: a mutated row that carries
        d-tags (or cannot be checked) forces a lazy postings rebuild."""
        if self._dtag_postings is not None and not self._dtag_stale \
                and event in ("add", "delete", "bulk"):
            for r in rows or [None]:
                rec = self.store.record(r) if r is not None else None
                if rec is None or rec.d_tags:
                    self._dtag_stale = True
                    break
        if self._ann is None:
            return
        if event in ("add", "delete") and rows:
            self._ann_events.append((event, rows))
        elif event != "grow":  # "bulk" and anything else: whole-corpus rewrite
            self._ann_stale_hard = True

    def _reset_ann_incremental(self) -> None:
        self._ann_events.clear()
        self._ann_stale_hard = False
        self._ann_slot_of_row = None
        self._ann_cursor = 0
        self._ann_gate = None
        self._dtag_postings = None
        self._dtag_stale = False

    def _local_gating_active(self) -> bool:
        """MRAG_GATING: "local" forces candidate-local gating (proj backend),
        "dense" disables it, "auto" is local under host residency (the 10M
        configuration whose [B, C] buffers local gating exists to remove)
        and dense on a device-resident store, as in the JAX engine. A sharded
        engine gates densely."""
        mode = self.cfg.gating
        if mode == "dense" or self.sharded is not None or self.vector_backend != "proj":
            return False
        return mode == "local" or self.store.host_vectors is not None

    def _ensure_local_structs(self, ann):
        """Build or refresh the ProjGate and DTagPostings for the current
        ann tables. Returns the `local` tuple for arm_candidates, or None
        when local gating is off."""
        if not self._local_gating_active() or not isinstance(ann, PackedProj):
            return None
        if self._ann_gate is None:
            self._ann_gate = ProjGate.build(ann, self.store.index)
        if self._dtag_postings is None or self._dtag_stale:
            self._dtag_postings = gating.DTagPostings.build(self.store.index,
                                                            self.cfg.dtag_postings)
            self._dtag_stale = False
        return (self._ann_gate.words, self._dtag_postings.as_tuple())

    @staticmethod
    def _batch_tag_level(exps) -> int:
        """Gate word rows a batch needs, from its lexicon expansions (an
        over-approximation is safe: more words read, the same gate)."""
        if any(exp.tag_ids["d"] or exp.tag_ids["p"] for exp in exps):
            return 2
        return 1 if any(exp.tag_ids["j"] for exp in exps) else 0

    def _try_ann_incremental(self) -> bool:
        """Apply queued adds/deletes to the live PackedProj tables in place:
        adds encode into the reserved always-probed slabs, deletes clear
        their slots. Returns False when the tables cannot absorb the
        mutations (a bulk rewrite, no table mirrors, or the reserved
        headroom is used up); the caller then rebuilds."""
        ann = self._ann
        if (self._ann_stale_hard or not isinstance(ann, PackedProj)
                or ann.build_rowids is None or ann.reserve_start >= ann.nlist):
            return False
        events, self._ann_events = self._ann_events, []
        if not events:  # generation moved without row mutations (a grow)
            return True
        pad = ann.pad
        res_base = ann.reserve_start * pad
        res_cap = (ann.nlist - ann.reserve_start) * pad
        if self._ann_slot_of_row is None:
            flat_rows = ann.build_rowids.reshape(-1)
            flat_ok = ann.build_valid.reshape(-1) > 0
            slot_of = np.full(self.store.capacity, -1, np.int64)
            slot_of[flat_rows[flat_ok]] = np.flatnonzero(flat_ok)
            self._ann_slot_of_row = slot_of
            self._ann_cursor = int(flat_ok[res_base:res_base + res_cap].sum())
        slot_of = self._ann_slot_of_row
        if len(slot_of) < self.store.capacity:  # the store grew since the map
            grown = np.full(self.store.capacity, -1, np.int64)
            grown[: len(slot_of)] = slot_of
            slot_of = self._ann_slot_of_row = grown

        # Host pass: replay the events against the row → slot map, then
        # reconcile to the final slot states (a row added and deleted in
        # one batch must not come back). Running out of headroom drops the
        # half-updated map and leaves the device tables to the rebuild.
        freed: list[int] = []
        placed: list[tuple[int, int]] = []  # (row, fresh reserved slot)
        cursor = self._ann_cursor
        for event, rows in events:
            for r in rows:
                old = int(slot_of[r]) if r < len(slot_of) else -1
                if old >= 0:
                    freed.append(old)
                    slot_of[r] = -1
                if event == "add":
                    if cursor >= res_cap:
                        self._ann_slot_of_row = None
                        return False
                    slot = res_base + cursor
                    cursor += 1
                    placed.append((r, slot))
                    slot_of[r] = slot
        self._ann_cursor = cursor
        add_final = [(r, slot) for r, slot in placed if slot_of[r] == slot]
        live_slots = {slot for _, slot in add_final}
        del_slots = np.asarray(sorted({x for x in freed if x not in live_slots}), np.int64)
        add_rows = np.asarray([r for r, _ in add_final], np.int64)
        add_slots = np.asarray([slot for _, slot in add_final], np.int64)
        fv = ann.build_valid.reshape(-1)
        fr = ann.build_rowids.reshape(-1)
        fv[del_slots] = 0.0
        fr[add_slots] = add_rows
        fv[add_slots] = 1.0

        # Device pass: in-place scatters into the tables and the gate pack.
        dev = self.device
        if len(del_slots):
            cells = torch.from_numpy(del_slots // pad).to(dev)
            slots = torch.from_numpy(del_slots % pad).to(dev)
            invalidate_slots(ann, cells, slots)
            if self._ann_gate is not None:
                self._ann_gate.invalidate(cells, slots)
        if len(add_rows):
            index = self.store.index
            rows_t = torch.from_numpy(add_rows).to(dev)
            cells = torch.from_numpy(add_slots // pad).to(dev)
            slots = torch.from_numpy(add_slots % pad).to(dev)
            if self.store.host_vectors is not None:  # the rows live in host RAM
                x = torch.from_numpy(self.store.host_vectors[add_rows].astype(np.float32)
                                     * self.store.host_scales[add_rows][:, None]).to(dev)
            else:
                x = index.vectors[rows_t].float()
                if self.cfg.vector_dtype == "int8":
                    x = x * index.vec_scales[rows_t][:, None]
            codes, scales = encode_reserved(ann.proj, x)
            rid = rows_t.to(torch.int32)
            scatter_slots(ann, cells, slots, codes, scales,
                          torch.ones(len(add_rows), dtype=torch.float32, device=dev), rid)
            if self._ann_gate is not None:
                self._ann_gate.scatter(cells, slots, ProjGate.pack_rows(index, rows_t),
                                       scales, rid)
        return True

    def ensure_ann(self):
        """Build (or bring up to date after store mutations) the ANN tables
        of the configured backend; None for exact. Row-level mutations of
        proj tables go through the incremental path; every other change
        re-runs the k-means build. Under host residency the tables come
        from the host int8 matrix (proj, or residual PQ for any other
        backend). With MRAG_IVF_TARGET_RECALL > 0 the ivf and packed builds
        calibrate nprobe (:meth:`_calibrate_nprobe`)."""
        if self.vector_backend == "exact":
            return None
        if self._ann is not None and self._ann_generation == self.store.generation:
            return self._ann
        if self._ann is not None and self._try_ann_incremental():
            self._ann_generation = self.store.generation
            return self._ann
        self._reset_ann_incremental()
        from mobius_rag_tpu_torch.index.ivf import IVFIndex

        cfg = self.cfg
        index = self.store.index
        store = self.store
        m = effective_m(cfg.embed_dim, cfg.pq_m)
        if store.host_vectors is not None:
            # cluster and encode from the host int8 matrix
            ivf = IVFIndex.build_host(store.host_vectors, store.host_scales,
                                      index.valid.cpu().numpy(), device=self.device,
                                      nlist=cfg.ivf_nlist or None)
            if self.vector_backend == "proj":
                self._ann = PackedProj.from_ivf(ivf, store.host_vectors, p=cfg.proj_p,
                                                row_scales=store.host_scales,
                                                reserve_slabs=cfg.ann_reserve_slabs)
            else:
                self._ann = PackedPQ.from_ivf(ivf, store.host_vectors, m=m,
                                              row_scales=store.host_scales)
        else:
            ivf = IVFIndex.build(index.vectors, index.valid.cpu().numpy(),
                                 nlist=cfg.ivf_nlist or None)
            scales = index.vec_scales if cfg.vector_dtype == "int8" else None
            if self.vector_backend == "packed":
                self._ann = PackedIVF.from_ivf(ivf, index.vectors, row_scales=scales)
            elif self.vector_backend == "pq":
                self._ann = PackedPQ.from_ivf(ivf, index.vectors, m=m, row_scales=scales)
            elif self.vector_backend == "proj":
                self._ann = PackedProj.from_ivf(ivf, index.vectors, p=cfg.proj_p,
                                                row_scales=scales,
                                                reserve_slabs=cfg.ann_reserve_slabs)
            else:
                self._ann = ivf
        self._ann_generation = self.store.generation
        self._ann_nprobe = None
        # (host residency serves pq or proj only: no calibration there)
        if cfg.ivf_target_recall > 0 and self.vector_backend in ("ivf", "packed"):
            self._calibrate_nprobe(cfg.ivf_target_recall)
        return self._ann

    def save_ann(self, path: str) -> dict:
        """Write the built ANN tables next to a store snapshot, in the JAX
        package's ann_io format. Returns the meta header written."""
        from mobius_rag_tpu_torch.index.ann_io import save_ann as _save

        ann = self.ensure_ann()
        if ann is None:
            raise ValueError("exact backend has no ANN tables to save")
        meta = {"backend": self.vector_backend, "rows": len(self.store.records),
                "dim": self.cfg.embed_dim, "nprobe": self._ann_nprobe}
        _save(ann, path, meta=meta)
        return meta

    def load_ann(self, path: str) -> dict:
        """Adopt saved ANN tables for the current store (written by either
        package's save_ann against the matching snapshot). Refuses on a
        backend or row-count mismatch."""
        from mobius_rag_tpu_torch.index.ann_io import load_ann as _load

        ann, meta = _load(path, self.device)
        if meta.get("backend") != self.vector_backend:
            raise ValueError(f"ann file is for backend {meta.get('backend')!r}, "
                             f"engine serves {self.vector_backend!r}")
        if meta.get("rows") != len(self.store.records):
            raise ValueError(
                f"ann file indexed {meta.get('rows')} rows, store has "
                f"{len(self.store.records)}: snapshot/ann pairing broken")
        self._ann = ann
        self._ann_generation = self.store.generation
        self._ann_nprobe = meta.get("nprobe")
        self._reset_ann_incremental()
        return meta

    @property
    def effective_nprobe(self) -> int:
        return self._ann_nprobe or self.cfg.ivf_nprobe

    # -- the host re-rank (host residency) -----------------------------------

    def _device_k(self, k: int) -> int:
        """Result width of the device program: k, or k·over_fetch under
        host residency, so the exact host re-rank has candidates to
        reorder."""
        if self.store.host_vectors is None:
            return k
        return min(k * self.cfg.over_fetch, self.store.capacity)

    def _device_funnel(self, k: int) -> int:
        """The vector arm's funnel width under host residency (0
        elsewhere): MRAG_HOST_FUNNEL, auto = max(512, k·over_fetch)."""
        if self.store.host_vectors is None:
            return 0
        w = self.cfg.host_funnel or max(512, k * self.cfg.over_fetch)
        return int(min(w, self.store.capacity))

    def _host_rerank(self, reqs, exps, out: dict, k: int) -> dict:
        """Exact re-rank of the fused (and funnel) candidates from the host
        int8 matrix: sim = max(exact cosine, normalized lexical), the v1.3
        weighted score, a stable sort with an rrf epsilon, the first
        occurrence of each row, the top k. Host numpy, line for line the
        JAX engine's (``engine.py:1387-1461``); the cosines come from the
        native gather (cpp/rerank.cc) or, without a C++ toolchain, the
        numpy expression."""
        hv, hs = self.store.host_vectors, self.store.host_scales
        idx = np.asarray(out["idx"])
        alive = np.asarray(out["rerank"]) > NEG_INF / 2
        lexn = np.asarray(out["lexn"])
        auth, lng = np.asarray(out["auth"]), np.asarray(out["len"])
        jpd, cov = np.asarray(out["jpd"]), np.asarray(out["cov"])
        rrf = np.asarray(out["rrf"])
        if "wide_idx" in out:
            # the funnel union: fused top-kd and the vector arm's top-W,
            # each with its device signals; duplicates resolve after scoring
            idx = np.concatenate([idx, out["wide_idx"]], axis=1)
            alive = np.concatenate(
                [alive, np.asarray(out["wide_vals"]) > NEG_INF / 2], axis=1)
            lexn = np.concatenate([lexn, out["wide_lexn"]], axis=1)
            auth = np.concatenate([auth, out["wide_auth"]], axis=1)
            lng = np.concatenate([lng, out["wide_len"]], axis=1)
            jpd = np.concatenate([jpd, out["wide_jpd"]], axis=1)
            cov = np.concatenate([cov, out["wide_cov"]], axis=1)
            rrf = np.concatenate(
                [rrf, np.zeros_like(np.asarray(out["wide_vals"]))], axis=1)
        qv = self._embeddings(reqs)  # [B, D] normalized float32
        cos = native.gather_cos(hv, hs, idx, qv)
        if cos is None:
            safe = np.clip(idx, 0, hv.shape[0] - 1)
            rows = hv[safe].astype(np.float32) * hs[safe][..., None]
            cos = np.einsum("bwd,bd->bw", rows, qv.astype(np.float32))
        sim = np.clip(np.maximum(cos, lexn), 0.0, 1.0)
        has_jpd = np.array([1.0 if exp.tag_ids["d"] else 0.0 for exp in exps])[:, None]
        has_cov = np.array([1.0 if exp.phrase_slots else 0.0 for exp in exps])[:, None]
        w_jpd, w_cov = W_JPD * has_jpd, W_COV * has_cov
        max_w = W_SIM + W_AUTH + W_LEN + w_jpd + w_cov
        score = (W_SIM * sim + W_AUTH * auth + W_LEN * lng
                 + w_jpd * jpd + w_cov * cov) / np.maximum(max_w, 1e-6)
        score = np.where(alive, score, NEG_INF)
        if "wide_idx" in out:
            # a row in both sets: keep its first copy in score order (the
            # epsilon breaks ties toward the rrf-carrying fused copy)
            full = np.argsort(-(score + rrf * 1e-6), axis=1, kind="stable")
            sid = np.take_along_axis(idx, full, axis=1)
            order = np.empty((idx.shape[0], k), np.int64)
            for i in range(idx.shape[0]):
                _, first = np.unique(sid[i], return_index=True)
                first.sort()
                sel = first[:k]
                if len(sel) < k:
                    sel = np.concatenate([sel, np.full(k - len(sel), sel[-1])])
                order[i] = full[i, sel]
        else:
            order = np.argsort(-score, axis=1)[:, :k]

        def take(a):
            return np.take_along_axis(np.asarray(a), order, axis=1)

        new = {key: v for key, v in out.items() if not key.startswith("wide_")}
        new.update({
            "rerank": take(score), "sim": take(sim), "cos": take(cos), "idx": take(idx),
            "auth": take(auth), "len": take(lng), "jpd": take(jpd), "cov": take(cov),
            "rrf": take(rrf), "lexn": take(lexn),
        })
        return new

    @property
    def cross_encoder(self):
        return self._cross_encoder

    @cross_encoder.setter
    def cross_encoder(self, model) -> None:
        """None, or a callable (query, [texts]) → scores [len(texts)] (e.g.
        ``models.cross_encoder.CrossEncoderModel``) that rescores each
        result's hits."""
        if model is not None and not callable(model):
            raise TypeError(f"a cross-encoder is called as model(query, texts); got "
                            f"{type(model).__name__}")
        self._cross_encoder = model

    # -- host-side query prep ---------------------------------------------

    def prepare_query(self, req: QueryRequest
                      ) -> tuple[dict[str, np.ndarray], LexiconExpansion,
                                 dict[int, float]]:
        cfg = self.cfg
        if req.mode not in _MODES:
            raise ValueError(f"mode {req.mode!r} must be one of {_MODES}")
        if req.tag_mode not in ("strict", "relaxed", "none"):
            raise ValueError(f"tag_mode {req.tag_mode!r} must be strict|relaxed|none")
        cache_key = (req.query, req.mode, req.payer, req.state, req.program,
                     float(req.min_similarity), req.tag_mode, req.inherit_authority)
        token = (self.store.generation,
                 self.lexicon.num_phrases if self.lexicon else 0)
        hit = self._prep_cache.get(cache_key)
        if hit is not None and hit[0] == token:
            self._prep_cache.move_to_end(cache_key)
            return hit[1], hit[2], hit[3]
        exp = self.lexicon.expand(req.query) if self.lexicon else LexiconExpansion()

        df, n_live = self.store.lexical_stats()
        lex_w = query_lexical_weights(req.query, exp.expansion_phrases, df, n_live,
                                      cfg.lexical_buckets)

        slots = exp.phrase_slots[:MAX_PHRASE_SLOTS]
        s_word = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_bit = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_jword = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_jbit = np.zeros(MAX_PHRASE_SLOTS, np.int32)
        s_isj = np.zeros(MAX_PHRASE_SLOTS, np.float32)
        s_weight = np.zeros(MAX_PHRASE_SLOTS, np.float32)
        for i, (pid, weight, jtag) in enumerate(slots):
            if pid >= cfg.phrase_words * 32:
                continue  # phrase id beyond bitset capacity: skip the slot
            s_word[i] = pid // 32
            s_bit[i] = pid % 32
            s_weight[i] = weight
            if 0 <= jtag < cfg.tag_words * 32:
                s_isj[i] = 1.0
                s_jword[i] = jtag // 32
                s_jbit[i] = jtag % 32

        def meta_id(interner, value):
            # "" → -1 = no filter; an unknown value → -2, which matches no row
            if not value:
                return -1
            return interner.to_id.get(value, -2)

        q = {
            "payer": np.int32(meta_id(self.store.payers, req.payer)),
            "state": np.int32(meta_id(self.store.states, req.state)),
            "program": np.int32(meta_id(self.store.programs, req.program)),
            "j_bits": pack_bits(exp.tag_ids["j"], cfg.tag_words),
            "d_bits": pack_bits(exp.tag_ids["d"], cfg.tag_words),
            "p_bits": pack_bits(exp.tag_ids["p"], cfg.tag_words),
            "min_sim": np.float32(req.min_similarity),
            "inherit_authority": np.float32(1.0 if req.inherit_authority else 0.0),
            "tag_mode": np.int32({"strict": 0, "relaxed": 1, "none": 2}[req.tag_mode]),
            "arm_weights": np.asarray(_MODE_ARM_WEIGHTS[req.mode], np.float32),
            "slot_word": s_word,
            "slot_bit": s_bit,
            "slot_jword": s_jword,
            "slot_jbit": s_jbit,
            "slot_isj": s_isj,
            "slot_weight": s_weight,
            "d_tag_ids": query_dtag_ids(exp.tag_ids["d"], cfg.tag_words),
        }
        if len(self._prep_cache) >= self._prep_cache_max:
            self._prep_cache.popitem(last=False)
        self._prep_cache[cache_key] = (token, q, exp, lex_w)
        return q, exp, lex_w

    def prepare_host(self, reqs: Sequence[QueryRequest], ready=None):
        """The batched query arrays on the host (numpy): per-query arrays
        stacked, the lexical contraction as the union bucket list [U] with
        per-query weights [B, U], U padded as the JAX engine pads it
        (``engine.py:1576-1588``: the first of 128, 512, 2,048 that holds
        the union, else the bucket count; pad columns name bucket 0 at
        weight 0; a union past the pad keeps its first U buckets), and the
        normalized float32 queries. Returns (dict, expansions). Nothing
        here waits for work already enqueued on the device; ``ready`` (a
        CUDA event after the index's last write, default now) orders the
        strict counts of local gating after the index."""
        vecs = self._embeddings(reqs)
        prepared = [self.prepare_query(r) for r in reqs]
        host = {key: np.stack([p[0][key] for p in prepared]) for key in prepared[0][0]}
        union: dict[int, int] = {}
        for _, _, lex_w in prepared:
            for b in lex_w:
                union.setdefault(b, len(union))
        u_pad = next((p for p in _BUCKET_PADS if len(union) <= p), self.cfg.lexical_buckets)
        if len(union) > u_pad:  # past the largest pad: the first u_pad buckets
            union = {b: i for b, i in union.items() if i < u_pad}
        buckets = np.zeros(u_pad, np.int32)
        buckets[:len(union)] = np.fromiter(union, np.int32, len(union))
        weights = np.zeros((len(reqs), u_pad), np.float32)
        for bi, (_, _, lex_w) in enumerate(prepared):
            for b, w in lex_w.items():
                if b in union:
                    weights[bi, union[b]] = w
        host["lex_buckets"] = buckets
        host["lex_weights"] = weights
        if self._local_gating_active() and self._ann is not None:
            host["strict_total"] = self._strict_totals(prepared, ready)
        host["vec"] = vecs
        return PreparedBatch(host, len(union)), [p[1] for p in prepared]

    def prepare_batch(self, reqs: Sequence[QueryRequest], ready=None):
        """The batched query dict on the device: :meth:`prepare_host`'s
        arrays (u32 bitsets as int32 bit patterns, the union at its padded
        width), the queries rounded to bf16. Returns (DeviceBatch,
        expansions)."""
        host, exps = self.prepare_host(reqs, ready)
        return DeviceBatch(_bf16(to_device(host, self.device)), host), exps

    def _union_read(self, q: PreparedBatch) -> int:
        """The lexical union columns this engine's device program reads.
        On a card, the live ones rounded up (:func:`_union_width`) so that
        the captured graphs stay few, eager or captured alike, sharded or
        not; the CPU, which never captures, reads exactly the live ones."""
        if self.device.type == "cuda":
            return _union_width(q.union, q["lex_buckets"].shape[0])
        return q.union

    def _device_batch(self, q: PreparedBatch) -> dict[str, torch.Tensor]:
        """`q` as this engine's device program reads it, on its device: the
        union cut to :meth:`_union_read` columns, the queries in bf16."""
        return _bf16(to_device(_cut_union(q, self._union_read(q)), self.device))

    def _strict_totals(self, prepared, ready=None) -> np.ndarray:
        """Host-cached global strict-eligible counts per request (the
        auto-relax branch's input), keyed on the filter signature and the
        store generation; the misses of a batch go through one
        gating.strict_counts call (see _count_strict)."""
        gen = self.store.generation
        counts = np.zeros(len(prepared), np.float32)
        missing: list[tuple[int, tuple]] = []
        for i, (qq, _, _) in enumerate(prepared):
            sig = (gen, int(qq["payer"]), int(qq["state"]), int(qq["program"]),
                   float(qq["inherit_authority"]), qq["j_bits"].tobytes())
            hit = self._strict_cache.get(sig)
            if hit is None:
                missing.append((i, sig))
            else:
                self._strict_cache.move_to_end(sig)
                counts[i] = hit
        if missing:
            vals = self._count_strict(
                {key: np.stack([prepared[i][0][key] for i, _ in missing])
                 for key in ("payer", "state", "program", "inherit_authority", "j_bits")},
                ready)
            for (i, sig), v in zip(missing, vals.tolist()):
                counts[i] = v
                if len(self._strict_cache) >= 4096:
                    self._strict_cache.popitem(last=False)
                self._strict_cache[sig] = v
        return counts

    def _count_strict(self, host: dict, ready=None) -> np.ndarray:
        """gating.strict_counts for the filter fields in `host`, on the
        host. On a card the counts run on a stream of their own, after
        `ready` (default: an event recorded now on the current stream): they
        read only the index, so they need not wait for the batches enqueued
        since, and the host waits for this stream's event alone."""
        dev = self.device
        if dev.type != "cuda":
            return gating.strict_counts(self.store.index, to_device(host, dev)).numpy()
        if ready is None:
            ready = torch.cuda.Event()
            ready.record()
        if self._count_stream is None:
            self._count_stream = torch.cuda.Stream(device=dev)
        side = self._count_stream
        with torch.cuda.stream(side):
            side.wait_event(ready)
            counts = gating.strict_counts(self.store.index, to_device(host, dev))
            out = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
            out.copy_(counts, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return out.numpy()

    def _logged_query_vectors(self, want: int) -> np.ndarray | None:
        """Embeddings of up to `want` recent distinct queries from the
        telemetry log (search_events), the served distribution for a
        calibration sample. None without a telemetry store or an embedder,
        or when the log is empty."""
        if self.telemetry is None or self.embed_fn is None or want <= 0:
            return None
        try:
            events = self.telemetry.recent_search_events(limit=max(200, want * 4))
        except sqlite3.Error:
            return None
        seen: set[str] = set()
        texts: list[str] = []
        for ev in events:
            qt = (ev.get("query") or "").strip()
            if qt and qt.lower() not in seen:
                seen.add(qt.lower())
                texts.append(qt)
            if len(texts) >= want:
                break
        if not texts:
            return None
        return self._embeddings([QueryRequest(query=t) for t in texts])

    def _calibrate_nprobe(self, target: float, sample: int = 32) -> dict:
        """Per-corpus auto-nprobe (index.ivf.calibrate_nprobe) on a sample of
        recent logged queries (with a telemetry store) and self-queries:
        live rows drawn by ``np.random.default_rng(0)``, perturbed by 0.02
        N(0, 1) per dimension and normalized. The JAX engine draws that
        noise with ``jax.random.normal(PRNGKey(0))``; the port draws it
        from a ``torch.Generator`` seeded 0, so the two samples differ."""
        index = self.store.index
        live = np.flatnonzero(index.valid.cpu().numpy() > 0)
        if len(live) == 0:
            return {}
        logged = self._logged_query_vectors(sample // 2)
        n_logged = 0 if logged is None else len(logged)
        n_self = max(sample - n_logged, 1)
        rng = np.random.default_rng(0)
        rows = torch.from_numpy(rng.choice(live, size=min(n_self, len(live)),
                                           replace=False)).to(self.device)
        int8 = self.cfg.vector_dtype == "int8"
        qv = index.vectors[rows].float()
        if int8:
            qv = qv * index.vec_scales[rows][:, None]
        noise = torch.Generator(device=self.device).manual_seed(0)
        qv = qv + 0.02 * torch.randn(qv.shape, generator=noise, device=self.device)
        qv = qv / torch.linalg.norm(qv, dim=1, keepdim=True)
        if n_logged:
            qv = torch.cat([torch.from_numpy(logged).to(self.device), qv])
        cal = calibrate_nprobe(self._ann, index.vectors, qv, k=self.cfg.default_k,
                               target_recall=target,
                               row_scales=index.vec_scales if int8 else None)
        cal["logged_queries"] = n_logged
        self._ann_nprobe = cal["nprobe"]
        self._ann_calibration = cal
        return cal

    def _embeddings(self, reqs: Sequence[QueryRequest]) -> np.ndarray:
        def cache_key(q: str) -> str:
            return q.strip().lower()

        need = [r.query for r in reqs
                if r.embedding is None and cache_key(r.query) not in self._embed_cache]
        if need and self.embed_fn is None:
            raise ValueError("QueryRequest.embedding missing and no embed_fn attached")
        if need:
            for q, v in zip(need, self.embed_fn(need)):
                if len(self._embed_cache) >= self._embed_cache_max:
                    self._embed_cache.popitem(last=False)
                self._embed_cache[cache_key(q)] = np.asarray(v, np.float32)
        out = []
        for r in reqs:
            if r.embedding is not None:
                v = np.asarray(r.embedding, np.float32)
            else:
                key = cache_key(r.query)
                self._embed_cache.move_to_end(key)
                v = self._embed_cache[key]
            n = np.linalg.norm(v)
            out.append(v / n if n > 0 else v)
        return np.stack(out)

    # -- public API ---------------------------------------------------------

    def _packed(self, q: PreparedBatch, exps, ann, local, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """One prepared batch (:meth:`prepare_host`'s, or the host arrays
        behind :meth:`prepare_batch`'s tensors) through its device program,
        and the program's two packed output arrays, enqueued: over the
        device grid when a sharded engine is attached, else on this
        engine's device; as a captured graph's replay when ``graphs`` is
        on. The program is search_batch (or the sharded engine's program)
        at the device width (k, or k·over_fetch with a funnel under host
        residency), then pack_device."""
        q = getattr(q, "host", q)
        kd, fw = self._device_k(k), self._device_funnel(k)
        if self.sharded is not None:
            # the host part (refresh, ANN tables, widths) before any capture
            plan = self.sharded.plan(q["vec"].shape[0], kd, fw)
            key, held, run = plan.key, plan.held, plan.program
        else:
            cfg = self.cfg
            nprobe = self.effective_nprobe
            tag_level = self._batch_tag_level(exps) if local else 2
            # the tables as they stand now: a write on another thread that
            # replaces one (a grow, a postings resize) reaches the next batch
            index = self.store.index
            index = DeviceIndex(**{f: getattr(index, f) for f in index.fields})

            def run(qd):
                return search_batch(index, qd, kd, cfg.over_fetch, cfg.rrf_k, ann=ann,
                                    nprobe=nprobe, approx=cfg.ann_approx_topk, local=local,
                                    tag_level=tag_level, funnel=fw)

            key = (kd, fw, cfg.over_fetch, cfg.rrf_k, nprobe, cfg.ann_approx_topk, tag_level,
                   type(ann).__name__)
            held = tables_held(index, ann, local)

        def program(qd):
            return pack_device(run(_bf16(qd)), fw)

        host = _cut_union(q, self._union_read(q))
        if not self.graphs:
            return program(to_device(host, self.device))
        if self.sharded is not None and not self.sharded.one_device:
            # a graph per device and stage, the stages joined between devices
            return plan.staged(self.programs, host, _bf16, lambda out: pack_device(out, fw))
        return self.programs.run(key, held, host, program)

    def _dispatch(self, q: PreparedBatch, exps, ann, local, k: int) -> PendingFetch:
        """The device side of one batch (`q` as :meth:`_packed` takes it):
        its program, the output packing and the copies of the two packed
        arrays to the host, all enqueued; nothing here waits for the
        device. A captured program runs under ``compiled.LOCK`` up to its
        copies (see query/compiled.py)."""
        with LOCK if self.graphs else contextlib.nullcontext():
            return PendingFetch(self._packed(q, exps, ann, local, k))

    def _finish(self, reqs, exps, fetched, k: int) -> dict[str, np.ndarray]:
        """The packed arrays of one batch, on the host → its output dict,
        re-ranked exactly from the host rows under host residency."""
        kd, fw = self._device_k(k), self._device_funnel(k)
        out = unpack_out(fetched, kd, fw)
        if kd != k or fw:
            out = self._host_rerank(list(reqs), exps, out, k)
        return out

    def _tables(self):
        """(ANN tables, local-gating structures) of this engine's own device
        program, built before a batch is prepared (local gating bakes the
        host strict counts into it); (None, None) under sharding, whose
        tables the sharded engine keeps: brought up to date here, outside
        ``compiled.LOCK`` (a re-shard or a per-shard ANN build takes
        seconds at 1M rows), so a batch's host part finds them current."""
        if self.sharded is not None:
            self.sharded.refresh()
            self.sharded.ensure_ann()
            return None, None
        ann = self.ensure_ann()
        return ann, self._ensure_local_structs(ann)

    def _run(self, reqs: Sequence[QueryRequest], k: int):
        ann, local = self._tables()
        q, exps = self.prepare_host(reqs)
        t_prep = time.perf_counter()
        out = self._finish(reqs, exps, self._dispatch(q, exps, ann, local, k).wait(), k)
        return exps, out, t_prep

    def search(self, reqs: Sequence[QueryRequest] | QueryRequest, k: int | None = None
               ) -> list[SearchResult]:
        if isinstance(reqs, QueryRequest):
            reqs = [reqs]
        k = k or self.cfg.default_k
        t0 = time.perf_counter()
        exps, out, t_prep = self._run(reqs, k)
        t_dev = time.perf_counter()
        timings = {
            "prepare": (t_prep - t0) * 1e3 / len(reqs),
            "device": (t_dev - t_prep) * 1e3 / len(reqs),
        }
        return self._assemble(list(reqs), exps, out, k, timings)

    def search_pipelined(self, batches: Sequence[Sequence[QueryRequest]],
                         k: int | None = None) -> list[list[SearchResult]]:
        """Bulk search: the same results as one `search` per batch (with
        empty timings, as the JAX engine's pipelined path reports). Every
        batch is prepared and dispatched before any is fetched (see the
        module docstring), so on a card the host's fetch, re-rank and
        assembly of one batch overlap the device work of the later ones."""
        k = k or self.cfg.default_k
        ann, local = self._tables()
        ready = None
        if self.device.type == "cuda":  # the index as it stands before the first batch
            ready = torch.cuda.Event()
            ready.record()
        pending = []
        for batch in batches:
            q, exps = self.prepare_host(batch, ready)
            pending.append((batch, exps, self._dispatch(q, exps, ann, local, k)))
        return [self._assemble(list(batch), exps,
                               self._finish(batch, exps, fetch.wait(), k), k)
                for batch, exps, fetch in pending]

    # Neighbor-expansion caps (per hit, per document).
    MAX_NEIGHBORS_PER_HIT = 2
    MAX_NEIGHBOR_CHUNKS_PER_DOC = 4

    def _expand_with_neighbors(self, hits: list[SearchHit]) -> None:
        """Attach adjacent same-document chunks to each hit: ±1 rows in
        publish order within the same doc, deduped against hits already
        present, capped per doc."""
        hit_rows = {h.row for h in hits}
        per_doc: dict[str, int] = {}
        for h in hits:
            rec = self.store.record(h.row)
            if rec is None:
                continue
            doc_rows = self.store._doc_rows.get(h.doc_id, [])
            try:
                pos = doc_rows.index(h.row)
            except ValueError:
                continue
            for npos in (pos - 1, pos + 1):
                if not (0 <= npos < len(doc_rows)):
                    continue
                nrow = doc_rows[npos]
                if nrow in hit_rows:
                    continue
                if per_doc.get(h.doc_id, 0) >= self.MAX_NEIGHBOR_CHUNKS_PER_DOC:
                    break
                nrec = self.store.record(nrow)
                if nrec is None:
                    continue
                if len(h.neighbors) >= self.MAX_NEIGHBORS_PER_HIT:
                    break
                h.neighbors.append({
                    "chunk_id": nrec.chunk_id, "text": nrec.text,
                    "section_path": nrec.section_path, "page": nrec.page,
                    "position": "before" if npos < pos else "after",
                })
                per_doc[h.doc_id] = per_doc.get(h.doc_id, 0) + 1

    # Signal channels materialized per hit, in out-dict key order.
    _SIGNAL_KEYS = (("sim", "sim"), ("cos", "cosine"), ("auth", "authority"),
                    ("len", "length"), ("jpd", "jpd"), ("cov", "coverage"),
                    ("rrf", "rrf"))

    def _assemble(self, reqs: list[QueryRequest], exps, out, k: int,
                  timings: dict | None = None) -> list[SearchResult]:
        cfg = self.cfg
        cols = {key: np.asarray(v).tolist() for key, v in out.items()}
        results = []
        for bi, req in enumerate(reqs):
            # corpus/precision drop abstain-grade hits; recall keeps all
            floor = 0.0 if MODE_MIN_LABEL.get(req.mode) == "abstain" \
                else cfg.confidence_low
            rerank_b = cols["rerank"][bi]
            idx_b = cols["idx"][bi]
            sig_b = [cols[src][bi] for src, _ in self._SIGNAL_KEYS]
            hits = []
            for j in range(k):
                score = rerank_b[j]
                if score <= NEG_INF / 2 or score < floor:
                    continue
                row = idx_b[j]
                rec = self.store.record(row)
                if rec is None:
                    continue
                hits.append(SearchHit(
                    row=row,
                    chunk_id=rec.chunk_id,
                    doc_id=rec.doc_id,
                    text=rec.text,
                    score=score,
                    similarity=sig_b[0][j],
                    signals={name: col[j] for (_, name), col
                             in zip(self._SIGNAL_KEYS, sig_b)},
                    metadata={
                        "payer": rec.payer, "state": rec.state,
                        "program": rec.program, "filename": rec.filename,
                        "section_path": rec.section_path, "page": rec.page,
                        "authority_level": rec.authority_level,
                    },
                ))
            if self._cross_encoder is not None and hits:
                ce = self._cross_encoder(req.query, [h.text for h in hits])
                for h, s in zip(hits, ce):
                    h.signals["cross_encoder"] = float(s)
                # stable re-sort by the cross-encoder's logit; the confidence
                # label keeps the linear rerank score
                hits.sort(key=lambda h: -h.signals["cross_encoder"])
            self._expand_with_neighbors(hits)
            label = _confidence_label(max(h.score for h in hits), cfg) \
                if hits else "abstain"
            exp = exps[bi]

            def _arm_trace(name):
                idxs = cols[f"{name}_idx"][bi]
                vals = cols[f"{name}_vals"][bi]
                return [{"row": i, "score": v}
                        for i, v in zip(idxs, vals) if v > NEG_INF / 2][:k]

            results.append(SearchResult(
                query=req.query,
                hits=hits,
                confidence_label=label,
                expansion=exp,
                telemetry={
                    "timings_ms": timings or {},
                    "arms": {
                        "vector": _arm_trace("vec"),
                        "lexical": _arm_trace("lex"),
                        "dtag": _arm_trace("dtag"),
                    },
                    "strict_count": int(cols["strict_count"][bi]),
                    "expansion_log": exp.log,
                    "mode": req.mode,
                },
            ))
            if self.telemetry is not None:
                result = results[-1]
                self.telemetry.record_search_event(
                    query=req.query, mode=req.mode,
                    timings=result.telemetry["timings_ms"],
                    arms={a: len(v) for a, v in result.telemetry["arms"].items()},
                    expansion=exp.matched_codes,
                    results=[{"chunk_id": h.chunk_id, "score": h.score,
                              "signals": h.signals} for h in hits],
                    extra={"strict_count": result.telemetry["strict_count"],
                           "confidence": label},
                )
        return results
