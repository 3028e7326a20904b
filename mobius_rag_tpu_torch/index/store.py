"""Device-resident chunk index on one torch device (the port of
``mobius_rag_tpu.index.store``).

Layout (fixed-capacity tensors; capacity doubles on overflow, unused rows
masked by ``valid``):

  vectors      [C, D]   f32/bf16/int8  L2-normalized chunk embeddings
                                  ([0, D] under host residency)
  vec_scales   [C]      f32       per-row dequant scales (1.0 unless int8)
  valid        [C]      f32       1.0 = live row, 0.0 = hole/pad
  doc_id       [C]      i32       int-coded document
  authority    [C]      f32       authority_level normalized to [0, 1]
  length_score [C]      f32       precomputed body-length signal
  payer/state/program [C] i32     int-coded canonical metadata
  j/d/p_tags   [C, TW]  i32       tag bitsets (u32 bit patterns)
  phrase_bits  [C, PW]  i32       lexicon-phrase presence bitsets (u32 bits)
  lexical      [H, C]   bf16      hashed-term BM25 weights, bucket-major
                                  (MRAG_LEXICAL_FORMAT=dense), or
  lex_cols     [H, P]   i32       sparse postings: chunk rows (-1 pad) and
  lex_wts      [H, P]   bf16      their weights (MRAG_LEXICAL_FORMAT=sparse);
                                  P grows by doubling from
                                  lexical_postings_init and is pruned by
                                  impact at lexical_postings_max

torch has few uint32 kernels, so every bitset keeps the JAX package's u32
bit pattern in an int32 tensor: AND/OR are the same bits, and the engine
tests ``!= 0`` and masks every shift (``>>`` on int32 is arithmetic).

The host keeps the row ↔ ChunkRecord map for assembly. Writes are
publish-grain: ``publish_document`` = delete_by_document + append, and
rows freed by deletes are recycled before the index grows. Writes are
in-place row assignments; no padded write blocks are needed because
nothing recompiles. Every mutation bumps ``generation`` and tells the
``listeners`` (event ``add``/``delete``/``grow``/``bulk`` with its rows), as
the JAX store does; the engine's ANN maintenance listens.

int8 rows (``MRAG_VECTOR_DTYPE=int8``) are symmetric per-row max-abs
quantized: ``add_chunks`` quantizes each row on the host in numpy,
``bulk_load`` on the device (``ops.quant.quantize_rows``), each with the
JAX store's arithmetic, so both packages hold the same bytes.

Host residency (``MRAG_VECTOR_RESIDENCY=host``, the 10M configuration):
the int8 rows and their scales live in host RAM (``host_vectors
[cap, D]`` int8, ``host_scales [cap]`` f32, numpy; page-locked when the
store's device is CUDA, so uploads from them are asynchronous DMA) and
serve the engine's exact post-fusion re-rank; the device index keeps a
``[0, D]`` vectors tensor and the ANN codes are built from the host
matrix. Host residency with the pq backend is not ported yet (ROADMAP
queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.ops.quant import _quantize_block, quantize_rows
from mobius_rag_tpu_torch.utils import round_up

# Capacity granularity; matches the JAX store's write block so that both
# packages give the same capacity C (and so the same m = min(k·of, C)).
_WRITE_BLOCK = 256

# Rows quantized on the device per block when bulk_load takes a tensor
# under host residency (bounds the float32 transient).
_HOST_QUANT_BLOCK = 250_000

BITSET_FIELDS = ("j_tags", "d_tags", "p_tags", "phrase_bits")
BF16_FIELDS = ("vectors", "lexical", "lex_wts")


def pack_bits(ids: Iterable[int], words: int) -> np.ndarray:
    """Pack small-int ids into a uint32 bitset of `words` words."""
    acc = 0
    limit = words * 32
    for i in ids:
        if 0 <= i < limit:
            acc |= 1 << int(i)  # int(): numpy scalars overflow at 1<<63
    if acc == 0:
        return np.zeros(words, dtype=np.uint32)
    return np.frombuffer(acc.to_bytes(words * 4, "little"),
                         dtype=np.uint32).copy()


def unpack_bits(bits: np.ndarray) -> list[int]:
    """Inverse of pack_bits; takes u32 words or their int32 bit patterns."""
    out = []
    for w, word in enumerate(np.asarray(bits).view(np.uint32)):
        word = int(word)
        b = 0
        while word:
            if word & 1:
                out.append(w * 32 + b)
            word >>= 1
            b += 1
    return out


@dataclasses.dataclass
class ChunkRecord:
    """One published chunk: host-side record plus everything needed to
    build its device row."""

    chunk_id: str
    doc_id: str
    text: str
    embedding: np.ndarray  # [D] (will be L2-normalized)
    source_id: str = ""  # embeddable-unit id, for incremental resume
    authority_level: int = 0  # 0..4 (higher = more authoritative)
    payer: str = ""
    state: str = ""
    program: str = ""
    filename: str = ""
    section_path: str = ""
    summary: str = ""
    page: int = 0
    j_tags: list[int] = dataclasses.field(default_factory=list)
    d_tags: list[int] = dataclasses.field(default_factory=list)
    p_tags: list[int] = dataclasses.field(default_factory=list)
    phrase_ids: list[int] = dataclasses.field(default_factory=list)
    lexical_weights: dict[int, float] = dataclasses.field(default_factory=dict)
    neighbor_text: str = ""
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


def _check_supported(cfg: Config) -> None:
    if cfg.vector_residency == "host" and cfg.vector_backend == "pq":
        raise NotImplementedError(
            "MRAG_VECTOR_RESIDENCY=host with the pq backend is not ported yet "
            "(ROADMAP queue 1, item 10)")


def _vec_dtype(cfg: Config) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}[cfg.vector_dtype]


_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32}


def host_array(shape: tuple[int, ...], dtype, fill, device) -> np.ndarray:
    """A numpy array filled with `fill`; on a CUDA store's host it lives in
    page-locked memory (a pinned torch tensor, which the array keeps
    alive), so copies from it to the card are asynchronous DMA."""
    if torch.device(device).type == "cuda":
        t = torch.empty(shape, dtype=_TORCH_DTYPE[np.dtype(dtype)], pin_memory=True)
        return t.fill_(fill).numpy()
    return np.full(shape, fill, dtype)


def _quantize_host(v: np.ndarray) -> tuple[np.ndarray, float]:
    """One normalized float32 row → (its int8 values as float32, scale):
    the JAX store's add_chunks arithmetic (``store.py:475-479``)."""
    max_abs = float(np.abs(v).max())
    scale = max_abs / 127.0 if max_abs > 0 else 1.0
    return np.clip(np.round(v / scale), -127, 127), scale


class DeviceIndex:
    """A plain container of the index tensors, all on one device. The
    lexical layout is ``FIELDS`` (dense ``lexical``) or ``SPARSE_FIELDS``
    (``lex_cols`` + ``lex_wts``); ``fields`` names the one in use."""

    FIELDS = (
        "vectors", "vec_scales", "valid", "doc_id", "authority", "length_score",
        "payer", "state", "program",
        "j_tags", "d_tags", "p_tags", "phrase_bits",
        "lexical",
    )
    SPARSE_FIELDS = FIELDS[:-1] + ("lex_cols", "lex_wts")

    def __init__(self, **tensors: torch.Tensor):
        layout = self.FIELDS if "lexical" in tensors else self.SPARSE_FIELDS
        if set(tensors) != set(layout):
            raise ValueError(
                f"DeviceIndex needs exactly {self.FIELDS} or {self.SPARSE_FIELDS}, "
                f"got {sorted(tensors)}")
        self.fields = layout
        for f in layout:
            setattr(self, f, tensors[f])

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @classmethod
    def empty(cls, capacity: int, cfg: Config, device) -> "DeviceIndex":
        c = capacity
        # host residency: no dense payload on the device
        c_vec = 0 if cfg.vector_residency == "host" else c
        kw = dict(device=device)
        if cfg.lexical_format == "sparse":
            h, p = cfg.lexical_buckets, cfg.lexical_postings_init
            lex = dict(lex_cols=torch.full((h, p), -1, dtype=torch.int32, **kw),
                       lex_wts=torch.zeros((h, p), dtype=torch.bfloat16, **kw))
        else:
            lex = dict(lexical=torch.zeros((cfg.lexical_buckets, c),
                                           dtype=torch.bfloat16, **kw))
        return cls(
            vectors=torch.zeros((c_vec, cfg.embed_dim), dtype=_vec_dtype(cfg), **kw),
            vec_scales=torch.ones((c,), dtype=torch.float32, **kw),
            valid=torch.zeros((c,), dtype=torch.float32, **kw),
            doc_id=torch.full((c,), -1, dtype=torch.int32, **kw),
            authority=torch.zeros((c,), dtype=torch.float32, **kw),
            length_score=torch.zeros((c,), dtype=torch.float32, **kw),
            payer=torch.full((c,), -1, dtype=torch.int32, **kw),
            state=torch.full((c,), -1, dtype=torch.int32, **kw),
            program=torch.full((c,), -1, dtype=torch.int32, **kw),
            j_tags=torch.zeros((c, cfg.tag_words), dtype=torch.int32, **kw),
            d_tags=torch.zeros((c, cfg.tag_words), dtype=torch.int32, **kw),
            p_tags=torch.zeros((c, cfg.tag_words), dtype=torch.int32, **kw),
            phrase_bits=torch.zeros((c, cfg.phrase_words), dtype=torch.int32, **kw),
            **lex,
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The fields in the JAX package's numpy form: bitsets as uint32,
        bf16 as its uint16 bit pattern (numpy has no bfloat16). Copies:
        later in-place writes to the index do not show through."""
        out = {}
        for f in self.fields:
            t = getattr(self, f).detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                out[f] = t.view(torch.int16).numpy().view(np.uint16)
            elif f in BITSET_FIELDS:
                out[f] = t.numpy().view(np.uint32)
            else:
                out[f] = t.numpy()
        return out


def _to_tensor(a: np.ndarray, field: str, device) -> torch.Tensor:
    """One JAX-form numpy field → its port tensor (bit patterns kept)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # np.load / jax.device_get arrays
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes array: same bits as uint16
        a = a.view(np.uint16)
    if a.dtype == np.uint16 and field in BF16_FIELDS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device)


def index_from_numpy(arrays: dict[str, np.ndarray], device) -> DeviceIndex:
    """Carry a JAX ``DeviceIndex`` (its fields fetched with
    ``jax.device_get``) over to the port: u32 bitsets become int32 with
    the same bits, bf16 (as ml_dtypes or a uint16 bit pattern) becomes
    ``torch.bfloat16`` bitwise."""
    layout = DeviceIndex.FIELDS if "lexical" in arrays else DeviceIndex.SPARSE_FIELDS
    return DeviceIndex(**{f: _to_tensor(arrays[f], f, device) for f in layout})


class _Interner:
    """String → dense int id (payer/state/program/doc interning)."""

    def __init__(self):
        self.to_id: dict[str, int] = {}
        self.to_str: list[str] = []

    def intern(self, s: str) -> int:
        if s not in self.to_id:
            self.to_id[s] = len(self.to_str)
            self.to_str.append(s)
        return self.to_id[s]

    def state_dict(self):
        return {"to_str": self.to_str}

    def load_state(self, st):
        self.to_str = list(st["to_str"])
        self.to_id = {s: i for i, s in enumerate(self.to_str)}


# Authority levels normalize to [0,1] over a 0..4 scale.
_AUTH_MAX = 4.0


def _length_score(text: str) -> float:
    """Body-length signal in [0,1]: ramps to 1.0 at ~600 chars, flat after."""
    return min(len(text) / 600.0, 1.0)


class ChunkStore:
    """Mutable host handle around a :class:`DeviceIndex` on `device`."""

    SNAPSHOT_VERSION = 1

    def __init__(self, cfg: Config | None = None, capacity: int | None = None,
                 device="cuda"):
        self.cfg = cfg or get_config()
        _check_supported(self.cfg)
        self.device = torch.device(device)
        cap = round_up(capacity or self.cfg.initial_capacity, _WRITE_BLOCK)
        self.index = DeviceIndex.empty(cap, self.cfg, self.device)
        self.records: list[ChunkRecord | None] = []
        self.docs = _Interner()
        self.payers = _Interner()
        self.states = _Interner()
        self.programs = _Interner()
        self._doc_rows: dict[str, list[int]] = {}
        self._source_ids: dict[str, set[str]] = {}  # doc → embedded source ids
        self._free_rows: list[int] = []
        self._lexical_stats_cache: tuple[dict[int, int], int] | None = None
        # Every mutation bumps `generation` (the engine's prepared-query
        # cache keys on it) and calls each listener with (event, rows).
        self.generation = 0
        self.listeners: list[Callable[[str, list[int]], Any]] = []
        self._sparse_lexical = self.cfg.lexical_format == "sparse"
        self._host_residency = self.cfg.vector_residency == "host"
        self.host_vectors: np.ndarray | None = None
        self.host_scales: np.ndarray | None = None
        if self._host_residency:
            self.host_vectors, self.host_scales = self._host_rows(cap)
        if self._sparse_lexical:
            h, p = self.cfg.lexical_buckets, self.cfg.lexical_postings_init
            # host mirrors of lex_cols/lex_wts (postings packed left,
            # -1-padded; weights in float32): writes mutate these, then
            # the touched buckets are copied to the device
            self._lex_cols_np = np.full((h, p), -1, np.int32)
            self._lex_wts_np = np.zeros((h, p), np.float32)
            self._lex_fill = np.zeros(h, np.int64)

    # -- sizing ----------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self.records) - len(self._free_rows)

    @property
    def capacity(self) -> int:
        return self.index.capacity

    def _host_rows(self, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """Fresh host-residency arrays: zero rows, unit scales."""
        return (host_array((cap, self.cfg.embed_dim), np.int8, 0, self.device),
                host_array((cap,), np.float32, 1.0, self.device))

    def _notify(self, event: str, rows: Sequence[int]) -> None:
        self.generation += 1
        for fn in self.listeners:
            fn(event, list(rows))

    def _ensure_capacity(self, extra: int) -> None:
        needed = len(self.records) + extra
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        grown = DeviceIndex.empty(new_cap, self.cfg, self.device)
        for f in grown.fields:
            old = getattr(self.index, f)
            if f in ("lex_cols", "lex_wts"):  # postings do not scale with rows
                setattr(grown, f, old)
            elif f == "lexical":  # bucket-major: rows are columns
                grown.lexical[:, :old.shape[1]] = old
            else:
                getattr(grown, f)[:old.shape[0]] = old
        self.index = grown
        if self._host_residency:
            hv, hs = self._host_rows(new_cap)
            hv[: len(self.host_vectors)] = self.host_vectors
            hs[: len(self.host_scales)] = self.host_scales
            self.host_vectors, self.host_scales = hv, hs
        self._notify("grow", [])

    # -- writes ------------------------------------------------------------

    def _stage(self, recs: Sequence[ChunkRecord], with_vectors: bool = True,
               quantize: bool = False) -> dict:
        """Host arrays (numpy) of every row field for `recs` except the
        lexical weights; `vectors` (normalized embeddings) only when
        `with_vectors`, int8-quantized per row (values held in float32,
        scales in `vec_scales`) when `quantize`."""
        cfg = self.cfg
        n = len(recs)
        st = {
            "vec_scales": np.ones(n, np.float32),
            "valid": np.ones(n, np.float32),
            "doc_id": np.zeros(n, np.int32),
            "authority": np.zeros(n, np.float32),
            "length_score": np.zeros(n, np.float32),
            "payer": np.zeros(n, np.int32),
            "state": np.zeros(n, np.int32),
            "program": np.zeros(n, np.int32),
            "j_tags": np.zeros((n, cfg.tag_words), np.uint32),
            "d_tags": np.zeros((n, cfg.tag_words), np.uint32),
            "p_tags": np.zeros((n, cfg.tag_words), np.uint32),
            "phrase_bits": np.zeros((n, cfg.phrase_words), np.uint32),
        }
        if with_vectors:
            st["vectors"] = np.zeros((n, cfg.embed_dim), np.float32)
        for i, r in enumerate(recs):
            if with_vectors:
                v = np.asarray(r.embedding, np.float32)
                norm = float(np.linalg.norm(v))
                v = v / norm if norm > 0 else v
                if quantize:
                    v, st["vec_scales"][i] = _quantize_host(v)
                st["vectors"][i] = v
            st["doc_id"][i] = self.docs.intern(r.doc_id)
            st["authority"][i] = min(max(r.authority_level, 0), _AUTH_MAX) / _AUTH_MAX
            st["length_score"][i] = _length_score(r.text)
            st["payer"][i] = self.payers.intern(r.payer) if r.payer else -1
            st["state"][i] = self.states.intern(r.state) if r.state else -1
            st["program"][i] = self.programs.intern(r.program) if r.program else -1
            # the arrays start zeroed: empty lists skip pack_bits, which
            # matters at a million records
            for f, ids, words in (("j_tags", r.j_tags, cfg.tag_words),
                                  ("d_tags", r.d_tags, cfg.tag_words),
                                  ("p_tags", r.p_tags, cfg.tag_words),
                                  ("phrase_bits", r.phrase_ids, cfg.phrase_words)):
                if ids:
                    st[f][i] = pack_bits(ids, words)
        return st

    def _write_rows(self, rows: Sequence[int], recs: Sequence[ChunkRecord]) -> None:
        """Overwrite every field of `rows` (which also clears what a
        deleted previous occupant left behind). Runs in chunks of
        _WRITE_BLOCK records so the staged [H, n] lexical block stays
        small."""
        h = self.cfg.lexical_buckets
        for off in range(0, len(rows), _WRITE_BLOCK):
            blk_rows = list(rows[off:off + _WRITE_BLOCK])
            blk_recs = recs[off:off + _WRITE_BLOCK]
            st = self._stage(blk_recs, quantize=self.cfg.vector_dtype == "int8")
            if self._host_residency:  # the rows go to host RAM, their scales both ways
                self.host_vectors[blk_rows] = st.pop("vectors").astype(np.int8)
                self.host_scales[blk_rows] = st["vec_scales"]
            idx = torch.as_tensor(blk_rows, dtype=torch.long, device=self.device)
            for f, a in st.items():
                t = getattr(self.index, f)
                t[idx] = _to_tensor(a, f, self.device).to(t.dtype)
            if self._sparse_lexical:
                continue  # postings are written by bucket (_sparse_add)
            lex = np.zeros((h, len(blk_recs)), np.float32)  # bucket-major
            for i, r in enumerate(blk_recs):
                for bucket, w in r.lexical_weights.items():
                    lex[bucket % h, i] += w
            self.index.lexical[:, idx] = torch.from_numpy(lex).to(
                self.device).to(torch.bfloat16)

    def add_chunks(self, recs: Sequence[ChunkRecord]) -> list[int]:
        """Insert records; returns their rows. Embeddings are
        L2-normalized here. Rows freed by deletes are recycled (lowest
        first) before the record list grows."""
        if not recs:
            return []
        cfg = self.cfg
        # Validate before mutating any host state so a bad batch is atomic.
        for r in recs:
            emb = np.asarray(r.embedding, np.float32)
            if emb.shape != (cfg.embed_dim,):
                raise ValueError(
                    f"embedding shape {emb.shape} != ({cfg.embed_dim},) "
                    f"for chunk {r.chunk_id!r}")
        n_rec = min(len(recs), len(self._free_rows))
        self._free_rows.sort()
        recycled, self._free_rows = self._free_rows[:n_rec], self._free_rows[n_rec:]
        if recycled and self._sparse_lexical:
            # stale postings still name the freed rows: scrub them before
            # the rows get new occupants, or old weights would score them
            self._sparse_scrub_rows(recycled)
        self._ensure_capacity(len(recs) - n_rec)
        rows = []
        for i, r in enumerate(recs):
            if i < n_rec:
                row = recycled[i]
                self.records[row] = r
            else:
                row = len(self.records)
                self.records.append(r)
            rows.append(row)
            self._doc_rows.setdefault(r.doc_id, []).append(row)
            if r.source_id:
                self._source_ids.setdefault(r.doc_id, set()).add(r.source_id)
        self._write_rows(rows, recs)
        if self._sparse_lexical:
            postings: dict[int, list[tuple[int, float]]] = {}
            for row, r in zip(rows, recs):
                for bucket, w in r.lexical_weights.items():
                    postings.setdefault(bucket % cfg.lexical_buckets, []).append(
                        (row, float(w)))
            self._sparse_add(postings)
        self._lexical_stats_cache = None
        self._notify("add", rows)
        return rows

    # -- sparse-lexical maintenance ----------------------------------------

    def _sparse_scrub_rows(self, rows: Sequence[int]) -> None:
        """Remove every posting that names `rows` (host mirrors, then the
        touched buckets on the device). Until a freed row is recycled its
        dead postings are harmless (the valid mask gates them)."""
        mask = np.isin(self._lex_cols_np, np.asarray(sorted(rows), np.int32))
        touched = np.nonzero(mask.any(axis=1))[0]
        if len(touched) == 0:
            return
        self._lex_cols_np[mask] = -1
        self._lex_wts_np[mask] = 0.0
        # fill counts keep the holes; compaction reclaims them lazily
        self._sync_sparse_device(list(touched))

    def _sparse_compact(self, bucket: int) -> None:
        """Repack a bucket's postings, dropping holes and rows deleted (and
        not yet recycled)."""
        fill = int(self._lex_fill[bucket])
        cols = self._lex_cols_np[bucket, :fill]
        wts = self._lex_wts_np[bucket, :fill]
        live = np.array([0 <= c < len(self.records) and self.records[c] is not None
                         for c in cols], dtype=bool)
        keep = int(live.sum())
        self._lex_cols_np[bucket, :keep] = cols[live]
        self._lex_wts_np[bucket, :keep] = wts[live]
        self._lex_cols_np[bucket, keep:] = -1
        self._lex_wts_np[bucket, keep:] = 0.0
        self._lex_fill[bucket] = keep

    def _sparse_grow(self) -> None:
        """Double the postings width P (host mirrors; the caller syncs)."""
        h, p = self._lex_cols_np.shape
        cols = np.full((h, p * 2), -1, np.int32)
        wts = np.zeros((h, p * 2), np.float32)
        cols[:, :p] = self._lex_cols_np
        wts[:, :p] = self._lex_wts_np
        self._lex_cols_np, self._lex_wts_np = cols, wts

    def _sparse_add(self, postings: dict[int, list[tuple[int, float]]]) -> None:
        """Append postings to their buckets: on overflow compact, then
        double P; at the lexical_postings_max cap keep the heaviest
        postings (impact-ordered truncation, ties to the earlier one)."""
        if not postings:
            return
        p_max = self.cfg.lexical_postings_max
        grew = False
        for b, posts in postings.items():
            need = int(self._lex_fill[b]) + len(posts)
            if need > self._lex_cols_np.shape[1]:
                self._sparse_compact(b)
                need = int(self._lex_fill[b]) + len(posts)
            while need > self._lex_cols_np.shape[1] and self._lex_cols_np.shape[1] < p_max:
                self._sparse_grow()
                grew = True
            p = self._lex_cols_np.shape[1]
            fill = int(self._lex_fill[b])
            new_cols = np.fromiter((c for c, _ in posts), np.int32, len(posts))
            new_wts = np.fromiter((w for _, w in posts), np.float32, len(posts))
            if need > p:  # at the cap: keep the p heaviest
                cols = np.concatenate([self._lex_cols_np[b, :fill], new_cols])
                wts = np.concatenate([self._lex_wts_np[b, :fill], new_wts])
                top = np.argsort(-wts, kind="stable")[:p]
                self._lex_cols_np[b] = cols[top]
                self._lex_wts_np[b] = wts[top]
                self._lex_fill[b] = p
            else:
                self._lex_cols_np[b, fill:need] = new_cols
                self._lex_wts_np[b, fill:need] = new_wts
                self._lex_fill[b] = need
        self._sync_sparse_device(None if grew else sorted(postings))

    def _sync_sparse_device(self, buckets: Sequence[int] | None) -> None:
        """Copy the host postings mirrors to the device: the given bucket
        rows in place, or everything (None: P changed shape)."""
        if buckets is None:
            self.index.lex_cols = torch.from_numpy(self._lex_cols_np.copy()).to(self.device)
            self.index.lex_wts = torch.from_numpy(self._lex_wts_np).to(
                self.device).to(torch.bfloat16)
            return
        idx = np.asarray(buckets, np.int64)
        tidx = torch.from_numpy(idx).to(self.device)
        self.index.lex_cols[tidx] = torch.from_numpy(self._lex_cols_np[idx]).to(self.device)
        self.index.lex_wts[tidx] = torch.from_numpy(self._lex_wts_np[idx]).to(
            self.device).to(torch.bfloat16)

    def bulk_load(self, recs: Sequence[ChunkRecord], *, vectors=None,
                  lexical=None) -> list[int]:
        """Mass-ingest fast path on an empty store: one transfer per field.

        `vectors` [N, D] (numpy, or a tensor on any device) and/or
        `lexical` [N', H] numpy (N' ≤ N, row-major; rows past N' carry
        no lexical weights) may be given directly, row-aligned with
        `recs`; otherwise they come from the records. Vectors passed as
        an array are assumed L2-normalized. int8 rows are quantized on
        the store's device (``quantize_rows``).

        Under host residency `vectors` is one of: a tensor (quantized on
        its device in 250,000-row blocks and copied down), a float numpy
        matrix (quantized on the host), or an int8 numpy matrix, taken
        as it is with unit scales (the caller sets ``host_scales``); an
        int8 matrix of exactly [capacity, D] becomes the host matrix
        itself, with no copy.

        The store keeps the capacity it was built with when that exceeds
        N (the JAX store sizes from N alone and so drops the headroom a
        caller reserved for later inserts: ROADMAP queue 3)."""
        if self.records:
            raise ValueError("bulk_load requires an empty store")
        cfg = self.cfg
        n = len(recs)
        cap = round_up(max(n, cfg.initial_capacity, self.capacity), _WRITE_BLOCK)
        fresh = DeviceIndex.empty(cap, cfg, self.device)
        for i, r in enumerate(recs):
            self.records.append(r)
            self._doc_rows.setdefault(r.doc_id, []).append(i)
            if r.source_id:
                self._source_ids.setdefault(r.doc_id, set()).add(r.source_id)
        st = self._stage(recs, with_vectors=vectors is None)
        if vectors is None:
            vectors = st.pop("vectors")
        del st["vec_scales"]  # set below: ones unless int8
        if self._host_residency:
            # drop the empty arrays first: a pinned block freed here is
            # reused by the allocation that replaces it
            self.host_vectors = self.host_scales = None
            self.host_vectors, self.host_scales = self._host_rows_from(vectors, n, cap)
            fresh.vec_scales.copy_(torch.from_numpy(self.host_scales))
        else:
            vt = vectors[:n] if isinstance(vectors, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(vectors[:n], np.float32))
            vt = vt.to(self.device)
            if cfg.vector_dtype == "int8":
                fresh.vectors[:n], fresh.vec_scales[:n] = quantize_rows(vt)
            else:
                fresh.vectors[:n] = vt.to(fresh.vectors.dtype)
        for f, a in st.items():
            t = getattr(fresh, f)
            t[:n] = _to_tensor(a, f, self.device).to(t.dtype)
        self.index = fresh
        if self._sparse_lexical:
            h = cfg.lexical_buckets
            postings: dict[int, list[tuple[int, float]]] = {}
            if lexical is not None:
                lex_np = np.asarray(lexical, np.float32)  # [N', H] row-major
                rows_nz, buckets_nz = np.nonzero(lex_np)
                for i, b in zip(rows_nz.tolist(), buckets_nz.tolist()):
                    postings.setdefault(b % h, []).append((i, float(lex_np[i, b])))
            else:
                for i, r in enumerate(recs):
                    for bucket, w in r.lexical_weights.items():
                        postings.setdefault(bucket % h, []).append((i, float(w)))
            self._sparse_add(postings)
        else:
            if lexical is None:
                last = max((i + 1 for i, r in enumerate(recs) if r.lexical_weights),
                           default=0)
                lexical = np.zeros((last, cfg.lexical_buckets), np.float32)
                for i, r in enumerate(recs[:last]):
                    for bucket, w in r.lexical_weights.items():
                        lexical[i, bucket % cfg.lexical_buckets] += w
            if lexical.shape[0] > 0:
                fresh.lexical[:, :lexical.shape[0]] = torch.from_numpy(
                    np.ascontiguousarray(lexical, np.float32)).to(
                    self.device).to(torch.bfloat16).T
        self._lexical_stats_cache = None
        self._notify("bulk", range(n))
        return list(range(n))

    def _host_rows_from(self, vectors, n: int, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """bulk_load's host matrix from its three kinds of input (the JAX
        store's ``bulk_load`` host branch, ``store.py:714-741``)."""
        d = self.cfg.embed_dim
        if (isinstance(vectors, np.ndarray) and vectors.dtype == np.int8
                and vectors.shape == (cap, d) and vectors.flags.c_contiguous):
            return vectors, host_array((cap,), np.float32, 1.0, self.device)
        hv, hs = self._host_rows(cap)
        if isinstance(vectors, torch.Tensor):
            for off in range(0, n, _HOST_QUANT_BLOCK):
                hi = min(off + _HOST_QUANT_BLOCK, n)
                q8, qs = _quantize_block(vectors[off:hi])
                torch.from_numpy(hv[off:hi]).copy_(q8)
                torch.from_numpy(hs[off:hi]).copy_(qs)
        elif np.asarray(vectors).dtype == np.int8:
            hv[:n] = np.asarray(vectors)[:n]
        else:
            v32 = np.asarray(vectors[:n], np.float32)
            maxabs = np.abs(v32).max(axis=1)
            hs[:n] = np.where(maxabs > 0, maxabs / 127.0, 1.0)
            hv[:n] = np.clip(np.round(v32 / hs[:n, None]), -127, 127)
        return hv, hs

    def _clear_rows(self, rows: Sequence[int]) -> None:
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        self.index.valid[idx] = 0.0

    def delete_by_document(self, doc_id: str) -> int:
        """Invalidate all live rows of a document."""
        rows = [r for r in self._doc_rows.pop(doc_id, []) if self.records[r] is not None]
        self._source_ids.pop(doc_id, None)
        if not rows:
            return 0
        for r in rows:
            self.records[r] = None
            self._free_rows.append(r)
        self._clear_rows(rows)
        self._lexical_stats_cache = None
        self._notify("delete", rows)
        return len(rows)

    def invalidate_rows(self, rows: Sequence[int]) -> int:
        """Force-clear device rows regardless of host-record state."""
        rows = [r for r in rows if 0 <= r < self.capacity]
        if not rows:
            return 0
        for r in rows:
            if r < len(self.records) and self.records[r] is not None:
                rec = self.records[r]
                self.records[r] = None
                self._free_rows.append(r)
                if r in self._doc_rows.get(rec.doc_id, []):
                    self._doc_rows[rec.doc_id].remove(r)
        self._clear_rows(rows)
        self._lexical_stats_cache = None
        self._notify("delete", rows)
        return len(rows)

    def publish_document(self, doc_id: str, recs: Sequence[ChunkRecord]) -> list[int]:
        """Idempotent republish: DELETE+INSERT, then verify the document's
        live row count equals the record count."""
        self.delete_by_document(doc_id)
        rows = self.add_chunks(recs)
        live = [r for r in self._doc_rows.get(doc_id, [])
                if self.records[r] is not None]
        if len(live) != len(recs):
            raise RuntimeError(
                f"publish integrity: {doc_id!r} expected {len(recs)} live rows, "
                f"found {len(live)}")
        return rows

    def lexical_stats(self) -> tuple[dict[int, int], int]:
        """(bucket → live-chunk document frequency, live chunk count) for
        query-side IDF. Cached; invalidated by add/delete."""
        if self._lexical_stats_cache is None:
            df: dict[int, int] = {}
            n = 0
            for r in self.records:
                if r is None:
                    continue
                n += 1
                for b in r.lexical_weights:
                    key = b % self.cfg.lexical_buckets
                    df[key] = df.get(key, 0) + 1
            self._lexical_stats_cache = (df, n)
        return self._lexical_stats_cache

    # -- reads -------------------------------------------------------------

    def record(self, row: int) -> ChunkRecord | None:
        if 0 <= row < len(self.records):
            return self.records[row]
        return None

    # -- snapshot / resume (the JAX package's format, both ways) -----------

    def snapshot(self, path: str) -> None:
        """Write ``index.npz`` + ``store.json`` exactly as the JAX store
        does (bf16 fields as uint16 bit patterns, bitsets as uint32), so
        either package restores the other's snapshots."""
        os.makedirs(path, exist_ok=True)
        arrays = self.index.to_numpy()
        meta_dtypes = {f: "bfloat16" for f in arrays
                       if getattr(self.index, f).dtype == torch.bfloat16}
        np.savez_compressed(os.path.join(path, "index.npz"), **arrays)
        if self.host_vectors is not None:
            # the host matrix lives beside index.npz, uncompressed (np.save
            # streams; zip compression of 15 GB at 10M rows would not)
            np.save(os.path.join(path, "host_vectors.npy"), self.host_vectors)
            np.save(os.path.join(path, "host_scales.npy"), self.host_scales)
        recs = []
        for r in self.records:
            if r is None:
                recs.append(None)
            else:
                d = dataclasses.asdict(r)
                d["embedding"] = None  # lives in index.npz
                d["lexical_weights"] = {str(k): v for k, v in d["lexical_weights"].items()}
                recs.append(d)
        state = {
            "version": self.SNAPSHOT_VERSION,
            "records": recs,
            "free_rows": self._free_rows,
            "doc_rows": self._doc_rows,
            "source_ids": {k: sorted(v) for k, v in self._source_ids.items()},
            "interners": {
                "docs": self.docs.state_dict(),
                "payers": self.payers.state_dict(),
                "states": self.states.state_dict(),
                "programs": self.programs.state_dict(),
            },
            "bf16_fields": meta_dtypes,
            "config": {
                "embed_dim": self.cfg.embed_dim,
                "tag_words": self.cfg.tag_words,
                "phrase_words": self.cfg.phrase_words,
                "lexical_buckets": self.cfg.lexical_buckets,
                "lexical_format": self.cfg.lexical_format,
                "vector_residency": self.cfg.vector_residency,
            },
        }
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump(state, f)

    @classmethod
    def restore(cls, path: str, cfg: Config | None = None,
                device="cuda") -> "ChunkStore":
        """Read a snapshot written by either package."""
        with open(os.path.join(path, "store.json")) as f:
            state = json.load(f)
        version = int(state.get("version", 0))  # v0 has v1's layout
        if version > cls.SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {version} is newer than this build "
                f"supports ({cls.SNAPSHOT_VERSION})")
        cfg = cfg or get_config()
        for key, val in state["config"].items():
            if getattr(cfg, key) != val:
                raise ValueError(f"snapshot {key}={val!r} != config {getattr(cfg, key)!r}")
        with np.load(os.path.join(path, "index.npz")) as data:
            arrays = {f: data[f] for f in data.files}
        # capacity from valid: under host residency vectors has 0 rows
        store = cls(cfg, capacity=arrays["valid"].shape[0], device=device)
        store.index = index_from_numpy(arrays, store.device)
        if store._host_residency:
            hv_path = os.path.join(path, "host_vectors.npy")
            if not os.path.exists(hv_path):
                raise ValueError("host-residency snapshot is missing host_vectors.npy")
            for name in ("host_vectors", "host_scales"):
                saved = np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
                if saved.shape == getattr(store, name).shape:
                    getattr(store, name)[:] = saved  # into the (pinned) arrays
                else:
                    setattr(store, name, np.array(saved))
        if store._sparse_lexical:
            # the host postings mirrors, from the restored arrays
            store._lex_cols_np = np.array(arrays["lex_cols"], np.int32)
            store._lex_wts_np = (np.asarray(arrays["lex_wts"]).view(np.uint16)
                                 .astype(np.uint32) << 16).view(np.float32)
            store._lex_fill = (store._lex_cols_np >= 0).sum(axis=1)
        # Rehydrate record embeddings from the restored rows (the host
        # matrix under host residency): republish paths treat record
        # embeddings as authoritative. int8 rows dequantize.
        if store._host_residency:
            vecs, scales = store.host_vectors, store.host_scales
        else:
            vecs, scales = arrays["vectors"], arrays["vec_scales"]
        if state["bf16_fields"].get("vectors") == "bfloat16":
            vecs = (vecs.astype(np.uint32) << 16).view(np.float32)
        store.records = []
        for i, d in enumerate(state["records"]):
            if d is None:
                store.records.append(None)
                continue
            if vecs.dtype == np.int8:
                d["embedding"] = vecs[i].astype(np.float32) * float(scales[i])
            else:
                d["embedding"] = vecs[i]
            d["lexical_weights"] = {int(k): v for k, v in d["lexical_weights"].items()}
            store.records.append(ChunkRecord(**d))
        store._free_rows = list(state["free_rows"])
        store._doc_rows = {k: list(v) for k, v in state["doc_rows"].items()}
        store._source_ids = {k: set(v) for k, v in state["source_ids"].items()}
        for name in ("docs", "payers", "states", "programs"):
            getattr(store, name).load_state(state["interners"][name])
        return store
