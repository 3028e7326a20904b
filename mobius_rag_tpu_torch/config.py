"""Environment-driven configuration: a frozen :class:`Config` whose
defaults read the same ``MRAG_*`` variables as ``mobius_rag_tpu.config``,
so one environment sizes both packages alike.

Only the knobs the port reads are here.
"""
from __future__ import annotations

import dataclasses
import os
from functools import lru_cache


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name, "").strip()
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name, "").strip()
    return float(raw) if raw else default


def _env_str(name: str, default: str) -> str:
    return os.getenv(name, "").strip() or default


@dataclasses.dataclass(frozen=True)
class Config:
    """All tunables the port reads. Frozen; construct via :func:`get_config`."""

    # ---- index layout -------------------------------------------------
    embed_dim: int = _env_int("MRAG_EMBED_DIM", 1536)
    # Initial row capacity; grows by doubling.
    initial_capacity: int = _env_int("MRAG_INITIAL_CAPACITY", 8192)
    # Tag-bitset width in 32-bit words per kind (j/d/p).
    tag_words: int = _env_int("MRAG_TAG_WORDS", 8)
    # Lexicon-phrase presence bitset width in 32-bit words.
    phrase_words: int = _env_int("MRAG_PHRASE_WORDS", 64)
    # Hashed-term buckets for the lexical (BM25-style) arm.
    lexical_buckets: int = _env_int("MRAG_LEXICAL_BUCKETS", 16384)
    # "dense" (bucket-major [H, C]) or "sparse" (postings [H, P]).
    lexical_format: str = _env_str("MRAG_LEXICAL_FORMAT", "dense")
    # Sparse postings per bucket: initial width (doubles on overflow) and
    # cap (beyond it the lowest-weight postings are pruned).
    lexical_postings_init: int = _env_int("MRAG_LEXICAL_POSTINGS_INIT", 64)
    lexical_postings_max: int = _env_int("MRAG_LEXICAL_POSTINGS_MAX", 8192)
    # "float32" | "bfloat16" | "int8" (symmetric per-row, scales in
    # vec_scales).
    vector_dtype: str = _env_str("MRAG_VECTOR_DTYPE", "float32")
    # Vector-arm backend: "exact", or an ANN backend over IVF clusters:
    # "ivf" (rows gathered from the chunk matrix), "packed" (int8 cluster
    # blocks), "pq" (residual PQ codes), "proj" (int8 projected residuals).
    vector_backend: str = _env_str("MRAG_VECTOR_BACKEND", "exact")
    # "device": rows on the card; "host": int8 rows in host RAM serving an
    # exact post-fusion re-rank, only ANN codes on the card (pq or proj).
    vector_residency: str = _env_str("MRAG_VECTOR_RESIDENCY", "device")

    # ---- ANN backends -------------------------------------------------
    # IVF clusters (0 = sqrt(live rows)) and probed clusters per query.
    ivf_nlist: int = _env_int("MRAG_IVF_NLIST", 0)
    ivf_nprobe: int = _env_int("MRAG_IVF_NPROBE", 32)
    # Auto-nprobe (ivf and packed): when > 0, the ANN build picks the
    # smallest nprobe whose recall@k against the exact scan, on a sample of
    # self-queries and logged queries, clears this target.
    ivf_target_recall: float = _env_float("MRAG_IVF_TARGET_RECALL", 0.0)
    # Bytes per row of the pq backend's codes (subvectors; falls back to
    # 16-dim subvectors when it does not divide the embedding width).
    pq_m: int = _env_int("MRAG_PQ_M", 96)
    # Bytes per row of the projected-residual codes.
    proj_p: int = _env_int("MRAG_PROJ_P", 256)
    # Host-residency funnel: the vector arm's top-W candidates handed, with
    # their rerank signals, to the exact host re-rank on top of the fused
    # top-(k·over_fetch) (0 = auto: max(512, k·over_fetch)).
    host_funnel: int = _env_int("MRAG_HOST_FUNNEL", 0)
    # Empty always-probed slabs appended at build for streaming inserts.
    ann_reserve_slabs: int = _env_int("MRAG_ANN_RESERVE_SLABS", 2)
    # Recall target of an approximate final top-k in the probed scan. The
    # JAX package serves it approximately only on a TPU and exactly on every
    # other backend; the port selects exactly, which meets any target.
    ann_approx_topk: float = _env_float("MRAG_ANN_APPROX_TOPK", 0.0)
    # Filter gate: "dense" [B, C] masks + penalty, "local" evaluated on the
    # candidates (proj backend), "auto" = local under host residency only.
    gating: str = _env_str("MRAG_GATING", "auto")
    # Candidate-local d-tag arm: per-tag postings width.
    dtag_postings: int = _env_int("MRAG_DTAG_POSTINGS", 4096)

    # ---- search tunables ------------------------------------------------
    rrf_k: int = _env_int("MRAG_RRF_K", 60)
    over_fetch: int = _env_int("MRAG_OVER_FETCH", 4)
    default_k: int = _env_int("MRAG_DEFAULT_K", 10)
    confidence_high: float = _env_float("MRAG_CONFIDENCE_HIGH", 0.55)
    confidence_medium: float = _env_float("MRAG_CONFIDENCE_MEDIUM", 0.35)
    confidence_low: float = _env_float("MRAG_CONFIDENCE_LOW", 0.18)

    # ---- device grid (parallel/) -----------------------------------------
    # Name of the corpus-shard axis.
    shard_axis: str = _env_str("MRAG_SHARD_AXIS", "shard")
    # Number of corpus shards; 0 → one shard per visible device.
    num_shards: int = _env_int("MRAG_NUM_SHARDS", 0)
    # Query data-parallel groups for sharded serving (>1: a [dp, shards]
    # grid; the corpus is replicated over dp and the batch split over it).
    serve_dp: int = _env_int("MRAG_SERVE_DP", 1)

    # ---- encoder model (models/encoder.py) -------------------------------
    encoder_vocab_size: int = _env_int("MRAG_ENCODER_VOCAB", 32768)
    encoder_layers: int = _env_int("MRAG_ENCODER_LAYERS", 12)
    encoder_heads: int = _env_int("MRAG_ENCODER_HEADS", 12)
    encoder_model_dim: int = _env_int("MRAG_ENCODER_MODEL_DIM", 768)
    encoder_mlp_dim: int = _env_int("MRAG_ENCODER_MLP_DIM", 3072)
    encoder_max_seq: int = _env_int("MRAG_ENCODER_MAX_SEQ", 512)

    # ---- host state -----------------------------------------------------
    # Default directory of the host sqlite stores (telemetry, curator,
    # job queues, eval runs, candidates) and of snapshots.
    data_dir: str = _env_str("MRAG_DATA_DIR", os.path.expanduser("~/.mobius_rag_tpu"))
    # Reference eval banks (YAML, read-only; the parity oracle). The port's
    # own banks are JSON copies under data/ (eval_harness/bank.py).
    eval_bank_dir: str = _env_str("MRAG_EVAL_BANK_DIR", "/root/reference/eval")
    # Curated lexicon loaded by the server entry points (JSON; a .yaml path
    # loads through PyYAML). The 17-entry sample lexicon is for tests only.
    lexicon_path: str = _env_str(
        "MRAG_LEXICON_PATH",
        os.path.join(os.path.dirname(__file__), "data", "lexicon_full.json"))
    # Cross-encoder reranker checkpoint dir (kind="cross"); when set,
    # AppContext.build attaches the model as the engine's rescoring stage.
    cross_encoder_ckpt: str = _env_str("MRAG_CROSS_ENCODER_CKPT", "")

    def validate(self) -> list[str]:
        """Collect every problem at once."""
        problems: list[str] = []
        if self.embed_dim % 128 != 0:
            problems.append(
                f"MRAG_EMBED_DIM={self.embed_dim} must be a multiple of 128")
        if self.vector_dtype not in ("float32", "bfloat16", "int8"):
            problems.append(
                f"MRAG_VECTOR_DTYPE={self.vector_dtype!r} must be "
                "float32|bfloat16|int8")
        if self.lexical_buckets % 128 != 0:
            problems.append(
                f"MRAG_LEXICAL_BUCKETS={self.lexical_buckets} must be a "
                "multiple of 128")
        if self.lexical_format not in ("dense", "sparse"):
            problems.append(
                f"MRAG_LEXICAL_FORMAT={self.lexical_format!r} must be "
                "dense|sparse")
        if self.vector_backend not in ("exact", "ivf", "packed", "pq", "proj"):
            problems.append(
                f"MRAG_VECTOR_BACKEND={self.vector_backend!r} must be "
                "exact|ivf|packed|pq|proj")
        if self.vector_residency not in ("device", "host"):
            problems.append(
                f"MRAG_VECTOR_RESIDENCY={self.vector_residency!r} must be "
                "device|host")
        if self.vector_residency == "host" and self.vector_backend not in ("pq", "proj"):
            problems.append(
                "MRAG_VECTOR_RESIDENCY=host requires MRAG_VECTOR_BACKEND=pq|proj "
                "(no dense device matrix exists to scan exactly)")
        if self.vector_residency == "host" and self.vector_dtype != "int8":
            problems.append(
                "MRAG_VECTOR_RESIDENCY=host requires MRAG_VECTOR_DTYPE=int8 "
                "(the host payload is the int8 re-rank matrix)")
        if not 8 <= self.lexical_postings_init <= self.lexical_postings_max:
            problems.append(
                "MRAG_LEXICAL_POSTINGS_INIT must be in "
                f"[8, MRAG_LEXICAL_POSTINGS_MAX={self.lexical_postings_max}]")
        if self.gating not in ("auto", "dense", "local"):
            problems.append(f"MRAG_GATING={self.gating!r} must be auto|dense|local")
        if self.dtag_postings < 8:
            problems.append("MRAG_DTAG_POSTINGS must be >= 8")
        if self.tag_words <= 0 or self.phrase_words <= 0:
            problems.append("tag_words and phrase_words must be positive")
        if self.initial_capacity < 128:
            problems.append("MRAG_INITIAL_CAPACITY must be >= 128")
        return problems

    def assert_valid(self) -> None:
        problems = self.validate()
        if problems:
            raise ValueError(
                "invalid mobius_rag_tpu_torch config:\n  - "
                + "\n  - ".join(problems))


@lru_cache(maxsize=1)
def get_config() -> Config:
    cfg = Config()
    cfg.assert_valid()
    return cfg
