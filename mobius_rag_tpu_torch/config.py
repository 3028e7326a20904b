"""Environment-driven configuration: a frozen :class:`Config` whose
defaults read the same ``MRAG_*`` variables as ``mobius_rag_tpu.config``,
so one environment sizes both packages alike.

Only the knobs the port reads are here. The ones that select a layout or
backend the port does not have yet (int8 vectors, sparse lexical, host
residency, ANN backends) are kept so that asking for one raises
``NotImplementedError`` instead of silently serving the default.
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
    # "dense" (bucket-major [H, C]) is the only layout ported so far.
    lexical_format: str = _env_str("MRAG_LEXICAL_FORMAT", "dense")
    # "float32" | "bfloat16" (int8 is not ported yet).
    vector_dtype: str = _env_str("MRAG_VECTOR_DTYPE", "float32")
    # "exact" is the only vector-arm backend ported so far.
    vector_backend: str = _env_str("MRAG_VECTOR_BACKEND", "exact")
    # "device" is the only vector residency ported so far.
    vector_residency: str = _env_str("MRAG_VECTOR_RESIDENCY", "device")

    # ---- search tunables ------------------------------------------------
    rrf_k: int = _env_int("MRAG_RRF_K", 60)
    over_fetch: int = _env_int("MRAG_OVER_FETCH", 4)
    default_k: int = _env_int("MRAG_DEFAULT_K", 10)
    confidence_high: float = _env_float("MRAG_CONFIDENCE_HIGH", 0.55)
    confidence_medium: float = _env_float("MRAG_CONFIDENCE_MEDIUM", 0.35)
    confidence_low: float = _env_float("MRAG_CONFIDENCE_LOW", 0.18)

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
