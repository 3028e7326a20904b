"""Query-side gating helpers. Only what the exact dense path needs is
here; candidate-local gating (strict_counts, the local lexical and d-tag
arms, DTagPostings) belongs to the proj backend (ROADMAP queue 1,
item 11)."""
from __future__ import annotations

import numpy as np

MAX_QUERY_DTAGS = 16


def query_dtag_ids(tag_ids: list[int], tag_words: int) -> np.ndarray:
    """The first MAX_QUERY_DTAGS in-range d-tag ids of a query, -1
    padded (prepare_query attaches this as q["d_tag_ids"], keeping the
    JAX package's query schema)."""
    out = np.full(MAX_QUERY_DTAGS, -1, np.int32)
    keep = [t for t in tag_ids if 0 <= t < tag_words * 32]
    out[: min(len(keep), MAX_QUERY_DTAGS)] = keep[:MAX_QUERY_DTAGS]
    return out
