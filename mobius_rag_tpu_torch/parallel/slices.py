"""Multi-slice serving: the host-side merge of per-slice search results
(the port of ``mobius_rag_tpu.parallel.slices``).

A device grid scales a corpus within one host (``parallel/sharded.py``).
Beyond that the corpus splits at the host layer: one engine (or one
``RemoteIndexClient`` endpoint) per slice, each serving its own rows, and
every query fans out to every slice; only the top-k results per query
cross between hosts.

Results merge by the engine's rerank score, deduplicated by chunk id.
Every per-row signal in that score is slice-independent except the
lexical normalizer (a slice divides lexical scores by its own best), so
for embedding-only queries the merge reproduces a whole-corpus engine's
ranking exactly, and for text queries each slice normalizes against the
rows it holds, as separate instances of the reference do.
"""
from __future__ import annotations

from typing import Sequence

from mobius_rag_tpu_torch.query.engine import SearchResult

_LABELS = ("abstain", "low", "medium", "high")


def merge_slice_results(per_slice: "Sequence[list[SearchResult]]",
                        k: int) -> list[SearchResult]:
    """Merge per-query results from S slices: ``per_slice[s][q]`` is slice
    s's result for query q. Returns one result per query: the top k hits by
    rerank score, deduplicated by chunk id, with the best of the slices'
    confidence labels."""
    if not per_slice:
        return []
    n_q = len(per_slice[0])
    if any(len(rs) != n_q for rs in per_slice):
        raise ValueError("ragged slice results")
    merged: list[SearchResult] = []
    for qi in range(n_q):
        base = per_slice[0][qi]
        seen: set[str] = set()
        hits = []
        for rs in per_slice:
            for h in rs[qi].hits:
                if h.chunk_id not in seen:
                    seen.add(h.chunk_id)
                    hits.append(h)
        hits.sort(key=lambda h: -h.score)
        hits = hits[:k]
        label = max((rs[qi].confidence_label for rs in per_slice), key=_label_rank)
        merged.append(SearchResult(
            query=base.query,
            hits=hits,
            confidence_label=label if hits else "abstain",
            expansion=base.expansion,
            telemetry={
                "multi_slice": {
                    "slices": len(per_slice),
                    "per_slice_hits": [len(rs[qi].hits) for rs in per_slice],
                },
                **{key: v for key, v in base.telemetry.items() if key != "arms"},
            },
        ))
    return merged


def _label_rank(label: str) -> int:
    return _LABELS.index(label) if label in _LABELS else 0
