"""Query classification: literals, profile features, query class (the port of
``mobius_rag_tpu.query.classify``).

Semantics follow the reference's classifier (corpus_search_agent.py:218,
literal patterns :86-103) and query-class derivation
(corpus_search_router.py:356-386): a query profiles into
  literal_anchor | tight_pool | wide_pool | conceptual | exploratory | vague
based on literal anchors (HCPCS/CPT/policy IDs, quoted phrases), lexicon
tag matches, and the corpus pool size behind those tags.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

from mobius_rag_tpu_torch.query.lexicon import Lexicon, LexiconExpansion

QUERY_CLASSES = (
    "literal_anchor", "tight_pool", "wide_pool", "conceptual", "exploratory", "vague",
)

# Literal anchors: HCPCS (letter + 4 digits), CPT (5 digits), revenue/policy
# codes, quoted phrases.
_HCPCS_RE = re.compile(r"\b[A-Za-z]\d{4}\b")
_CPT_RE = re.compile(r"\b\d{5}\b")
_POLICY_ID_RE = re.compile(r"\b(?:[A-Z]{2,5}[-.]\d{2,6}(?:[-.]\d{1,4})?)\b")
_QUOTED_RE = re.compile(r"\"([^\"]{3,80})\"|'([^']{3,80})'")

# Exploratory framing ("what's out there", list/overview asks).
_EXPLORATORY_RE = re.compile(
    r"\b(overview|summar(y|ize)|everything about|all (the )?(policies|documents|requirements)|"
    r"list (of|all)|what do (you|we) have)\b", re.IGNORECASE)

# Conceptual framing (why/compare/explain — no single fact row answers it).
_CONCEPTUAL_RE = re.compile(
    r"\b(why|compare|difference between|explain|how does .* work|trade[- ]?offs?)\b",
    re.IGNORECASE)

_TIGHT_POOL_MAX_DOCS = 500


@dataclasses.dataclass
class QueryProfile:
    query: str
    query_class: str
    literals: list[str]
    expansion: LexiconExpansion
    has_literal: bool
    has_j_tag: bool
    has_j_payor_tag: bool
    has_d_tag: bool
    has_p_tag: bool
    pool_size: int  # docs behind the matched tags (union)
    pool_intersection: int  # docs carrying ALL matched kinds
    thematic_policy: bool  # broad policy-section ask (canonical themes)
    canonicality: float  # [0,1] — see router blend
    features: dict[str, Any] = dataclasses.field(default_factory=dict)


def find_literals(query: str) -> list[str]:
    out = []
    out += _HCPCS_RE.findall(query)
    out += _CPT_RE.findall(query)
    out += _POLICY_ID_RE.findall(query)
    for a, b in _QUOTED_RE.findall(query):
        out.append(a or b)
    # dedupe, preserve order
    seen = set()
    res = []
    for x in out:
        if x.lower() not in seen:
            seen.add(x.lower())
            res.append(x)
    return res


def canonicality(has_j: bool, has_d: bool, pool_size: int, is_vague: bool) -> float:
    """[0,1] canonical-policy weight: gated on a J×D pair, peaked on a
    moderate pool — plateau [100, 500], taper to 0 at 50/900 (the
    reference's measured bimodal-b fix, corpus_search_router.py:340-360)."""
    if not (has_j and has_d) or is_vague or pool_size <= 0:
        return 0.0
    if 100 <= pool_size <= 500:
        return 1.0
    if pool_size < 100:
        return max(0.0, (pool_size - 50) / 50.0)
    return max(0.0, (900 - pool_size) / 400.0)


def classify_query(
    query: str,
    lexicon: Lexicon | None,
    probe: "dict[str, int] | None" = None,
) -> QueryProfile:
    """probe: {"union_docs": N, "intersection_docs": M} from
    gate.corpus_probe — pool sizes behind the matched tags."""
    exp = lexicon.expand(query) if lexicon else LexiconExpansion()
    literals = find_literals(query)
    has_literal = bool(literals)
    has_j = bool(exp.jurisdiction_tags)
    has_j_payor = any(t.startswith("j:payor.") for t in exp.jurisdiction_tags)
    has_d = bool(exp.domain_tags)
    has_p = bool(exp.process_tags)
    pool = int((probe or {}).get("union_docs", 0))
    inter = int((probe or {}).get("intersection_docs", 0))

    thematic = bool(_CONCEPTUAL_RE.search(query)) or (
        has_d and not has_literal and len(query.split()) >= 8
    )

    if has_literal:
        qc = "literal_anchor"
    elif not has_j and not has_d and not has_p:
        qc = "exploratory" if _EXPLORATORY_RE.search(query) else "vague"
    elif _EXPLORATORY_RE.search(query):
        qc = "exploratory"
    elif _CONCEPTUAL_RE.search(query):
        qc = "conceptual"
    elif has_d and 0 < pool <= _TIGHT_POOL_MAX_DOCS:
        qc = "tight_pool"
    elif has_d:
        qc = "wide_pool"
    else:
        qc = "tight_pool" if pool and pool <= _TIGHT_POOL_MAX_DOCS else "vague"

    canon = canonicality(has_j, has_d, pool, qc == "vague")
    return QueryProfile(
        query=query,
        query_class=qc,
        literals=literals,
        expansion=exp,
        has_literal=has_literal,
        has_j_tag=has_j,
        has_j_payor_tag=has_j_payor,
        has_d_tag=has_d,
        has_p_tag=has_p,
        pool_size=pool,
        pool_intersection=inter,
        thematic_policy=thematic,
        canonicality=canon,
        features={
            "has_literal": has_literal,
            "has_j_tag": has_j,
            "has_j_payor_tag": has_j_payor,
            "has_d_tag": has_d,
            "has_p_tag": has_p,
            "pool_size": pool,
            "thematic_policy": thematic,
        },
    )
