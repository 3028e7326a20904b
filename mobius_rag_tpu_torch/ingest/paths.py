"""Ingest enrichment paths.

Path A — facts (reference: app/worker/path_a.py:92-378 +
services/extraction.py:141 + services/critique.py:132): per paragraph,
an LLM extracts structured facts, a critique pass scores them, and
low-scoring extractions retry once with the stricter retry prompt
(threshold 0.6, config.py:124). Facts become embeddable units alongside
the paragraph itself.

Path B — policy lines + tags (reference: app/worker/path_b.py +
services/policy_path_b.py): deterministic — split the paragraph into
policy lines, tag each line via the native Aho-Corasick lexicon
automaton, extract n-gram/abbreviation lexicon candidates, then
aggregate tags line → paragraph → document.

Ported from ``mobius_rag_tpu.ingest.paths`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from typing import Any

from mobius_rag_tpu_torch.clients import LLMClient
from mobius_rag_tpu_torch.query.lexicon import Lexicon
from mobius_rag_tpu_torch.query.text import STOPWORDS, tokenize

CRITIQUE_RETRY_THRESHOLD = 0.6

# ---------------------------------------------------------------------------
# Path A
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExtractedFact:
    text: str
    category: str = "general"
    critique_score: float = 0.0
    retried: bool = False
    span: tuple[int, int] | None = None  # char span in the paragraph, if located


_EXTRACT_PROMPT = (
    "Extract the atomic policy facts from the paragraph as a JSON list of "
    '{{"text": ..., "category": ...}} objects. Categories: coverage, '
    "authorization, billing, eligibility, timeline, contact, general. "
    "Only facts stated in the paragraph.\n\nPARAGRAPH:\n{para}"
)
_RETRY_PROMPT = (
    "Your previous extraction scored poorly. Re-extract ONLY facts stated "
    "verbatim-or-near-verbatim in the paragraph, one atomic claim each, as a "
    'JSON list of {{"text": ..., "category": ...}}.\n\nPARAGRAPH:\n{para}'
)
_CRITIQUE_PROMPT = (
    "Score 0.0-1.0 how faithful these extracted facts are to the paragraph "
    "(1.0 = every fact stated, atomic, correctly scoped). Reply with just "
    "the number.\n\nPARAGRAPH:\n{para}\n\nFACTS:\n{facts}"
)


def _parse_fact_json(raw: str) -> list[dict[str, Any]]:
    m = re.search(r"\[.*\]", raw or "", re.S)
    if not m:
        return []
    try:
        items = json.loads(m.group(0))
        return [i for i in items if isinstance(i, dict) and i.get("text")]
    except (json.JSONDecodeError, TypeError):
        return []


def _parse_score(raw: str) -> float:
    m = re.search(r"(?:0?\.\d+|1\.0|[01])(?!\d)", raw or "")
    try:
        return min(max(float(m.group(0)), 0.0), 1.0) if m else 0.0
    except ValueError:
        return 0.0


def find_fact_span(fact_text: str, paragraph: str) -> tuple[int, int] | None:
    """Locate the fact in the paragraph (whitespace-normalized substring,
    the reference's _find_fact_span_in_markdown contract, path_a.py:58)."""
    norm_para = re.sub(r"\s+", " ", paragraph).lower()
    norm_fact = re.sub(r"\s+", " ", fact_text).strip().lower()
    if not norm_fact:
        return None
    i = norm_para.find(norm_fact)
    if i < 0:
        return None
    return (i, i + len(norm_fact))


def run_path_a(paragraph: str, llm: LLMClient) -> list[ExtractedFact]:
    """extract → critique → retry-below-threshold, per paragraph."""
    raw = llm.generate(_EXTRACT_PROMPT.format(para=paragraph), stage="extraction")
    items = _parse_fact_json(raw)
    facts_str = json.dumps([i["text"] for i in items])
    score = _parse_score(
        llm.generate(_CRITIQUE_PROMPT.format(para=paragraph, facts=facts_str),
                     stage="critique")
    ) if items else 0.0
    retried = False
    if score < CRITIQUE_RETRY_THRESHOLD:
        retried = True
        raw2 = llm.generate(_RETRY_PROMPT.format(para=paragraph),
                            stage="extraction_retry")
        items2 = _parse_fact_json(raw2)
        if items2:
            facts_str = json.dumps([i["text"] for i in items2])
            score2 = _parse_score(
                llm.generate(_CRITIQUE_PROMPT.format(para=paragraph, facts=facts_str),
                             stage="critique"))
            if score2 >= score:
                items, score = items2, score2
    return [
        ExtractedFact(
            text=i["text"], category=str(i.get("category", "general")),
            critique_score=score, retried=retried,
            span=find_fact_span(i["text"], paragraph),
        )
        for i in items
    ]


# ---------------------------------------------------------------------------
# Path B
# ---------------------------------------------------------------------------

_LINE_SPLIT_RE = re.compile(r"(?<=[.;:])\s+|\n")
_ABBREV_RE = re.compile(r"\b([A-Z]{2,6})\b(?:\s*\(([^)]{4,60})\))?")


@dataclasses.dataclass
class PolicyLine:
    text: str
    line_index: int
    phrase_ids: list[int]
    j_tags: list[int]
    d_tags: list[int]
    p_tags: list[int]


@dataclasses.dataclass
class PathBResult:
    lines: list[PolicyLine]
    paragraph_tags: dict[str, list[int]]  # union over lines (j/d/p)
    candidates: list[dict[str, Any]]  # lexicon candidates for curation


def split_policy_lines(paragraph: str) -> list[str]:
    lines = [ln.strip() for ln in _LINE_SPLIT_RE.split(paragraph)]
    return [ln for ln in lines if len(ln) >= 3]


def extract_candidates(paragraph: str, lexicon: Lexicon) -> list[dict[str, Any]]:
    """Lexicon-candidate mining (policy_path_b.py:481): capitalized
    abbreviations (with optional expansions) and frequent content
    bigrams not already covered by the lexicon."""
    known = set(lexicon.phrase_ids)
    out: list[dict[str, Any]] = []
    for abbr, expansion in _ABBREV_RE.findall(paragraph):
        phrase = abbr.lower()
        if phrase in known or phrase in STOPWORDS or len(abbr) < 2:
            continue
        out.append({"phrase": phrase, "kind_hint": "abbreviation",
                    "expansion": expansion.lower() or None})
    toks = [t for t in tokenize(paragraph, stemmed=False, drop_stopwords=True)
            if len(t) > 2]
    bigrams = Counter(zip(toks, toks[1:]))
    for (a, b), n in bigrams.items():
        if n >= 2:
            phrase = f"{a} {b}"
            if phrase not in known:
                out.append({"phrase": phrase, "kind_hint": "ngram", "count": n})
    seen = set()
    deduped = []
    for c in out:
        if c["phrase"] not in seen:
            seen.add(c["phrase"])
            deduped.append(c)
    return deduped


def run_path_b(paragraph: str, lexicon: Lexicon) -> PathBResult:
    _, owners = lexicon.phrase_table()
    lines = []
    para_tags: dict[str, set[int]] = {"j": set(), "d": set(), "p": set()}
    for i, text in enumerate(split_policy_lines(paragraph)):
        pids = sorted(lexicon.matcher.match_set(text))
        tags: dict[str, set[int]] = {"j": set(), "d": set(), "p": set()}
        for pid in pids:
            for kind, tag_id in owners.get(pid, ()):
                tags[kind].add(tag_id)
                para_tags[kind].add(tag_id)
        lines.append(PolicyLine(
            text=text, line_index=i, phrase_ids=pids,
            j_tags=sorted(tags["j"]), d_tags=sorted(tags["d"]),
            p_tags=sorted(tags["p"]),
        ))
    return PathBResult(
        lines=lines,
        paragraph_tags={k: sorted(v) for k, v in para_tags.items()},
        candidates=extract_candidates(paragraph, lexicon),
    )


def aggregate_document_tags(per_paragraph: list[dict[str, list[int]]]) -> dict[str, list[int]]:
    """paragraph → document tag aggregation (policy_path_b.py:706-815):
    a tag reaches doc level when it appears in ≥2 paragraphs or in ≥20%
    of them (single-mention tags are usually incidental)."""
    n = max(len(per_paragraph), 1)
    counts: dict[str, Counter] = {"j": Counter(), "d": Counter(), "p": Counter()}
    for tags in per_paragraph:
        for kind in ("j", "d", "p"):
            counts[kind].update(set(tags.get(kind, ())))
    threshold = max(2, int(0.2 * n)) if n > 1 else 1
    return {
        kind: sorted(t for t, c in counts[kind].items() if c >= min(threshold, n))
        for kind in ("j", "d", "p")
    }
