"""Rubric judge: per-fact booleans → deterministic score → verdict bands
(the port of ``mobius_rag_tpu.eval_harness.judge``).

Reference semantics (eval/judge.py:1-26): the LLM marks each
must/bonus/forbidden fact present-or-absent; the SCORE is computed
deterministically from the booleans (never by the LLM); verdict bands
are correct ≥ 0.85, partial ≥ 0.5 (BASELINE.md). An offline
token-overlap matcher stands in for the LLM when no client is supplied
(zero-egress pods, hermetic tests).

Scoring: must facts carry the weight (fraction present, 0.9 of score);
bonus facts add up to 0.1; any forbidden fact present caps the score at
0.2 (a contradiction is disqualifying). Honest abstain (explicit
can't-answer with no facts asserted) gets the abstain verdict, not zero.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Sequence

from mobius_rag_tpu_torch.clients import LLMClient
from mobius_rag_tpu_torch.query.text import STOPWORDS, tokenize

VERDICT_CORRECT = 0.85
VERDICT_PARTIAL = 0.5

_ABSTAIN_RE = re.compile(
    r"\b(unknown|cannot answer|can't answer|no information|not found in the corpus|"
    r"outside the corpus|unable to determine)\b", re.IGNORECASE)

# Number-bearing tokens must match exactly — "180 days" is not "190 days".
_NUM_RE = re.compile(r"\d+(?:\.\d+)?")

# Negation polarity: a fact phrased negatively ("no PA required") must not
# match an answer with no negation (and vice versa) — token overlap alone
# would score "PA required" == "no PA required".
_NEG_RE = re.compile(r"\b(no|not|never|without|cannot|can't|won't|isn't|aren't)\b",
                     re.IGNORECASE)

# The reference bank frames identification facts in judge-facing
# vocabulary ("Sunshine Health is the payer being asked about", "H0015
# is the IOP code under discussion"). Its LLM judge scores these
# semantically; the offline matcher approximates that by dropping the
# framing words so only the CONTENT tokens (entity names, codes) have to
# appear in the haystack.
_FRAME_STOPWORDS = frozenset({
    "payer", "payor", "context", "question", "asked", "asking",
    "discussion", "being", "destination", "verified", "applies",
})

# Common jurisdiction abbreviations normalize to the spelled-out form so
# "FL Medicaid" matches corpus text that says "Florida Medicaid".
_TOKEN_ALIASES = {
    "fl": "florida", "ga": "georgia", "tx": "texas", "ca": "california",
    "ny": "new", "oh": "ohio", "il": "illinois", "mi": "michigan",
    "nc": "north", "pa2": "pennsylvania",
}


@dataclasses.dataclass
class FactVerdicts:
    must: list[bool]
    bonus: list[bool]
    forbidden: list[bool]


@dataclasses.dataclass
class JudgeResult:
    score: float
    verdict: str  # correct | partial | incorrect | abstain
    verdicts: FactVerdicts
    method: str  # "llm" | "overlap"


def _fact_present(fact: str, haystack: str, hay_tokens: set[str]) -> bool:
    """Offline presence check: all numbers in the fact must appear
    verbatim, and ≥60% of its content tokens (stemmed, stopword-free)
    must appear in the haystack."""
    nums = _NUM_RE.findall(fact)
    if nums and not all(n in haystack for n in nums):
        return False
    if _NEG_RE.search(fact) and not _NEG_RE.search(haystack):
        return False  # negative fact, positive haystack — polarity mismatch
    toks = [_TOKEN_ALIASES.get(t, t)
            for t in tokenize(fact, drop_stopwords=True)
            if t not in STOPWORDS and t not in _FRAME_STOPWORDS]
    if not toks:
        return bool(nums)
    hit = sum(1 for t in toks if t in hay_tokens)
    return hit / len(toks) >= 0.6


def _overlap_verdicts(answer: str, must: Sequence[str], bonus: Sequence[str],
                      forbidden: Sequence[str]) -> FactVerdicts:
    hay_tokens = set(tokenize(answer, drop_stopwords=True))
    return FactVerdicts(
        must=[_fact_present(f, answer, hay_tokens) for f in must],
        bonus=[_fact_present(f, answer, hay_tokens) for f in bonus],
        forbidden=[_fact_present(f, answer, hay_tokens) for f in forbidden],
    )


def _llm_verdicts(llm: LLMClient, answer: str, must, bonus, forbidden) -> FactVerdicts | None:
    facts = [("must", f) for f in must] + [("bonus", f) for f in bonus] \
        + [("forbidden", f) for f in forbidden]
    numbered = "\n".join(f"{i}. [{kind}] {f}" for i, (kind, f) in enumerate(facts))
    out = llm.generate(
        "For each numbered fact, answer true if the ANSWER asserts it "
        "(semantically, not verbatim), else false. Reply as a JSON list of "
        f"booleans only.\n\nANSWER:\n{answer}\n\nFACTS:\n{numbered}",
        stage="judge", max_tokens=400,
    )
    try:
        flags = json.loads(re.search(r"\[.*\]", out, re.S).group(0))
        assert len(flags) == len(facts)
    except Exception:
        return None  # fall back to overlap
    n_m, n_b = len(must), len(bonus)
    return FactVerdicts(
        must=[bool(x) for x in flags[:n_m]],
        bonus=[bool(x) for x in flags[n_m:n_m + n_b]],
        forbidden=[bool(x) for x in flags[n_m + n_b:]],
    )


def score_from_verdicts(v: FactVerdicts) -> float:
    must_frac = (sum(v.must) / len(v.must)) if v.must else 1.0
    bonus_frac = (sum(v.bonus) / len(v.bonus)) if v.bonus else 0.0
    score = 0.9 * must_frac + 0.1 * bonus_frac
    if any(v.forbidden):
        score = min(score, 0.2)
    return round(score, 4)


def get_judge_llm() -> "LLMClient | None":
    """Env-selected judge LLM — the rubric judge's live path through
    the concrete wire adapters (reference: eval/judge.py:376 scores via
    the LLM manager; verdict bands stay deterministic here either way).

    MRAG_JUDGE_PROVIDER=openai|vertex → providers_external adapters
    (model override MRAG_JUDGE_MODEL); =proxy → the generic JSON proxy
    (MRAG_JUDGE_URL). Unset → None (the offline overlap matcher, the
    zero-egress default).

    One-command real-endpoint eval:
      MRAG_JUDGE_PROVIDER=openai MRAG_OPENAI_API_KEY=… \
        python -m mobius_rag_tpu_torch.eval_harness.run --bank cmhc --judge llm
    (or MRAG_JUDGE_PROVIDER=vertex with MRAG_VERTEX_PROJECT/TOKEN).
    The tests drive the same path against a local fake
    chat/completions server (tests/test_torch_eval_harness.py)."""
    import os

    sel = os.getenv("MRAG_JUDGE_PROVIDER", "").strip().lower()
    if not sel:
        return None
    model = os.getenv("MRAG_JUDGE_MODEL", "")
    if sel in ("openai", "vertex"):
        from mobius_rag_tpu_torch import providers_external as pe

        cls = pe.OpenAILLMClient if sel == "openai" else pe.VertexLLMClient
        return cls(model=model) if model else cls()
    if sel == "proxy":
        from mobius_rag_tpu_torch.clients import HTTPLLMClient

        return HTTPLLMClient(os.environ["MRAG_JUDGE_URL"], model=model)
    raise ValueError(
        f"MRAG_JUDGE_PROVIDER={sel!r} must be openai|vertex|proxy")


def judge_answer(
    answer: str,
    must_facts: Sequence[str],
    bonus_facts: Sequence[str] = (),
    forbidden_facts: Sequence[str] = (),
    llm: LLMClient | None = None,
) -> JudgeResult:
    is_abstain = bool(_ABSTAIN_RE.search(answer or "")) or not (answer or "").strip()
    method = "overlap"
    verdicts = None
    if llm is not None:
        verdicts = _llm_verdicts(llm, answer or "", must_facts, bonus_facts,
                                 forbidden_facts)
        if verdicts is not None:
            method = "llm"
    if verdicts is None:
        verdicts = _overlap_verdicts(answer or "", must_facts, bonus_facts,
                                     forbidden_facts)
    score = score_from_verdicts(verdicts)
    if is_abstain and not any(verdicts.must):
        verdict = "abstain"
    elif score >= VERDICT_CORRECT:
        verdict = "correct"
    elif score >= VERDICT_PARTIAL:
        verdict = "partial"
    else:
        verdict = "incorrect"
    return JudgeResult(score=score, verdict=verdict, verdicts=verdicts, method=method)
