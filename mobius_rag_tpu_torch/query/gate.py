"""Gate: "can / should we answer?" — contour classification + fail-fast (the port of
``mobius_rag_tpu.query.gate``).

Rebuilds two reference mechanisms:
- the next-gen Shape gate (app/services/retriever/shape/gate.py):
  lexicon expand → doc-grain corpus probe (union/intersection of
  tag-bearing docs) → contour EXACT / VICINITY / UNDERSPECIFIED /
  CORPUS_GAP / OUT_OF_SCOPE / UNCLEAR;
- the agent's fail-fast gate "e" (corpus_search_agent.py:398): PHI /
  prompt-injection / no-domain-match refusal before any expensive arm.

The corpus probe here is a host-side dict lookup over the ChunkStore's
doc→tag map (O(matched tags), never touches the chunk matrix) — same
cost profile as the reference's doc-grain SQL probe.
"""
from __future__ import annotations

import dataclasses
import enum
import re

from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.query.classify import QueryProfile
from mobius_rag_tpu_torch.query.lexicon import Lexicon


class Contour(str, enum.Enum):
    EXACT = "EXACT"
    VICINITY = "VICINITY"
    UNDERSPECIFIED = "UNDERSPECIFIED"
    CORPUS_GAP = "CORPUS_GAP"
    OUT_OF_SCOPE = "OUT_OF_SCOPE"
    UNCLEAR = "UNCLEAR"


# Below this many union docs the corpus itself narrows the answer — a
# missing slot doesn't make the query underspecified (gate.py:_BROAD_MIN_DOCS).
BROAD_MIN_DOCS = 25

# Structural process-intent phrasing (explicit how-to framing only).
_PROCESS_INTENT_RE = re.compile(
    r"\b(how do i|how can i|how does one|how to|"
    r"what('?s| is) the process (for|to)|"
    r"what are the steps (for|to)|steps to|procedure for)\b", re.IGNORECASE)

# Malformed = not parseable as a question/ask at all (gibberish, empty,
# no plausible English words). The reference's word-count check let
# multi-word fake English ("asdkfj qwoeiru xyz") through — a pinned known
# gap in its contour bank (queries_gate_contours.yaml gate024 notes).
# Here a word is plausible only if it has a vowel AND no ≥4-run of
# consonants or vowels (keyboard mash produces such runs; real English
# almost never does), which closes that gap.
_TOKEN_RE = re.compile(r"[a-zA-Z]+")
_CONS_RUN_RE = re.compile(r"[bcdfghjklmnpqrstvwxz]{4,}", re.IGNORECASE)
_VOWEL_RUN_RE = re.compile(r"[aeiou]{4,}", re.IGNORECASE)
_VOWEL_RE = re.compile(r"[aeiouy]", re.IGNORECASE)


def _plausible_words(query: str) -> int:
    n = 0
    for w in _TOKEN_RE.findall(query):
        if len(w) < 2 or not _VOWEL_RE.search(w):
            continue
        if _CONS_RUN_RE.search(w) or _VOWEL_RUN_RE.search(w):
            continue
        if re.search(r"q(?!u)", w, re.IGNORECASE):  # q without u = mash
            continue
        n += 1
    return n


# Yes/no fact-lookup form ("Is eligibility required for Medicaid") — a
# closed question picks ONE fact, so an umbrella domain match is still
# disambiguated (the reference's gate010 negative control: 'required' as
# fact lookup, not a process ask → exact).
_YESNO_RE = re.compile(r"^\s*(is|are|does|do|will|would|should|must)\b",
                       re.IGNORECASE)

# Fail-fast gate e patterns: PHI and prompt-injection/jailbreak shapes.
_PHI_RE = re.compile(
    r"\b(\d{3}-\d{2}-\d{4}|(?:patient|member)\s+(?:ssn|dob|date of birth)|"
    r"medical record number|mrn\s*[:#]\s*\d+)\b", re.IGNORECASE)
_JAILBREAK_RE = re.compile(
    r"\b(ignore\s+(?:(?:all|any|the|previous|prior)\s+)*(?:instructions|rules)|"
    r"system prompt|you are now|pretend (?:you are|to be)|developer mode)\b",
    re.IGNORECASE)


@dataclasses.dataclass
class CorpusProbe:
    union_docs: int
    intersection_docs: int
    per_code_docs: dict[str, int]


@dataclasses.dataclass
class GateResult:
    contour: Contour
    probe: CorpusProbe
    reasons: list[str]
    fail_fast: str | None = None  # "phi" | "jailbreak" | None
    narration: str = ""

    @property
    def should_answer(self) -> bool:
        return self.fail_fast is None and self.contour in (
            Contour.EXACT, Contour.VICINITY, Contour.UNDERSPECIFIED,
        )


def doc_tag_index(store: ChunkStore, lexicon: Lexicon) -> dict[str, set[str]]:
    """full tag code → set of doc_ids carrying it (built from the host
    record map; cached by the agent). The device mirror of the
    reference's document_tags doc-grain probe."""
    by_tag_id = {}
    for e in lexicon.entries:
        by_tag_id[(e.kind, e.tag_id)] = e.full_code
    out: dict[str, set[str]] = {}
    for rec in store.records:
        if rec is None:
            continue
        for kind, ids in (("j", rec.j_tags), ("d", rec.d_tags), ("p", rec.p_tags)):
            for t in ids:
                code = by_tag_id.get((kind, t))
                if code:
                    out.setdefault(code, set()).add(rec.doc_id)
    return out


def corpus_probe(profile_codes: list[str], tag_docs: dict[str, set[str]]) -> CorpusProbe:
    per_code = {c: len(tag_docs.get(c, ())) for c in profile_codes}
    sets = [tag_docs.get(c, set()) for c in profile_codes if c in tag_docs]
    union = set().union(*sets) if sets else set()
    inter = set.intersection(*sets) if sets else set()
    return CorpusProbe(len(union), len(inter), per_code)


def fail_fast_check(query: str) -> str | None:
    if _PHI_RE.search(query):
        return "phi"
    if _JAILBREAK_RE.search(query):
        return "jailbreak"
    return None


# Deictic/anaphoric fragments: a query that points at unstated prior
# context ("the thing from before", "that form", "it") can't be
# classified by content — UNCLEAR, not OUT_OF_SCOPE (the reference's
# malformed-vs-off-domain detector, retriever/shape/gate.py:65).
_DEICTIC_RE = re.compile(
    r"\b(the (thing|one|stuff|item)|from (before|earlier|last time)|"
    r"that (one|thing)|as (discussed|mentioned)|you know)\b", re.IGNORECASE)

# Minimum fraction of a no-codes query's plausible words that must
# appear in the corpus vocabulary for the query to count as in-domain
# (UNDERSPECIFIED — proceed on the vector arm) rather than
# OUT_OF_SCOPE. Everyday paraphrases fire no lexicon code but share
# most of their vocabulary with the corpus; a sourdough recipe shares
# almost none.
DOMAIN_VOCAB_MIN = 0.4


def run_gate(query: str, profile: QueryProfile, probe: CorpusProbe,
             vocab_overlap: float | None = None) -> GateResult:
    """Contour rules (reference gate.py:9-24 semantics, pinned against the
    live-verified contour bank queries_gate_contours.yaml):
      no codes, malformed/deictic          → UNCLEAR
      no codes, corpus-vocab overlap ≥ min → UNDERSPECIFIED (lexicon-free
                                             but in-domain: vector arm)
      no codes, well-formed, off-domain    → OUT_OF_SCOPE
      tags matched, union == 0             → CORPUS_GAP
      D+J, D umbrella-only, no P/intent    → UNDERSPECIFIED (explore_siblings)
      D+J matched, intersection == 0       → VICINITY
      D+J matched                          → EXACT
      no J (and no literal anchor)         → UNDERSPECIFIED (missing_jurisdiction)
      J but no D (and no literal anchor)   → UNDERSPECIFIED (missing_domain)
      literal anchor                       → EXACT (the code IS the slot)
    Disambiguators for umbrella-D: a P tag, explicit process-intent
    phrasing, or a yes/no fact-lookup form.

    ``vocab_overlap`` (optional, supplied by the agent from the store's
    document-frequency table): fraction of the query's plausible words
    whose hash bucket is populated in the corpus. Round-5 fix: all four
    lexicon-free probe classes previously collapsed to OUT_OF_SCOPE —
    a false fail-fast for in-domain colloquial phrasing the paraphrase
    bank exists to catch.
    """
    reasons: list[str] = []
    ff = fail_fast_check(query)
    if ff:
        return GateResult(Contour.OUT_OF_SCOPE, probe, [f"fail_fast:{ff}"],
                          fail_fast=ff, narration=f"refused ({ff})")

    exp = profile.expansion
    any_codes = bool(exp.matched_codes) or profile.has_literal

    if not any_codes:
        n_plausible = _plausible_words(query)
        if n_plausible < 2:
            return GateResult(Contour.UNCLEAR, probe, ["no codes; malformed"])
        if _DEICTIC_RE.search(query) and n_plausible < 8:
            return GateResult(Contour.UNCLEAR, probe,
                              ["no codes; deictic fragment needs context"])
        if vocab_overlap is not None and vocab_overlap >= DOMAIN_VOCAB_MIN:
            return GateResult(
                Contour.UNDERSPECIFIED, probe,
                [f"no codes but corpus vocabulary overlap "
                 f"{vocab_overlap:.2f} — lexicon-free in-domain phrasing"])
        return GateResult(Contour.OUT_OF_SCOPE, probe, ["no codes; well-formed"])

    if exp.matched_codes and probe.union_docs == 0:
        return GateResult(Contour.CORPUS_GAP, probe,
                          ["tags matched but no docs carry them"])

    has_d, has_j = profile.has_d_tag, profile.has_j_tag
    if has_d and has_j:
        d_general_only = all(
            c.endswith(".general") for c in exp.domain_tags
        ) and bool(exp.domain_tags)
        disambiguated = (profile.has_p_tag
                         or bool(_PROCESS_INTENT_RE.search(query))
                         or bool(_YESNO_RE.search(query)))
        if d_general_only and not disambiguated:
            return GateResult(Contour.UNDERSPECIFIED, probe,
                              ["underspecified_kind=explore_siblings: "
                               "D umbrella-only, no disambiguator"])
        if probe.intersection_docs == 0 and len(exp.matched_codes) > 1:
            return GateResult(Contour.VICINITY, probe,
                              ["tags covered separately, combination not"])
        return GateResult(Contour.EXACT, probe, ["D+J matched with coverage"])

    if profile.has_literal:
        return GateResult(Contour.EXACT, probe,
                          ["literal anchor narrows the missing slot"])
    if not has_j:
        return GateResult(Contour.UNDERSPECIFIED, probe,
                          ["underspecified_kind=missing_jurisdiction"])
    return GateResult(Contour.UNDERSPECIFIED, probe,
                      ["underspecified_kind=missing_domain"])
