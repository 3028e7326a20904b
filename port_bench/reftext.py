"""The host text semantics of a hybrid query, written out plainly for the
reference (``reference.py``): tokenizing and stemming, the hashed-term
BM25 weights of a chunk, lexicon phrase matching with word boundaries,
query expansion and the query's IDF weights.

They follow the documented behaviour of the system's ingest and query
preparation (a chunk's BM25 weights, Path-B tagging, the reference
lexicon expansion with its 12-entry cap and single-word stoplist) and
import nothing of the system. A phrase is matched by a regular
expression with ``[a-z0-9]`` word boundaries over the lowercased text.
"""
from __future__ import annotations

import json
import math
import re
import zlib
from collections import Counter

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_QUESTION_LEAD = re.compile(
    r"^\s*(?:(?:how\s+(?:many|much|long|do|does|can|should)|what(?:'s|\s+is|\s+are)?|"
    r"when\s+(?:is|are|do|does|can|should)|where\s+(?:is|are|do|can)|"
    r"who\s+(?:is|are|do|can)|why\s+(?:is|are|do|does)|"
    r"do(?:es)?|can|could|should|would|is|are|tell\s+me(?:\s+about)?|"
    r"i\s+(?:need|want)\s+to\s+know)\b\s*)+",
    re.IGNORECASE,
)
NOISE_WORDS = frozenset({"many", "much", "often", "several", "various", "certain", "few",
                         "some", "any", "every", "all", "most", "more"})
STOPWORDS = frozenset({
    "a", "an", "the", "and", "or", "but", "not", "is", "are", "was", "were",
    "be", "been", "being", "do", "does", "did", "have", "has", "had",
    "i", "me", "my", "we", "our", "you", "your", "he", "she", "it", "they",
    "to", "of", "in", "for", "on", "with", "at", "by", "from", "up",
    "about", "into", "through", "during", "until", "against", "among",
    "when", "where", "who", "which", "what", "that", "this", "these", "those",
    "can", "will", "just", "should", "would", "could", "use", "used", "using",
    "may", "how", "why", "if", "than", "so", "as", "such", "also",
})
SINGLE_WORD_STOPLIST = frozenset({
    "provider", "providers", "policy", "policies", "rule", "rules", "requirement",
    "requirements", "information", "info", "details", "general", "specific", "covered",
    "coverage", "applies", "apply", "process", "guideline", "guidelines", "service",
    "services", "plan", "plans", "member", "members", "patient", "patients", "client",
    "clients", "notice", "section", "program", "programs", "benefit", "benefits",
    "criteria", "procedure", "procedures", "standard", "standards", "update", "updates",
})
_SUFFIXES = (("ization", "ize"), ("ational", "ate"), ("fulness", "ful"), ("ousness", "ous"),
             ("iveness", "ive"), ("tional", "tion"), ("biliti", "ble"), ("icate", "ic"),
             ("ative", ""), ("alize", "al"), ("ment", ""), ("ness", ""))
# BM25 shape of a chunk's weights: body field weight, k1, b, reference length
BODY_WEIGHT, K1, B_LEN, REF_LEN = 0.1, 1.2, 0.75, 300.0
MAX_ENTRIES = 12
MAX_SLOTS = 64


def stem(w: str) -> str:
    if len(w) > 4 and w.endswith("ies"):
        w = w[:-3] + "y"
    elif len(w) > 4 and w.endswith("sses"):
        w = w[:-2]
    elif len(w) > 3 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        w = w[:-1]
    for suf, repl in _SUFFIXES:
        if len(w) > len(suf) + 3 and w.endswith(suf):
            w = w[: -len(suf)] + repl
            break
    if len(w) > 5 and w.endswith("ing"):
        base = w[:-3]
        if len(base) >= 3:
            w = base[:-1] if len(base) > 3 and base[-1] == base[-2] else base
    elif len(w) > 4 and w.endswith("ed"):
        base = w[:-2]
        if len(base) >= 3:
            w = base[:-1] if len(base) > 3 and base[-1] == base[-2] else base
    if len(w) > 4 and w.endswith("ly"):
        w = w[:-2]
    return w


def tokens(text: str, drop_stopwords: bool = False) -> list[str]:
    toks = _TOKEN_RE.findall(text.lower())
    if drop_stopwords:
        toks = [t for t in toks if t not in STOPWORDS]
    return [stem(t) for t in toks]


def bucket(term: str, n: int) -> int:
    return zlib.crc32(term.encode("utf-8")) % n


def body_weights(text: str, n_buckets: int) -> dict[int, float]:
    """A chunk body's hashed-term weights: field weight times the
    tf-saturated BM25 term weight at a fixed reference length."""
    toks = tokens(text)
    out: dict[int, float] = {}
    if not toks:
        return out
    norm = K1 * (1.0 - B_LEN + B_LEN * len(toks) / REF_LEN)
    for term, tf in Counter(toks).items():
        b = bucket(term, n_buckets)
        out[b] = out.get(b, 0.0) + BODY_WEIGHT * (tf * (K1 + 1.0)) / (tf + norm)
    return out


def normalize_query(query: str) -> str:
    q = _QUESTION_LEAD.sub(" ", query)
    words = [w for w in q.split() if w.lower() not in NOISE_WORDS]
    return " ".join(words).strip() or query


class RefLexicon:
    """Entries in file order; each kind numbers its entries from 0 (the
    bit of its tag); every distinct phrase gets an id in order of first
    appearance. An entry's phrases are its strong phrases, aliases and the
    last part of its code, lowercased and deduplicated."""

    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        self.entries = []
        self.phrase_ids: dict[str, int] = {}
        count = {"j": 0, "d": 0, "p": 0}
        for item in raw["entries"]:
            leaf = item["code"].split(".")[-1].replace("_", " ")
            bag: list[str] = []
            for p in [*(item.get("strong_phrases") or []), *(item.get("aliases") or []), leaf]:
                p = p.strip().lower()
                if p and p not in bag:
                    bag.append(p)
            kind = item["kind"]
            self.entries.append({"kind": kind, "tag": count[kind], "phrases": bag,
                                 "selectivity": float(item.get("selectivity", 0.8))})
            count[kind] += 1
            for p in bag:
                self.phrase_ids.setdefault(p, len(self.phrase_ids))
        self._patterns = {p: re.compile(r"(?<![a-z0-9])" + re.escape(p) + r"(?![a-z0-9])")
                          for p in self.phrase_ids}

    def matched(self, text: str) -> set[str]:
        t = text.lower()
        return {p for p, pat in self._patterns.items() if pat.search(t)}

    def tag_text(self, text: str) -> dict:
        """Tags and phrase ids that a chunk's haystack carries: every
        matched phrase, and the tags of every entry holding one."""
        hits = self.matched(text)
        tags: dict[str, set[int]] = {"j": set(), "d": set(), "p": set()}
        for e in self.entries:
            if any(p in hits for p in e["phrases"]):
                tags[e["kind"]].add(e["tag"])
        return {"phrases": {self.phrase_ids[p] for p in hits}, **tags}

    def expand(self, query: str) -> dict:
        """The query's expansion: matched entries in file order (at most
        12; a lone stoplisted word matches nothing), their tags, the
        deduplicated phrase bag and its coverage slots (phrase id,
        selectivity, j-tag or -1)."""
        hits = {p for p in self.matched(query) if " " in p or p not in SINGLE_WORD_STOPLIST}
        matched = [e for e in self.entries if any(p in hits for p in e["phrases"])]
        matched = matched[:MAX_ENTRIES]
        tags: dict[str, list[int]] = {"j": [], "d": [], "p": []}
        bag: list[str] = []
        slots: list[tuple[int, float, int]] = []
        for e in matched:
            tags[e["kind"]].append(e["tag"])
            jtag = e["tag"] if e["kind"] == "j" else -1
            for p in e["phrases"]:
                if p not in bag:
                    bag.append(p)
                    slots.append((self.phrase_ids[p], e["selectivity"], jtag))
        return {"tags": tags, "phrases": bag, "slots": slots[:MAX_SLOTS]}


def query_weights(query: str, phrases: list[str], df: dict[int, int], n_docs: int,
                  n_buckets: int) -> dict[int, float]:
    """Bucket -> IDF weight of the query's terms and its expansion
    phrases' terms (stopwords dropped); a bucket keeps its largest
    positive weight."""
    terms = set(tokens(normalize_query(query), drop_stopwords=True))
    for p in phrases:
        terms.update(tokens(p, drop_stopwords=True))
    nd = max(n_docs, 1)
    out: dict[int, float] = {}
    for t in terms:
        b = bucket(t, n_buckets)
        d = df.get(b, 0)
        idf = math.log(1.0 + (nd - d + 0.5) / (d + 0.5))
        if idf > out.get(b, 0.0):
            out[b] = idf
    return out
