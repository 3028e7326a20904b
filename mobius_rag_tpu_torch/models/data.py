"""Training-pair mining from the published corpus (the port of
``mobius_rag_tpu.models.data``: host-only numpy, so the same store and
seed give the same pairs and token arrays as the JAX package).

The encoder fine-tunes on in-domain (query, chunk) pairs without any
labeling: the Inverse Cloze Task (ICT) — a sentence sampled from a
paragraph is the pseudo-query, the paragraph (with or without that
sentence) is the positive — plus section-title → paragraph pairs. This
is the native replacement for 'better embeddings' where the reference
could only swap API models."""
from __future__ import annotations

import re

import numpy as np

from mobius_rag_tpu_torch.index.store import ChunkStore

_SENT_RE = re.compile(r"(?<=[.!?;])\s+")


def mine_ict_pairs(store: ChunkStore, *, max_pairs: int = 10000,
                   seed: int = 0, drop_sentence: bool = True
                   ) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    pairs: list[tuple[str, str]] = []
    for rec in store.records:
        if rec is None or len(rec.text) < 80:
            continue
        sents = [s.strip() for s in _SENT_RE.split(rec.text) if len(s.strip()) > 20]
        if not sents:
            continue
        i = int(rng.integers(0, len(sents)))
        query = sents[i]
        if drop_sentence and len(sents) > 1:
            doc = " ".join(sents[:i] + sents[i + 1:])
        else:
            doc = rec.text
        pairs.append((query, doc))
        if rec.section_path:
            pairs.append((f"{rec.payer} {rec.section_path}".strip(), rec.text))
        if len(pairs) >= max_pairs:
            break
    return pairs[:max_pairs]


def batches(pairs: list[tuple[str, str]], tokenizer, batch_size: int,
            *, seed: int = 0):
    """Shuffled (q_tokens, d_tokens) batches, dropping the ragged tail
    (the JAX package's static shapes; kept so both packages draw alike)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for off in range(0, len(pairs) - batch_size + 1, batch_size):
        idx = order[off:off + batch_size]
        qs = tokenizer.encode_batch([pairs[i][0] for i in idx])
        ds = tokenizer.encode_batch([pairs[i][1] for i in idx])
        yield qs, ds


# ---------------------------------------------------------------------------
# Paraphrase augmentation (round 5): surface-form variation for ICT
# ---------------------------------------------------------------------------
# Plain ICT teaches "a sentence retrieves the paragraph around it" —
# pairs share most of their tokens, so a hash-token encoder learns
# little beyond lexical overlap and loses to a random projection on
# lexicon-free paraphrases (EVAL_r4 encoder_real_text). Two augmenters
# close the surface gap:
#
# 1. Lexicon alias substitution: a lexicon entry's phrase list IS a
#    curated synonym cluster ("timely filing" / "filing deadline" /
#    "claim submission deadline" → one j/d/p code). Swapping a matched
#    phrase in the pseudo-query for a sibling phrase creates a pair
#    whose query and document use DIFFERENT surface forms for the same
#    concept — exactly what the reference gets for free from
#    gemini-embedding-001's pretraining.
# 2. A colloquial↔jargon synonym table for the everyday words real
#    queries use where documents use terms of art ("bill"→"claim",
#    "sign-off"→"authorization", …). General domain vocabulary, not
#    bank-specific strings.
#
# Plus word dropout on the query side (robustness to partial overlap).

COLLOQUIAL_SYNONYMS: dict[str, list[str]] = {
    "bill": ["claim"], "bills": ["claims"],
    "rebill": ["resubmit", "corrected claim"],
    "sign-off": ["authorization", "approval"],
    "ok": ["approval", "authorization"],
    "okay": ["approval"],
    "approval": ["authorization", "sign-off"],
    "plan": ["insurer", "health plan", "payer"],
    "insurer": ["plan", "payer"],
    "doctor": ["provider", "practitioner"],
    "office": ["provider", "practice"],
    "patient": ["member", "enrollee"],
    "medicine": ["drug", "medication"],
    "medicines": ["drugs", "medications"],
    "window": ["deadline", "timeframe", "time limit"],
    "deadline": ["window", "time limit", "filing limit"],
    "cut-off": ["deadline", "limit"],
    "send": ["submit", "file"],
    "sent": ["submitted", "filed"],
    "sending": ["submitting", "filing"],
    "fix": ["correct"], "fixed": ["corrected"], "fixing": ["correcting"],
    "challenge": ["appeal", "dispute"],
    "complaint": ["grievance"],
    "ride": ["transportation"],
    "check-up": ["well-child visit", "exam"],
    "paperwork": ["documentation"],
    "turned down": ["denied"],
    "turn-down": ["denial"],
    "paid back": ["reimbursed"],
    "payback": ["reimbursement"],
    "video visit": ["telehealth", "telemedicine"],
    "camera": ["audio-video"],
    "kid": ["child", "pediatric member"], "kids": ["children"],
    "urgent": ["expedited"],
    "rushed": ["expedited", "urgent"],
}


def augment_pairs(pairs: list[tuple[str, str]], *, lexicon=None,
                  factor: float = 1.0, seed: int = 0,
                  word_dropout: float = 0.15) -> list[tuple[str, str]]:
    """Return pairs + ~factor·len(pairs) augmented variants whose
    queries differ in surface form: lexicon-alias swaps, colloquial
    synonym swaps, and word dropout. Documents are never altered (the
    corpus side must look like the corpus)."""
    rng = np.random.default_rng(seed)
    phrase_clusters: list[list[str]] = []
    if lexicon is not None:
        for e in lexicon.entries:
            ph = [p for p in e.phrases if len(p) > 3]
            if len(ph) >= 2:
                phrase_clusters.append(ph)

    def alias_swap(q: str) -> str | None:
        ql = q.lower()
        hits = [(c, p) for c in phrase_clusters for p in c if p in ql]
        if not hits:
            return None
        cluster, p = hits[int(rng.integers(0, len(hits)))]
        repl = cluster[int(rng.integers(0, len(cluster)))]
        if repl == p:
            repl = cluster[(cluster.index(p) + 1) % len(cluster)]
        i = ql.index(p)
        return q[:i] + repl + q[i + len(p):]

    def synonym_swap(q: str) -> str | None:
        ql = q.lower()
        hits = [w for w in COLLOQUIAL_SYNONYMS if w in ql]
        if not hits:
            return None
        w = hits[int(rng.integers(0, len(hits)))]
        repl = COLLOQUIAL_SYNONYMS[w][
            int(rng.integers(0, len(COLLOQUIAL_SYNONYMS[w])))]
        i = ql.index(w)
        return q[:i] + repl + q[i + len(w):]

    def dropout(q: str) -> str | None:
        words = q.split()
        if len(words) < 6:
            return None
        keep = [w for w in words
                if rng.random() > word_dropout or any(ch.isdigit() for ch in w)]
        if len(keep) == len(words) or len(keep) < 4:
            return None
        return " ".join(keep)

    out = list(pairs)
    want = int(len(pairs) * factor)
    ops = (alias_swap, synonym_swap, dropout)
    attempts = 0
    while len(out) - len(pairs) < want and attempts < want * 8:
        attempts += 1
        q, d = pairs[int(rng.integers(0, len(pairs)))]
        op = ops[int(rng.integers(0, len(ops)))]
        q2 = op(q)
        if q2 and q2 != q:
            out.append((q2, d))
    return out


def pretokenized_batches(pairs: list[tuple[str, str]], tokenizer,
                         batch_size: int, *, steps: int, seed: int = 0):
    """Tokenize ONCE into two arrays, then stream index-shuffled
    batches for `steps` steps (re-shuffling per epoch). `batches()`
    re-tokenizes every epoch in Python, which bounds a long run's
    throughput on a small host."""
    q_tok = tokenizer.encode_batch([p[0] for p in pairs])
    d_tok = tokenizer.encode_batch([p[1] for p in pairs])
    rng = np.random.default_rng(seed)
    done = 0
    while done < steps:
        order = rng.permutation(len(pairs))
        for off in range(0, len(pairs) - batch_size + 1, batch_size):
            idx = order[off:off + batch_size]
            yield q_tok[idx], d_tok[idx]
            done += 1
            if done >= steps:
                return
