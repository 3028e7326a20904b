"""The one traffic generator. A traffic mix is a JSON file of parameters
(``traffic/<name>.json``); this module turns it and a seed into requests
and, for an open loop, their due times. Every seed gets the same mix (the
same count of each template, payer and filter, the same share of repeats)
and the same number of arrivals; the texts, their order and the times
differ.

Keys of a mix:
  kind        "backlog": a closed loop handing the engine `depth` batches
              of `batch` at a time; "open": independent callers, one
              request each, arriving at `rate` per second
  queries     {"templates": [...], "topics": [...], "payers": [[word,
              filter], ...], "years": [...]}: a text is a template with
              two distinct topics, a payer's word and a year filled in
              ({a}, {b}, {payer}, {year}); each request draws its own
  filtered    [n, m]: n requests in every m carry their payer filter
  repeat      share of the pool's requests whose text and filter repeat
              an earlier request's; the rest are distinct
  tag_mode, mode, k: as a QueryRequest takes them
  pool        requests drawn for a run (the window cycles over them)
  warm        requests more, with texts of their own, that warm-up alone
              uses, so that warm-up fills no cache the window reads
  vectors     query vectors made for a run; request n takes vector
              n mod `vectors`
  query_noise N(0, 1) per dimension added to a corpus row to make a
              query vector, which is then normalized
  sample      answers compared with the reference after the window
  backlog:    batch, depth
  open:       rate, warmup_s (arrivals before the window, not counted)
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.corpus import generator


def _draw(mix: dict, seed: int) -> list[dict]:
    """`pool` + `warm` request specs, every text distinct: request n has
    template n mod T and payer (n // T) mod P; the topics and the year of
    each (template, payer) are drawn without replacement."""
    q = mix["queries"]
    tpl, topics, payers, years = q["templates"], q["topics"], q["payers"], q["years"]
    n = mix["pool"] + mix["warm"]
    rng = np.random.default_rng([int(seed), 2])
    n_t, n_p, n_a, n_y = len(tpl), len(payers), len(topics), len(years)
    combos = n_a * (n_a - 1) * n_y
    specs: list[dict | None] = [None] * n
    n_f, every = mix["filtered"]
    for t in range(n_t):
        for p in range(n_p):
            ids = list(range(t + n_t * p, n, n_t * n_p))
            if len(ids) > combos:
                raise ValueError("the mix's texts run out: more requests than combinations")
            for i, c in zip(ids, rng.choice(combos, len(ids), replace=False).tolist()):
                a, rest = divmod(c, (n_a - 1) * n_y)
                b, y = divmod(rest, n_y)
                b += b >= a  # the second topic differs from the first
                word, payer = payers[p]
                text = tpl[t].format(a=topics[a], b=topics[b], payer=word, year=years[y])
                filt = (i // (n_t * n_p)) % every < n_f
                specs[i] = {"text": text, "payer": payer if filt else "",
                            "tag_mode": mix["tag_mode"], "mode": mix["mode"]}
    return specs


def _place(specs: list[dict], mix: dict, seed: int) -> list[dict]:
    """The pool in a seeded order, `repeat` of it made repeats (each the
    text and filter of an earlier request), and each request's vector."""
    rng = np.random.default_rng([int(seed), 5])
    specs = [specs[i] for i in rng.permutation(len(specs))]
    n_rep = int(round(mix["repeat"] * len(specs)))
    picks = rng.choice(np.arange(1, len(specs)), n_rep, replace=False) if n_rep else []
    for i in np.sort(picks):
        src = specs[int(rng.integers(0, i))]
        specs[i] = dict(specs[i], text=src["text"], payer=src["payer"])
    for n, s in enumerate(specs):
        s["vec"] = n % mix["vectors"]
    return specs


def request_specs(mix: dict, seed: int) -> list[dict]:
    """The pool: `pool` request specs, each {text, payer, tag_mode, mode,
    vec (its query vector's index)}."""
    return _place(_draw(mix, seed)[:mix["pool"]], mix, seed)


def warm_specs(mix: dict, seed: int) -> list[dict]:
    """The `warm` specs that warm-up uses: texts no pool request has."""
    return [dict(s, vec=n % mix["vectors"])
            for n, s in enumerate(_draw(mix, seed)[mix["pool"]:])]


def repeat_share(specs: list[dict], served: int) -> float:
    """The share of the first `served` requests (cycling over the pool)
    whose text and filter an earlier one of them had: what a cache keyed
    on the text could serve at most."""
    seen, rep = set(), 0
    for n in range(served):
        s = specs[n % len(specs)]
        key = (s["text"], s["payer"])
        rep += key in seen
        seen.add(key)
    return rep / max(served, 1)


def query_vectors(mix: dict, rows: torch.Tensor, seed: int) -> np.ndarray:
    """[vectors, D] float32 unit query vectors on the host: each a corpus
    row drawn from the seed plus `query_noise` N(0, 1) per dimension,
    normalized; made on the rows' device."""
    g = generator(seed, 3, rows.device)
    n = mix["vectors"]
    idx = torch.randint(0, rows.shape[0], (n,), device=rows.device, generator=g)
    v = rows[idx].float() + mix["query_noise"] * torch.randn(
        (n, rows.shape[1]), device=rows.device, generator=g)
    return (v / v.norm(dim=1, keepdim=True)).cpu().numpy()


def backlog_batches(mix: dict, n_specs: int) -> list[list[int]]:
    """The pool's requests (by index) as consecutive batches of `batch`."""
    b = mix["batch"]
    return [list(range(lo, lo + b)) for lo in range(0, n_specs - b + 1, b)]


def arrivals(mix: dict, seed: int, seconds: float) -> tuple[np.ndarray, np.ndarray]:
    """An open loop's due times (s from the start of its warm-up) and
    pool indices: round(rate x (warm-up + window)) arrivals with
    exponential gaps, scaled so that they span warm-up and window
    (the first at 0), so every seed offers the same count."""
    span = mix["warmup_s"] + seconds
    n = int(round(mix["rate"] * span))
    rng = np.random.default_rng([int(seed), 4])
    gaps = rng.exponential(1.0, n)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])]) / gaps.sum() * span
    picks = np.arange(n) % mix["pool"]
    return due, picks
