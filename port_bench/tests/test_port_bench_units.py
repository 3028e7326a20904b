"""The yardstick's pieces at small sizes: the traffic generator, the
corpus, the roofline counts, the trace's reduction."""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from port_bench import corpus, roofline, spec, trace, traffic

MIX = spec.load_json(spec.mix_path("backlog"))
SERVED = spec.load_json(spec.mix_path("served"))
SMALL = {"seed": 2**40 + 3, "rows": 3000, "dim": 64, "centers": 16, "noise": 0.05}


def test_request_specs_are_the_same_per_seed_and_reordered_across_seeds():
    mix = dict(MIX, pool=960, warm=48, vectors=64)
    a, b = traffic.request_specs(mix, 3_000_000_017), traffic.request_specs(mix, 3_000_000_017)
    c = traffic.request_specs(mix, 11)
    assert a == b
    assert a != c

    def mix_of(specs):
        """(payer filter, template) counts: the same on every seed."""
        tpl = mix["queries"]["templates"]
        return collections.Counter(
            (s["payer"], next(t for t in tpl if _fits(t, s["text"]))) for s in specs)

    assert mix_of(a) == mix_of(c)
    filtered = sum(1 for s in a if s["payer"]) / len(a)
    assert filtered == pytest.approx(MIX["filtered"][0] / MIX["filtered"][1], abs=0.01)
    # every text distinct, warm-up's too, and none of warm-up's in the pool
    warm = traffic.warm_specs(mix, 3_000_000_017)
    texts = [s["text"] for s in a + warm]
    assert len(set(texts)) == len(texts) == 960 + 48
    assert traffic.repeat_share(a, 960) == 0.0
    assert traffic.repeat_share(a, 1920) == 0.5  # the second pass repeats the first
    assert [s["vec"] for s in a[:66]] == list(range(64)) + [0, 1]


def _fits(template: str, text: str) -> bool:
    import re

    pat = re.escape(template)
    for slot in ("a", "b", "payer", "year"):
        pat = pat.replace(re.escape("{" + slot + "}"), ".+")
    return re.fullmatch(pat, text) is not None


def test_a_repeat_share_in_the_mix_is_what_the_pool_holds():
    mix = dict(MIX, pool=1000, warm=0, vectors=64, repeat=0.25)
    specs = traffic.request_specs(mix, 5)
    assert traffic.repeat_share(specs, 1000) == pytest.approx(0.25, abs=0.002)


def test_arrivals_offer_the_same_count_on_every_seed():
    d1, p1 = traffic.arrivals(SERVED, 5, 10.0)
    d2, p2 = traffic.arrivals(SERVED, 5, 10.0)
    d3, _ = traffic.arrivals(SERVED, 4_000_000_000, 10.0)
    assert np.array_equal(d1, d2) and np.array_equal(p1, p2)
    assert len(d1) == len(d3) == round(SERVED["rate"] * (SERVED["warmup_s"] + 10.0))
    assert not np.array_equal(d1, d3)
    assert d1[0] == 0.0 and d1[-1] < SERVED["warmup_s"] + 10.0
    assert np.all(np.diff(d1) >= 0)


def test_corpus_and_queries_are_the_same_per_seed():
    r1 = corpus.make_vectors(SMALL, "cpu", 2**40 + 3)
    r2 = corpus.make_vectors(SMALL, "cpu", 2**40 + 3)
    assert r1.dtype == torch.bfloat16 and r1.shape == (3000, 64)
    assert torch.equal(r1, r2)
    assert not torch.equal(r1, corpus.make_vectors(SMALL, "cpu", 7))
    mix = dict(MIX, vectors=64)
    q1 = traffic.query_vectors(mix, r1, 9)
    assert q1.shape == (64, 64)
    assert np.array_equal(q1, traffic.query_vectors(mix, r2, 9))
    assert not np.array_equal(q1, traffic.query_vectors(mix, r1, 10))
    assert np.allclose(np.linalg.norm(q1, axis=1), 1.0, atol=1e-5)


def test_row_texts_cycle_by_runs_of_featurize_every():
    spec_ = {"texts": ["a", "b", "c"], "featurize_every": 50}
    got = [corpus.text(spec_, i) for i in (0, 49, 50, 100, 150, 199)]
    assert got == ["a", "a", "b", "c", "a", "a"]


def test_backlog_batches_cover_the_pool_in_order():
    b = traffic.backlog_batches(MIX, 100)
    assert b == [list(range(0, 32)), list(range(32, 64)), list(range(64, 96))]


def test_topk_bound_by_hand():
    # B=2, C=10, D=8, m=3, bf16 rows: rows 160 B, queries 64, penalty 80, out 48
    nbytes, ops = roofline.topk_work(2, 10, 8, 3, "bfloat16")
    assert nbytes == 160 + 64 + 80 + 48
    assert ops == {"bfloat16": 2 * 2 * 10 * 8}
    t, by = roofline.least_s(nbytes, ops)
    assert by == "bytes" and t == pytest.approx(352 / 3.35e12)


def test_proj_bound_by_hand():
    # B=2 queries probing 3 cells each that hold rows; the batch's
    # distinct probed cells hold 7 rows, each query's own cells 5 and 6
    # (11 pairs), p 8: codes 7*8 = 56 B, probes 2*3*4 = 24, int8 queries
    # 16, dots out 11*4 = 44; padding slots are not counted
    nbytes, ops = roofline.proj_work(2, 3, 7, 11, 8)
    assert nbytes == 56 + 24 + 16 + 44
    assert ops == {"int8": 2 * 11 * 8}


def test_search_bound_by_hand():
    shape = {"batch": 2, "rows": 10, "dim": 8, "m": 3, "k": 2, "tag_words": 1,
             "phrase_words": 1, "postings": 5, "dtype": "bfloat16", "backend": "exact"}
    nbytes, ops = roofline.search_work(shape)
    per_row = 5 * 4 + 3 * 4  # gate scalars, j/d/p bitsets of one word
    cand = 2 * 3 * 3
    want = (10 * per_row + 2 * 8 * 2 + 2 * 2 * 8 + 5 * 6
            + cand * (8 * 2 + 8 + 4 + 8) + 10 * 8 * 2)
    assert nbytes == want
    assert ops == {"bfloat16": 2 * cand * 8 + 2 * 2 * 10 * 8}
    # 4 cells hold rows; the probed cells hold 3 rows, 5 query-row pairs
    proj = dict(shape, backend="proj", cells=4, p=4, probe=2, scan_rows=3, scan_pairs=5)
    nbytes_p, ops_p = roofline.search_work(proj)
    assert nbytes_p == want - 10 * 8 * 2 + 3 * (4 + 8) + 4 * 8 * 4 + 4 * 8 * 4
    assert ops_p == {"bfloat16": 2 * cand * 8, "float32": 2 * 2 * (4 + 4) * 8,
                     "int8": 2 * 5 * 4}


def test_busy_union_counts_an_overlap_once():
    # [0, 10) and [5, 15) overlap: 15 ns busy, not 20; [20, 30) alone
    dev = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a")]
    out = trace.reduce(dev, [], 0, 40)
    assert out["busy_s"] == pytest.approx(25e-9)
    assert out["by_name"] == {"a": pytest.approx(20e-9), "b": pytest.approx(10e-9)}
    # idle: [15, 20) and [30, 40), the longer first
    assert [g[1] for g in out["idle_gaps"]] == [pytest.approx(10e-9), pytest.approx(5e-9)]


def test_idle_gaps_are_named_by_the_innermost_span():
    dev = [(0, 10, "k"), (30, 40, "k")]
    spans = [(0, 100, "search_pipelined"), (12, 28, "prepare_host")]
    out = trace.reduce(dev, spans, 0, 100)
    assert out["idle_gaps"][0] == ["search_pipelined", pytest.approx(60e-9)]
    assert out["idle_gaps"][1] == ["prepare_host", pytest.approx(20e-9)]


def test_events_are_clipped_to_the_window():
    out = trace.reduce([(0, 100, "k")], [], 50, 150)
    assert out["busy_s"] == pytest.approx(50e-9)
    assert out["window_s"] == pytest.approx(100e-9)


@pytest.mark.parametrize("raw,want", [
    ("void topk_tiles<__nv_bfloat16, 4>(float const*, int)", "topk_tiles"),
    ("void (anonymous namespace)::proj_scan_kernel<-1>(int const*)", "proj_scan_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pinned -> Device)"),
])
def test_kernel_names(raw, want):
    assert trace.kernel_name(raw) == want
