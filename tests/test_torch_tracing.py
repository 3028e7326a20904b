"""The port's spans, stage marks and counters (``observability``'s
"Spans and counters", and the query path that records them), on the CPU.

- With no profiler running nothing is recorded and no
  ``record_function`` is made on the query path.
- Under a profiler, ``search_pipelined`` over four batches gives exactly
  one ``query.prepare``, ``query.dispatch``, ``query.fetch``,
  ``query.finish`` and ``query.assemble`` span a batch, sharing the
  batch's id, with their parents and self times.
- ``query.starved`` opens at the fetch that leaves no batch in flight and
  closes inside the next dispatch, once its batch is in flight; the spans
  in between, and that dispatch up to then, are its children. A batch
  given up unfetched (a failed batch before it) leaves the flight all the
  same, and a profiler session ends the span still open at its stop.
- The CPU's stage marks (the host clock) lie inside their batch's
  dispatch and sum to no more than it; marks outside the engine's
  one-device program are no-ops.
- ``search``'s ``timings_ms`` are the spans' stamps.
- The ring stays bounded; a span recorded on the micro-batcher's executor
  thread, under a profiler started on the main thread, is kept; the
  micro-batcher's queue wait reaches its stats.
- ``CapturedPrograms`` counts captures by key, with a stand-in capture."""
import asyncio

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mobius_rag_tpu_torch import observability as obs
from mobius_rag_tpu_torch.query import engine as eng
from mobius_rag_tpu_torch.query.microbatch import MicroBatcher
from test_torch_compiled import _reqs, _stand_in, _toy_engine

K = 5
PER_BATCH = ("query.prepare", "query.dispatch", "query.fetch", "query.finish",
             "query.assemble")


@pytest.fixture
def recorder():
    obs.RECORDER.reset()
    yield obs.RECORDER
    obs.RECORDER.reset()


def _batches(n: int = 4, size: int = 3) -> list:
    return [_reqs(size, f" round {i}") for i in range(n)]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.tracing()
        return fn()


def _by_name(recorder) -> dict:
    out: dict[str, list] = {}
    for r in recorder.records():
        out.setdefault(r.name, []).append(r)
    return out


def test_no_profiler_records_nothing_and_calls_no_record_function(recorder, monkeypatch):
    made = []
    monkeypatch.setattr(obs.torch_profiler, "record_function",
                        lambda *a, **kw: made.append(a))
    engine = _toy_engine()
    assert not obs.tracing()
    engine.search(_reqs(3), k=K)
    engine.search_pipelined(_batches(), k=K)
    _run(_served(engine, 5))
    assert made == []
    assert len(recorder.records()) == 0
    assert recorder.summary() == {"spans": {}, "children": {}, "stages": {}, "counts": {}}
    assert engine._flight.n == 0 and engine._flight.starved is None


def test_pipelined_spans_one_set_per_batch_with_ids_parents_and_self_times(recorder):
    engine = _toy_engine()
    _traced(lambda: engine.search_pipelined(_batches(), k=K))
    spans = _by_name(recorder)
    ids = sorted({r.batch for r in spans["query.prepare"]})
    assert len(ids) == 4
    for name in PER_BATCH:
        assert sorted(r.batch for r in spans[name]) == ids, name
        assert all(r.parent is None for r in spans[name]), name
    by_id = {r.id: r for r in recorder.records()}
    for emb in spans["query.embeddings"]:
        parent = by_id[emb.parent]
        assert parent.name == "query.prepare" and parent.batch == emb.batch
        assert parent.start <= emb.start <= emb.end <= parent.end
    for prep in spans["query.prepare"]:
        kids = [r for r in recorder.records() if r.parent == prep.id]
        assert prep.self_ns == prep.end - prep.start - sum(r.end - r.start for r in kids)
        assert prep.attrs == {"size": 3}
    for name in PER_BATCH:
        tot = recorder.summary()["spans"][name]
        assert tot["count"] == 4
        assert tot["total_ms"] == pytest.approx(
            sum(r.end - r.start for r in spans[name]) / 1e6)
        assert tot["self_ms"] == pytest.approx(sum(r.self_ns for r in spans[name]) / 1e6)
    # each batch's spans in order: prepared and dispatched before any fetch
    first_fetch = min(r.start for r in spans["query.fetch"])
    assert max(r.end for r in spans["query.dispatch"]) <= first_fetch
    assert [r.attrs["union"] > 0 for r in spans["query.dispatch"]] == [True] * 4
    assert recorder.summary()["spans"]["query.tables"]["count"] == 1


def test_starved_opens_after_the_last_fetch_and_closes_at_the_next_dispatch(recorder):
    engine = _toy_engine()
    calls = [_batches(), _batches()]
    _traced(lambda: [engine.search_pipelined(b, k=K) for b in calls])
    spans = _by_name(recorder)
    starved = spans["query.starved"]
    assert len(starved) == 1  # the second call's stays open until a dispatch
    (gap,) = starved
    fetches = sorted(spans["query.fetch"], key=lambda r: r.start)
    dispatches = sorted(spans["query.dispatch"], key=lambda r: r.start)
    # none opens while batches of the engine are still in flight
    assert fetches[3].end <= gap.start < dispatches[4].start < gap.end <= dispatches[4].end
    assert gap.batch == fetches[3].batch
    kids = recorder.summary()["children"]["query.starved"]
    assert set(kids) == {"query.finish", "query.assemble", "query.tables", "query.prepare",
                         "query.dispatch"}
    covered = sum(kids.values())
    assert covered <= (gap.end - gap.start) / 1e6
    assert gap.self_ns / 1e6 == pytest.approx((gap.end - gap.start) / 1e6 - covered)
    assert engine._flight.n == 0 and engine._flight.starved is not None
    engine.search(_reqs(2), k=K)  # profiler off: closes it, records nothing
    assert engine._flight.starved is None and len(_by_name(recorder)["query.starved"]) == 1


def test_cpu_stage_marks_lie_inside_the_batch_program_and_sum_to_no_more(recorder,
                                                                          monkeypatch):
    engine = _toy_engine()
    readings, read = [], obs.Recorder.read_stages

    def spy(self, marks, run, batch):
        readings.append({"batch": batch, "ms": marks.elapsed_ms(),
                         "start": marks.stamps[0][1], "end": marks.stamps[-1][1]})
        read(self, marks, run, batch)

    monkeypatch.setattr(obs.Recorder, "read_stages", spy)
    _traced(lambda: engine.search_pipelined(_batches(), k=K))
    dispatch = {r.batch: r for r in _by_name(recorder)["query.dispatch"]}
    assert len(readings) == 4
    for reading in readings:
        assert tuple(reading["ms"]) == obs.STAGES
        d = dispatch[reading["batch"]]
        assert d.start <= reading["start"] <= reading["end"] <= d.end
        assert all(v >= 0 for v in reading["ms"].values())
        assert sum(reading["ms"].values()) <= (d.end - d.start) / 1e6
        assert sum(reading["ms"].values()) == pytest.approx(
            (reading["end"] - reading["start"]) / 1e6)
    counts = recorder.summary()["counts"]
    assert counts["marks_read"] == 4 and "marks_skipped" not in counts
    stages = recorder.summary()["stages"]
    assert set(stages) == set(obs.STAGES) and {s["count"] for s in stages.values()} == {4}


def test_marks_outside_the_engine_program_are_no_ops(recorder):
    engine = _toy_engine()
    q = engine.prepare_batch(_reqs(2))[0]

    def direct():
        eng.search_batch(engine.store.index, q, K, engine.cfg.over_fetch, engine.cfg.rrf_k)

    _traced(direct)
    assert recorder.summary()["stages"] == {}
    with obs.stage_marks("cpu") as marks:
        direct()
    assert [s for s, _ in marks.stamps] == ["start", "gate", "vector", "lexical", "dtag"]


def test_search_timings_come_from_the_span_stamps(recorder):
    engine = _toy_engine()
    res = _traced(lambda: engine.search(_reqs(3), k=K))
    spans = {name: rs[0] for name, rs in _by_name(recorder).items()}
    t = res[0].telemetry["timings_ms"]
    assert set(t) == {"prepare", "device"}
    assert t["prepare"] == (spans["query.prepare"].end - spans["query.tables"].start) / 1e6 / 3
    assert t["device"] == (spans["query.finish"].end - spans["query.dispatch"].start) / 1e6 / 3
    untraced = engine.search(_reqs(3), k=K)[0].telemetry["timings_ms"]
    assert set(untraced) == {"prepare", "device"} and min(untraced.values()) > 0


def test_the_ring_stays_bounded():
    rec = obs.Recorder(size=8)

    def many():
        for i in range(20):
            with rec.span("s", batch=i):
                with rec.span("child"):
                    pass

    _traced(many)
    assert len(rec.records()) == 8
    assert rec.summary()["spans"]["s"]["count"] == 20
    assert [r.batch for r in rec.records() if r.name == "child"] == [16, 17, 18, 19]
    assert rec.open("x") is None
    assert rec.summary()["spans"].keys() == {"s", "child"}


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _served(engine, n: int) -> tuple:
    batcher = MicroBatcher(engine, max_batch=4)
    try:
        reqs = _reqs(n, " served")
        res = await asyncio.gather(*(batcher.search_one(r, K) for r in reqs))
        return batcher, res
    finally:
        batcher._pool.shutdown(wait=True)


def test_spans_on_the_executor_thread_are_kept_and_queue_waits_counted(recorder):
    import threading

    engine = _toy_engine()
    batcher, res = _traced(lambda: _run(_served(engine, 10)))
    assert len(res) == 10
    spans = _by_name(recorder)
    main = threading.get_ident()
    assert spans["query.prepare"] and all(r.thread != main for r in spans["query.prepare"])
    assert {r.batch for r in spans["query.assemble"]} == {r.batch for r in spans["query.prepare"]}
    st = batcher.stats
    assert st["queue_wait_count"] == 10 and st["queries"] == 10
    assert 0 <= st["queue_wait_ms_max"] <= st["queue_wait_ms_sum"]
    # no request waits longer than the whole run's spans
    first = min(r.start for r in recorder.records())
    last = max(r.end for r in recorder.records())
    assert st["queue_wait_ms_max"] <= (last - first) / 1e6


def test_captures_are_counted_by_key_and_spanned(recorder):
    engine = _toy_engine()
    cache = _stand_in(engine)
    _traced(lambda: [engine.search(b, k=K) for b in (_reqs(2), _reqs(3), _reqs(2), _reqs(2))])
    assert cache.captures == 2 and cache.replays == 2
    assert sorted(cache.captures_by_key.values()) == [1, 1]
    assert set(cache.captures_by_key) == set(cache.graphs)
    caps = _by_name(recorder)["programs.capture"]
    assert {r.attrs["key"] for r in caps} == set(cache.graphs)
    assert [round(ms, 6) for ms in cache.capture_ms] == [
        round((r.end - r.start) / 1e6, 6) for r in sorted(caps, key=lambda r: r.start)]
    # the stand-in hands out plain copies of the outputs, without the marks
    assert "marks_read" not in recorder.summary()["counts"]


def test_a_later_dispatch_of_the_same_marks_skips_the_earlier_reading(recorder):
    with obs.stage_marks("cpu") as marks:
        obs.mark("gate")
    first = eng.PendingFetch((torch.zeros(1, 2), torch.zeros(1, 2, dtype=torch.int32)), marks)
    second = eng.PendingFetch((torch.zeros(1, 2), torch.zeros(1, 2, dtype=torch.int32)), marks)
    _traced(lambda: (first.wait(), second.wait()))
    assert recorder.summary()["counts"] == {"marks_skipped": 1, "marks_read": 1}
    assert set(recorder.summary()["stages"]) == {"gate"}
    assert recorder.summary()["stages"]["gate"]["count"] == 1


@pytest.mark.parametrize("fails", ["finish", "prepare"])
def test_a_failed_batch_leaves_none_in_flight(recorder, monkeypatch, fails):
    """The second batch's finish, or the third's preparation, raises: the
    batches dispatched and never fetched leave the flight all the same, so
    the next traced drain opens ``query.starved`` again."""
    engine = _toy_engine()
    calls, real = [], getattr(engine, f"_{fails}" if fails == "finish" else "prepare_host")
    at = 2 if fails == "finish" else 3

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == at:
            raise RuntimeError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(engine, "_finish" if fails == "finish" else "prepare_host", failing)
    with pytest.raises(RuntimeError, match="planted"):
        engine.search_pipelined(_batches(), k=K)
    assert engine._flight.n == 0
    monkeypatch.undo()
    _traced(lambda: [engine.search_pipelined(_batches(), k=K) for _ in range(2)])
    assert len(_by_name(recorder)["query.starved"]) == 1
    assert engine._flight.n == 0 and engine._flight.starved is not None


def test_a_starved_span_ends_with_its_profiler_session(recorder):
    """Two sessions of ``profiling.locked_profiler`` with no dispatch
    between them: the span open at the first's stop ends there, and the
    second's first dispatch does not close it again over the gap."""
    import time

    from mobius_rag_tpu_torch.profiling import locked_profiler

    engine = _toy_engine()
    with locked_profiler([ProfilerActivity.CPU]):
        engine.search_pipelined(_batches(), k=K)
    first_stop = time.time_ns()
    time.sleep(0.05)
    second_start = time.time_ns()
    with locked_profiler([ProfilerActivity.CPU]) as prof:
        engine.search(_reqs(2), k=K)
    starved = sorted(_by_name(recorder)["query.starved"], key=lambda r: r.start)
    assert len(starved) == 2 and not recorder._floating
    assert starved[0].end <= first_stop and starved[1].start >= second_start
    twins = [e for e in prof.events() if e.name == "mrag:query.starved"]
    assert len(twins) == 1


def test_window_readings_are_the_recorders_totals_per_batch(recorder):
    """``scripts/trace_window.py``'s readings of a traced drain: each span's
    and stage's total over its count, the stages' sum, the starved share of
    the window and its split, the marks' counts; None where nothing was
    recorded."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "trace_window.py")
    spec = importlib.util.spec_from_file_location("trace_window", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    engine = _toy_engine()
    engine._lexical_kernel_route = lambda: True  # the pair counts, as on a card
    _traced(lambda: [engine.search_pipelined(_batches(), k=K) for _ in range(2)])
    summary = recorder.summary()
    got = mod.readings(summary, window_s=2.0)
    spans, stages = summary["spans"], summary["stages"]
    for name, span_name in (("prepare_ms", "query.prepare"), ("assemble_ms", "query.assemble")):
        assert got[name] == spans[span_name]["total_ms"] / 8
    for stage, name in mod.STAGE_NAMES.items():
        assert got[name] == stages[stage]["total_ms"] / 8
    assert got["stage_sum_ms"] == pytest.approx(sum(s["total_ms"] for s in stages.values()) / 8)
    assert got["starved_share"] == pytest.approx(spans["query.starved"]["total_ms"] / 20.0)
    assert got["starved_split_ms"] == summary["children"]["query.starved"]
    assert got["marks"] == {"marks_read": 8, "marks_skipped": 0}
    counts = summary["counts"]
    assert got["lexical_live_pairs"] == counts["lex_pairs_live"] / counts["lex_pairs_read"]
    recorder.reset()
    none = mod.readings(recorder.summary(), window_s=2.0)
    assert none["prepare_ms"] is None and none["stage_sum_ms"] is None
    assert none["starved_share"] is None and none["marks"] == {"marks_read": 0, "marks_skipped": 0}
    assert none["lexical_live_pairs"] is None


@pytest.mark.parametrize("as_card", [False, True])
def test_lexical_pair_counts_are_the_weights_read(recorder, as_card):
    """While tracing, an engine whose lexical arm runs the kernels adds per
    prepared batch its nonzero (query, bucket) weights (``lex_pairs_live``)
    and B times the union columns its device program reads
    (``lex_pairs_read``: rounded up, as on a card); the CPU's engine, which
    runs the plain version, counts nothing, nor does any engine with
    tracing off."""
    import numpy as np

    from test_torch_compiled import _reads_as_card

    engine = _toy_engine(lexical_format="sparse")
    if as_card:  # the card's route and union width, on the CPU
        _reads_as_card(engine)
        engine._lexical_kernel_route = lambda: True
    batches = _batches(3, 4)
    batches[1] = _reqs(5, " " + " ".join(f"term{i}" for i in range(20)))
    preps = _traced(lambda: [engine.prepare_host(reqs)[0] for reqs in batches])
    counts = recorder.summary()["counts"]
    if not as_card:
        assert "lex_pairs_live" not in counts and "lex_pairs_read" not in counts
        return
    assert counts["lex_pairs_live"] == sum(int(np.count_nonzero(p["lex_weights"]))
                                           for p in preps)
    widths = [eng._union_width(p.union, p["lex_buckets"].shape[0]) for p in preps]
    assert counts["lex_pairs_read"] == sum(len(r) * w for r, w in zip(batches, widths))
    assert 0 < counts["lex_pairs_live"] < counts["lex_pairs_read"]
    recorder.reset()
    for reqs in batches:
        engine.prepare_host(reqs)
    assert recorder.summary()["counts"] == {}


@pytest.mark.parametrize("case", ["card sparse", "cpu", "dense layout", "local gating"])
def test_lexical_kernel_route_is_sparse_dense_gated_on_a_card(case):
    """The route the pair counts follow is lexical_candidates' kernel
    route: the sparse layout under dense gating, on a card (the device is
    named, never used: the method reads no tensor)."""
    from mobius_rag_tpu_torch.ops.proj import PackedProj

    engine = _toy_engine(lexical_format="dense" if case == "dense layout" else "sparse")
    if case != "cpu":
        engine.device = torch.device("cuda")
    if case == "local gating":
        engine._local_gating_active = lambda: True
        engine._ann = object.__new__(PackedProj)
    assert engine._lexical_kernel_route() is (case == "card sparse")
