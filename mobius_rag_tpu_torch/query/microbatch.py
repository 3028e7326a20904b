"""Adaptive micro-batching for the served query path (the port of
``mobius_rag_tpu.query.microbatch``).

The reference serves strictly one query per request — each POST runs
its own SQL scans (corpus_search.py:3280), so concurrency is capacity
division. Here the hybrid search is *batched* by design, so the server
can fold concurrent batch-of-1 arrivals into ONE engine call: while a
batch is in flight on the device, new arrivals accumulate; when it
completes, the accumulated set launches as the next batch (continuous
batching). At low load a request launches immediately (no imposed
window); at high load batch size grows toward the service time ×
arrival rate, and throughput approaches the pipelined engine's instead
of the sync-per-query floor.

Batch shapes pad up to the JAX package's bucket ladder (padding
replicates the last request; padded results are dropped), so both
packages hand their engines the same batch sizes.

Engine calls run in a single worker thread: the engine's device
dispatch is not re-entrant by contract (one serving stream), and the
waits that dominate wall time (a CUDA event, a device-to-host copy)
release the GIL, so the event loop stays live while a batch executes.

``stats`` counts batches, queries, the largest batch, requests shed, and
the queue wait: each request's time from its arrival to its batch's
hand-off to the engine (``queue_wait_ms_sum``, ``queue_wait_count``,
``queue_wait_ms_max``), served by ``GET /admin/microbatch``.
"""
from __future__ import annotations

import asyncio
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchResult

_BUCKETS = (1, 2, 4, 8, 16, 32)


class OverloadedError(RuntimeError):
    """Queue depth exceeded — the server should shed with a 503 rather
    than let latency and memory grow without bound (round-4 advisor
    finding: an unbounded queue under sustained overload accumulates
    futures forever; predictable degradation beats silent pile-up)."""


class MicroBatcher:
    """Fold concurrent single-query arrivals into batched engine calls.

    ``search_one`` is the awaitable the HTTP handlers use; it resolves
    with that caller's SearchResult. All queued requests run with the
    max requested k of their batch and are cut back per caller.

    Input validation is the CALLER's job (the HTTP handler): the engine
    raises per-batch, so a malformed co-batched request would fail its
    neighbors. The batcher itself only bounds the queue.
    """

    def __init__(self, engine, *, max_batch: int | None = None,
                 max_queue: int | None = None):
        self.engine = engine
        self.max_batch = max_batch or int(
            os.getenv("MRAG_MICROBATCH_MAX", "32"))
        # shed threshold: beyond this many waiting requests, reject —
        # default 16 full batches of headroom
        self.max_queue = max_queue or int(
            os.getenv("MRAG_MICROBATCH_MAX_QUEUE", str(self.max_batch * 16)))
        # (request, k, future, arrival ns on time.time_ns's clock)
        self._queue: list[tuple[QueryRequest, int, asyncio.Future, int]] = []
        self._running = False
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mrag-microbatch")
        self.stats = {"batches": 0, "queries": 0, "max_batch_seen": 0,
                      "shed": 0, "queue_wait_ms_sum": 0.0, "queue_wait_count": 0,
                      "queue_wait_ms_max": 0.0}

    async def search_one(self, req: QueryRequest, k: int) -> SearchResult:
        if len(self._queue) >= self.max_queue:
            self.stats["shed"] += 1
            raise OverloadedError(
                f"query queue full ({self.max_queue} waiting); retry later")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._queue.append((req, int(k), fut, time.time_ns()))
        if not self._running:
            self._running = True
            asyncio.ensure_future(self._drain(loop))
        return await fut

    @staticmethod
    def _bucket(n: int) -> int:
        for b in _BUCKETS:
            if n <= b:
                return b
        return _BUCKETS[-1]

    # Queue depth beyond one full batch drains through the engine's
    # PIPELINED path: up to this many same-tick batches dispatch
    # before any fetch, so host fetch/assembly of batch N overlaps the
    # device executing batch N+1. The sync-per-batch loop was the 1M
    # served ceiling (~24 qps achieved at 100 offered while the
    # pipelined engine measured ~600 qps on the same corpus —
    # BENCH_r5_served_latency_1000k.json).
    PIPELINE_DEPTH = 4

    async def _drain(self, loop) -> None:
        try:
            while self._queue:
                groups: list[list[tuple]] = []
                while self._queue and len(groups) < self.PIPELINE_DEPTH:
                    items = self._queue[: self.max_batch]
                    del self._queue[: len(items)]
                    groups.append(items)
                k = max(it[1] for g in groups for it in g)
                padded_groups: list[Sequence[QueryRequest]] = []
                for items in groups:
                    reqs = [it[0] for it in items]
                    pad = self._bucket(len(reqs))
                    padded_groups.append(
                        list(reqs) + [reqs[-1]] * (pad - len(reqs)))
                self._handed_off(groups)
                try:
                    if len(padded_groups) == 1:
                        results_groups = [await loop.run_in_executor(
                            self._pool,
                            lambda: self.engine.search(padded_groups[0], k=k))]
                    else:
                        results_groups = await loop.run_in_executor(
                            self._pool,
                            lambda: self.engine.search_pipelined(
                                padded_groups, k=k))
                except Exception as e:
                    for items in groups:
                        for _, _, fut, _ in items:
                            if not fut.done():
                                fut.set_exception(_clone_exc(e))
                    continue
                for items, results in zip(groups, results_groups):
                    self.stats["batches"] += 1
                    self.stats["queries"] += len(items)
                    self.stats["max_batch_seen"] = max(
                        self.stats["max_batch_seen"], len(items))
                    for (req, want_k, fut, _), res in zip(items, results):
                        if fut.done():
                            continue
                        if want_k < len(res.hits):
                            res.hits = res.hits[:want_k]
                        fut.set_result(res)
        finally:
            self._running = False
            # arrivals during the last executor hop can race the flag
            if self._queue:
                self._running = True
                asyncio.ensure_future(self._drain(loop))

    def _handed_off(self, groups: list[list[tuple]]) -> None:
        """The queue waits of `groups`, handed to the engine now, each
        request's into ``stats``."""
        now = time.time_ns()
        st = self.stats
        for items in groups:
            waits = [(now - it[3]) / 1e6 for it in items]
            st["queue_wait_ms_sum"] += sum(waits)
            st["queue_wait_count"] += len(waits)
            st["queue_wait_ms_max"] = max(st["queue_wait_ms_max"], *waits)


def _clone_exc(e: Exception) -> Exception:
    # each Future needs its own exception instance (tracebacks attach)
    try:
        return type(e)(*e.args)
    except Exception:
        return RuntimeError(str(e))


def microbatch_enabled() -> bool:
    """Default ON; MRAG_MICROBATCH=0 opts out (per-request sync path)."""
    return os.getenv("MRAG_MICROBATCH", "1").strip().lower() not in (
        "0", "false", "no", "off")


def make_batcher(engine) -> Any:
    return MicroBatcher(engine) if microbatch_enabled() else None
