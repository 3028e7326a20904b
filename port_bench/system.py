"""Everything the benchmark does through the system under test,
``mobius_rag_tpu_torch``: its configuration, the store and engine built
from a corpus, warm-up, the two window loops (a closed-loop backlog
through ``SearchEngine.search_pipelined`` and an open loop of single
requests through ``MicroBatcher.search_one``) and the answers read back.
Nothing else in the benchmark imports the system."""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import corpus

def make_config(env: dict):
    """The system's Config under the configuration's settings (its
    ``env``): they go into the environment (read there by modules that
    read them at call time), and the config module is evaluated once more
    under them, so an earlier import of it does not decide. The host
    threads torch runs on (OMP_NUM_THREADS) are set from them too."""
    os.environ.update({k: str(v) for k, v in env.items()})
    from mobius_rag_tpu_torch import config as sys_config

    spec = importlib.util.spec_from_file_location("port_bench_sys_config", sys_config.__file__)
    fresh = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = fresh  # dataclasses look their module up
    try:
        spec.loader.exec_module(fresh)
    finally:
        del sys.modules[spec.name]
    cfg = sys_config.Config(**dataclasses.asdict(fresh.Config()))
    cfg.assert_valid()
    if "OMP_NUM_THREADS" in env:
        # torch reads the variable when it starts, and this process has
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    return cfg


class System:
    """The store and engine of one configuration on one device."""

    def __init__(self, cfg: dict, lexicon_path: str, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.sys_cfg = make_config(cfg["env"])
        self.lexicon_path = lexicon_path
        self.engine = None
        self.ann = None
        self.k = 10  # results a request asks for (the traffic mix's k)

    def build(self, rows: torch.Tensor, stages: dict) -> None:
        """Records from the corpus rules (every `featurize_every`-th
        featurized through the system's ingest), the store bulk-loaded with
        `rows`, the engine, and the ANN tables where the backend has them;
        the seconds of each into `stages`."""
        from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
        from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
        from mobius_rag_tpu_torch.query.engine import SearchEngine
        from mobius_rag_tpu_torch.query.lexicon import Lexicon

        spec = self.cfg["corpus"]
        t0 = time.perf_counter()
        lexicon = Lexicon.from_json(self.lexicon_path)
        empty = np.zeros(0, np.float32)  # the rows come as one device tensor
        recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=corpus.doc(spec, i), source_id=f"s{i}",
                            text=corpus.text(spec, i), embedding=empty,
                            payer=corpus.payer(spec, i), state=spec["state"],
                            authority_level=corpus.authority_level(spec, i),
                            d_tags=[corpus.dtag(spec, i)])
                for i in range(spec["rows"])]
        for r in recs[::spec["featurize_every"]]:
            featurize_chunk(r, lexicon, self.sys_cfg)
        stages["records"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = ChunkStore(self.sys_cfg, capacity=spec["rows"], device=self.device)
        store.bulk_load(recs, vectors=rows)
        self.sync()
        stages["bulk_load"] = time.perf_counter() - t0
        self.engine = SearchEngine(store, lexicon, cfg=self.sys_cfg, device=self.device)
        t0 = time.perf_counter()
        self.ann = self.engine.ensure_ann()
        self.sync()
        stages["ann_build"] = time.perf_counter() - t0

    def sync(self) -> None:
        """Wait for the card, under the lock that captures hold (a
        device-wide synchronize breaks a capture on another thread)."""
        if self.device.type == "cuda":
            from mobius_rag_tpu_torch.query.compiled import LOCK

            with LOCK:
                torch.cuda.synchronize(self.device)

    def requests(self, specs: list[dict], vecs: np.ndarray) -> list:
        from mobius_rag_tpu_torch.query.engine import QueryRequest

        return [QueryRequest(query=s["text"], embedding=vecs[s["vec"]], mode=s["mode"],
                             payer=s["payer"], tag_mode=s["tag_mode"]) for s in specs]

    def buckets(self, req) -> set:
        """The lexical buckets of one request, as the engine prepares it."""
        return set(self.engine.prepare_query(req)[2])

    def read_width(self, batch: list) -> int:
        """The lexical union columns the engine's device program reads for
        `batch` (part of a captured program's key): the engine's own
        rounding where it has one, else the live union."""
        host = self.engine.prepare_host(batch)[0]
        width = getattr(self.engine, "_union_read", None)
        return width(host) if width is not None else host.union

    def warm(self, batches: list[list]) -> int:
        """One search of each distinct (batch size, union width read) among
        `batches`, so that every program the window replays is captured
        before it. Returns the searches run."""
        seen = set()
        for batch in batches:
            key = (len(batch), self.read_width(batch))
            if key not in seen:
                seen.add(key)
                self.engine.search(batch, k=self.k)
        self.sync()
        return len(seen)

    def freeze(self) -> None:
        """Freeze the store's objects out of the collector, as a server
        does once loaded: one full collection over a million records takes
        seconds, and one inside the window stalls every request."""
        gc.collect()
        gc.freeze()

    def lock(self):
        """The system's capture lock (held to start or stop a profiler
        while captures may run on another thread)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        from mobius_rag_tpu_torch.query.compiled import LOCK

        return LOCK

    @contextlib.contextmanager
    def spans(self):
        """Benchmark spans (``torch.profiler.record_function``, named
        "bench:<call>") around the engine's calls into its layers, for a
        traced run: its host preparation, dispatch, fetch and assembly of
        a batch, and the searches themselves. A call the engine lacks is
        left alone."""
        eng = self.engine
        names = ("search", "search_pipelined", "prepare_host", "_dispatch", "_finish",
                 "_assemble")
        saved = {n: getattr(eng, n) for n in names if hasattr(eng, n)}

        def wrap(name, fn):
            def call(*a, **kw):
                with record_function(f"bench:{name.lstrip('_')}"):
                    return fn(*a, **kw)
            return call

        for n, fn in saved.items():
            setattr(eng, n, wrap(n, fn))
        try:
            yield
        finally:
            for n in saved:
                delattr(eng, n)

    def counters(self) -> dict:
        """The captured programs' replays and captures so far (0 on the
        CPU, which runs the program eagerly)."""
        if not self.engine.graphs:
            return {"replays": 0, "captures": 0}
        p = self.engine.programs
        return {"replays": p.replays, "captures": p.captures}

    def release(self) -> None:
        gc.unfreeze()
        self.engine = self.ann = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def answer_of(res) -> dict:
    """What the comparison reads of a SearchResult: the hits (row, rerank
    score), each arm's listed (row, value), the strict count."""
    arms = res.telemetry["arms"]
    return {"hits": [(h.row, h.score) for h in res.hits],
            "arms": [[(a["row"], a["score"]) for a in arms[name]]
                     for name in ("vector", "lexical", "dtag")],
            "strict": int(res.telemetry["strict_count"])}


class Reservoir:
    """A seeded uniform sample of `size` of a stream of items."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.default_rng([int(seed), 6])

    def offer(self, make) -> None:
        """Count one item; `make()` builds it only when it is kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = make()


def backlog_window(system: System, reqs: list, batches: list[list[int]], depth: int,
                   seconds: float, sample: Reservoir, on_group=None) -> dict:
    """The closed loop: `depth` batches at a time through search_pipelined,
    cycling over `batches` (pool indices), until `seconds` have passed;
    every answer offered to `sample` as (pool index, answer)."""
    groups = itertools.cycle([batches[i:i + depth]
                              for i in range(0, len(batches) - depth + 1, depth)])
    engine = system.engine
    before = system.counters()
    n_q = n_b = 0
    t0 = time.perf_counter()
    while True:
        group = next(groups)
        results = engine.search_pipelined([[reqs[i] for i in b] for b in group],
                                          k=system.k)
        with record_function("bench:sample"):
            for b, res_b in zip(group, results):
                for i, res in zip(b, res_b):
                    sample.offer(lambda i=i, res=res: (i, answer_of(res)))
                n_q += len(b)
        n_b += len(group)
        if on_group is not None:
            on_group()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    after = system.counters()
    return {"window_s": elapsed, "queries": n_q, "batches": n_b, "failed": 0,
            "replays": after["replays"] - before["replays"],
            "captures": after["captures"] - before["captures"]}


def served_window(system: System, reqs: list, due: np.ndarray, picks: np.ndarray,
                  warmup_s: float, seconds: float, keep: set, drain_s: float = 60.0) -> dict:
    """The open loop: request n (pool index picks[n]) handed to one
    MicroBatcher at its due time due[n] (s from the start), from one
    asyncio loop. Latency counts from the due time. Requests due in
    [warmup_s, warmup_s + seconds) are the window's; those in `keep` (by
    arrival) have their answers kept."""
    from mobius_rag_tpu_torch.query.microbatch import MicroBatcher, OverloadedError

    batcher = MicroBatcher(system.engine)
    before = system.counters()
    n = len(due)
    done = np.full(n, np.nan)
    shed = np.zeros(n, bool)
    late = np.zeros(n)
    answers: dict[int, tuple] = {}
    marks: dict[str, dict] = {}

    async def one(i: int, t0: float, loop) -> None:
        try:
            res = await batcher.search_one(reqs[picks[i]], system.k)
        except OverloadedError:
            shed[i] = True
            return
        done[i] = loop.time() - t0
        if i in keep:
            answers[i] = (int(picks[i]), answer_of(res))

    async def offer() -> float:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        marks["t0"] = {"perf": time.perf_counter(), "ns": time.time_ns()}
        # in flight only: a finished task is let go, so the collector's
        # work does not grow over the run
        pending: set = set()
        i = 0
        while i < n:
            now = loop.time() - t0
            while i < n and due[i] <= now:
                if "start" not in marks and due[i] >= warmup_s:
                    marks["start"] = dict(batcher.stats)
                late[i] = now - due[i]
                task = asyncio.ensure_future(one(i, t0, loop))
                pending.add(task)
                task.add_done_callback(pending.discard)
                i += 1
            if i < n:
                await asyncio.sleep(max(0.0, due[i] - (loop.time() - t0)))
        if pending:
            await asyncio.wait(set(pending), timeout=drain_s + seconds)
        marks["end"] = dict(batcher.stats)
        return loop.time() - t0

    try:
        total = asyncio.run(offer())
    finally:
        batcher._pool.shutdown(wait=True)
    win = (due >= warmup_s) & (due < warmup_s + seconds)
    lat = (done - due)[win] * 1e3
    failed = int(np.isnan(lat).sum())
    # an answer that never came waits at least until the run's end
    lat = np.where(np.isnan(lat), (total - due[win]) * 1e3, lat)
    start, end = marks.get("start", batcher.stats), marks["end"]
    after = system.counters()
    kept = np.zeros(n, bool)
    kept[list(keep)] = True
    return {"latency_ms": lat, "failed": failed, "attempted": int(win.sum()),
            "unanswered_kept": int((kept & np.isnan(done) & ~shed).sum()),
            "start_perf": marks["t0"]["perf"], "start_ns": marks["t0"]["ns"],
            "late_ms": late[win] * 1e3, "answers": answers, "run_s": total,
            "batches": end["batches"] - start["batches"],
            "queries": end["queries"] - start["queries"],
            "shed": end["shed"] - start["shed"], "max_batch": batcher.max_batch,
            "replays": after["replays"] - before["replays"],
            "captures": after["captures"] - before["captures"]}
