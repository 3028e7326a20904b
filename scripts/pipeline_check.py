"""Where the time of SearchEngine.search_pipelined goes on one CUDA card,
and how far ahead of the device its host loop should run.

For the 70k exact engine (chip_smoke.py phase 3) and the 1M proj engines
under dense and local gating (phase 4), over 8 distinct batches of 32
hybrid requests: the queue entries of one batch (kernels, memory copies
and sets); queries/s of the sync loop (one `search` per batch) and of
the pipelined loop with the host dispatching every batch before it
fetches any ("all first") or keeping at most 1, 2 or 4 batches in flight
ahead of the one it fetches, in turns, 3 rounds each; and per batch the
host time spent preparing, enqueueing (search_batch, packing, copies),
waiting for a batch's event, and unpacking plus assembling. Every
variant's results are held to one search per batch (ids and scores
bitwise). Then the host's own cost of one batch: prepared and enqueued
while the card sleeps behind a 3 s kernel (no device work to wait for;
where the host takes half the sleep or more, it blocked, and the slowest
aten operator says where), and the aten operators of one batch's enqueue
by host time. Last, the time of a full garbage collection with the 1M
store's records alive. `--toy` runs only the hunt, on small stores, with
probes of the launch queue's depth, of which allocations wait for the
card and of the dense gate's stable sort at 1M rows. Needs one CUDA card.

    python3 scripts/pipeline_check.py            # from the root of a checkout
    python3 scripts/pipeline_check.py --toy      # the wait hunt alone, small
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from mobius_rag_tpu_torch.query import engine as eng  # noqa: E402

K, BATCH, N_BATCHES = 10, 32, 8
AHEAD = (None, 1, 2, 4)  # None: every batch dispatched before any is fetched


class _Timers:
    """Host seconds spent in a few engine methods (wrapped on the instance
    or the class, restored on exit); no synchronisation is added."""

    def __init__(self, engine):
        self.engine, self.total = engine, collections.Counter()

    def _wrap(self, key, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.total[key] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        e = self.engine
        for name, key in (("prepare_host", "prepare"), ("_dispatch", "enqueue"),
                          ("_finish", "unpack"), ("_assemble", "assemble")):
            setattr(e, name, self._wrap(key, getattr(e, name)))
        self._wait = eng.PendingFetch.wait
        eng.PendingFetch.wait = self._wrap("wait", self._wait)
        return self

    def __exit__(self, *exc):
        for name in ("prepare_host", "_dispatch", "_finish", "_assemble"):
            del self.engine.__dict__[name]
        eng.PendingFetch.wait = self._wait


def pipelined(engine, batches, ahead):
    """search_pipelined's loop with at most `ahead` batches in flight
    beyond the one being fetched (None: all dispatched first)."""
    ann = engine.ensure_ann()
    local = engine._ensure_local_structs(ann)
    ready = None
    if engine.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    pending, out = collections.deque(), []

    def fetch_one():
        batch, exps, fetch = pending.popleft()
        res = engine._finish(batch, exps, fetch.wait(), K)
        out.append(engine._assemble(list(batch), exps, res, K))

    for batch in batches:
        q, exps = engine.prepare_host(batch, ready)
        pending.append((batch, exps, engine._dispatch(q, exps, ann, local, K)))
        if ahead is not None and len(pending) > ahead:
            fetch_one()
    while pending:
        fetch_one()
    return out


def launches_per_batch(engine, batch) -> tuple[int, int]:
    """(kernels, memory copies and sets) on the card for one search of
    `batch`: together, the entries the batch puts in the launch queue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.search(batch, k=K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.search(batch, k=K)
        torch.cuda.synchronize()
    dev = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    mem = sum(n.startswith(("Memcpy", "Memset")) for n in dev)
    return len(dev) - mem, mem


class _SlowestOp(TorchDispatchMode):
    """The aten operator that took the longest host time (a blocked launch
    or a wait for the card shows as one long call), its place among the
    operators run, and the port's frames of its Python stack."""

    def __init__(self):
        super().__init__()
        self.n, self.worst = 0, (0.0, None, 0, [])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        t0 = time.perf_counter()
        out = func(*args, **(kwargs or {}))
        dt = time.perf_counter() - t0
        self.n += 1
        if dt > self.worst[0]:
            frames = [f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno} {fr.name}"
                      for fr in traceback.extract_stack()[:-1]
                      if fr.filename.startswith(ROOT)]
            self.worst = (dt, str(func), self.n, frames[-5:])
        return out


def _sleep_cycles_per_ms() -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 100_000_000 / start.elapsed_time(end)


def behind_sleep(name, engine, batches, want, smi, sleep_ms: float = 3000.0,
                 rounds: int = 2) -> None:
    """Every batch prepared and dispatched while the card runs a sleep
    kernel enqueued first, `rounds` times: host ms per batch of prepare
    and enqueue with nothing on the device to wait for. Where the host
    took half the sleep or more, it blocked: the slowest aten operator
    (_SlowestOp) names where. Holds the results to one search per batch."""
    ann = engine.ensure_ann()
    local = engine._ensure_local_structs(ann)
    cycles = int(_sleep_cycles_per_ms() * sleep_ms)
    n = len(batches)
    for rnd in range(rounds):
        torch.cuda.synchronize()
        ready = torch.cuda.Event()
        ready.record()
        torch.cuda._sleep(cycles)
        prep = enq = 0.0
        pending = []
        t0 = time.perf_counter()
        with _SlowestOp() as slow:
            for batch in batches:
                t1 = time.perf_counter()
                q, exps = engine.prepare_host(batch, ready)
                t2 = time.perf_counter()
                pending.append((batch, exps, engine._dispatch(q, exps, ann, local, K)))
                prep += t2 - t1
                enq += time.perf_counter() - t2
        host_ms = (time.perf_counter() - t0) * 1e3
        got = [engine._assemble(list(b), exps, engine._finish(b, exps, fetch.wait(), K), K)
               for b, exps, fetch in pending]
        if [[smoke._hits(r) for r in b] for b in got] != want:
            raise AssertionError(f"{name}: results behind the sleep differ from search per batch")
        line = (f"{name}: round {rnd + 1} behind a {sleep_ms:.0f} ms sleep of the card, "
                f"host ms per batch prepare {prep * 1e3 / n:.2f}, enqueue {enq * 1e3 / n:.2f}; ")
        dt, op, i, frames = slow.worst
        if host_ms < sleep_ms / 2:
            line += f"{n} batches prepared and enqueued in {host_ms:.1f} ms: nothing waited"
        else:
            line += (f"the host blocked: {host_ms:.1f} ms, of which {dt * 1e3:.1f} ms in "
                     f"{op}, aten operator {i} of {slow.n}, at {' <- '.join(reversed(frames))}")
        print(line + f" on {smi}", flush=True)


def enqueue_ops(name, engine, batch, top: int = 8):
    """torch.profiler over one batch's enqueue (host side only): aten
    operators and their host time, the costliest first."""
    from torch.profiler import ProfilerActivity, profile

    ann = engine.ensure_ann()
    local = engine._ensure_local_structs(ann)
    q, exps = engine.prepare_host(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fetch = engine._dispatch(q, exps, ann, local, K)
    fetch.wait()
    ops = [a for a in prof.key_averages() if a.key.startswith("aten::")]
    ranked = sorted(ops, key=lambda a: -a.self_cpu_time_total)[:top]
    print(f"{name}: one enqueue (profiled) calls {sum(a.count for a in ops)} aten operators "
          f"({len(ops)} kinds); by host time: " + ", ".join(
              f"{a.key} {a.count}x {a.self_cpu_time_total / 1e3:.2f} ms" for a in ranked),
          flush=True)


def check(name, engine, batches, smi):
    want = [engine.search(b, k=K) for b in batches]
    key = [[smoke._hits(r) for r in b] for b in want]
    n = sum(len(b) for b in batches)
    kern, mem = launches_per_batch(engine, batches[0])
    print(f"{name}: {kern} kernel launches and {mem} memory copies and sets in one batch "
          f"of {BATCH}", flush=True)
    variants = ["sync"] + [f"ahead {a}" if a else "all first" for a in AHEAD]
    qps = {v: [] for v in variants}
    split = {}
    for rnd in range(3):
        order = variants if rnd % 2 == 0 else variants[::-1]  # in turns
        for v in order:
            torch.cuda.synchronize()
            with _Timers(engine) as tm:
                t0 = time.perf_counter()
                if v == "sync":
                    got = [engine.search(b, k=K) for b in batches]
                else:
                    got = pipelined(engine, batches,
                                    None if v == "all first" else int(v.split()[1]))
                dt = time.perf_counter() - t0
            if [[smoke._hits(r) for r in b] for b in got] != key:
                raise AssertionError(f"{name} {v}: results differ from search per batch")
            qps[v].append(n / dt)
            if v != "sync":
                split[v] = {k: s * 1e3 / len(batches) for k, s in tm.total.items()}
                split[v]["wall"] = dt * 1e3 / len(batches)
    for v in variants:
        line = (f"{name}: {v}: {np.median(qps[v]):.1f} queries/s (rounds "
                f"{[round(x, 1) for x in qps[v]]})")
        if v in split:
            line += "; host ms per batch " + ", ".join(
                f"{k} {x:.2f}" for k, x in split[v].items())
        print(line + f" on {smi}", flush=True)
    behind_sleep(f"{name}, one batch", engine, batches[:1], key[:1], smi)
    enqueue_ops(name, engine, batches[0])


def primitives(smi, sleep_ms: float = 1000.0) -> None:
    """How far the host can run ahead of the card, and which allocations
    wait for it: behind a sleep kernel, how many tiny launches queue
    before one blocks; then, each behind its own sleep, a page-locked host
    buffer of a size not cached yet, the same size again once its block is
    free, and a device buffer of a size not cached yet; and the queue
    entries of the dense gate's stable sort at 1M rows, with one and two
    of them enqueued behind a sleep."""
    cycles = int(_sleep_cycles_per_ms() * sleep_ms)
    cases = [("page-locked host buffer, new size",
              lambda: torch.empty(3 << 20, dtype=torch.uint8, pin_memory=True)),
             ("page-locked host buffer, the same size again",
              lambda: torch.empty(3 << 20, dtype=torch.uint8, pin_memory=True)),
             ("device buffer, new size",
              lambda: torch.empty(1 << 30, dtype=torch.uint8, device="cuda"))]
    x = torch.zeros(1, device="cuda")
    x.add_(1)  # the kernel's module loaded first: a first launch waits for the card
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    for n in range(1, 8193):  # tiny launches queued behind the sleep, until one blocks
        t0 = time.perf_counter()
        x.add_(1)
        if time.perf_counter() - t0 > 0.05:
            break
    blocked = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"primitive: behind a {sleep_ms:.0f} ms sleep the host queued {n - 1} launches; "
          + (f"launch {n} blocked {blocked:.1f} ms" if n < 8192 else "none blocked")
          + f" on {smi}", flush=True)
    # the dense gate's stable sort at 1M rows (topk_stable): its queue entries,
    # and one and two of them behind the sleep
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(BATCH, 1_000_000, device="cuda")
    torch.sort(x, dim=-1, descending=True, stable=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.sort(x, dim=-1, descending=True, stable=True)
        torch.cuda.synchronize()
    entries = sum(ev.device_type == DeviceType.CUDA for ev in prof.events())
    for n_sorts in (1, 2):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        for _ in range(n_sorts):
            torch.sort(x, dim=-1, descending=True, stable=True)
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        print(f"primitive: {n_sorts} stable sort(s) of a [{BATCH}, 1,000,000] float32 matrix "
              f"({entries} queue entries each) enqueued in {ms:.1f} ms behind a "
              f"{sleep_ms:.0f} ms sleep on {smi}", flush=True)
    del x
    for what, alloc in cases:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        buf = alloc()
        ms = (time.perf_counter() - t0) * 1e3
        idle = torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        del buf
        print(f"primitive: {what}: {ms:.1f} ms behind a {sleep_ms:.0f} ms sleep; the card "
              f"{'idle after it (it waited)' if idle else 'still asleep'} on {smi}", flush=True)


def toy(smi) -> None:
    """The wait hunt alone, on the toy corpus (150 padding documents) with
    the exact backend and proj under dense and local gating: the shapes of
    tests/test_torch_pipelined.py's card test, in seconds."""
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.index.store import ChunkStore
    from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus

    primitives(smi)
    lex = sample_lexicon()
    qs = [("timely filing deadline for claims", dict(payer="sunshine_health")),
          ("prior authorization for durable medical equipment", dict(tag_mode="relaxed")),
          ("eligibility verification", dict(payer="molina", state="FL", tag_mode="none")),
          ("provider credentialing requirements", dict(payer="aetna"))]
    reqs = [QueryRequest(query=q, **kw) for q, kw in qs]
    batches = [reqs, reqs[:2], reqs[1:]] * 2
    for name, fields in (("toy exact", {}),
                         ("toy proj dense", dict(vector_backend="proj", gating="dense")),
                         ("toy proj local", dict(vector_backend="proj", gating="local"))):
        cfg = dataclasses.replace(get_config(), lexical_format="sparse", ivf_nlist=8,
                                  ivf_nprobe=8, proj_p=64, **fields)
        store = ChunkStore(cfg, device="cuda")
        store.add_chunks(toy_corpus(lex, pad_docs=150))
        engine = SearchEngine(store, lex, cfg=cfg, embed_fn=hash_embed, device="cuda")
        want = [[smoke._hits(r) for r in engine.search(b, k=K)] for b in batches]
        print(f"{name}: (kernels, memory copies and sets) "
              f"{launches_per_batch(engine, batches[0])} in a batch of {len(batches[0])}, "
              f"{launches_per_batch(engine, batches[1])} in one of {len(batches[1])}",
              flush=True)
        behind_sleep(name, engine, batches, want, smi)
        behind_sleep(f"{name}, one batch", engine, batches[:1], want[:1], smi)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _, smi = smoke.phase0_device()
    smoke.phase1_build()
    if "--toy" in sys.argv[1:]:
        return toy(smi)
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

    cfg = get_config()
    store, lexicon, vectors, rng, payers = smoke.build_bench_store(cfg)
    q = vectors[rng.choice(len(vectors), 64, replace=False)]
    q = q + 0.15 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    batches = [[QueryRequest(query=f"timely filing deadline for {payers[(j * 7 + i) % 3]} "
                                   "claims", embedding=q[(j * 7 + i) % 64])
                for i in range(BATCH)] for j in range(N_BATCHES)]
    check("70k exact", SearchEngine(store, lexicon, cfg=cfg, device="cuda"), batches, smi)
    del store
    torch.cuda.empty_cache()

    base = dataclasses.replace(
        cfg, vector_dtype="bfloat16", lexical_format="sparse", vector_backend="proj",
        proj_p=256, ivf_nlist=0, ivf_nprobe=64, ann_reserve_slabs=2, over_fetch=4)
    store, lexicon, vectors = smoke.build_1m_store(base, {}, "cuda", smoke.N_1M)
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randperm(smoke.N_1M, device="cuda", generator=g)[:64]
    qv = vectors[rows].float() + 0.15 * torch.randn((64, base.embed_dim), device="cuda",
                                                     generator=g)
    qv = (qv / qv.norm(dim=1, keepdim=True)).cpu().numpy()
    hyb = smoke._HYBRID_1M
    batches = [[QueryRequest(query=hyb[(j * 7 + i) % len(hyb)][0],
                             payer=hyb[(j * 7 + i) % len(hyb)][1], embedding=qv[(j * 7 + i) % 64])
                for i in range(BATCH)] for j in range(N_BATCHES)]
    engine_a = SearchEngine(store, lexicon, cfg=dataclasses.replace(base, gating="dense"),
                            device="cuda")
    engine_b = SearchEngine(store, lexicon, cfg=dataclasses.replace(base, gating="local"),
                            device="cuda")
    engine_a.ensure_ann()
    with tempfile.TemporaryDirectory() as tmp:
        engine_a.save_ann(f"{tmp}/ann.npz")
        engine_b.load_ann(f"{tmp}/ann.npz")
    check("1M proj path A", engine_a, batches, smi)
    check("1M proj path B", engine_b, batches, smi)
    for _ in range(2):
        t0 = time.perf_counter()
        n = gc.collect()
        print(f"a full garbage collection with the 1M store alive: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({n} unreachable)", flush=True)
    gc.freeze()
    t0 = time.perf_counter()
    gc.collect()
    print(f"after gc.freeze(): {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
