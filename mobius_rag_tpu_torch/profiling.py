"""Per-stage device timing of the search pipeline (the port of
``mobius_rag_tpu.profiling``).

The serving telemetry records host-side prepare / device / assemble
times; the stages inside the device program are where the time goes once
host prep is fast. Two tools:

- :func:`profile_engine`: each stage of one prepared batch run eagerly as
  a growing prefix of the program (the filter masks; masks, gate and one
  arm; all arms with their signals; the whole program), timed with CUDA
  events on a card (host clock and a synchronize on the CPU), medians of
  ``iters`` runs after one warm-up. The stage differences give the
  signals' and the fusion's cost. Eager PyTorch runs every stage
  separately, so the parts run as they run inside the whole program; the
  overlap left is that the prefixes repeat the masks and the gate. The
  result is recorded as a ``profile`` search event when the engine has a
  telemetry store.
- :func:`capture_trace`: ``torch.profiler`` around N searches, exported as
  a Chrome trace (Perfetto) under ``data_dir/profiles/``.

The profiler starts and stops under ``compiled.LOCK`` (:func:`locked_profiler`):
its stop synchronizes the device, which would break a CUDA graph that
another thread (the micro-batcher's, the ingest worker's) is capturing.

Served at ``POST /admin/profile`` (api/extended.py).
"""
from __future__ import annotations

import contextlib
import os
import time
import uuid
from typing import Any, Iterator, Sequence

import torch

from mobius_rag_tpu_torch.observability import RECORDER
from mobius_rag_tpu_torch.ops.topk import masked_topk, topk_stable
from mobius_rag_tpu_torch.query import compiled
from mobius_rag_tpu_torch.query import engine as eng


@contextlib.contextmanager
def locked_profiler(activities) -> Iterator[torch.profiler.profile]:
    """``torch.profiler.profile`` over the block, its start and its stop
    each under ``compiled.LOCK``: both may synchronize the device, and a
    device-wide synchronize breaks a capture open on another thread. The
    lock is not held inside the block (a search takes it itself). The
    recorder's spans still open (``query.starved``) end at the stop."""
    prof = torch.profiler.profile(activities=activities)
    with compiled.LOCK:
        prof.start()
    try:
        yield prof
    finally:
        with compiled.LOCK:
            RECORDER.end_session()
            prof.stop()


def _timed(fn, device: torch.device, iters: int = 5) -> float:
    """Median ms of fn() on `device` after one warm call: CUDA events
    around the call on a card, the host clock and a synchronize
    elsewhere."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


@torch.inference_mode()
def _arm_prefix(index, q: dict, k: int, m: int, which: str):
    """The program's prefix up to stage `which`: filters | vector |
    lexical | dtag | arms (all three with their signals)."""
    q = dict(q, vec=q["vec"].float())
    if which == "arms":
        return eng.arm_candidates(index, q, k, m)
    strict, relaxed, open_mask, meta_ok = eng.filter_masks(index, q)
    if which == "filters":
        return strict, relaxed, open_mask, meta_ok
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k,
                               strict.sum(dim=1, keepdim=True))
    if which == "vector":
        scales = index.vec_scales if index.vectors.dtype == torch.int8 else None
        return masked_topk(q["vec"], index.vectors, penalty, q["min_sim"], m,
                           row_scales=scales)
    if which == "lexical":
        return eng.lexical_candidates(index, q, penalty, m)[:2]
    return topk_stable(eng.dtag_raw(index, q, meta_ok), m)


def profile_engine(engine, reqs: Sequence, k: int | None = None,
                   iters: int = 5) -> dict[str, Any]:
    """Stage timings for one query batch through the engine's one-device
    program: ms medians per stage, the host prepare and assemble costs,
    and a ``profile`` search event when the engine has a telemetry store.
    The per-arm prefixes exist for the exact backend only."""
    cfg = engine.cfg
    k = k or cfg.default_k
    if engine.sharded is not None:
        raise ValueError("profile_engine runs the one-device pipeline; "
                         "detach the sharded engine to profile per stage")
    ann = engine.ensure_ann()
    device = engine.device

    t0 = time.perf_counter()
    host, exps = engine.prepare_host(reqs)
    q = engine._device_batch(host)  # the union columns the served program reads
    prepare_ms = (time.perf_counter() - t0) * 1e3

    index = engine.store.index
    c = int(index.valid.shape[0])
    m = min(k * cfg.over_fetch, c)

    stages: dict[str, float] = {}
    if ann is None:
        for which in ("filters", "vector", "lexical", "dtag", "arms"):
            stages[which] = _timed(lambda w=which: _arm_prefix(index, q, k, m, w),
                                   device, iters)

    def full():
        return eng.search_batch(index, q, k, cfg.over_fetch, cfg.rrf_k, ann=ann,
                                nprobe=cfg.ivf_nprobe)

    stages["full_pipeline"] = _timed(full, device, iters)
    out = eng.unpack_out(eng.pack_out(full()), k)
    t0 = time.perf_counter()
    engine._assemble(list(reqs), exps, out, k)
    assemble_ms = (time.perf_counter() - t0) * 1e3

    derived = {}
    if "arms" in stages:
        derived = {
            "signals_ms": max(0.0, stages["arms"] - max(stages["vector"], stages["lexical"],
                                                        stages["dtag"])),
            "fusion_rerank_ms": max(0.0, stages["full_pipeline"] - stages["arms"]),
        }
    profile = {
        "profile_id": uuid.uuid4().hex[:12],
        "batch": len(reqs),
        "k": k,
        "corpus_rows": c,
        "backend": engine.vector_backend,
        "host_prepare_ms": round(prepare_ms, 3),
        "host_assemble_ms": round(assemble_ms, 3),
        "device_stages_ms": {s: round(v, 3) for s, v in stages.items()},
        **{key: round(v, 3) for key, v in derived.items()},
        "iters": iters,
        "note": ("each stage is a prefix of the eagerly run program (every prefix "
                 "repeats the filter masks and the gate), so the parts do not "
                 "sum to the whole"),
    }
    if engine.telemetry is not None:
        engine.telemetry.record_search_event(
            query=f"[profile {profile['profile_id']}]", mode="profile",
            timings={"prepare": prepare_ms, "assemble": assemble_ms,
                     **{f"dev_{s}": v for s, v in stages.items()}},
            arms={}, expansion=[], results=[],
            extra={"profile": profile},
        )
    return profile


def capture_trace(engine, reqs: Sequence, k: int | None = None,
                  n_batches: int = 4, logdir: str | None = None) -> dict:
    """``torch.profiler`` around `n_batches` searches of `reqs` (one warm-up
    search first, outside the trace), exported as a Chrome trace
    ``trace.json`` under `logdir` (default ``data_dir/profiles/<time>``).
    Returns {"ok", "trace_dir", "trace_file", "batches"}, or the failure
    with "ok" false."""
    from mobius_rag_tpu_torch.config import get_config

    k = k or engine.cfg.default_k
    logdir = logdir or os.path.join(get_config().data_dir, "profiles",
                                    time.strftime("%Y%m%d-%H%M%S"))
    engine.search(list(reqs), k=k)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(logdir, "trace.json")
    try:
        os.makedirs(logdir, exist_ok=True)
        with locked_profiler(activities) as prof:
            for _ in range(n_batches):
                engine.search(list(reqs), k=k)
        prof.export_chrome_trace(path)
        return {"ok": True, "trace_dir": logdir, "trace_file": path, "batches": n_batches}
    except (RuntimeError, OSError) as e:
        return {"ok": False, "error": str(e), "trace_dir": logdir}
