"""Checks of the port's spans and device stage marks on one CUDA card, on a
benchmark cell's system (``port_bench``: its configuration, its corpus
from the seed, its warm-up) at the cell's size:

1. clock: every span of the recorder's ring against its ``mrag:`` twin on
   ``torch.profiler``'s timeline, over two drains of the backlog
   (``search_pipelined``): the largest distance of their starts and of
   their ends, in microseconds;
2. marks: the five stage times of the device program read from the
   timing events inside its captured graph, against the same stages run
   eagerly: timed by the same marks behind a sleeping kernel (the device
   busy ahead of the host), and as the device's busy time (the union of
   the kernels, copies and fills each stage launched, from a profiler
   trace in which the marks open a host range a stage); medians over the
   batches, and their ratios; the stages' sum against the whole replay
   (events around it);
3. cost: the device time of a replay of the graph with its six
   event-record nodes against a graph of the same program captured
   without them, in turns on the same batch;
4. starved: one ``profiling.capture_trace`` Chrome trace (sync searches of
   one batch), its device idle gaps over 1 ms between its first and last
   device event, and the share of each gap under ``mrag:query.starved``;
   and the split of the starved time by its child spans;
5. segments: the same program captured instead as five consecutive graphs
   of one pool, cut where the one graph records its first four marks, and
   replayed in order with a timing event after each: each stage's time
   against the one graph's marks on the same batches, with the device busy
   ahead (behind a sleeping kernel, so no launch gap shows), and the whole
   program's time on an idle device, one graph against five (what the
   four extra launches cost).

    python3 scripts/trace_check.py exact1m.backlog proj1m.backlog

Prints one JSON line a cell (the card's name and power limit first);
the traces it reads are written under the checkout's ``.bench_cache/``
and removed. Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mobius_rag_tpu_torch import observability as obs  # noqa: E402
from mobius_rag_tpu_torch import profiling  # noqa: E402
from mobius_rag_tpu_torch.query.compiled import LOCK, CapturedPrograms  # noqa: E402
from port_bench import run, spec, traffic  # noqa: E402

SEED = 2_900_000_017
BATCHES = 16  # distinct batches of the backlog's size
SLEEP_CYCLES = 1_200_000_000  # ~0.6 s at the H100's clock: longer than an eager enqueue
TURNS = 20
WORK = os.path.join(ROOT, ".bench_cache", "trace_check")


def build(cell_name: str):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    cfg_path = spec.config_path(bench, cell["config"])
    cfg = spec.load_json(cfg_path)
    mix = spec.load_json(spec.mix_path(cell["traffic"]))
    lexicon = os.path.join(os.path.dirname(cfg_path), cfg["lexicon"])
    sysm, specs, _, reqs = run.set_up(cfg, mix, lexicon, SEED, "cuda", {})
    batches = traffic.backlog_batches(mix, len(specs))[:BATCHES]
    return sysm, mix, [[reqs[i] for i in b] for b in batches]


def clock(sysm, mix, batches) -> dict:
    from torch.autograd import DeviceType

    obs.RECORDER.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiling.locked_profiler(acts) as prof:
        for lo in range(0, 2 * mix["depth"], mix["depth"]):
            sysm.engine.search_pipelined(batches[lo:lo + mix["depth"]], k=mix["k"])
        sysm.sync()
    twins: dict[str, list] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("mrag:") and ev.device_type() == DeviceType.CPU:
            twins.setdefault(ev.name()[5:], []).append((ev.start_ns(), ev.end_ns()))
    d_start, d_end, unmatched = [], [], 0
    for rec in obs.RECORDER.records():
        cands = twins.get(rec.name, [])
        if not cands:
            unmatched += 1
            continue
        s, e = min(cands, key=lambda se: abs(se[0] - rec.start))
        d_start.append(abs(s - rec.start) / 1e3)
        d_end.append(abs(e - rec.end) / 1e3)
    return {"spans": len(obs.RECORDER.records()), "matched": len(d_start), "unmatched": unmatched,
            "max_start_us": max(d_start), "max_end_us": max(d_end),
            "over_100us": sum(max(a, b) > 100.0 for a, b in zip(d_start, d_end)),
            "p50_start_us": statistics.median(d_start), "p50_end_us": statistics.median(d_end)}


def _program(sysm, batch, k, eager: bool, sleep: bool | None = None):
    """One batch's device program through the engine's dispatch path (no
    fetch): its packed outputs (and marks), the host's enqueue ms, and
    the device ms between events around it. `sleep` (default: `eager`)
    puts a sleeping kernel ahead of it."""
    engine = sysm.engine
    ann, local = engine._tables()
    q, exps = engine.prepare_host(batch)
    before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if eager if sleep is None else sleep:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    with LOCK:
        before.record()
        out = engine._packed(q, exps, ann, local, k)
        after.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return out, host_ms, before.elapsed_time(after)


def marks(sysm, mix, batches) -> dict:
    engine, k = sysm.engine, mix["k"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    graph, eager, whole, host = [], [], [], []
    for b in batches:
        _program(sysm, b, k, eager=False)  # captures a key the warm-up missed
        out, _, ms = _program(sysm, b, k, eager=False)
        graph.append(out.marks.elapsed_ms())
        whole.append(ms)
    engine.graphs = False
    try:
        syncs = []
        ann, local = engine._tables()
        q, exps = engine.prepare_host(batches[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with LOCK:
                engine._packed(q, exps, ann, local, k)
        except RuntimeError:  # the eager program read a device value back
            syncs = traceback.format_exc().splitlines()[-12:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for b in batches:
            _program(sysm, b, k, eager=True)
            out, host_ms, _ = _program(sysm, b, k, eager=True)
            eager.append(out.marks.elapsed_ms())
            host.append(host_ms)
    finally:
        engine.graphs = True
    busy = eager_busy(sysm, mix, batches)
    res = {"batches": len(batches), "eager_enqueue_ms_max": max(host),
           "eager_enqueue_ms_p50": statistics.median(host),
           "eager_sync": syncs,
           "sleep_ms": start.elapsed_time(end), "stages": {}}
    for stage in obs.STAGES:
        g = statistics.median(m[stage] for m in graph)
        e = statistics.median(m[stage] for m in eager)
        b = statistics.median(m[stage] for m in busy)
        res["stages"][stage] = {"graph_ms": g, "eager_ms": e, "ratio": g / e,
                                "eager_busy_ms": b, "ratio_busy": g / b}
    sums = [sum(m.values()) for m in graph]
    res["graph_sum_ms"] = statistics.median(sums)
    res["replay_ms"] = statistics.median(whole)
    res["sum_over_replay"] = statistics.median(s / w for s, w in zip(sums, whole))
    return res


def eager_busy(sysm, mix, batches) -> list[dict]:
    """Each batch's eager program, its device busy ms by stage: the union
    of the kernels, copies and fills launched inside each stage's host
    range ("stage:<name>", opened at the mark before it)."""
    engine, k = sysm.engine, mix["k"]
    order = ("start", *obs.STAGES)
    mark, open_range = obs.StageMarks.mark, {}

    def ranged(self, stage):
        mark(self, stage)
        rf = open_range.pop("rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)
        nxt = order.index(stage) + 1
        if nxt < len(order):
            open_range["rf"] = torch.autograd.profiler.record_function(f"stage:{order[nxt]}")
            open_range["rf"].__enter__()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    engine.graphs = False
    obs.StageMarks.mark = ranged
    try:
        with profiling.locked_profiler(acts) as prof:
            for b in batches:
                _program(sysm, b, k, eager=False)
    finally:
        obs.StageMarks.mark = mark
        engine.graphs = True
    path = os.path.join(WORK, "eager.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("stage:"))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    per_range: dict[int, list] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            t = launched.get(e["args"].get("correlation"))
            for i, (s, end, _) in enumerate(ranges):
                if t is not None and s <= t <= end:
                    per_range.setdefault(i, []).append((e["ts"], e["ts"] + e["dur"]))
                    break
    out: list[dict] = []
    for i, (_, _, stage) in enumerate(ranges):
        if stage == obs.STAGES[0]:
            out.append({})
        busy = sum(e - s for s, e in _union(per_range.get(i, [])))
        out[-1][stage] = busy / 1e3
    return out


def cost(sysm, mix, batch) -> dict:
    """A replay's device ms with its marks against without them: the
    batch's program captured twice, each graph alone in a new pool."""
    engine, k = sysm.engine, mix["k"]
    served, fresh = engine._programs, {}
    mark = obs.StageMarks.mark
    for name in ("with", "without"):
        if name == "without":
            obs.StageMarks.mark = lambda self, stage: None
        try:
            engine._programs = None
            _program(sysm, batch, k, eager=False)  # eager, then captured
            fresh[name] = engine.programs
        finally:
            obs.StageMarks.mark = mark
    times = {"with": [], "without": []}
    for _ in range(TURNS):
        for name, programs in fresh.items():
            engine._programs = programs
            times[name].append(_program(sysm, batch, k, eager=False)[2])
    engine._programs = served
    w, wo = statistics.median(times["with"]), statistics.median(times["without"])
    return {"with_ms": w, "without_ms": wo, "extra_ms": w - wo, "turns": TURNS,
            "with_all": times["with"], "without_all": times["without"]}


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def starved(sysm, mix, batch) -> dict:
    obs.RECORDER.reset()
    logdir = os.path.join(WORK, "capture")
    got = profiling.capture_trace(sysm.engine, batch, k=mix["k"], n_batches=8, logdir=logdir)
    if not got["ok"]:
        return {"error": got}
    with open(got["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    os.remove(got["trace_file"])
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    under = _union([(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == "mrag:query.starved"])
    busy = _union(dev)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] - busy[i][1] > 1000.0]
    shares = []
    for s, e in gaps:
        cover = sum(max(0.0, min(e, ue) - max(s, us)) for us, ue in under)
        shares.append(cover / (e - s))
    summary = obs.RECORDER.summary()
    return {"device_events": len(dev), "starved_spans": len(under),
            "gaps_over_1ms": [[round((e - s) / 1e3, 4), round(sh, 4)]
                              for (s, e), sh in zip(gaps, shares)],
            "gaps_at_least_90pct": sum(sh >= 0.9 for sh in shares),
            "starved_ms": summary["spans"].get("query.starved", {}).get("total_ms"),
            "starved_children_ms": summary["children"].get("query.starved", {}),
            "spans": summary["spans"], "counts": summary["counts"]}


class Segments:
    """A program's graphs, cut at its stage marks, replayed in order; with
    ``events`` set, a timing event before the first and after each."""

    def __init__(self, graphs: list):
        self.graphs, self.events = graphs, None

    def replay(self) -> None:
        if self.events is not None:
            self.events[0].record()
        for i, g in enumerate(self.graphs):
            g.replay()
            if self.events is not None:
                self.events[i + 1].record()

    def stage_ms(self) -> dict:
        ev = self.events
        return {stage: ev[i].elapsed_time(ev[i + 1]) for i, stage in enumerate(obs.STAGES)}


def _segmented_capture(self, program, static):
    """``CapturedPrograms._capture`` cut at the program's first four stage
    marks into five graphs of the instance's pool (the last runs from the
    d-tag mark to the program's end)."""
    import gc

    if self._pool is None:
        self._pool = torch.cuda.graph_pool_handle()
    graphs = []

    def begin():
        graphs.append(torch.cuda.CUDAGraph())
        graphs[-1].capture_begin(pool=self._pool, capture_error_mode="thread_local")

    def cut(marks, stage):
        if stage in obs.STAGES[:-1]:
            graphs[-1].capture_end()
            begin()

    mark, collecting = obs.StageMarks.mark, gc.isenabled()
    gc.disable()
    obs.StageMarks.mark = cut
    try:
        torch.cuda.synchronize()
        with torch.cuda.device(self.device), torch.cuda.stream(self.capture_stream()):
            begin()
            outputs = program(static)
            graphs[-1].capture_end()
    finally:
        obs.StageMarks.mark = mark
        if collecting:
            gc.enable()
    return Segments(graphs), outputs


def segments(sysm, mix, batches) -> dict:
    engine, k = sysm.engine, mix["k"]
    served = engine._programs
    capture = CapturedPrograms._capture
    CapturedPrograms._capture = _segmented_capture
    try:
        engine._programs = None
        _program(sysm, batches[0], k, eager=False)  # eager, then captured in five
        cut = engine.programs
    finally:
        CapturedPrograms._capture = capture
    (entry,) = cut.graphs.values()
    seg = entry.graph
    one_ms, cut_ms, one_stages, cut_stages = [], [], [], []
    try:
        for b in batches:
            engine._programs = served
            out, _, _ = _program(sysm, b, k, eager=False, sleep=True)
            one_stages.append(out.marks.elapsed_ms())
            seg.events = [torch.cuda.Event(enable_timing=True) for _ in range(len(seg.graphs) + 1)]
            engine._programs = cut
            _program(sysm, b, k, eager=False, sleep=True)
            cut_stages.append(seg.stage_ms())
            seg.events = None
            for _ in range(2):  # idle device: the host launches each graph as the last ends
                engine._programs = served
                one_ms.append(_program(sysm, b, k, eager=False)[2])
                engine._programs = cut
                cut_ms.append(_program(sysm, b, k, eager=False)[2])
    finally:
        engine._programs = served
    res = {"graphs": len(seg.graphs), "batches": len(batches), "stages": {}}
    for stage in obs.STAGES:
        one = statistics.median(m[stage] for m in one_stages)
        sg = statistics.median(m[stage] for m in cut_stages)
        res["stages"][stage] = {"one_graph_mark_ms": one, "segment_ms": sg, "ratio": one / sg}
    one, sg = statistics.median(one_ms), statistics.median(cut_ms)
    res.update(one_graph_idle_ms=one, segments_idle_ms=sg,
               extra_ms_per_launch=(sg - one) / (len(seg.graphs) - 1),
               one_graph_busy_sum_ms=statistics.median(sum(m.values()) for m in one_stages),
               segments_busy_sum_ms=statistics.median(sum(m.values()) for m in cut_stages))
    return res


def main(cells: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    run.set_caches(spec.ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    os.makedirs(WORK, exist_ok=True)
    for name in cells:
        sysm, mix, batches = build(name)
        res = {}
        for check, args in ((clock, batches), (marks, batches), (cost, batches[0]),
                            (starved, batches[0]), (segments, batches)):
            try:
                res[check.__name__] = check(sysm, mix, args)
            except Exception:  # the other checks still report
                res[check.__name__] = {"error": traceback.format_exc().splitlines()[-12:]}
        print(json.dumps({name: res}), flush=True)
        sysm.release()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["exact1m.backlog", "proj1m.backlog"]))
