"""The traced window: ``torch.profiler`` over the card while the window
runs, reduced to what the per-layer readers and the breakdown take: the
union of the device's busy intervals (kernels, copies and fills; an
overlap counts once), device seconds by kernel name, and the longest idle
gaps, each named by the benchmark span the host was in."""
from __future__ import annotations

import contextlib
import re
import time

SPAN_PREFIX = "bench:"
TOP = 10


def kernel_name(raw: str) -> str:
    """A device event's name without its return type, namespace,
    template arguments and parameters: ``void topk_tiles<...>(...)`` ->
    ``topk_tiles``."""
    name = raw.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    return re.split(r"[<(]", name)[0] or raw[:40]


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Overlapping or touching [start, end) intervals merged, in order."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(device: list[tuple[int, int, str]], spans: list[tuple[int, int, str]],
           t0: int, t1: int) -> dict:
    """Device events (start ns, end ns, name) and the host's benchmark
    spans over the window [t0, t1) ns -> busy seconds, seconds by kernel
    name, and the TOP longest idle gaps, each named by the innermost span
    that covers most of it."""
    clipped = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
    merged = union([(s, e) for s, e, _ in clipped])
    busy = sum(e - s for s, e in merged) / 1e9
    by_name: dict[str, float] = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    edges = [t0] + [x for seg in merged for x in seg] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP]:
        # the innermost span that covers most of the gap: of the spans
        # covering at least half as much as the most covering one, the
        # shortest
        cover = [(min(e, se) - max(s, ss), se - ss, n) for ss, se, n in spans
                 if se > s and ss < e]
        most = max((c for c, _, _ in cover), default=0)
        inner = sorted((d, n) for c, d, n in cover if c * 2 >= most)
        named.append([inner[0][1] if inner else "between the engine's calls",
                      (e - s) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": (t1 - t0) / 1e9, "by_name": by_name,
            "device_ops": [[n, v] for n, v in top], "idle_gaps": named}


@contextlib.contextmanager
def traced(lock, sync):
    """Profile the body; yields a dict that holds, after the body, the
    reduction of `reduce` over the body's window, or over the window the
    body puts under "clip" ((start, end) in ns of time.time_ns). The
    profiler starts and stops under `lock` (the system's capture lock),
    with the card waited for on both sides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with lock:
        prof.__enter__()
    out: dict = {}
    try:
        sync()
        t0 = time.time_ns()
        yield out
        sync()
        t1 = time.time_ns()
    finally:
        with lock:
            prof.__exit__(None, None, None)
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(), kernel_name(ev.name())))
        elif ev.name().startswith(SPAN_PREFIX):
            spans.append((ev.start_ns(), ev.end_ns(), ev.name()[len(SPAN_PREFIX):]))
    t0, t1 = out.pop("clip", (t0, t1))
    out.update(reduce(device, spans, t0, t1))
