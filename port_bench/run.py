"""One cell of the port's benchmark, run once:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``port_bench/configs/<config>.json``) and a traffic mix
(``port_bench/traffic/<traffic>.json``). The run makes the corpus on the
card from the seed, builds the system's store (and ANN tables), warms up
every program the window will replay, measures for ``--seconds``, then
compares a seeded sample of the window's answers with the plain reference
(``reference.py``, ``check.py``). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics and a breakdown
from ``torch.profiler``. The last line on standard output is one JSON
object; the numbers compared, each beside its limit, are also the last
lines on standard error. Without a CUDA card (or with fewer cards than
the cell asks for) it exits with 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import check, corpus, reference, reftext, spec, traffic  # noqa: E402
from port_bench import system as sysmod  # noqa: E402
from port_bench import trace as tracemod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mobius_rag_tpu")
CACHE = ".bench_cache"  # the checkout's own caches, at fixed paths under its root


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    jax, jaxlib, flax or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_caches(root: str) -> None:
    """Every cache the run may write, in fixed directories of the
    checkout. The system builds its kernels into its own fixed
    ``mobius_rag_tpu_torch/_build/``, inside the checkout too."""
    base = os.path.join(root, CACHE)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("MRAG_DATA_DIR", "data")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


@contextlib.contextmanager
def collections():
    """Counts the collector's runs by generation, and their seconds,
    while the body runs."""
    import gc

    out = {"gen0": 0, "gen1": 0, "gen2": 0, "seconds": 0.0}
    started = []

    def watch(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out[f"gen{info['generation']}"] += 1
            out["seconds"] += time.perf_counter() - started.pop()

    gc.callbacks.append(watch)
    try:
        yield out
    finally:
        gc.callbacks.remove(watch)


def warm_batches(sysm, reqs: list, sizes: list[int], seed: int, draws: int = 24) -> list[list]:
    """Batches of each size in `sizes` that together reach every lexical
    union width the window's batches can: a batch of n distinct requests
    (n up to the size, the rest copies of its last, as the micro-batcher
    pads) for each width met among `draws` seeded draws of every n, among
    the requests alone, and along two walks over `reqs` (from the request
    with the fewest buckets, adding the one that adds the fewest new; from
    the one with the most, adding the most), whose unions grow by one
    request's buckets at a time up to about the largest that n requests
    reach."""
    sets = [sysm.buckets(r) for r in reqs]
    by_width: dict[tuple[int, int], list] = {}
    top = min(max(sizes), len(reqs))
    pad = {n: min(b for b in sizes if b >= n) for n in range(1, top + 1)}

    def note(group: list[int]) -> None:
        b = pad[len(group)]
        batch = [reqs[i] for i in group] + [reqs[group[-1]]] * (b - len(group))
        by_width.setdefault((b, sysm.read_width(batch)), batch)

    for i in range(len(reqs)):
        note([i])
    rng = np.random.default_rng([int(seed), 8])
    for n in range(2, top + 1):
        for _ in range(draws):
            note(rng.choice(len(reqs), n, replace=False).tolist())
    order = sorted(range(len(reqs)), key=lambda i: len(sets[i]))
    for first, fewest in ((order[0], True), (order[-1], False)):
        group, union = [first], set(sets[first])
        while len(group) < top:
            rest = [i for i in range(len(reqs)) if i not in group]
            gain = {i: len(sets[i] - union) for i in rest}
            grow = [i for i in rest if gain[i]] or rest
            nxt = min(grow, key=gain.get) if fewest else max(grow, key=gain.get)
            group.append(nxt)
            union |= sets[nxt]
            note(group)
    return [by_width[key] for key in sorted(by_width)]


def shape_of(cfg: dict, mix: dict, rc, tables, qs_batches: list[list]) -> dict:
    """The sizes the roofline counts take: the configuration's, the mix's,
    and, averaged over a few of the window's batches, the lexical
    postings their buckets hold and, of the ANN cells they probe, the
    rows those hold (each distinct cell once, and each query's own)."""
    env, c = cfg["env"], cfg["corpus"]
    k = mix["k"]
    shape = {"batch": mix["batch"] if mix["kind"] == "backlog" else env_int(env, "MRAG_MICROBATCH_MAX"),
             "rows": c["rows"], "dim": c["dim"], "k": k,
             "m": k * env_int(env, "MRAG_OVER_FETCH"), "tag_words": env_int(env, "MRAG_TAG_WORDS"),
             "phrase_words": env_int(env, "MRAG_PHRASE_WORDS"),
             "dtype": env["MRAG_VECTOR_DTYPE"], "backend": env["MRAG_VECTOR_BACKEND"]}
    posts, scan_rows, scan_pairs, probed = [], [], [], []
    for qs in qs_batches:
        union = set().union(*(q.weights for q in qs))
        posts.append(sum(rc.postings[b][0].numel() for b in union if b in rc.postings))
        if tables is not None:
            held = tables.held.tolist()
            qv = torch.stack([q.vec for q in qs])
            cells, pairs = set(), 0
            for cs in qv @ tables.centroids.T:
                mine = [x for x in tables.probes(cs, 0.0)[0] if held[x]]
                cells.update(mine)
                pairs += sum(held[x] for x in mine)
                probed.append(len(mine))
            scan_rows.append(sum(held[x] for x in cells))
            scan_pairs.append(pairs)
    shape["postings"] = float(np.mean(posts)) if posts else 0.0
    if tables is not None:
        shape.update(cells=int((tables.held > 0).sum()), p=int(tables.codes.shape[-1]),
                     probe=float(np.mean(probed)), scan_rows=float(np.mean(scan_rows)),
                     scan_pairs=float(np.mean(scan_pairs)))
    return shape


def env_int(env: dict, key: str) -> int:
    return int(env[key])


def set_up(cfg: dict, mix: dict, lexicon_path: str, seed: int, device, stages: dict):
    """The system built and warmed for a mix: (system, request specs,
    query vectors, requests); the seconds of each stage into `stages`.
    Warm-up runs one search of each program key the window can replay
    (``warm_batches``), on requests of its own: batches of the backlog's
    size, or of every size the micro-batcher pads to."""
    def stage(name: str, t0: float) -> float:
        stages[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    sysm = sysmod.System(cfg, lexicon_path, device)
    sysm.k = mix["k"]
    t = stage("import", t)
    rows = corpus.make_vectors(cfg["corpus"], device, seed)
    specs = traffic.request_specs(mix, seed)
    vecs = traffic.query_vectors(mix, rows, seed)
    reqs = sysm.requests(specs, vecs)
    warm_reqs = sysm.requests(traffic.warm_specs(mix, seed), vecs)
    sysm.sync()
    t = stage("corpus", t)
    sysm.build(rows, stages)
    del rows
    t = time.perf_counter()
    if mix["kind"] == "backlog":
        warm = [w for w in warm_batches(sysm, warm_reqs, [mix["batch"]], seed)
                if len(w) == mix["batch"]]
        stages["warm_keys"] = sysm.warm(warm)
        sysm.engine.search_pipelined(warm[:mix["depth"]], k=mix["k"])
    else:
        from mobius_rag_tpu_torch.query.microbatch import MicroBatcher

        top = env_int(cfg["env"], "MRAG_MICROBATCH_MAX")
        pad = getattr(MicroBatcher, "_bucket", lambda n: n)
        stages["warm_keys"] = sysm.warm(warm_batches(
            sysm, warm_reqs, sorted({pad(n) for n in range(1, top + 1)}), seed))
    sysm.sync()
    t = stage("warmup", t)
    sysm.freeze()
    stage("freeze", t)
    return sysm, specs, vecs, reqs


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
             device="cuda", root: str = spec.ROOT, control: bool = False) -> dict:
    """Set-up, window, and the comparison of one run; the result line's
    object (before the device's name and count are added). `control`
    (``control.py`` only) adds the control's numbers under "control"."""
    cfg_path = spec.config_path(bench, cell["config"], root)
    cfg = spec.load_json(cfg_path)
    mix = spec.load_json(spec.mix_path(cell["traffic"], root))
    lexicon_path = os.path.join(os.path.dirname(cfg_path), cfg["lexicon"])
    on_card = torch.device(device).type == "cuda"
    # the interpreter and its imports, before this function
    stages: dict[str, float] = {"start": time.perf_counter() - T_START}

    sysm, specs, vecs, reqs = set_up(cfg, mix, lexicon_path, seed, device, stages)
    batches = traffic.backlog_batches(mix, len(specs)) if mix["kind"] == "backlog" else None
    log(f"set-up stages (s): {json.dumps(stages)}")

    span_ctx = sysm.spans() if traced else contextlib.nullcontext()
    trace_ctx = tracemod.traced(sysm.lock(), sysm.sync) if traced else \
        contextlib.nullcontext({})
    n_sample = mix["sample"]
    with span_ctx, trace_ctx as tr, collections() as gcs:
        if mix["kind"] == "backlog":
            sample = sysmod.Reservoir(n_sample, seed)
            setup_s = time.perf_counter() - T_START
            w = sysmod.backlog_window(sysm, reqs, batches, mix["depth"], seconds, sample)
            items, unanswered = sample.items, 0
            attempted, failed = w["queries"], w["failed"]
            e2e = {"qps": w["queries"] / w["window_s"]}
        else:
            due, picks = traffic.arrivals(mix, seed, seconds)
            in_win = np.flatnonzero((due >= mix["warmup_s"]) & (due < mix["warmup_s"] + seconds))
            rng = np.random.default_rng([int(seed), 7])
            keep = set(rng.choice(in_win, min(n_sample, len(in_win)), replace=False).tolist())
            w = sysmod.served_window(sysm, reqs, due, picks, mix["warmup_s"], seconds, keep)
            setup_s = w["start_perf"] + mix["warmup_s"] - T_START
            items = [w["answers"][i] for i in sorted(w["answers"])]
            unanswered = w["unanswered_kept"]
            attempted, failed = w["attempted"], w["failed"]
            e2e = {"p95_ms": float(np.percentile(w["latency_ms"], 95))}
            if traced:
                tr["clip"] = (w["start_ns"] + int(mix["warmup_s"] * 1e9),
                              w["start_ns"] + int((mix["warmup_s"] + seconds) * 1e9))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"window: {json.dumps({k: v for k, v in w.items() if np.isscalar(v)})}")

    # ---- the comparison, after the window, the system's state freed ----
    t = time.perf_counter()
    tables = ann = None
    if cfg["env"]["MRAG_VECTOR_BACKEND"] == "proj":
        tables = reference.ProjTables(sysm.ann, env_int(cfg["env"], "MRAG_IVF_NPROBE"),
                                      cfg["ann_choices"])
        ann = sysm.ann if control else None
    sysm.release()
    del reqs
    rows = corpus.make_vectors(cfg["corpus"], device, seed)
    numbers = {}
    if tables is not None:
        numbers.update(tables.verify(rows, cfg["corpus"]["rows"], cfg["ties"]["vector"]))
    rc = reference.RefCorpus(cfg, reftext.RefLexicon(lexicon_path), rows)
    qs = [reference.Query(rc, specs[i], vecs[specs[i]["vec"]], mix["k"], 0.0)
          for i, _ in items]
    progs = [a for _, a in items]
    answers = []
    for lo in range(0, len(qs), reference.QUERY_BLOCK):
        answers += reference.answer_block(rc, qs[lo:lo + reference.QUERY_BLOCK],
                                          progs[lo:lo + reference.QUERY_BLOCK], cfg, tables,
                                          cfg["ties"]["vector"])
    numbers.update(check.compare(progs, answers, unanswered, mix["k"]))
    correct, shown = check.judge(numbers, cfg["limits"])
    correct = correct and len(items) > 0
    log(f"reference: {len(items)} answers compared in {time.perf_counter() - t:.1f} s")
    ctrl = None
    if control:
        from port_bench.control import control_numbers

        ctrl = control_numbers(cfg, mix, rc.lexicon, rows, specs, vecs,
                               [i for i, _ in items], rc, tables, ann)

    device_info = {"platform": "gpu", "memory_peak_bytes": int(peak)}
    if traced:
        qs_b = [[reference.Query(rc, specs[i], vecs[specs[i]["vec"]], mix["k"], 0.0)
                 for i in b]
                for b in (batches[:4]
                          if mix["kind"] == "backlog" else
                          [list(range(lo, lo + 32)) for lo in range(0, 128, 32)])]
        ctx = {"cell": cell, "cfg": cfg, "mix": mix, "window": w, "trace": tr,
               "stages": stages, "graphs": on_card,
               "shape": shape_of(cfg, mix, rc, tables, qs_b)}
        metrics = {}
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec.metrics_of(bench, cell["name"], "end_to_end")}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    served = w["queries"] if mix["kind"] == "backlog" else len(due)
    recalls = [a.recall for a in answers if a.recall is not None]
    notes = {"setup_stages_s": stages, "window": {k: v for k, v in w.items() if np.isscalar(v)},
             "collections": gcs, "host_threads": torch.get_num_threads(),
             # the share of the run's requests whose text and filter came
             # before in it: what a text-keyed cache could serve at most
             "text_repeat_share": traffic.repeat_share(specs, served),
             "vector_recall_at_k": float(np.mean(recalls)) if recalls else None}
    if mix["kind"] == "open":
        notes["generator_late_ms"] = {"p95": float(np.percentile(w["late_ms"], 95)),
                                      "max": float(w["late_ms"].max())}
    result["notes"] = notes
    if ctrl is not None:
        result["control"] = ctrl
    result["checks"] = shown  # last: the numbers compared, each beside its limit
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    set_caches(spec.ROOT)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    result["device"].update(kind=torch.cuda.get_device_name(0), count=cell["chips"])
    found = forbidden_modules()
    if found:
        log(f"the process loaded {', '.join(found)}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
