"""The port's grid paths across four cards: each runs over cuda:0..3 and is
held bitwise against the same path on one card, with the first numbers of
its cost across cards.

1. The staged sharded route (``ShardedEngine`` over several devices: per
   card a count graph and an arms graph, the merge graph on cuda:0, joined
   by copies between cards behind events): BASELINE.json config 4's
   layout, chip_smoke phase 4's 1M x 1536 bf16 corpus over 8 shards, two a
   card, with the exact and the ivf backend; phase 3's 70k float32 store on
   a [2, 4] serving grid, shard j of each data row on cuda:j. Captured
   (staged) against the same engine eager and against the one graph on
   cuda:0 (the same grid named on cuda:0; ivf with the same tables):
   every hit of a batch searched and of the batches pipelined, and one
   batch's packed outputs, bitwise; q/s sync and pipelined of each. At 70k
   a writer thread then publishes and refreshes while another searches,
   and captured is held against eager again.
2. The data-parallel encoder (``MeshEncoderModel``, dp 4, a replica a
   card) at the front door's width (``EncoderConfig.from_env()``: 12 x
   768, bf16): batches of 128 at L = 64 and 256, captured against eager
   and against ``EncoderModel`` on cuda:0 run on each part, row by row,
   bitwise; ms a batch and chunks/s, beside the same model over cuda:0
   named 4 times.
3. The segmented trainer (segment graphs of a grid over several cards) at
   that width on phase 9's pairs, batches of 32: grids (4, 1), (2, 2) and
   (2, 4) (each row over cuda:0..3), against the eager step on the same
   cards (torch's AccumulateGrad stream warning made an error there) and
   against the same route forced on cuda:0: per-step losses, final
   parameters and optimizer state bitwise; ms a step (captures included,
   and after the last new key), host operations a step, the pool per card.
4. The dryrun twin, ``python -m mobius_rag_tpu_torch.graft_entry 4``,
   over the four cards.

Each path prints each card's busy share (torch.profiler's kernel and copy
time on the card over the wall time) and peak memory. First (0) the
cards' name and power limit, their count and their links (``nvidia-smi
topo -m`` and ``nvlink --status``, peer access, a copy's rate), and (w)
torch's AccumulateGrad warning, each case in a fresh process
(torch warns once a process): a parameter copied between cards straight
from its leaf and through a view of it; the segmented route forced on
one card, each pool's group capturing on a stream of its own and on its
device's one stream. A failed comparison or path is
printed and the rest still run; the exit code is 1 if any failed.

    python3 scripts/four_card_check.py [--only 0,w,1,2,3,4]

Needs four CUDA cards and refuses fewer. ``--devices cpu,cpu:1,cpu:2,cpu:3
--small`` rehearses its code on the CPU at small sizes (named CPU devices
compare unequal, so the routes are the cards'); set stand-in captures
first (tests/test_torch_compiled.StandIn for ``CapturedPrograms``).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K = 10
BATCH = 32
N_BATCHES = 8
ROUNDS = 3  # rounds of the q/s and ms timings; their median is printed
TRAIN_STEPS = 12  # batches of 32 pairs through each route of each grid
GRIDS = ((4, 1), (2, 2), (2, 4))
ENC_BLOCKS = ((128, 64), (128, 256))  # (texts, length) of an encoder batch
ENC_TIMED = 10
FAILED: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> bool:
    """A comparison's result on a line of its own; a failure is kept."""
    log(f"CHECK {'ok' if ok else 'FAILED'}: {what}")
    if not ok:
        FAILED.append(what)
    return ok


def sync_all(devices) -> None:
    """Wait for every card of `devices` (under compiled.LOCK, as captures)."""
    from mobius_rag_tpu_torch.query.compiled import LOCK

    with LOCK:
        for d in dict.fromkeys(torch.device(x) for x in devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def profile(run, n: int, devices) -> dict:
    """torch.profiler over run(), n batches or steps: each card's busy share
    (the union of its kernels' and copies' device time over the wall
    time) and the host's CUDA calls that launch a kernel or a graph or
    enqueue a copy or a fill, per batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from chip_smoke import HOST_OP
    from mobius_rag_tpu_torch.profiling import locked_profiler

    cards = [torch.device(d) for d in dict.fromkeys(devices)]
    on_card = cards[0].type == "cuda"
    sync_all(cards)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with locked_profiler(acts) as prof:
        t0 = time.perf_counter()
        run()
        sync_all(cards)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans: dict = {}
    host = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            spans.setdefault(ev.device_index, []).append((ev.time_range.start,
                                                          ev.time_range.end))
        elif HOST_OP.match(ev.name):
            host += 1
    busy = {}
    for d, iv in sorted(spans.items()):
        total, end = 0.0, -1.0
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        busy[f"cuda:{d}"] = round(total / wall_us, 4)
    return {"busy": busy if on_card else "not measured (CPU)", "host_ops": host / n,
            "wall_ms": wall_us / 1e3 / n}


def reset_peaks(devices) -> None:
    from chip_smoke import _empty_cache

    if torch.device(devices[0]).type == "cuda":
        _empty_cache()
        for d in dict.fromkeys(devices):
            torch.zeros(1, device=d)  # a card's allocator exists from its first tensor on
            torch.cuda.reset_peak_memory_stats(d)


def peaks(devices) -> dict:
    if torch.device(devices[0]).type != "cuda":
        return "not measured (CPU)"
    return {str(d): round(torch.cuda.max_memory_allocated(d) / 2**30, 3)
            for d in dict.fromkeys(devices)}


def median_rate(fn, items: int) -> tuple[float, list]:
    """items/s of fn() (which waits for its result), ROUNDS rounds."""
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        rounds.append(items / (time.perf_counter() - t0))
    return float(np.median(rounds)), [round(r, 1) for r in rounds]


def section(name: str, fn, *args) -> None:
    t0 = time.perf_counter()
    try:
        fn(*args)
    except Exception:
        check(False, f"{name} raised: {traceback.format_exc(limit=8)}")
    log(f"{name}: {time.perf_counter() - t0:.1f} s")


# ---- 0. the cards, and torch's AccumulateGrad warning -------------------------

_PROBE = """
import warnings, torch
warnings.simplefilter("error")
leaf = torch.randn(64, 64, device="cuda:1", requires_grad=True)
moved = (leaf.view_as(leaf) if {view} else leaf).to("cuda:0")
(moved * 2).sum().backward()
torch.cuda.synchronize("cuda:1")
print(float(leaf.grad.sum()))
"""


# the segmented route forced on cuda:0, its groups' captures each on a
# stream of its own (as the route once did) or on the device's one stream
_SEGMENT_PROBE = """
import dataclasses, sys, warnings
import numpy as np, torch
sys.path.insert(0, {root!r})
from mobius_rag_tpu_torch.models import encoder as tenc, train as ttrain
from mobius_rag_tpu_torch.parallel import sharded
from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh
from mobius_rag_tpu_torch.query import compiled
if {own}:
    def own(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream
    compiled.CapturedPrograms.capture_stream = own
warnings.filterwarnings("error", message="The AccumulateGrad node's stream")
sharded.on_one_device = lambda groups, device: False
cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=128, vocab_size=512)
step, shard, batch, init = ttrain.make_train_step(
    cfg, ttrain.TrainConfig(), make_train_mesh(2, 2, devices=["cuda:0"] * 4))
model = shard(tenc.init_params(cfg, torch.Generator(device="cuda:0").manual_seed(0)))
opt = init(model)
q = np.random.default_rng(0).integers(2, 512, (8, 64)).astype(np.int32)
for _ in range(2):
    model, opt, m = step(model, opt, batch(q), batch(q))
print(float(m["loss"]))
"""


def cards_section(cards, smi: str) -> None:
    """The cards' name, power limit and count, and the links between them:
    what ``nvidia-smi topo -m`` and ``nvlink --status`` say, whether each
    pair has peer access, and the rate of a 256 MiB copy from cuda:0 to
    each other card (CUDA events, median of 5, after a warm copy)."""
    log(f"cards: {smi.replace(chr(10), '; ')}; count {torch.cuda.device_count()}")
    for args in (["topo", "-m"], ["nvlink", "--status"]):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        out = (r.stdout or r.stderr).strip().splitlines()
        log(f"nvidia-smi {' '.join(args)}: exit {r.returncode}\n" + "\n".join(out[:40]))
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(4)]
            for i in range(4)]
    log(f"peer access (row: from cuda:i): {peer}")
    src = torch.empty(2**28, dtype=torch.uint8, device=cards[0])
    for d in cards[1:]:
        dst = torch.empty_like(src, device=d)
        dst.copy_(src)
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times))
        log(f"copy of 256 MiB {cards[0]} -> {d}: {ms:.3f} ms, {2**28 / ms / 1e6:.1f} GB/s")
        del dst
    del src


def warning_section(cards, smi: str) -> None:
    """Torch's AccumulateGrad stream warning, each case in a fresh process
    (torch warns once a process)."""
    for view in (False, True):
        how = "through a view on its card" if view else "straight from the leaf"
        r = subprocess.run([sys.executable, "-c", _PROBE.format(view=view)],
                           capture_output=True, text=True, timeout=300)
        warned = "AccumulateGrad node's stream" in r.stderr
        log(f"a parameter on cuda:1 copied to cuda:0 {how}, backward with warnings as "
            f"errors: exit {r.returncode}, AccumulateGrad stream warning "
            f"{'raised' if warned else 'not raised'}"
            + (f": {r.stderr.strip().splitlines()[-1][:200]}" if r.returncode else ""))
        if view:
            check(r.returncode == 0 and not warned,
                  "a parameter copied between cards through a view on its card: no "
                  "AccumulateGrad stream warning")
    for own in (True, False):
        how = "a stream of its own" if own else "its device's one stream"
        r = subprocess.run([sys.executable, "-c", _SEGMENT_PROBE.format(root=ROOT, own=own)],
                           capture_output=True, text=True, timeout=600)
        warned = "AccumulateGrad node's stream" in r.stderr
        log(f"the segmented route forced on cuda:0 at (2, 2), each group's captures on {how}, "
            f"warnings as errors: exit {r.returncode}, AccumulateGrad stream warning "
            f"{'raised' if warned else 'not raised'}"
            + (f": {r.stderr.strip().splitlines()[-1][:200]}" if r.returncode else ""))
        if not own:
            check(r.returncode == 0 and not warned,
                  "the segmented route's captures on one stream a device: no AccumulateGrad "
                  "stream warning")


# ---- 1. the staged sharded route ---------------------------------------------

def _hits(results) -> list:
    return [[(h.chunk_id, h.score) for h in r.hits] for r in results]


def _packed(engine, reqs) -> tuple:
    q, exps = engine.prepare_host(reqs)
    f, i = engine._packed(q, exps, None, None, K)
    return f.cpu().numpy().view(np.int32), i.cpu().numpy()


def _serving(store, lexicon, cfg, mesh, home):
    from mobius_rag_tpu_torch.parallel import ShardedEngine
    from mobius_rag_tpu_torch.query.engine import SearchEngine

    return SearchEngine(store, lexicon, cfg=cfg, device=home,
                        sharded=ShardedEngine(store, mesh=mesh, cfg=cfg))


def _release(serving) -> None:
    from chip_smoke import _release_sharded

    _release_sharded(serving.sharded)
    serving.store.listeners.remove(serving._on_store_mutation)


def staged_path(name: str, over, one, reqs, pipe, cards, smi: str) -> dict:
    """`over` (a grid over the cards: the staged route) against itself eager
    and against `one` (the grid on cuda:0: one graph), bitwise; q/s, busy
    share per card, the masked top-k's and the lexical kernels' launches a
    batch."""
    from mobius_rag_tpu_torch.ops.lexical import lexical_topk
    from mobius_rag_tpu_torch.ops.topk import masked_topk
    from mobius_rag_tpu_torch.query.compiled import ProgramsByDevice

    home = over.device
    check(isinstance(over.programs, ProgramsByDevice) and not over.sharded.one_device
          and one.sharded.one_device, f"{name}: the staged route over {cards}, the one graph "
          f"on {home}")
    runs = {}
    for label, engine, graphs in (("staged", over, True), ("staged again", over, True),
                                  ("eager", over, False), ("one graph", one, True)):
        engine.graphs = graphs
        before, lex_before = masked_topk.launches, lexical_topk.launches
        runs[label] = (_hits(engine.search(reqs, k=K)),
                       [_hits(b) for b in engine.search_pipelined(pipe, k=K)],
                       masked_topk.launches - before, _packed(engine, reqs),
                       lexical_topk.launches - lex_before)
    want = runs["one graph"]
    for label in ("staged", "staged again", "eager"):
        got = runs[label]
        check(got[0] == want[0] and got[1] == want[1],
              f"{name}: {label} over the cards, every hit (1 batch searched, {len(pipe)} "
              f"pipelined) equal to the one graph's on {home}")
        check(all(np.array_equal(a, b) for a, b in zip(got[3], want[3])),
              f"{name}: {label}: one batch's packed outputs bitwise the one graph's")
    # the exact backend's arm scan is the masked top-k, once a shard and group
    per = (len(over.sharded.groups) * over.sharded.num_shards
           if over.sharded.vector_backend == "exact" else 0)
    check(runs["staged"][2] == per * (1 + len(pipe)) or home.type != "cuda",
          f"{name}: masked_topk launched {runs['staged'][2]} times over the stages for "
          f"{1 + len(pipe)} batches (want {per} a batch)")
    # the sparse lexical arm's kernels, once a shard and group (the packed
    # outputs' batch above adds one more)
    lex = (len(over.sharded.groups) * over.sharded.num_shards
           if "lex_cols" in over.store.index.fields else 0)
    check(runs["staged"][4] == lex * (2 + len(pipe)) or home.type != "cuda",
          f"{name}: lexical_topk launched {runs['staged'][4]} times over the stages for "
          f"{2 + len(pipe)} batches (want {lex} a batch)")
    out = {}
    for label, engine, graphs in (("staged", over, True), ("eager", over, False),
                                  ("one graph", one, True)):
        engine.graphs = graphs
        sync, sync_r = median_rate(lambda: [engine.search(reqs, k=K) for _ in pipe],
                                   BATCH * len(pipe))
        piped, piped_r = median_rate(lambda: engine.search_pipelined(pipe, k=K),
                                     BATCH * len(pipe))
        prof = profile(lambda: engine.search_pipelined(pipe, k=K), len(pipe),
                       cards + [home])
        out[label] = {"qps_sync": sync, "qps_pipelined": piped, "busy": prof["busy"]}
        log(f"{name} {label}: {sync:.1f} q/s sync (rounds {sync_r}), {piped:.1f} pipelined "
            f"({piped_r}), batch {BATCH}; pipelined busy share per card {prof['busy']}, "
            f"{prof['host_ops']:.0f} host operations a batch; on {smi}")
    over.graphs = True
    programs = over.programs
    log(f"{name}: staged captures {programs.captures} (ms median "
        f"{np.median(programs.capture_ms):.1f}), replays {programs.replays}, graphs kept "
        f"{len(programs.graphs)}, pool {programs.pool_bytes() / 2**20:.1f} MiB over the cards")
    return out


def _requests_1m(vectors, dev):
    """phase 4's hybrid requests (payer filters, strict with auto-relax) on
    noisy corpus rows: a batch and N_BATCHES batches to pipeline."""
    from chip_smoke import _HYBRID_1M
    from mobius_rag_tpu_torch.query.engine import QueryRequest

    g = torch.Generator(device=dev).manual_seed(3)
    nq = 64
    rows = torch.randperm(len(vectors), device=dev, generator=g)[:nq]
    qv = vectors[rows].float() + 0.15 * torch.randn((nq, vectors.shape[1]), device=dev,
                                                    generator=g)
    q_np = (qv / qv.norm(dim=1, keepdim=True)).cpu().numpy()

    def req(i):
        text, payer = _HYBRID_1M[i % len(_HYBRID_1M)]
        return QueryRequest(query=text, payer=payer, embedding=q_np[i % nq])

    return ([req(i) for i in range(BATCH)],
            [[req(j * 7 + i) for i in range(BATCH)] for j in range(N_BATCHES)])


def sharded_1m(cards, smi: str, small: bool) -> None:
    import chip_smoke as c
    from mobius_rag_tpu_torch.parallel import make_mesh
    from mobius_rag_tpu_torch.parallel.sharded import _tables_to

    home = cards[0]
    n = 20_000 if small else c.N_1M
    base = c.config_1m()
    exact = dataclasses.replace(base, vector_backend="exact", gating="dense")
    reset_peaks(cards)
    t0 = time.perf_counter()
    store, lexicon, vectors = c.build_1m_store(exact, {}, home, n)
    reqs, pipe = _requests_1m(vectors, home)
    del vectors
    log(f"1M: {store.size:,} bf16 rows on {home} in {time.perf_counter() - t0:.1f} s")
    eight = [d for d in cards for _ in range(2)]  # two shards a card
    ivf = dataclasses.replace(base, ivf_nlist=0, ivf_nprobe=32, pq_m=96, gating="dense",
                              ivf_target_recall=0.0, vector_backend="ivf")
    for label, cfg in (("exact", exact), ("ivf", ivf)):
        name = f"1: 1M bf16 {label} S=8"
        t0 = time.perf_counter()
        over = _serving(store, lexicon, cfg, make_mesh(8, devices=eight), home)
        one = _serving(store, lexicon, cfg, make_mesh(8, devices=[home] * 8), home)
        if label == "ivf":  # one build, the one graph's tables copied from it
            tse = over.sharded
            tse.ensure_ann()
            on: dict = {}
            one.sharded._ann = [[on.setdefault((d, si), _tables_to(tse._ann[g][si], d))
                                 for si, d in enumerate(row)]
                                for g, row in enumerate(one.sharded.groups)]
            one.sharded._ann_generation = tse._ann_generation
            one.sharded._ann_backend = tse._ann_backend
        sync_all(cards)
        log(f"{name}: shard copies over {eight} and on {home} in "
            f"{time.perf_counter() - t0:.1f} s")
        staged_path(name, over, one, reqs, pipe, cards, smi)
        _release(over)
        _release(one)
    log(f"1: 1M peak memory per card (GiB) {peaks(cards)}")


def sharded_70k(cards, smi: str, small: bool) -> None:
    import chip_smoke as c
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.parallel import make_serve_mesh
    from mobius_rag_tpu_torch.query.engine import QueryRequest

    home = cards[0]
    n = 3_000 if small else c.N_CHUNKS
    cfg = get_config()
    reset_peaks(cards)
    store, lexicon, vectors, rng, payers = c.build_bench_store(cfg, home, n)
    nq = 64
    q_vecs = vectors[rng.choice(n, nq, replace=False)] + 0.15 * rng.standard_normal(
        (nq, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)

    def req(i):
        return QueryRequest(query=f"timely filing deadline for {payers[i % 3]} claims",
                            embedding=q_vecs[i % nq])

    reqs = [req(i) for i in range(BATCH)]
    pipe = [[req(j * 7 + i) for i in range(BATCH)] for j in range(N_BATCHES)]
    name = "1: 70k float32 [2, 4]"
    over = _serving(store, lexicon, cfg, make_serve_mesh(2, 4, devices=cards * 2), home)
    one = _serving(store, lexicon, cfg, make_serve_mesh(2, 4, devices=[home] * 8), home)
    staged_path(name, over, one, reqs, pipe, cards, smi)
    _release(one)
    writer_thread(name, over, cfg, reqs, pipe)
    _release(over)
    log(f"1: 70k peak memory per card (GiB) {peaks(cards)}")


def writer_thread(name: str, serving, cfg, reqs, pipe) -> None:
    """A writer publishes documents (the first grows the store: a
    re-shard; the rest copy rows into the shards in place) and refreshes
    the sharded engine while another thread searches it, captured; then
    every batch replays bitwise the eager program, and the last document
    is found."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.query.engine import QueryRequest

    store, tse = serving.store, serving.sharded
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((16, cfg.embed_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    errors = []
    serving.graphs = True

    def write():
        try:
            for i in range(8):
                store.publish_document(f"w{i}", [ChunkRecord(
                    chunk_id=f"w{i}-{j}", doc_id=f"w{i}", text=f"writer doc {i} row {j}",
                    embedding=emb[2 * i + j]) for j in range(2)])
                tse.refresh()
        except Exception as e:
            errors.append(("write", repr(e)))

    def search():
        try:
            for _ in range(2):
                for b in pipe:
                    serving.search(b, k=K)
        except Exception as e:
            errors.append(("search", repr(e)))

    threads = [threading.Thread(target=write), threading.Thread(target=search)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not errors and not any(t.is_alive() for t in threads),
          f"{name}: a writer thread publishing and refreshing while another searches: "
          f"{errors or 'no errors'}")
    serving.graphs = False
    want = [_hits(serving.search(b, k=K)) for b in pipe]
    serving.graphs = True
    got = [_hits(serving.search(b, k=K)) for b in pipe]
    found = serving.search([QueryRequest(query="writer doc 7 row 0", embedding=emb[14])],
                           k=K)[0].hits
    check(got == want and any(h.chunk_id == "w7-0" for h in found),
          f"{name}: after the writes every batch replays the eager program's hits; the last "
          f"document is found")


# ---- 2. the data-parallel encoder ---------------------------------------------

def mesh_encoder(cards, smi: str, small: bool) -> None:
    from mobius_rag_tpu_torch.models.encoder import (EncoderConfig, EncoderModel,
                                                     MeshEncoderModel, init_params)
    from mobius_rag_tpu_torch.parallel import make_mesh

    home = cards[0]
    cfg = EncoderConfig.from_env()
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0))
    reset_peaks(cards)
    models = {"over the cards": MeshEncoderModel(make_mesh(4, devices=cards), cfg, params,
                                                 graphs=True),
              "eager over the cards": MeshEncoderModel(make_mesh(4, devices=cards), cfg,
                                                       params, graphs=False),
              f"on {home} x 4": MeshEncoderModel(make_mesh(4, devices=[home] * 4), cfg,
                                                 params, graphs=True)}
    one = EncoderModel(cfg, params, device=home, graphs=True)
    rng = np.random.default_rng(0)
    log(f"2: MeshEncoderModel dp 4, encoder {cfg.num_layers} x {cfg.model_dim}, {cfg.dtype}")
    for n, length in ENC_BLOCKS:
        name = f"2: mesh encoder {n} x L={length}"
        tokens = np.zeros((n, length), np.int32)
        for i in range(n):
            k = int(rng.integers(length // 2 + 1, length + 1))
            tokens[i, :k] = rng.integers(2, cfg.vocab_size, k)
        outs = {label: m.encode_tokens(tokens).cpu().numpy() for label, m in models.items()}
        outs["again"] = models["over the cards"].encode_tokens(tokens).cpu().numpy()
        rows = models["over the cards"]._bucket(n) // 4
        parts = torch.cat([one._forward(tokens[i * rows:(i + 1) * rows], rows)
                           for i in range(4)])[:n].cpu().numpy()
        want = outs["over the cards"]
        check(np.isfinite(want).all() and want.shape == (n, cfg.out_dim),
              f"{name}: finite [{n}, {cfg.out_dim}] on {home}")
        for label in ("again", "eager over the cards", f"on {home} x 4"):
            check(np.array_equal(outs[label], want),
                  f"{name}: captured over the cards bitwise {label}")
        check(np.array_equal(parts, want),
              f"{name}: each part's rows bitwise EncoderModel's on {home} for that part")
        for label in ("over the cards", "eager over the cards", f"on {home} x 4"):
            m = models[label]
            m.encode_tokens(tokens)
            ms = []
            for _ in range(ROUNDS):
                sync_all(cards)
                t0 = time.perf_counter()
                for _ in range(ENC_TIMED):
                    m.encode_tokens(tokens)
                sync_all(cards)
                ms.append((time.perf_counter() - t0) * 1e3 / ENC_TIMED)
            prof = profile(lambda: [m.encode_tokens(tokens) for _ in range(ENC_TIMED)],
                           ENC_TIMED, cards)
            med = float(np.median(ms))
            log(f"{name} {label}: {med:.3f} ms a batch (rounds {[round(x, 3) for x in ms]}), "
                f"{n / med * 1e3:.0f} chunks/s; busy share per card {prof['busy']}; on {smi}")
    log(f"2: peak memory per card (GiB) {peaks(cards)}")


# ---- 3. the segmented trainer ------------------------------------------------

def _pairs_blocks(cfg, home, small: bool) -> list:
    import chip_smoke as c
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.eval_harness.fixture_corpus import (build_fixture_stack,
                                                                  distractor_corpus)
    from mobius_rag_tpu_torch.models.data import mine_ict_pairs, pretokenized_batches
    from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer

    _, engine, store, _, _ = build_fixture_stack(device=home)
    store.add_chunks(distractor_corpus(100 if small else c.N_DISTRACTORS, engine.lexicon,
                                       get_config()))
    pairs = mine_ict_pairs(store, max_pairs=TRAIN_STEPS * BATCH * 2, seed=0)
    tok = HashTokenizer(cfg.vocab_size, cfg.max_seq)
    return list(pretokenized_batches(pairs, tok, BATCH, steps=TRAIN_STEPS, seed=0))


def _train(trainer, params, blocks, devices, warn_error: bool = False) -> dict:
    """`blocks` through `trainer` from `params`: per-step losses and
    accuracies, ms a step (host clock, every card waited for), the final
    parameters and optimizer state, the model, optimizer and step."""
    import warnings

    from mobius_rag_tpu_torch.models.train import _held

    step, shard, batch, init = trainer
    model = shard(params)
    opt = init(model)
    seen, ms = [], []
    with warnings.catch_warnings():
        if warn_error:
            warnings.filterwarnings("error", message="The AccumulateGrad node's stream")
        for q, d in blocks:
            sync_all(devices)
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, batch(q), batch(d))
            seen.append((float(m["loss"]), float(m["accuracy"])))
            sync_all(devices)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"seen": seen, "ms": ms, "state": [t.detach().clone() for t in _held(model, opt)],
            "model": model, "opt": opt, "step": step, "batch": batch}


def _pool_by_card(programs) -> dict:
    out: dict = {}
    for p in programs._all():
        out[str(p.device)] = out.get(str(p.device), 0) + p.pool_bytes()
    return {d: round(b / 2**30, 3) for d, b in sorted(out.items())}


def segmented_trainer(cards, smi: str, small: bool) -> None:
    import chip_smoke as c
    from mobius_rag_tpu_torch.models.encoder import EncoderConfig, init_params, seq_bucket
    from mobius_rag_tpu_torch.models.segments import SegmentedStep
    from mobius_rag_tpu_torch.models.train import TrainConfig, make_train_step
    from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh

    home = cards[0]
    cfg = EncoderConfig.from_env()
    blocks = _pairs_blocks(cfg, home, small)
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0))
    shapes = [(seq_bucket(q).shape[1], seq_bucket(d).shape[1]) for q, d in blocks]
    new = [s for s in range(len(shapes)) if shapes[s] not in shapes[:s]]
    log(f"3: {len(blocks)} batches of {BATCH} pairs (widths {shapes}, new at steps {new}); "
        f"encoder {cfg.num_layers} x {cfg.model_dim}, {cfg.dtype}")
    for dp, tp in GRIDS:
        name = f"3: grid ({dp}, {tp})"
        grid = (cards * 2)[:dp * tp]
        one_card = [home] * (dp * tp)
        mesh = make_train_mesh(dp, tp, devices=grid)
        log(f"{name} over {grid}")
        reset_peaks(cards)
        eager_trainer = make_train_step(cfg, TrainConfig(), mesh, graphs=False)
        try:
            eager = _train(eager_trainer, params, blocks, cards, warn_error=True)
            warned = None
        except UserWarning as e:  # the warning made an error; torch warns once a process
            warned = str(e)[:120]
            eager = _train(eager_trainer, params, blocks, cards)
        check(warned is None, f"{name}: the eager step over the cards raised no "
                              f"AccumulateGrad stream warning (made an error): {warned}")
        seg = _train(make_train_step(cfg, TrainConfig(), mesh, graphs=True), params, blocks,
                     cards)
        check(isinstance(seg["step"], SegmentedStep), f"{name}: the segmented route")
        with c._forced_stages():
            forced_trainer = make_train_step(cfg, TrainConfig(),
                                             make_train_mesh(dp, tp, devices=one_card),
                                             graphs=True)
        forced = _train(forced_trainer, params, blocks, cards)
        for label, got in (("segmented over the cards", seg),
                           (f"segmented forced on {home}", forced)):
            check(got["seen"] == eager["seen"] and all(
                torch.equal(a.to(b.device), b) for a, b in zip(got["state"], eager["state"])),
                f"{name}: {label}: per-step losses and accuracies, final parameters and "
                f"optimizer state bitwise the eager step's over the cards")
        after = new[-1] + 1
        lines = {}
        for label, got in (("eager", eager), ("segmented", seg),
                           (f"forced on {home}", forced)):
            lines[label] = (float(np.mean(got["ms"])), float(np.median(got["ms"][after:])))
        # one more step of each on a block whose key is captured: host
        # operations, busy share per card
        q, d = blocks[-1]
        prof = {}
        for label, got in (("eager", eager), ("segmented", seg)):
            s, b = got["step"], got["batch"]
            prof[label] = profile(lambda: s(got["model"], got["opt"], b(q), b(d)), 1, cards)
        step = seg["step"]
        log(f"{name}: ms a step (host clock) with captures and eager first steps / after the "
            f"last new key: { {k: (round(a, 3), round(b, 3)) for k, (a, b) in lines.items()} }"
            f"; host operations a step eager {prof['eager']['host_ops']:.0f}, segmented "
            f"{prof['segmented']['host_ops']:.0f} (the route's own count "
            f"{step.ops_per_step}); busy share per card eager {prof['eager']['busy']}, "
            f"segmented {prof['segmented']['busy']}; keys {len(step._keys)}, rows' towers "
            f"{len(step._rows)}, captures {step.programs.captures} in "
            f"{sum(step.programs.capture_ms) / 1e3:.2f} s; pool per card (GiB) "
            f"{_pool_by_card(step.programs)}; forced on {home}: pool "
            f"{_pool_by_card(forced['step'].programs)}; peak memory per card (GiB) "
            f"{peaks(cards)}; on {smi}")
        for got in (seg, forced):
            got["step"].programs.clear()
        del eager, seg, forced


# ---- 4. the dryrun twin ------------------------------------------------------

def dryrun(cards, smi: str, small: bool) -> None:
    env = dict(os.environ)
    args = [sys.executable, "-m", "mobius_rag_tpu_torch.graft_entry", "4"]
    if cards[0].type == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(d.index) for d in cards)
    else:
        args += ["--device", "cpu"]
    t0 = time.perf_counter()
    r = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    lines = [line for line in r.stdout.splitlines() if line.startswith("dryrun ")]
    log("\n".join(lines) + (f"\n{r.stderr[-2000:]}" if r.returncode else ""))
    check(r.returncode == 0 and len(lines) == 9 and all(" ok" in line for line in lines),
          f"4: python -m mobius_rag_tpu_torch.graft_entry 4 over the {len(cards)} cards: "
          f"exit {r.returncode}, {len(lines)} of 9 stages ok in "
          f"{time.perf_counter() - t0:.1f} s")


SECTIONS = {"1": ("1: the staged sharded route", (sharded_1m, sharded_70k)),
            "2": ("2: the data-parallel encoder", (mesh_encoder,)),
            "3": ("3: the segmented trainer", (segmented_trainer,)),
            "4": ("4: the dryrun twin", (dryrun,))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="0,w,1,2,3,4")
    ap.add_argument("--devices", default="cuda:0,cuda:1,cuda:2,cuda:3")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    cards = [torch.device(d) for d in args.devices.split(",")]
    if len(set(cards)) != 4:
        raise SystemExit("four_card_check: name four distinct devices")
    if cards[0].type == "cuda" and torch.cuda.device_count() < 4:
        raise SystemExit(f"four_card_check: needs four CUDA cards, found "
                         f"{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    smi = "cpu"
    if cards[0].type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    only = args.only.split(",")
    smi_line = smi.splitlines()[0] + f" x {len(smi.splitlines())}"
    if cards[0].type == "cuda":
        for key, name, fn in (("0", "0: the cards", cards_section),
                              ("w", "w: the AccumulateGrad warning", warning_section)):
            if key in only:
                section(name, fn, cards, smi)
    for key, (name, fns) in SECTIONS.items():
        if key in only:
            for fn in fns:
                section(f"{name} ({fn.__name__})", fn, cards, smi_line, args.small)
    log(json.dumps({"failed": FAILED, "seconds": round(time.perf_counter() - t_all, 1)}))
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
