"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's
CUDA kernels from the checkout, holds each against its plain PyTorch
version at the main paths' shapes, then drives the strategy-a hybrid
query path (``mobius_rag_tpu_torch.query.engine.SearchEngine.search``)
twice: on a 70,000-chunk x 1536-dim corpus with the exact backend
(phase 3), and on a 1,000,000-chunk corpus with the proj ANN backend
under dense and candidate-local filter gating (phase 4).

    python3 chip_smoke.py

Progress and numbers go to stdout. The line before the last is a JSON
object describing each kernel; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
not 0 and no result line is printed. Needs one CUDA card; it does not
fall back to the CPU.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# The reference operating point (bench.py): corpus size, batch, k.
N_CHUNKS = 70_000
K = 10
BATCH = 32
N_BATCHES = 8
KERNEL_SOURCE = "mobius_rag_tpu_torch/ops/csrc/topk.cu"
KERNEL_REPLACES = "mobius_rag_tpu/ops/topk.py:151"  # _topk_kernel
PROJ_SOURCE = "mobius_rag_tpu_torch/ops/csrc/proj_scan.cu"
PROJ_REPLACES = "mobius_rag_tpu/ops/pallas_proj.py:41"  # _kernel
GATED_REPLACES = "mobius_rag_tpu/ops/pallas_proj.py:141"  # _gated_kernel
TOL_VALS = 1e-4  # float32 summation order over D=1536
TIE_GAP = 1e-5  # ids must agree wherever neighbouring values differ by more
# Phase 4: bench_1m_e2e.py's corpus and the proj backend's 1M operating
# point (ops/proj.py: nprobe 64, batch 32).
N_1M = 1_000_000
N_CENTERS = 4096
FEATURIZE_EVERY = 50
HIT_TOL = 1e-3  # dense vs local rerank scores (test_gating.py's bound)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase0_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return name, smi.splitlines()[0]


def phase1_build() -> None:
    """Build every kernel library at once: one nvcc per source, started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from mobius_rag_tpu_torch.ops import proj_scan, topk

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {src: ex.submit(mod.build_kernel)
                for src, mod in ((KERNEL_SOURCE, topk), (PROJ_SOURCE, proj_scan))}
        seconds = {src: fut.result()[1] for src, fut in futs.items()}
    for src, sec in seconds.items():
        log(f"phase 1: built {src} with nvcc in {sec:.2f} s")
    log(f"phase 1: both builds and loads took {time.perf_counter() - t0:.2f} s")


def _compare(kv, ki, rv, ri) -> float:
    """Max |value difference|; raises unless values agree within TOL_VALS
    and ids agree wherever neighbouring reference values are not tied."""
    err = (kv - rv).abs().max().item()
    tied = (rv[:, 1:] - rv[:, :-1]).abs() <= TIE_GAP
    strict = torch.ones_like(ri, dtype=torch.bool)
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    bad = ((ki != ri) & strict).sum().item()
    if not err <= TOL_VALS or bad:
        raise AssertionError(f"kernel disagrees with plain version: "
                             f"max_abs_err={err} mismatched ids={bad}")
    return err


def _median_ms(fn, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def phase2_kernel() -> dict:
    from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk, masked_topk_reference

    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, c, d, dtype, gate=0.3, live=None, pen_form="bc", min_sim=True):
        v = torch.randn(c, d, device="cuda", generator=g)
        v = (v / v.norm(dim=1, keepdim=True)).to(dtype).contiguous()
        q = torch.randn(b, d, device="cuda", generator=g)
        q = q / q.norm(dim=1, keepdim=True)
        shape = (b, c) if pen_form == "bc" else (c,)
        pen = torch.where(torch.rand(shape, device="cuda", generator=g) < gate,
                          NEG_INF, 0.0)
        if live is not None:
            pen[..., live:] = NEG_INF
        ms = torch.where(torch.arange(b, device="cuda") % 2 == 1, 0.02, 0.0) \
            if min_sim else None
        return q, v, pen.contiguous(), ms

    c_main = 70_144  # capacity of the 70,000-row store
    cases = {
        "main_f32": (inputs(BATCH, c_main, 1536, torch.float32, live=N_CHUNKS), 40),
        "main_bf16": (inputs(BATCH, c_main, 1536, torch.bfloat16, live=N_CHUNKS), 40),
        "C=1000": (inputs(4, 1000, 1536, torch.float32), 40),
        "m=1024": (inputs(8, 4096, 1536, torch.float32), 1024),
        "fewer_live_than_m": (inputs(4, 2048, 1536, torch.float32, live=25), 40),
        "penalty[C]": (inputs(4, 3000, 1536, torch.float32, pen_form="c",
                              min_sim=False), 40),
        "B=1": (inputs(1, c_main, 1536, torch.float32), 40),
    }
    q, v, pen, ms = cases["C=1000"][0]
    pen[1] = NEG_INF  # one query with every row gated
    worst = 0.0
    timing = {}
    for name, ((q, v, pen, ms), m) in cases.items():
        kv, ki = masked_topk(q, v, pen, ms, m)
        torch.cuda.synchronize()
        rv, ri = masked_topk_reference(q, v, pen, ms, m)
        err = _compare(kv, ki, rv, ri)
        worst = max(worst, err)
        line = f"phase 2: {name} B={q.shape[0]} C={v.shape[0]} m={m} " \
               f"{str(v.dtype)[6:]}: max_abs_err={err:.3g} ids agree"
        if name.startswith("main"):
            t_k = _median_ms(lambda: masked_topk(q, v, pen, ms, m))
            t_p = _median_ms(lambda: masked_topk_reference(q, v, pen, ms, m))
            timing[name] = (t_k, t_p)
            line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median of 20)"
        log(line)
    return {"max_abs_err": worst, "timing": timing}


def _gate_inputs(g, b, n_probe, nlist, pad, p, tw=8):
    """Random proj-scan inputs shaped like the 1M tables: codes over the
    full int8 range, gate words with small metadata ids, the valid and
    regulator flags, a float scale, a row id and sparse tag bits, and one
    query per tag mode (plus "any"/"none" filters)."""
    from mobius_rag_tpu_torch.ops.proj import gate_widths

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device="cuda", generator=g,
                             dtype=torch.int64).to(torch.int32)

    probe = ri(0, nlist, (b, n_probe))
    codes = ri(-127, 128, (nlist, pad, p)).to(torch.int8)
    q8 = ri(-127, 128, (b, p)).to(torch.int8)
    w_full, _ = gate_widths(tw)
    sparse_bits = ri(0, 1 << 30, (nlist, 3 * tw, pad)) & ri(0, 1 << 30, (nlist, 3 * tw, pad)) \
        & ri(0, 1 << 30, (nlist, 3 * tw, pad))
    words = torch.zeros((nlist, w_full, pad), dtype=torch.int32, device="cuda")
    words[:, 0] = ri(0, 4, (nlist, pad)) | (ri(0, 2, (nlist, pad)) << 16)
    words[:, 1] = (ri(0, 3, (nlist, pad)) | (ri(0, 8, (nlist, pad)).clamp(max=1) << 16)
                   | (ri(0, 2, (nlist, pad)) << 17))
    words[:, 2] = (torch.rand((nlist, pad), device="cuda", generator=g) * 1e-2).view(torch.int32)
    words[:, 3] = ri(0, 1 << 20, (nlist, pad))
    words[:, 4:4 + 3 * tw] = sparse_bits
    qmeta = torch.stack([ri(0, 4, (b,)), ri(0, 2, (b,)), ri(0, 3, (b,)),
                         torch.arange(b, device="cuda", dtype=torch.int32) % 3,
                         ri(0, 2, (b,)), ri(0, 2, (b,)), ri(0, 2, (b,)), ri(0, 2, (b,))], 1)
    qmeta[1::4, :3] = 0xFFFE  # "any" payer, state and program
    # query 0: a payer no slot has, no inherited authority, strict/auto
    # mode — every one of its slots is gated
    qmeta[0, 0], qmeta[0, 3], qmeta[0, 5] = 0xFFFD, 0, 0
    qbits = ri(0, 1 << 30, (b, 3 * tw)) & ri(0, 1 << 30, (b, 3 * tw))
    return probe, qmeta.contiguous(), qbits.contiguous(), codes, words, q8


def phase2_proj_kernels() -> dict:
    """The two proj-scan kernels against their plain versions: raw dots
    and row ids bitwise, gated scores bitwise (live slots and -1e30)."""
    from mobius_rag_tpu_torch.ops.proj_scan import (
        proj_blocks, proj_blocks_reference, proj_gated_blocks,
        proj_gated_blocks_reference)

    g = torch.Generator(device="cuda").manual_seed(1)
    # (name, B, P, nlist, pad, p): the 1M tables (1,000 clusters + 2
    # reserved slabs, pad 2048, p 256, nprobe 64 + 2), the 10M config's
    # p=192, p=36 (a 4-byte tail beyond 32), p=37 (rows not 4-aligned: the
    # byte loop), and pads that are not a multiple of the 256-slot tile
    cases = [("main_1M", BATCH, 66, 1002, 2048, 256), ("p=192", 8, 10, 40, 512, 192),
             ("p=36", 4, 6, 9, 300, 36), ("p=37", 3, 5, 7, 100, 37),
             ("pad=520", 5, 7, 11, 520, 64)]
    timing = {}
    worst = 0.0
    for name, b, n_probe, nlist, pad, p in cases:
        probe, qmeta, qbits, codes, words, q8 = _gate_inputs(g, b, n_probe, nlist, pad, p)
        raw = proj_blocks(probe, codes, q8)
        torch.cuda.synchronize()
        ref = proj_blocks_reference(probe, codes, q8)
        worst = max(worst, (raw - ref).abs().max().item())
        if not torch.equal(raw, ref):
            raise AssertionError(f"proj_blocks disagrees with its plain version ({name})")
        live = []
        for level in (0, 1, 2):
            score, rid = proj_gated_blocks(probe, qmeta, qbits, codes, words, q8,
                                           tw=8, tag_level=level)
            torch.cuda.synchronize()
            rs, rr = proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8,
                                                 tw=8, tag_level=level)
            worst = max(worst, (score - rs).abs().max().item())
            if not (torch.equal(score, rs) and torch.equal(rid, rr)):
                raise AssertionError(f"proj_gated_blocks disagrees with its plain "
                                     f"version ({name}, tag_level {level})")
            if (score[0] > -1e29).any():
                raise AssertionError("a query whose every slot is gated has a live slot")
            live.append(round((rs > -1e29).float().mean().item(), 4))
        line = (f"phase 2: proj {name} B={b} P={n_probe} nlist={nlist} pad={pad} p={p}: "
                f"raw dots bitwise; gated scores and row ids bitwise at tag levels "
                f"0/1/2 (live share {live})")
        if name == "main_1M":
            t_k = _median_ms(lambda: proj_blocks(probe, codes, q8))
            t_p = _median_ms(lambda: proj_blocks_reference(probe, codes, q8))
            g_k = _median_ms(lambda: proj_gated_blocks(probe, qmeta, qbits, codes, words,
                                                       q8, tw=8, tag_level=2))
            g_p = _median_ms(lambda: proj_gated_blocks_reference(
                probe, qmeta, qbits, codes, words, q8, tw=8, tag_level=2))
            timing = {"proj_blocks": (t_k, t_p), "proj_gated_blocks": (g_k, g_p)}
            line += (f"; proj_blocks kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                     f"proj_gated_blocks (level 2) kernel {g_k:.4f} ms, plain "
                     f"{g_p:.4f} ms (median of 20)")
        log(line)
    codes = torch.full((12, 32, 128), 127, dtype=torch.int8, device="cuda")
    q8 = torch.full((4, 128), -127, dtype=torch.int8, device="cuda")
    probe = torch.randint(0, 12, (4, 5), device="cuda", generator=g, dtype=torch.int64)
    raw = proj_blocks(probe.to(torch.int32), codes, q8)
    if not bool((raw == float(128 * 127 * -127)).all()):
        raise AssertionError("proj_blocks is not exact at the +-127 extremes")
    log("phase 2: proj_blocks exact at the +-127 extremes (p=128)")
    return {"max_abs_err": worst, "timing": timing}


def build_bench_store(cfg):
    """bench.py's corpus (bench.py:59-97), same seed and draw order, in the
    port's ChunkStore on the card. Returns (store, lexicon, vectors, rng,
    payers)."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
    from mobius_rag_tpu_torch.testing import sample_lexicon

    rng = np.random.default_rng(7)
    lexicon = sample_lexicon()
    vectors = rng.standard_normal((N_CHUNKS, cfg.embed_dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    payers = ["sunshine_health", "aetna", "molina", ""]
    recs = []
    for i in range(N_CHUNKS):
        r = ChunkRecord(
            chunk_id=f"c{i}", doc_id=f"doc{i % 7000}", source_id=f"s{i}",
            text=f"policy paragraph {i} covering claims filing and authorization "
                 f"requirements for plan {i % 97}.",
            embedding=vectors[i],
            payer=payers[i % len(payers)], state="FL",
            authority_level=int(rng.integers(0, 5)),
            filename=f"doc{i % 7000}.pdf",
        )
        r.lexical_weights = {}
        r.d_tags = [int(rng.integers(0, 12))]
        recs.append(r)
    for r in recs[:64]:
        featurize_chunk(r, lexicon, cfg)
    store = ChunkStore(cfg, capacity=N_CHUNKS, device="cuda")
    lex_sample = np.zeros((64, cfg.lexical_buckets), np.float32)
    for i, r in enumerate(recs[:64]):
        for b, w in r.lexical_weights.items():
            lex_sample[i, b % cfg.lexical_buckets] += w
    store.bulk_load(recs, vectors=vectors, lexical=lex_sample)
    torch.cuda.synchronize()
    return store, lexicon, vectors, rng, payers


def phase3_slice(smi: str) -> dict:
    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.ops.topk import masked_topk, masked_topk_reference
    from mobius_rag_tpu_torch.query.engine import (
        QueryRequest, SearchEngine, arm_candidates, filter_masks, gate_penalty)

    cfg = get_config()
    if (cfg.embed_dim, cfg.lexical_buckets, cfg.vector_backend, cfg.lexical_format,
            cfg.vector_dtype) != (1536, 16384, "exact", "dense", "float32"):
        raise RuntimeError(f"not the reference configuration: {cfg} "
                           "(unset the MRAG_* variables)")
    t0 = time.perf_counter()
    store, lexicon, vectors, rng, payers = build_bench_store(cfg)
    log(f"phase 3: store of {store.size} rows, capacity {store.capacity}, "
        f"D={cfg.embed_dim}, H={cfg.lexical_buckets} built in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = SearchEngine(store, lexicon, device="cuda")

    nq = 64
    q_rows = rng.choice(N_CHUNKS, nq, replace=False)
    q_vecs = vectors[q_rows] + 0.15 * rng.standard_normal(
        (nq, cfg.embed_dim)).astype(np.float32)
    q_vecs /= np.linalg.norm(q_vecs, axis=1, keepdims=True)
    oracle = torch.from_numpy(q_vecs).cuda().double() @ \
        torch.from_numpy(vectors).cuda().double().T
    exact = torch.argsort(-oracle, dim=1)[:, :K].cpu().numpy()
    del oracle
    recall_reqs = [QueryRequest(query="claims filing authorization requirements",
                                embedding=q_vecs[i], tag_mode="none", mode="recall")
                   for i in range(nq)]
    bench_reqs = [QueryRequest(query=f"timely filing deadline for {payers[i % 3]} claims",
                               embedding=q_vecs[i % nq]) for i in range(BATCH)]

    # ---- the main path, counted ------------------------------------------
    masked_topk.launches = 0
    batches = 0
    recalls = []
    for off in range(0, nq, BATCH):
        results = engine.search(recall_reqs[off:off + BATCH], k=K)
        batches += 1
        for bi, res in enumerate(results):
            got = {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
            recalls.append(len(got & set(map(int, exact[off + bi]))) / K)
    recall = float(np.mean(recalls))
    hybrid = engine.search(bench_reqs, k=K)
    batches += 1
    for res in hybrid:
        if not res.hits:
            raise AssertionError(f"no hits for {res.query!r}")
        for h in res.hits:
            if not (np.isfinite(h.score) and 0.0 <= h.score <= 1.0):
                raise AssertionError(f"bad rerank score {h.score}")
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    singles = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search(one, k=K)
        singles.append((time.perf_counter() - t0) * 1e3)
    batches += 11
    piped = engine.search_pipelined([bench_reqs, bench_reqs], k=K)
    batches += 2
    launches = masked_topk.launches
    # ---- end of the counted run ------------------------------------------

    if launches != batches:
        raise AssertionError(f"kernel launched {launches} times for {batches} batches")
    if [[h.chunk_id for h in r.hits] for r in piped[0]] != \
            [[h.chunk_id for h in r.hits] for r in hybrid]:
        raise AssertionError("search_pipelined disagrees with search")
    if recall < 0.99:
        raise AssertionError(f"vector-arm recall@{K} {recall} < 0.99")

    # the vector arm's m candidates against the plain version on one batch
    q, _ = engine.prepare_batch(bench_reqs)
    m = min(K * cfg.over_fetch, store.capacity)
    with torch.inference_mode():
        q = dict(q, vec=q["vec"].float())
        vals, gidx, _, _ = arm_candidates(store.index, q, K, m)
        strict, relaxed, open_mask, _ = filter_masks(store.index, q)
        penalty = gate_penalty(strict, relaxed, open_mask, q, K)
        rv, ri = masked_topk_reference(q["vec"], store.index.vectors, penalty,
                                       q["min_sim"], m)
    _compare(vals[0], gidx[0], rv, ri)

    qps = float(np.median(rounds))
    single_ms = float(np.median(singles))
    log(f"phase 3: vector-arm recall@{K} vs exact fp64 oracle {recall:.4f} ({nq} queries)")
    log(f"phase 3: {len(hybrid)} hybrid requests, every one with hits; kernel "
        f"launches {launches} == search batches {batches}; vector-arm "
        f"candidates equal the plain version on one batch")
    log(f"phase 3: {qps:.1f} queries/s at batch {BATCH} (sync, median of "
        f"{[round(x, 1) for x in rounds]}), single query {single_ms:.3f} ms "
        f"(median of 10) on {smi}")
    return {"launches": launches, "recall": recall, "qps": qps, "single_ms": single_ms}

# ---------------------------------------------------------------------------
# phase 4: the proj backend at 1M rows, dense and candidate-local gating
# ---------------------------------------------------------------------------

_TEXT_1M = "policy paragraph on claims filing and authorization requirements."
# (query, payer): payer filters with strict gating; the corpus has no
# j-tags, so every one auto-relaxes to its d-tag. A row of payer p carries
# d-tag i % 12 with i % 4 == p, so the last request's filter admits no row.
_HYBRID_1M = [("timely filing deadline for sunshine_health claims", "sunshine_health"),
              ("claim appeals deadline for aetna", "aetna"),
              ("prior authorization requirements for molina claims", "molina"),
              ("behavioral health outpatient therapy for aetna", "aetna"),
              ("timely filing deadline for molina claims", "molina")]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _stage_timer(stages: dict, key: str, fn, dev="cuda"):
    def wrapped(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(dev)
        stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


class _StageTimers:
    """Times the ANN build's stages by wrapping the functions the engine
    calls (restored on exit)."""

    def __init__(self, stages: dict, dev: str):
        from mobius_rag_tpu_torch.index import ivf
        from mobius_rag_tpu_torch.ops.proj import ProjGate
        from mobius_rag_tpu_torch.query.gating import DTagPostings

        self.patches = [(ivf, "_kmeans", "k-means"), (ivf, "_topj_block", "capacity assign"),
                        (ivf, "_capacity_assign", "capacity assign"),
                        (ivf, "_fill_members", "capacity assign")]
        self.class_patches = [(ProjGate, "build", "gate pack"),
                              (DTagPostings, "build", "d-tag postings")]
        self.stages = stages
        self.dev = dev
        self.saved = []

    def __enter__(self):
        for mod, name, key in self.patches:
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))
            setattr(mod, name, _stage_timer(self.stages, key, orig, self.dev))
        for cls, name, key in self.class_patches:
            orig = cls.__dict__[name]
            self.saved.append((cls, name, orig))
            setattr(cls, name, classmethod(_stage_timer(self.stages, key, orig.__func__,
                                                              self.dev)))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self.saved):
            setattr(obj, name, orig)


def build_1m_store(cfg, stages: dict, dev: str, n_rows: int):
    """bench_1m_e2e.py's corpus (bench_1m_e2e.py:64-108), made on the card
    from a seeded torch.Generator: 4,096 unit centers plus 0.05 N(0, 1)
    noise per dimension, normalized, bf16; payers cycling, state FL,
    authority i % 5, d-tags [i % 12], doc i % 70,000; every 50th record
    featurized with the sample lexicon (sparse postings)."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
    from mobius_rag_tpu_torch.testing import sample_lexicon

    d = cfg.embed_dim
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(11)
    centers = torch.randn((N_CENTERS, d), device=dev, generator=g)
    centers /= centers.norm(dim=1, keepdim=True)
    vectors = torch.empty((n_rows, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_rows, 125_000):
        n = min(125_000, n_rows - lo)
        rows = torch.randint(0, N_CENTERS, (n,), device=dev, generator=g)
        v = centers[rows] + 0.05 * torch.randn((n, d), device=dev, generator=g)
        vectors[lo:lo + n] = (v / v.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    del centers, rows, v
    _sync(dev)
    stages["corpus on the card"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lexicon = sample_lexicon()
    payers = ["sunshine_health", "aetna", "molina", ""]
    empty = np.zeros(0, np.float32)  # the rows come as one device tensor
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"doc{i % 70_000}", source_id=f"s{i}",
                        text=_TEXT_1M, embedding=empty, payer=payers[i & 3], state="FL",
                        authority_level=i % 5, d_tags=[i % 12])
            for i in range(n_rows)]
    for r in recs[::FEATURIZE_EVERY]:
        featurize_chunk(r, lexicon, cfg)
    stages["records"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = ChunkStore(cfg, capacity=n_rows, device=dev)
    store.bulk_load(recs, vectors=vectors)
    _sync(dev)
    stages["bulk_load"] = time.perf_counter() - t0
    return store, lexicon, vectors


def _exact_top(vectors: torch.Tensor, q: torch.Tensor, k: int) -> np.ndarray:
    """Exact fp64 cosine top-k of q [n, D] over the bf16 rows, blockwise."""
    qd = q.double()
    best_v, best_i = None, None
    for lo in range(0, vectors.shape[0], 125_000):
        s = qd @ vectors[lo:lo + 125_000].double().T
        v, i = torch.topk(s, k, dim=1)
        i = i + lo
        if best_v is not None:
            v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy()


def _device_busy_share(engine, reqs, dev, n: int = 4) -> tuple[float, float, dict]:
    """torch.profiler over n searches: (device kernel ms per search, wall
    ms per search, kernel ms per search by name for the top entries).
    Sums the device-side events only (the CPU-side operator events carry
    their kernels' time too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(dev).type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.search(reqs, k=K)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0] or ev.name[:40]
            by_name[name] = by_name.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return sum(by_name.values()), wall, top


def _drive_path(engine, recall_reqs, exact, self_reqs, self_rows, bench_reqs) -> dict:
    """The counted run of one path: recall, self-hit, hybrid, qps rounds,
    single queries and one search_pipelined. Returns its numbers, its
    results and the launch counts."""
    from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks, proj_gated_blocks
    from mobius_rag_tpu_torch.ops.topk import masked_topk

    proj_blocks.launches = proj_gated_blocks.launches = masked_topk.launches = 0
    batches = 0
    recalls = []
    for off in range(0, len(recall_reqs), BATCH):
        results = engine.search(recall_reqs[off:off + BATCH], k=K)
        batches += 1
        for bi, res in enumerate(results):
            got = {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
            recalls.append(len(got & set(map(int, exact[off + bi]))) / K)
    self_res = engine.search(self_reqs, k=K)
    batches += 1
    self_hit = float(np.mean([int(row) in {h["row"] for h in res.telemetry["arms"]["vector"][:K]}
                              for row, res in zip(self_rows, self_res)]))
    hybrid = engine.search(bench_reqs, k=K)
    batches += 1
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_BATCHES):
            engine.search(bench_reqs, k=K)
        rounds.append(BATCH * N_BATCHES / (time.perf_counter() - t0))
        batches += N_BATCHES
    one = [bench_reqs[0]]
    engine.search(one, k=K)
    singles = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search(one, k=K)
        singles.append((time.perf_counter() - t0) * 1e3)
    batches += 11
    piped = engine.search_pipelined([bench_reqs, bench_reqs], k=K)
    batches += 2
    return {"batches": batches, "recall": float(np.mean(recalls)), "self_hit": self_hit,
            "hybrid": hybrid, "piped": piped, "qps": float(np.median(rounds)),
            "rounds": rounds, "single_ms": float(np.median(singles)),
            "launches": {"proj_blocks": proj_blocks.launches,
                         "proj_gated_blocks": proj_gated_blocks.launches,
                         "masked_topk": masked_topk.launches}}


def _hits(res):
    return [(h.chunk_id, h.score) for h in res.hits]


def phase4_proj(smi: str, dev: str = "cuda", n_rows: int = N_1M) -> dict:
    import dataclasses
    import tempfile

    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.ops import proj as proj_mod
    from mobius_rag_tpu_torch.ops.proj_scan import (proj_blocks_reference,
                                                      proj_gated_blocks_reference)
    from mobius_rag_tpu_torch.ops.topk import NEG_INF
    from mobius_rag_tpu_torch.query.engine import (
        QueryRequest, SearchEngine, arm_candidates, filter_masks, gate_penalty,
        lexical_raw)

    base = dataclasses.replace(
        get_config(), embed_dim=1536, vector_dtype="bfloat16", lexical_format="sparse",
        lexical_buckets=16384, tag_words=8, phrase_words=64, vector_backend="proj",
        proj_p=256, ivf_nlist=0, ivf_nprobe=64, ann_reserve_slabs=2, over_fetch=4)
    cfg_a = dataclasses.replace(base, gating="dense")
    cfg_b = dataclasses.replace(base, gating="local")
    stages: dict = {}
    t_all = time.perf_counter()
    store, lexicon, vectors = build_1m_store(cfg_a, stages, dev, n_rows)
    fill = store._lex_fill
    log(f"phase 4: store of {store.size} rows, capacity {store.capacity}; sparse postings "
        f"P={store._lex_cols_np.shape[1]}, {int((fill > 0).sum())} buckets in use, "
        f"{int((fill > cfg_a.lexical_postings_init).sum())} grown past "
        f"{cfg_a.lexical_postings_init}")
    engine_a = SearchEngine(store, lexicon, cfg=cfg_a, device=dev)
    engine_b = SearchEngine(store, lexicon, cfg=cfg_b, device=dev)
    with _StageTimers(stages, dev):
        t0 = time.perf_counter()
        ann = engine_a.ensure_ann()
        _sync(dev)
        t_ann = time.perf_counter() - t0
        stages["PCA + encode"] = t_ann - stages["k-means"] - stages["capacity assign"]
        # path B serves the same tables, carried over through the ann file
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            engine_a.save_ann(f"{tmp}/ann.npz")
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine_b.load_ann(f"{tmp}/ann.npz")
            _sync(dev)
            t_load = time.perf_counter() - t0
        engine_b._ensure_local_structs(engine_b.ensure_ann())
    log(f"phase 4: tables nlist={ann.nlist} (base {ann.base_nlist}, spill slabs "
        f"{ann.reserve_start - ann.base_nlist}, reserved {ann.nlist - ann.reserve_start}), "
        f"pad={ann.pad}, p={ann.bytes_per_row}; ann file save {t_save:.2f} s, "
        f"load {t_load:.2f} s")
    log("phase 4: build stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # requests: recall (corpus rows + 0.15 noise, as phase 3), self-hit
    # (exact corpus rows), hybrid (payer filters, strict with auto-relax)
    g = torch.Generator(device=dev).manual_seed(3)
    nq = 64
    q_rows = torch.randperm(n_rows, device=dev, generator=g)[:nq]
    qv = vectors[q_rows].float() + 0.15 * torch.randn((nq, cfg_a.embed_dim), device=dev,
                                                      generator=g)
    qv /= qv.norm(dim=1, keepdim=True)
    exact = _exact_top(vectors, qv, K)
    q_np = qv.cpu().numpy()
    recall_reqs = [QueryRequest(query="claims filing authorization requirements",
                                embedding=q_np[i], tag_mode="none", mode="recall")
                   for i in range(nq)]
    self_rows = np.arange(0, n_rows, n_rows // BATCH)[:BATCH]
    self_np = vectors[torch.from_numpy(self_rows).to(dev)].float().cpu().numpy()
    self_reqs = [QueryRequest(query="claims filing authorization", embedding=self_np[i],
                              tag_mode="none", mode="recall") for i in range(BATCH)]
    bench_reqs = [QueryRequest(query=_HYBRID_1M[i % len(_HYBRID_1M)][0],
                               payer=_HYBRID_1M[i % len(_HYBRID_1M)][1],
                               embedding=q_np[i % nq]) for i in range(BATCH)]

    # ---- the main path, counted, once per gating --------------------------
    runs = {}
    for path, engine, kernel in (("A", engine_a, "proj_blocks"),
                                 ("B", engine_b, "proj_gated_blocks")):
        r = _drive_path(engine, recall_reqs, exact, self_reqs, self_rows, bench_reqs)
        other = "proj_gated_blocks" if kernel == "proj_blocks" else "proj_blocks"
        on_card = torch.device(dev).type == "cuda"  # the CPU runs the plain versions
        if on_card and (r["launches"][kernel] != r["batches"] or r["launches"][other]
                        or r["launches"]["masked_topk"]):
            raise AssertionError(f"path {path}: launches {r['launches']} for "
                                 f"{r['batches']} search batches")
        runs[path] = r
    # ---- end of the counted runs -------------------------------------------

    ra, rb = runs["A"], runs["B"]
    for path, r in runs.items():
        if [_hits(x) for x in r["piped"][0]] != [_hits(x) for x in r["hybrid"]]:
            raise AssertionError(f"path {path}: search_pipelined disagrees with search")
        for res in r["hybrid"]:
            for h in res.hits:
                if not (np.isfinite(h.score) and 0.0 <= h.score <= 1.0):
                    raise AssertionError(f"path {path}: bad rerank score {h.score}")

    # one batch: the arms under both gatings, and the gate's admissions
    m = min(K * cfg_a.over_fetch, store.capacity)
    qa, exps = engine_a.prepare_batch(bench_reqs)
    qb, _ = engine_b.prepare_batch(bench_reqs)
    local = engine_b._ensure_local_structs(engine_b._ann)
    with torch.inference_mode():
        qa = dict(qa, vec=qa["vec"].float())
        qb = dict(qb, vec=qb["vec"].float())
        va, ia, _, sa = arm_candidates(store.index, qa, K, m, ann=engine_a._ann,
                                       nprobe=engine_a.effective_nprobe)
        vb, ib, _, sb = arm_candidates(store.index, qb, K, m, ann=engine_b._ann,
                                       nprobe=engine_b.effective_nprobe, local=local,
                                       tag_level=engine_b._batch_tag_level(exps))
        strict, relaxed, open_mask, _ = filter_masks(store.index, qa)
        penalty = gate_penalty(strict, relaxed, open_mask, qa, K)
        admitted = (penalty > NEG_INF / 2).sum(dim=1).cpu().numpy()
        lex_admitted = ((lexical_raw(store.index, qa) > 0)
                        & (penalty > NEG_INF / 2)).sum(dim=1).cpu().numpy()
        # the plain version of each path's vector-arm function, same inputs
        plain = {}
        saved = (proj_mod.proj_blocks, proj_mod.proj_gated_blocks)
        proj_mod.proj_blocks = proj_blocks_reference
        proj_mod.proj_gated_blocks = proj_gated_blocks_reference
        try:
            plain["A"] = arm_candidates(store.index, qa, K, m, ann=engine_a._ann,
                                        nprobe=engine_a.effective_nprobe)
            plain["B"] = arm_candidates(store.index, qb, K, m, ann=engine_b._ann,
                                        nprobe=engine_b.effective_nprobe, local=local,
                                        tag_level=engine_b._batch_tag_level(exps))
        finally:
            proj_mod.proj_blocks, proj_mod.proj_gated_blocks = saved
    for path, (v, i) in (("A", (va, ia)), ("B", (vb, ib))):
        pv, pi = plain[path][0], plain[path][1]
        live = pv[0] > NEG_INF / 2
        if not (torch.equal(live, v[0] > NEG_INF / 2) and torch.equal(v[0][live], pv[0][live])
                and torch.equal(i[0][live], pi[0][live])):
            raise AssertionError(f"path {path}: vector-arm candidates differ from the "
                                 "plain version's")
    # dense vs local: every arm's live candidates, the strict counts
    for arm, name in enumerate(("vector", "lexical", "d-tag")):
        live = va[arm] > NEG_INF / 2
        if not (torch.equal(live, vb[arm] > NEG_INF / 2)
                and torch.equal(va[arm][live], vb[arm][live])
                and torch.equal(ia[arm][live], ib[arm][live])):
            raise AssertionError(f"dense and local gating disagree on the {name} arm")
    if not torch.equal(sa[:, 0], sb[:, 0]):
        raise AssertionError("dense and local strict counts differ")
    # dense vs local: the hits. Local gating gives the other arms'
    # candidates a lexical signal only from the lexical arm's top m
    # (gating.lex_signal_join, the JAX package's contract), so hits must
    # match wherever the gate admits at most m lexical matches.
    under = [b for b in range(BATCH) if lex_admitted[b] <= m]
    for b in range(BATCH):
        a_res, b_res = ra["hybrid"][b], rb["hybrid"][b]
        if a_res.telemetry["strict_count"] != b_res.telemetry["strict_count"]:
            raise AssertionError(f"request {b}: strict counts differ")
        if admitted[b] > 0 and not a_res.hits:
            raise AssertionError(f"request {b}: the gate admits {admitted[b]} rows "
                                 "but there are no hits")
        if b in under:
            ha, hb = _hits(a_res), _hits(b_res)
            if {c for c, _ in ha} != {c for c, _ in hb} or any(
                    abs(x[1] - y[1]) > HIT_TOL for x, y in zip(ha, hb)):
                raise AssertionError(f"request {b}: dense and local hits differ: {ha} {hb}")
    log(f"phase 4: dense and local gating agree on all three arms' live candidates "
        f"(vector arm bitwise) and on the strict counts of {BATCH} hybrid requests; "
        f"hits equal (scores within {HIT_TOL}) on the {len(under)} requests whose "
        f"gate admits <= m={m} lexical matches (the other {BATCH - len(under)} admit "
        f"{sorted(set(int(x) for x in lex_admitted if x > m))}); gate admits "
        f"{sorted(set(int(x) for x in admitted))} rows")
    log("phase 4: each path's vector-arm candidates with the kernel equal the plain "
        "version's on one batch (ids identical, values bitwise on live entries)")

    for path, engine in (("A", engine_a), ("B", engine_b)):
        r = runs[path]
        busy, wall, top = _device_busy_share(engine, bench_reqs, dev)
        log(f"phase 4: path {path} ({engine.cfg.gating} gating): launches {r['launches']} "
            f"for {r['batches']} batches; vector-arm recall@{K} vs exact fp64 oracle "
            f"{r['recall']:.4f} ({nq} queries); self-hit@{K} {r['self_hit']:.4f} "
            f"({BATCH} corpus rows); {r['qps']:.1f} queries/s at batch {BATCH} (rounds "
            f"{[round(x, 1) for x in r['rounds']]}); single query {r['single_ms']:.3f} ms "
            f"(median of 10); device busy {busy:.3f} of {wall:.3f} ms per batch "
            f"({100 * busy / wall:.1f}%), by kernel (ms/batch) "
            + ", ".join(f"{k} {v:.3f}" for k, v in top.items()) + f" on {smi}")

    # publish + delete through the incremental reserved-slab path
    rng = np.random.default_rng(5)
    emb = rng.standard_normal(cfg_a.embed_dim).astype(np.float32)
    emb /= np.linalg.norm(emb)
    text = "Xylophone rider reimburses tuning forks within 45 days."
    tables = (id(engine_a._ann), id(engine_b._ann))
    store.publish_document("fresh-doc", [ChunkRecord(
        chunk_id="fresh-1", doc_id="fresh-doc", source_id="fresh-s1", text=text,
        embedding=emb, payer="sunshine_health", state="FL")])

    def served(engine, payer, tag_mode):
        res = engine.search(QueryRequest(query=text, embedding=emb, payer=payer,
                                         tag_mode=tag_mode), k=K)[0]
        return any(h.chunk_id == "fresh-1" for h in res.hits)

    for engine in (engine_a, engine_b):
        if not served(engine, "sunshine_health", "none"):
            raise AssertionError(f"{engine.cfg.gating}: a published row is not served")
        if served(engine, "molina", "strict"):
            raise AssertionError(f"{engine.cfg.gating}: the payer filter admits a "
                                 "published row of another payer")
    store.delete_by_document("fresh-doc")
    for engine in (engine_a, engine_b):
        if served(engine, "sunshine_health", "none"):
            raise AssertionError(f"{engine.cfg.gating}: a deleted row is still served")
    if (id(engine_a._ann), id(engine_b._ann)) != tables or \
            engine_a._ann_cursor != 1 or engine_b._ann_cursor != 1:
        raise AssertionError("the publish and delete did not go through the "
                             "incremental reserved-slab path")
    log("phase 4: a published document is served under its payer filter and not "
        "under another payer's, and gone after its delete, on both paths, through "
        "the reserved slabs (no rebuild)")
    log(f"phase 4: {time.perf_counter() - t_all:.1f} s")
    return {"launches": {"proj_blocks": ra["launches"]["proj_blocks"],
                         "proj_gated_blocks": rb["launches"]["proj_gated_blocks"]}}


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase0_device()
    phase1_build()
    k = phase2_kernel()
    kp = phase2_proj_kernels()
    s = phase3_slice(smi)
    p4 = phase4_proj(smi)
    t_k, t_p = k["timing"]["main_f32"]
    kernels = [{
        "name": "masked_topk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": s["launches"],
        "max_abs_err": k["max_abs_err"], "ms": t_k, "plain_ms": t_p}]
    for name, replaces in (("proj_blocks", PROJ_REPLACES),
                           ("proj_gated_blocks", GATED_REPLACES)):
        ms, plain_ms = kp["timing"][name]
        kernels.append({"name": name, "route": "cuda", "source": PROJ_SOURCE,
                        "replaces": replaces, "launches": p4["launches"][name],
                        "max_abs_err": kp["max_abs_err"], "ms": ms, "plain_ms": plain_ms})
    log(f"command time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
