"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's
CUDA kernel from the checkout, holds it against its plain PyTorch version
at the main path's shapes, then drives the strategy-a hybrid query path
(``mobius_rag_tpu_torch.query.engine.SearchEngine.search``) on a
70,000-chunk x 1536-dim corpus and checks what comes out.

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
TOL_VALS = 1e-4  # float32 summation order over D=1536
TIE_GAP = 1e-5  # ids must agree wherever neighbouring values differ by more


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
    from mobius_rag_tpu_torch.ops.topk import build_kernel

    t0 = time.perf_counter()
    _, seconds = build_kernel()
    log(f"phase 1: built {KERNEL_SOURCE} with nvcc in {seconds:.2f} s "
        f"(load {time.perf_counter() - t0 - seconds:.2f} s)")


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


def main() -> None:
    kind, smi = phase0_device()
    phase1_build()
    k = phase2_kernel()
    s = phase3_slice(smi)
    t_k, t_p = k["timing"]["main_f32"]
    print(json.dumps({"kernels": [{
        "name": "masked_topk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": s["launches"],
        "max_abs_err": k["max_abs_err"], "ms": t_k, "plain_ms": t_p}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
