"""Entry points of the flagship paths (the port of the JAX repository's
``__graft_entry__.py``).

- entry(): the forward step of the flagship model (the text encoder that
  feeds the retrieval index) on an explicit device.
- dryrun_multichip(n): one process over an n-device grid runs, in the JAX
  order and with its assertions, a dp x tp contrastive training step,
  sharded search (dense and sparse lexical layouts), live republish,
  sharded IVF, data-parallel encode, the [data, shard] serving grid,
  sharded host residency and the multi-slice merge, at tiny shapes.

The JAX dryrun forces n virtual CPU devices. Here the grid is explicit:
by default every visible CUDA device; a device named n times (``["cpu"] * 8``
in the tests, ``["cuda:0"] * 8`` on one card) runs the n-device program
on one device.

    python -m mobius_rag_tpu_torch.graft_entry [n] [--device DEV]

runs it over n visible CUDA devices, or over DEV named n times.
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fwd, (params, tokens)): ``fwd(params, tokens)`` is the 4 x 512
    encoder's forward (vocab 8,192, max_seq 128, out 1536, bf16
    activations) of 8 random token rows, on ``device``."""
    from mobius_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, init_params

    device = torch.device(device)
    cfg = EncoderConfig(
        vocab_size=8192, num_layers=4, num_heads=8,
        model_dim=512, mlp_dim=2048, max_seq=128, out_dim=1536,
    )
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))

    @torch.inference_mode()
    def fwd(params, tokens):
        return Encoder(cfg, params, device=device)(tokens)

    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(2, cfg.vocab_size, (8, cfg.max_seq)),
        dtype=torch.int32, device=device,
    )
    return fwd, (params, tokens)


def dryrun_multichip(n_devices: int = 8, devices=None) -> None:
    from mobius_rag_tpu_torch.parallel.mesh import _device_list

    devices = _device_list(devices)[:n_devices]
    assert len(devices) == n_devices, (
        f"need {n_devices} devices, have {len(devices)}: name one device "
        f"{n_devices} times to run the grid on it")
    home = devices[0]

    # ---- 1. full sharded training step (dp × tp) -------------------------
    from mobius_rag_tpu_torch.models.encoder import EncoderConfig
    from mobius_rag_tpu_torch.models.train import train_demo
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh, make_train_mesh

    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh = make_train_mesh(dp=dp, tp=tp, devices=devices)
    history = train_demo(num_steps=1, mesh=mesh, cfg=EncoderConfig.tiny(), batch=dp * 2)
    loss = float(history[-1]["loss"])
    assert np.isfinite(loss), f"non-finite training loss {loss}"
    print(f"dryrun train step ok on mesh dp={dp} tp={tp}: loss={loss:.4f}")

    # ---- 2. sharded corpus search (shard axis = all devices) -------------
    from mobius_rag_tpu_torch.index.store import ChunkStore
    from mobius_rag_tpu_torch.parallel.sharded import ShardedEngine
    from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus

    lex = sample_lexicon()
    store = ChunkStore(capacity=1024, device=home)
    store.add_chunks(toy_corpus(lex, pad_docs=40))
    smesh = make_mesh(n_devices, devices=devices)
    sharded = ShardedEngine(store, mesh=smesh)
    single = SearchEngine(store, lex, embed_fn=hash_embed, device=home)
    query_text = "timely filing deadline for sunshine health"
    req = QueryRequest(query=query_text, embedding=hash_embed([query_text])[0])
    q, _ = single.prepare_batch([req])
    out = sharded.search_arrays(q, k=5)
    top = int(out["idx"][0, 0])
    rec = store.record(top)
    assert rec is not None and rec.doc_id == "sunshine_provider_manual", (
        f"sharded search returned row {top} ({rec and rec.doc_id})"
    )
    print(f"dryrun sharded search ok on {n_devices} shards: top hit {rec.chunk_id}")

    # ---- 3. sharded search, SPARSE lexical layout -------------------------
    # (per-shard re-keyed postings tables; must agree with the dense run)
    import dataclasses

    from mobius_rag_tpu_torch.config import get_config

    sp_cfg = dataclasses.replace(get_config(), lexical_format="sparse",
                                 lexical_postings_init=8)
    sp_store = ChunkStore(sp_cfg, capacity=256, device=home)  # rows span shards
    sp_store.add_chunks(toy_corpus(lex, pad_docs=40))
    sp_sharded = ShardedEngine(sp_store, mesh=smesh, cfg=sp_cfg)
    sp_single = SearchEngine(sp_store, lex, cfg=sp_cfg, embed_fn=hash_embed, device=home)
    sp_q, _ = sp_single.prepare_batch([req])
    sp_out = sp_sharded.search_arrays(sp_q, k=5)
    assert list(sp_out["idx"][0]) == list(out["idx"][0]), (
        f"sparse sharded top-5 {sp_out['idx'][0]} != dense {out['idx'][0]}"
    )
    print("dryrun sparse-sharded search ok: top-5 matches dense")

    # ---- 4. live republish on the grid: publish → search → delete → search
    # (the sharded copy refreshes in place, no engine reconstruction)
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

    serving = SearchEngine(store, lex, embed_fn=hash_embed, sharded=sharded, device=home)
    text = ("Zephyr Plan zymurgy benefit requires prior authorization "
            "before the first fermentation consult.")
    zrec = featurize_chunk(ChunkRecord(
        chunk_id="zephyr-c0", doc_id="zephyr_doc", text=text,
        embedding=hash_embed([text])[0]), lex)
    store.publish_document("zephyr_doc", [zrec])
    assert sharded.stale, "sharded copy failed to observe the publish"
    zq = QueryRequest(query="zymurgy benefit fermentation consult")
    res = serving.search(zq, k=5)[0]  # auto-refresh inside search
    assert any(h.doc_id == "zephyr_doc" for h in res.hits), (
        f"published doc missing from sharded results: "
        f"{[h.chunk_id for h in res.hits]}"
    )
    store.delete_by_document("zephyr_doc")
    res2 = serving.search(zq, k=5)[0]
    assert not any(h.doc_id == "zephyr_doc" for h in res2.hits), (
        "deleted doc still served from the mesh"
    )
    print("dryrun live republish ok: publish→search→delete→search on the mesh")

    # ---- 5. sharded ANN (per-shard IVF) ------------------------------------
    # Full-probe IVF must reproduce the exact sharded scan.
    ann_cfg = dataclasses.replace(get_config(), ivf_nprobe=100_000)
    ann_sharded = ShardedEngine(store, mesh=smesh, cfg=ann_cfg, vector_backend="ivf")
    ann_out = ann_sharded.search_arrays(q, k=5)
    assert ann_sharded._ann is not None, "sharded IVF tables were not built"
    exact_out = sharded.search_arrays(q, k=5)
    assert set(map(int, ann_out["idx"][0])) == set(map(int, exact_out["idx"][0])), (
        f"sharded IVF full-probe {ann_out['idx'][0]} != exact {exact_out['idx'][0]}"
    )
    print("dryrun sharded IVF ok: full-probe matches exact on the mesh")

    # ---- 6. data-parallel ingest encode on the grid ------------------------
    # The reference's N embedding workers × SKIP LOCKED queue in one
    # process, the batch split over the grid. Per-row results must match
    # the single-device encoder.
    from mobius_rag_tpu_torch.models.encoder import EncoderModel, MeshEncoderModel

    enc_cfg = EncoderConfig.tiny()
    single_enc = EncoderModel(enc_cfg, device=home)
    mesh_enc = MeshEncoderModel(smesh, enc_cfg)  # same seed → same params
    sample = [f"prior authorization clause {i} for behavioral health"
              for i in range(n_devices * 3 + 1)]  # ragged: an uneven split
    e_single = single_enc(sample)
    e_mesh = mesh_enc(sample)
    err = float(np.abs(e_single - e_mesh).max())
    assert err < 1e-5, f"mesh encode diverges from single-device: {err}"
    print(f"dryrun mesh encode ok: {len(sample)} texts over {n_devices} "
          f"devices, max |Δ| {err:.2e}")

    # ---- 7. 2D data×shard serving grid -------------------------------------
    # make_serve_mesh(dp, shards): corpus replicated over `data`, query
    # batch split over it. Must reproduce the 1D results.
    from mobius_rag_tpu_torch.parallel.mesh import make_serve_mesh

    dp2 = 2 if n_devices % 2 == 0 else 1
    mesh2d = make_serve_mesh(dp2, n_devices // dp2, devices=devices)
    sharded2d = ShardedEngine(store, mesh=mesh2d)
    reqs3 = [req, zq, QueryRequest(query="prior authorization for dme")]
    q3, _ = single.prepare_batch(reqs3)  # 3 queries over dp=2: an uneven split
    out2d = sharded2d.search_arrays(q3, k=5)
    assert out2d["idx"].shape[0] == 3
    ref1d = sharded.search_arrays(q3, k=5)
    assert np.array_equal(out2d["idx"][0], ref1d["idx"][0]), (
        f"2D mesh top-5 {out2d['idx'][0]} != 1D {ref1d['idx'][0]}")
    print(f"dryrun 2D serve mesh ok: dp={dp2} × "
          f"{n_devices // dp2} shards matches 1D results")

    # ---- 8. sharded host residency (config 5 × multi-device) ---------------
    # Codes-only shards: per-shard residual-PQ tables from each shard's
    # host int8 rows; exact re-rank from host RAM after the merge.
    h_cfg = dataclasses.replace(
        get_config(), vector_residency="host", vector_dtype="int8",
        vector_backend="pq", ivf_nprobe=10 ** 6)
    h_store = ChunkStore(h_cfg, capacity=512, device=home)
    h_store.add_chunks(toy_corpus(lex, pad_docs=40))
    h_sharded = ShardedEngine(h_store, mesh=smesh, cfg=h_cfg)
    h_serving = SearchEngine(h_store, lex, cfg=h_cfg, embed_fn=hash_embed,
                             sharded=h_sharded, device=home)
    h_res = h_serving.search(req, k=5)[0]
    assert h_res.hits and h_res.hits[0].doc_id == "sunshine_provider_manual", (
        f"sharded host-residency top hit {h_res.hits and h_res.hits[0].doc_id}")
    assert h_store.index.vectors.shape[0] == 0  # the device holds codes only
    print("dryrun sharded host residency ok: codes-only shards + "
          "host exact re-rank on the mesh")

    # ---- 9. multi-slice: two device groups + hierarchical merge ----------
    # A corpus larger than one slice splits at the host layer: each slice
    # holds half the rows behind its own grid, and the cross-slice merge is
    # k results per query, fused on the host. For an embedding-only query
    # (no lexical arm) every per-row score is slice-independent, so the
    # hierarchical merge must exactly reproduce the full grid's top-k.
    from mobius_rag_tpu_torch.parallel.slices import merge_slice_results

    assert n_devices % 2 == 0, "multi-slice stage needs an even mesh"
    half = n_devices // 2
    groups = [devices[:half], devices[half:]]
    all_recs = toy_corpus(lex, pad_docs=40)
    mid = len(all_recs) // 2
    slice_engines = []
    for gi, dev_group in enumerate(groups):
        s_store = ChunkStore(capacity=512, device=dev_group[0])
        s_store.add_chunks(all_recs[mid:] if gi else all_recs[:mid])
        s_mesh = make_mesh(half, devices=dev_group)
        s_eng = SearchEngine(s_store, lex, embed_fn=hash_embed, device=dev_group[0],
                             sharded=ShardedEngine(s_store, mesh=s_mesh))
        slice_engines.append(s_eng)
    full_store = ChunkStore(capacity=1024, device=home)
    full_store.add_chunks(all_recs)
    full_eng = SearchEngine(
        full_store, lex, embed_fn=hash_embed, device=home,
        sharded=ShardedEngine(full_store, mesh=make_mesh(n_devices, devices=devices)))
    vec_req = QueryRequest(query="", embedding=hash_embed([query_text])[0],
                           tag_mode="none")
    per_slice = [e.search(vec_req, k=5) for e in slice_engines]
    merged = merge_slice_results(per_slice, k=5)[0]
    want = full_eng.search(vec_req, k=5)[0]
    got_ids = [h.chunk_id for h in merged.hits]
    want_ids = [h.chunk_id for h in want.hits]
    assert got_ids == want_ids, (
        f"hierarchical merge {got_ids} != full-mesh {want_ids}")
    # cross-slice wire cost is k results/query, not candidates
    assert all(len(r[0].hits) <= 5 for r in per_slice)
    print(f"dryrun multi-slice ok: 2 × {half}-device groups, hierarchical "
          f"k-results merge reproduces the {n_devices}-device mesh top-5")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", help="run the grid on this device, named n times")
    args = ap.parse_args()
    dryrun_multichip(args.n, devices=None if args.device is None else [args.device] * args.n)
