"""ChunkStore parity: the port's store and the JAX package's, fed the same
records through the same sequence of writes, hold equal state after every
step — every index field (bitsets compared as u32, bf16 bitwise) and the
host row maps — and each restores the other's snapshots. Exact: these
are copies and casts, no arithmetic differs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mobius_rag_tpu.config import get_config as jax_config
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu_torch.config import get_config as torch_config
from mobius_rag_tpu_torch.index.store import (ChunkStore as TStore, DeviceIndex,
                                              index_from_numpy, pack_bits, unpack_bits)
from mobius_rag_tpu_torch import testing as ttesting

torch.set_num_threads(1)

STEPS = ["add", "delete", "publish", "recycle", "bulk", "grow"]


def jax_fields(store) -> dict[str, np.ndarray]:
    out = {}
    for f in store.index.fields:
        a = np.asarray(jax.device_get(getattr(store.index, f)))
        out[f] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def host_state(store) -> dict:
    return {
        "records": [None if r is None else r.chunk_id for r in store.records],
        "free_rows": sorted(store._free_rows),
        "doc_rows": store._doc_rows,
        "source_ids": store._source_ids,
        "interners": [getattr(store, n).to_str
                      for n in ("docs", "payers", "states", "programs")],
        "capacity": store.capacity,
        "lexical_stats": store.lexical_stats(),
    }


def _republished(recs, doc):
    out = []
    for r in recs:
        if r.doc_id == doc:
            out.append(dataclasses.replace(r, text=r.text + " Revised.",
                                           chunk_id=r.chunk_id + "-v2"))
    return out


def _run(dtype: str) -> dict:
    """Drive both stores through the same writes; capture both states
    after every step."""
    jcfg = dataclasses.replace(jax_config(), vector_dtype=dtype)
    tcfg = dataclasses.replace(torch_config(), vector_dtype=dtype)
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=30)
    trecs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=30)
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    states = {}

    def capture(step):
        states[step] = (jax_fields(js), ts.index.to_numpy(), host_state(js),
                        host_state(ts))

    for stores, recs in ((js, jrecs), (ts, trecs)):
        stores.add_chunks(recs[:12])
        stores.add_chunks(recs[12:])
    capture("add")
    for s in (js, ts):
        s.delete_by_document("aetna_provider_manual")
        s.delete_by_document("filler3")
    capture("delete")
    js.publish_document("sunshine_provider_manual",
                        _republished(jrecs, "sunshine_provider_manual"))
    ts.publish_document("sunshine_provider_manual",
                        _republished(trecs, "sunshine_provider_manual"))
    capture("publish")
    jnew = jtesting.toy_corpus(None, pad_docs=6, rng=np.random.default_rng(5))[-6:]
    tnew = ttesting.toy_corpus(None, pad_docs=6, rng=np.random.default_rng(5))[-6:]
    for s, new in ((js, jnew), (ts, tnew)):
        for r in new:
            r.doc_id, r.chunk_id = "late-" + r.doc_id, "late-" + r.chunk_id
        s.add_chunks(new)  # fills the freed rows first, then appends
    capture("recycle")
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.bulk_load(jrecs)
    ts.bulk_load(trecs)
    capture("bulk")
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((1100, jcfg.embed_dim)).astype(np.float32)
    for s, mod in ((js, jtesting), (ts, ttesting)):
        mod_rec = mod.toy_corpus.__globals__["ChunkRecord"]
        s.add_chunks([mod_rec(chunk_id=f"g{i}", doc_id=f"gdoc{i % 50}", text="grow",
                              embedding=emb[i], authority_level=i % 5,
                              d_tags=[i % 12], payer="aetna" if i % 3 else "")
                      for i in range(1100)])
    capture("grow")
    return states


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def steps(request):
    return request.param, _run(request.param)


def assert_fields_equal(tf: dict, jf: dict) -> None:
    """Every field equal, dtype included. vec_scales only on live rows:
    on dead rows the JAX store leaves whatever its padded 256-row write
    blocks or zero-filled growth put there, and nothing reads it."""
    assert set(tf) == set(jf) == set(DeviceIndex.FIELDS)
    live = jf["valid"] > 0
    for f in DeviceIndex.FIELDS:
        assert tf[f].dtype == jf[f].dtype, f
        if f == "vec_scales":
            np.testing.assert_array_equal(tf[f][live], jf[f][live], err_msg=f)
        else:
            np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)


@pytest.mark.parametrize("step", STEPS)
def test_store_fields_equal(steps, step):
    _, states = steps
    jf, tf, jh, th = states[step]
    assert_fields_equal(tf, jf)
    assert th == jh


def test_store_dtypes(steps):
    dtype, _ = steps
    ts = TStore(dataclasses.replace(torch_config(), vector_dtype=dtype), device="cpu")
    assert ts.index.vectors.dtype == getattr(torch, dtype)
    assert ts.index.lexical.dtype == torch.bfloat16
    assert ts.index.j_tags.dtype == torch.int32


@pytest.fixture(scope="module")
def stores():
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=20)
    trecs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=20)
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jrecs)
    ts.add_chunks(trecs)
    js.delete_by_document("molina_quick_reference")
    ts.delete_by_document("molina_quick_reference")
    return js, ts


def _assert_same(js, ts):
    assert_fields_equal(ts.index.to_numpy(), jax_fields(js))
    assert host_state(ts) == host_state(js)
    for a, b in zip(js.records, ts.records):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b.embedding, np.float32),
                                          np.asarray(a.embedding, np.float32))
            assert dataclasses.asdict(dataclasses.replace(b, embedding=None)) == \
                dataclasses.asdict(dataclasses.replace(a, embedding=None))


# Restored records carry the index's normalized vectors as embeddings, so
# each snapshot is restored by both packages and the two compared.

def test_jax_snapshot_restores_into_port(stores, tmp_path):
    js, ts = stores
    js.snapshot(str(tmp_path / "snap"))
    ported = TStore.restore(str(tmp_path / "snap"), device="cpu")
    assert_fields_equal(ported.index.to_numpy(), jax_fields(js))  # as it was
    assert host_state(ported) == host_state(js)
    _assert_same(JStore.restore(str(tmp_path / "snap")), ported)


def test_port_snapshot_restores_into_jax(stores, tmp_path):
    js, ts = stores
    ts.snapshot(str(tmp_path / "snap"))
    restored = JStore.restore(str(tmp_path / "snap"))
    assert_fields_equal(ts.index.to_numpy(), jax_fields(restored))  # as it was
    assert host_state(ts) == host_state(restored)
    _assert_same(restored, TStore.restore(str(tmp_path / "snap"), device="cpu"))


def test_index_from_numpy_round_trips(stores):
    js, ts = stores
    src = {f: np.asarray(jax.device_get(getattr(js.index, f))) for f in js.index.fields}
    idx = index_from_numpy(src, "cpu")
    got = idx.to_numpy()
    for f in DeviceIndex.FIELDS:
        want = src[f].view(np.uint16) if src[f].dtype.name == "bfloat16" else src[f]
        np.testing.assert_array_equal(got[f], want, err_msg=f)
        np.testing.assert_array_equal(got[f], ts.index.to_numpy()[f], err_msg=f)


def test_pack_bits_round_trip_with_bit_31():
    ids = [0, 5, 31, 32, 63, 255]
    bits = pack_bits(ids, 8)
    assert unpack_bits(bits) == ids
    assert unpack_bits(bits.view(np.int32)) == ids  # the port's int32 form


def test_append_near_capacity_keeps_earlier_rows():
    # Appending at a start that is not a multiple of 256 close to the end
    # of capacity must not disturb earlier rows (the JAX store's clamped
    # block write does: ROADMAP queue 3).
    cfg = dataclasses.replace(torch_config(), initial_capacity=256)
    ts = TStore(cfg, device="cpu")
    rng = np.random.default_rng(3)
    mk = ttesting.toy_corpus.__globals__["ChunkRecord"]
    recs = [mk(chunk_id=f"c{i}", doc_id=f"d{i}", text="x",
               embedding=rng.standard_normal(cfg.embed_dim).astype(np.float32))
            for i in range(260)]
    ts.add_chunks(recs[:250])
    ts.add_chunks(recs[250:256])
    ts.add_chunks(recs[256:])
    assert ts.capacity == 512
    assert ts.index.valid.sum().item() == 260
    assert ts.index.doc_id[:260].tolist() == list(range(260))


_HOST_PQ = {"vector_residency": "host", "vector_dtype": "int8", "vector_backend": "pq"}


@pytest.mark.parametrize("env", [_HOST_PQ, dict(_HOST_PQ, lexical_format="sparse"),
                                 dict(_HOST_PQ, gating="local")])
def test_unported_layouts_raise(env):
    # int8 rows and host residency with proj are ported; host residency
    # with the pq backend is not (ROADMAP queue 1, item 10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TStore(dataclasses.replace(torch_config(), **env), device="cpu")
