"""The proj ANN backend of the port (ops/proj.py, ops/proj_scan.py,
index/ann_io.py) against the JAX package on the same numpy inputs.

- The plain versions of both kernels against the Pallas kernels in
  interpret mode: raw dots bitwise (with the ±127 extremes and p=36),
  gated scores bitwise (live slots, and -1e30 on the others) and row ids
  equal at tag levels 0, 1 and 2, on the inputs of test_gating.py:233-313.
- PackedProj.from_ivf from the same IVF tables: the projection compared
  as a subspace (projector within 1e-4), eigenvector signs aligned, codes
  within ±1 on >= 99% of the live entries; layout arrays identical.
- proj_search_packed / proj_search_gated on tables carried across (the
  JAX tables handed over), every cluster probed: values within 1e-5
  (float32 summation order of the centroid and projection products), ids
  equal except inside runs of values tied within 1e-6.
- ann_io files both ways, bitwise.
The CUDA kernels themselves are held against the plain versions on the
card (marked `cuda`; skipped without one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu.index import ann_io as jann_io
from mobius_rag_tpu.index.ivf import IVFIndex as JIVF
from mobius_rag_tpu.index.store import DeviceIndex as JDeviceIndex
from mobius_rag_tpu.ops import proj as jproj
from mobius_rag_tpu.ops.pallas_proj import proj_blocks_pallas, proj_gated_blocks_pallas
from mobius_rag_tpu.ops.topk import merged_topk as jmerged_topk
from mobius_rag_tpu_torch.index import ann_io as tann_io
from mobius_rag_tpu_torch.index.ivf import IVFIndex as TIVF
from mobius_rag_tpu_torch.index.store import index_from_numpy
from mobius_rag_tpu_torch.ops import proj as tproj
from mobius_rag_tpu_torch.ops.proj_scan import (group_probes, group_probes_reference,
                                                proj_blocks, proj_blocks_reference,
                                                proj_gated_blocks,
                                                proj_gated_blocks_reference)
from mobius_rag_tpu_torch.ops.topk import NEG_INF, merged_topk

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# raw block dots: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _mk(nlist=12, pad=32, p=64, b=4, nprobe=5, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, size=(nlist, pad, p)).astype(np.int8)
    q8 = rng.integers(-127, 128, size=(b, p)).astype(np.int8)
    probe = rng.integers(0, nlist, size=(b, nprobe)).astype(np.int32)
    return codes, q8, probe


@pytest.mark.parametrize("kw", [{}, {"p": 36, "pad": 40, "seed": 1},
                                {"p": 37, "pad": 24, "seed": 2}, {"p": 192, "seed": 3},
                                {"p": 1536, "pad": 16, "nprobe": 3, "seed": 4}])
def test_proj_blocks_reference_matches_pallas(kw):
    codes, q8, probe = _mk(**kw)
    want = np.asarray(proj_blocks_pallas(jnp.asarray(probe), jnp.asarray(codes),
                                         jnp.asarray(q8)))
    got = proj_blocks(_t(probe), _t(codes), _t(q8))  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.einsum("bjsp,bp->bjs", codes[probe].astype(np.int64),
                       q8.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), oracle)


def test_proj_blocks_extremes():
    codes, q8, probe = _mk(p=128, seed=3)
    codes[:] = 127
    q8[:] = -127
    want = np.asarray(proj_blocks_pallas(jnp.asarray(probe), jnp.asarray(codes),
                                         jnp.asarray(q8)))
    got = proj_blocks_reference(_t(probe), _t(codes), _t(q8)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got == np.float32(128 * 127 * -127))


def test_proj_blocks_exact_past_float32_accumulation():
    """p=1536 at the extremes: 1536·127² > 2^24, where a float32 sum would
    round; the int32 sum is exact and converts once."""
    codes, q8, probe = _mk(nlist=2, pad=8, p=1536, b=2, nprobe=2)
    codes[:] = 127
    q8[:] = 127
    q8[0, 0] = 126  # an odd total
    got = proj_blocks_reference(_t(probe), _t(codes), _t(q8)).numpy()
    exact = np.array([1535 * 127 * 127 + 126 * 127, 1536 * 127 * 127], np.int64)
    np.testing.assert_array_equal(got, np.broadcast_to(
        exact.astype(np.float32)[:, None, None], got.shape))


@pytest.mark.parametrize("bad", ["probe_dtype", "codes_dtype", "q8_shape", "tag_level",
                                 "words_shape"])
def test_wrappers_reject_bad_inputs(bad):
    codes, q8, probe = (_t(a) for a in _mk())
    tw = 2
    w_full, _ = tproj.gate_widths(tw)
    words = torch.zeros((12, w_full, 32), dtype=torch.int32)
    qmeta = torch.zeros((4, 8), dtype=torch.int32)
    qbits = torch.zeros((4, 3 * tw), dtype=torch.int32)
    level = 2
    if bad == "probe_dtype":
        probe = probe.long()
    elif bad == "codes_dtype":
        codes = codes.to(torch.int32)
    elif bad == "q8_shape":
        q8 = q8[:, :10]
    elif bad == "tag_level":
        level = 3
    else:
        words = words[:, :5]
    with pytest.raises((ValueError, TypeError)):
        if bad in ("tag_level", "words_shape"):
            proj_gated_blocks(probe, qmeta, qbits, codes, words, q8, tw=tw, tag_level=level)
        else:
            proj_blocks(probe, codes, q8)


# ---------------------------------------------------------------------------
# the gated scan: test_gating.py:233-313's inputs
# ---------------------------------------------------------------------------

N_G, D_G, P_G, B_G, TW_G = 600, 64, 32, 4, 2


def _gate_world():
    rng = np.random.default_rng(0)
    n, d, tw = N_G, D_G, TW_G
    arrays = dict(
        vectors=np.zeros((0, d), np.float32),
        vec_scales=np.ones((n,), np.float32),
        valid=(rng.random(n) > 0.05).astype(np.float32),
        doc_id=np.zeros((n,), np.int32),
        authority=np.where(rng.random(n) > 0.8, 1.0, 0.25).astype(np.float32),
        length_score=np.zeros((n,), np.float32),
        payer=rng.integers(-1, 3, n).astype(np.int32),
        state=rng.integers(-1, 2, n).astype(np.int32),
        program=rng.integers(-1, 2, n).astype(np.int32),
        j_tags=rng.integers(0, 2**16, (n, tw)).astype(np.uint32),
        d_tags=rng.integers(0, 2**16, (n, tw)).astype(np.uint32),
        p_tags=rng.integers(0, 2**16, (n, tw)).astype(np.uint32),
        phrase_bits=np.zeros((n, 1), np.uint32),
    )
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    jix = JDeviceIndex(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tix = index_from_numpy(dict(arrays, lexical=np.zeros((1, n), np.uint16)), "cpu")
    ivf = JIVF.build(jnp.asarray(vecs), nlist=8, iters=4)
    pp = jproj.PackedProj.from_ivf(ivf, jnp.asarray(vecs), p=P_G)
    gate = jproj.ProjGate.build(pp, jix)
    q = {
        "vec": vecs[:B_G] + 0.01,
        "payer": np.array([0, -1, 1, -2], np.int32),
        "state": np.array([-1, 0, -1, -1], np.int32),
        "program": np.array([-1, -1, 0, -1], np.int32),
        "tag_mode": np.array([0, 1, 2, 0], np.int32),
        "inherit_authority": np.array([1, 0, 0, 0], np.float32),
        "j_bits": rng.integers(0, 2**8, (B_G, tw)).astype(np.uint32),
        "d_bits": rng.integers(0, 2**8, (B_G, tw)).astype(np.uint32),
        "p_bits": np.zeros((B_G, tw), np.uint32),
    }
    strict_ok = np.array([True, False, True, True])
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    tq = {k: _t(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in q.items()}
    jqmeta, jqbits = jproj.encode_qmeta(jq, jnp.asarray(strict_ok))
    tqmeta, tqbits = tproj.encode_qmeta(tq, _t(strict_ok))
    tpp = tproj.PackedProj.from_numpy(
        {f: np.asarray(getattr(pp, f)) for f in jproj.PackedProj.FIELDS},
        pp.tree_flatten()[1], "cpu")
    return dict(jix=jix, tix=tix, pp=pp, tpp=tpp, gate=gate, jq=jq, tq=tq,
                jqmeta=jqmeta, jqbits=jqbits, tqmeta=tqmeta, tqbits=tqbits)


@pytest.fixture(scope="module")
def gw():
    return _gate_world()


def test_encode_qmeta_matches_jax(gw):
    np.testing.assert_array_equal(gw["tqmeta"].numpy(), np.asarray(gw["jqmeta"]))
    np.testing.assert_array_equal(gw["tqbits"].numpy(),
                                  np.asarray(gw["jqbits"]).view(np.int32))


def test_gate_pack_matches_jax(gw):
    words = tproj.ProjGate.build(gw["tpp"], gw["tix"]).words
    np.testing.assert_array_equal(words.numpy(), np.asarray(gw["gate"].words))
    rows = torch.tensor([0, 5, 599, -3, 600])
    got = tproj.ProjGate.pack_rows(gw["tix"], rows).numpy()
    want = np.asarray(jproj.ProjGate.pack_rows(gw["jix"], jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(got, want)


def _probe_q8(gw, nprobe=5):
    pp = gw["pp"]
    q32 = jnp.asarray(gw["jq"]["vec"], jnp.float32)
    cscores = q32 @ pp.centroids.T
    _, probe = jax.lax.top_k(cscores[:, : pp.base_nlist], nprobe)
    qp = q32 @ pp.proj.T
    q_scale = jnp.maximum(jnp.max(jnp.abs(qp), axis=1), 1e-9) / 127.0
    q8 = jnp.round(qp / q_scale[:, None]).astype(jnp.int8)
    return np.asarray(probe, np.int32), np.asarray(q8)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gated_reference_matches_pallas(gw, level):
    probe, q8 = _probe_q8(gw)
    pp, words = gw["pp"], gw["gate"].words
    want_s, want_r = (np.asarray(a) for a in proj_gated_blocks_pallas(
        jnp.asarray(probe), gw["jqmeta"], gw["jqbits"], pp.codes, words, jnp.asarray(q8),
        tw=TW_G, tag_level=level))
    got_s, got_r = proj_gated_blocks(_t(probe), gw["tqmeta"], gw["tqbits"], gw["tpp"].codes,
                                     _t(words), _t(q8), tw=TW_G, tag_level=level)
    live = want_s > NEG_INF / 2
    assert live.any() and (~live).any()
    np.testing.assert_array_equal(got_s.numpy(), want_s)  # live and -1e30 alike
    np.testing.assert_array_equal(got_r.numpy(), want_r)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gated_reference_matches_pallas_at_p1536(gw, level):
    """p = D = 1536 (the widest MRAG_PROJ_P the config allows at the main
    width), on the gate pack of test_gating.py's inputs and random codes."""
    words = gw["gate"].words
    nlist, _, pad = words.shape
    rng = np.random.default_rng(level)
    codes = rng.integers(-127, 128, size=(nlist, pad, 1536)).astype(np.int8)
    q8 = rng.integers(-127, 128, size=(B_G, 1536)).astype(np.int8)
    probe = rng.integers(0, nlist, size=(B_G, 3)).astype(np.int32)
    want_s, want_r = (np.asarray(a) for a in proj_gated_blocks_pallas(
        jnp.asarray(probe), gw["jqmeta"], gw["jqbits"], jnp.asarray(codes), words,
        jnp.asarray(q8), tw=TW_G, tag_level=level))
    got_s, got_r = proj_gated_blocks(_t(probe), gw["tqmeta"], gw["tqbits"], _t(codes),
                                     _t(words), _t(q8), tw=TW_G, tag_level=level)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_r.numpy(), want_r)


def test_gated_levels_differ_where_tags_matter(gw):
    """tag_level really bounds what the gate reads: with j and d bits in
    the queries, levels 0 and 2 admit different slots."""
    probe, q8 = _probe_q8(gw)
    args = (_t(probe), gw["tqmeta"], gw["tqbits"], gw["tpp"].codes,
            tproj.ProjGate.build(gw["tpp"], gw["tix"]).words, _t(q8))
    s0, _ = proj_gated_blocks_reference(*args, tw=TW_G, tag_level=0)
    s2, _ = proj_gated_blocks_reference(*args, tw=TW_G, tag_level=2)
    assert not torch.equal(s0 > NEG_INF / 2, s2 > NEG_INF / 2)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_search_gated_tables_carried_across(gw, level):
    k, nprobe = 12, 8  # every cluster probed
    jv, ji = (np.asarray(a) for a in jproj.proj_search_gated(
        gw["pp"], gw["gate"].words, gw["jq"]["vec"], gw["jqmeta"], gw["jqbits"], k, nprobe,
        tag_level=level, tw=TW_G))
    words = tproj.ProjGate.build(gw["tpp"], gw["tix"]).words
    tv, ti = tproj.proj_search_gated(gw["tpp"], words, gw["tq"]["vec"], gw["tqmeta"],
                                     gw["tqbits"], k, nprobe, tag_level=level, tw=TW_G)
    assert_topk_equal(tv.numpy(), ti.numpy(), jv, ji)


def assert_topk_equal(vals, idx, want_vals, want_idx, atol=ATOL):
    live = want_vals > NEG_INF / 2
    assert ((vals > NEG_INF / 2) == live).all()
    np.testing.assert_allclose(vals[live], want_vals[live], rtol=0, atol=atol)
    tied = np.abs(np.diff(want_vals, axis=1)) <= TIE
    strict = live.copy()
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    np.testing.assert_array_equal(idx[strict], want_idx[strict])


# ---------------------------------------------------------------------------
# from_ivf, proj_search_packed, ann_io
# ---------------------------------------------------------------------------

def _aniso(n=800, d=48, seed=0):
    """Rows with a decaying spectrum, so the residual PCA's eigenvalues are
    well separated and the fitted subspace is determined."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * (1.0 / (1.0 + np.arange(d)))[None, :]
    x = x + 0.3 * rng.standard_normal((8, d))[rng.integers(0, 8, n)]
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    v = _aniso()
    valid = np.ones(len(v), np.float32)
    valid[::13] = 0
    jivf = JIVF.build(jnp.asarray(v), valid, nlist=8, iters=5, pad_factor=1.05, choices=1)
    assert jivf.spill_count > 0  # the spill slabs are exercised
    jpp = jproj.PackedProj.from_ivf(jivf, jnp.asarray(v), p=16, reserve_slabs=2)
    tivf = TIVF(*(_t(getattr(jivf, f)) for f in JIVF.FIELDS), nlist=jivf.nlist,
                pad=jivf.pad)
    tpp = tproj.PackedProj.from_ivf(tivf, torch.from_numpy(v), p=16, reserve_slabs=2)
    carried = tproj.PackedProj.from_numpy(
        {f: np.asarray(getattr(jpp, f)) for f in jproj.PackedProj.FIELDS},
        jpp.tree_flatten()[1], "cpu")
    return v, valid, jpp, tpp, carried


def test_from_ivf_layout_identical(built):
    _, _, jpp, tpp, _ = built
    assert tpp.aux == tuple(jpp.tree_flatten()[1])
    for f in ("valid", "rowids"):
        np.testing.assert_array_equal(getattr(tpp, f).numpy(), np.asarray(getattr(jpp, f)))
    np.testing.assert_allclose(tpp.centroids.numpy(), np.asarray(jpp.centroids), atol=1e-6)
    np.testing.assert_array_equal(tpp.build_rowids, jpp.build_rowids)
    np.testing.assert_array_equal(tpp.build_valid, jpp.build_valid)


def test_from_ivf_subspace_and_codes(built):
    _, _, jpp, tpp, _ = built
    pj, pt = np.asarray(jpp.proj, np.float64), tpp.proj.numpy().astype(np.float64)
    np.testing.assert_allclose(pt.T @ pt, pj.T @ pj, atol=1e-4)  # the same subspace
    sign = np.sign(np.sum(pt * pj, axis=1))  # eigh may flip a vector's sign
    assert np.all(np.abs(np.sum(pt * pj, axis=1)) > 0.999)
    live = np.asarray(jpp.valid) > 0
    ct = tpp.codes.numpy().astype(np.int32)[live] * sign.astype(np.int32)[None, :]
    cj = np.asarray(jpp.codes).astype(np.int32)[live]
    assert np.abs(ct - cj).max() <= 1
    assert (ct == cj).mean() >= 0.99
    np.testing.assert_allclose(tpp.scales.numpy()[live], np.asarray(jpp.scales)[live],
                               rtol=1e-4)


@pytest.mark.parametrize("pen_form", ["c", "bc"])
def test_search_packed_tables_carried_across(built, pen_form):
    v, valid, jpp, _, carried = built
    rng = np.random.default_rng(4)
    q = _aniso(n=6, d=v.shape[1], seed=9)
    shape = (len(v),) if pen_form == "c" else (len(q), len(v))
    pen = np.where(rng.random(shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
    k, nprobe = 20, 64  # every cluster probed
    jv, ji = (np.asarray(a) for a in jproj.proj_search_packed(
        jpp, jnp.asarray(q), jnp.asarray(pen), k, nprobe))
    tv, ti = tproj.proj_search_packed(carried, torch.from_numpy(q), torch.from_numpy(pen),
                                      k, nprobe)
    assert_topk_equal(tv.numpy(), ti.numpy(), jv, ji)


def test_search_packed_probe_subset(built):
    """nprobe < nlist: the probe choice (stable top-k of the centroid
    scores) and the always-probed spill and reserved slabs agree."""
    v, _, jpp, _, carried = built
    q = _aniso(n=5, d=v.shape[1], seed=11)
    jv, ji = (np.asarray(a) for a in jproj.proj_search_packed(
        jpp, jnp.asarray(q), jnp.zeros((len(v),), jnp.float32), 15, 3))
    tv, ti = tproj.proj_search_packed(carried, torch.from_numpy(q),
                                      torch.zeros(len(v)), 15, 3)
    assert_topk_equal(tv.numpy(), ti.numpy(), jv, ji)


def test_encode_reserved_matches_jax(built):
    v, _, jpp, _, carried = built
    rows = v[:40]
    jc, js = (np.asarray(a) for a in jproj.encode_reserved(jpp.proj, jnp.asarray(rows)))
    tc, ts = tproj.encode_reserved(carried.proj, torch.from_numpy(rows))
    assert np.abs(tc.numpy().astype(np.int32) - jc).max() <= 1
    assert (tc.numpy() == jc).mean() >= 0.99
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)


def test_ann_io_both_ways(built, tmp_path):
    _, _, jpp, tpp, _ = built
    jpath = str(tmp_path / "jax_ann.npz")
    jann_io.save_ann(jpp, jpath, meta={"backend": "proj", "rows": 800})
    got, meta = tann_io.load_ann(jpath, "cpu")
    assert meta == {"backend": "proj", "rows": 800} and got.aux == tuple(jpp.tree_flatten()[1])
    for f in tproj.PackedProj.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jpp, f)))
    np.testing.assert_array_equal(got.build_rowids, np.asarray(jpp.rowids))

    tpath = str(tmp_path / "port_ann.npz")
    tann_io.save_ann(tpp, tpath, meta={"backend": "proj", "rows": 800})
    back, meta = jann_io.load_ann(tpath, to_device=False)
    assert type(back).__name__ == "PackedProj" and meta["rows"] == 800
    assert back.tree_flatten()[1] == tpp.aux
    for f in tproj.PackedProj.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), getattr(tpp, f).numpy())


def test_ann_io_rejects_unported_classes(tmp_path):
    v = _aniso(n=100)
    path = str(tmp_path / "ivf.npz")
    jann_io.save_ann(JIVF.build(jnp.asarray(v), nlist=4), path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tann_io.load_ann(path, "cpu")


@pytest.mark.parametrize("s,k", [(30, 10), (6, 10), (10, 10)])
def test_merged_topk_matches_jax(s, k):
    rng = np.random.default_rng(s)
    vals = np.round(rng.standard_normal((4, s)), 1).astype(np.float32)  # many ties
    vals[:, ::5] = NEG_INF
    ids = rng.integers(0, 1000, (4, s)).astype(np.int32)
    jv, ji = (np.asarray(a) for a in jmerged_topk(jnp.asarray(vals), jnp.asarray(ids), k))
    tv, ti = merged_topk(torch.from_numpy(vals), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    with pytest.raises(NotImplementedError, match="measurement"):
        merged_topk(torch.from_numpy(vals), torch.from_numpy(ids), k, 0.95)


# ---------------------------------------------------------------------------
# the kernels' grouping of (b, j) probe pairs by cluster: its plain twin
# ---------------------------------------------------------------------------

def _group_probe(kind, b, n_probe, nlist, rng):
    """probe [B, P] int32 of one group shape: "random" (duplicates inside a
    list), "one" (every probe on one cluster), "low" (clusters 0-2 only:
    the others unprobed), "engine" (P-2 distinct base cells, then the 2
    reserved slabs for every query), "outside" (ids past both ends)."""
    if kind == "random":
        return rng.integers(0, nlist, (b, n_probe)).astype(np.int32)
    if kind == "one":
        return np.full((b, n_probe), nlist // 2, np.int32)
    if kind == "low":
        return rng.integers(0, 3, (b, n_probe)).astype(np.int32)
    if kind == "outside":
        return rng.integers(-3, nlist + 3, (b, n_probe)).astype(np.int32)
    base = np.stack([rng.permutation(nlist - 2)[:n_probe - 2] for _ in range(b)])
    reserved = np.broadcast_to(np.arange(nlist - 2, nlist), (b, 2))
    return np.concatenate([base, reserved], axis=1).astype(np.int32)


GROUP_SHAPES = [("random", 8, 6, 12), ("one", 8, 4, 6), ("low", 4, 5, 50),
                ("engine", 32, 66, 1002), ("engine", 1, 66, 4098), ("engine", 33, 6, 12),
                ("random", 5, 8, 3), ("outside", 6, 7, 9),
                # past the clusters the kernel's grouping counts in shared memory
                ("random", 8, 6, 20_000)]


@pytest.mark.parametrize("kind,b,n_probe,nlist", GROUP_SHAPES)
def test_group_probes_reference_pins_the_grouping(kind, b, n_probe, nlist):
    """Every (b, j) appears once; members are grouped by clamped cluster id
    in ascending order; inside a group the (b, j) order is kept; a cluster
    nobody probes has no group; on the CPU the wrapper is the twin."""
    probe = _group_probe(kind, b, n_probe, nlist, np.random.default_rng(b * 131 + nlist))
    members, cells, starts = (a.numpy() for a in group_probes_reference(_t(probe), nlist))
    flat = np.clip(probe.reshape(-1), 0, nlist - 1)
    assert members.dtype == cells.dtype == starts.dtype == np.int32
    assert sorted(members.tolist()) == list(range(b * n_probe))
    np.testing.assert_array_equal(cells, np.unique(flat))
    assert starts[0] == 0 and starts[-1] == b * n_probe and np.all(np.diff(starts) > 0)
    for gi, cell in enumerate(cells):
        group = members[starts[gi]:starts[gi + 1]]
        np.testing.assert_array_equal(group, np.flatnonzero(flat == cell))  # stable
    for got, want in zip(group_probes(_t(probe), nlist),
                         group_probes_reference(_t(probe), nlist)):
        assert torch.equal(got, want)


def test_group_probes_rejects_bad_inputs():
    with pytest.raises(ValueError):
        group_probes(torch.zeros((2, 3), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        group_probes(torch.zeros((2, 3), dtype=torch.int32), 0)


def test_wrappers_reject_too_many_probe_pairs():
    probe = torch.empty((65535, 1025), dtype=torch.int32)
    codes = torch.zeros((1, 1, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="oversized"):
        proj_blocks(probe, codes, torch.zeros((65535, 4), dtype=torch.int8))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

# (p, pad, B, P, nlist, probe kind): the tables' widths, ragged pads, and
# the group shapes the grouped kernels must get right: one cluster for all
# queries, duplicates inside a list, clusters nobody probes, B=1, and B=33
# (the reserved slabs' group spans three 16-member tiles); p past one
# k-slice and nlist past the shared-memory grouping.
CARD_CASES = [(256, 2048, 8, 6, 12, "random"), (192, 520, 8, 6, 12, "random"),
              (36, 300, 8, 6, 12, "random"), (37, 100, 8, 6, 12, "random"),
              (32, 256, 8, 6, 12, "random"), (64, 300, 8, 4, 6, "one"),
              (128, 260, 5, 8, 3, "random"), (64, 256, 4, 5, 50, "low"),
              (192, 384, 1, 7, 20, "random"), (256, 256, 33, 6, 12, "engine"),
              (192, 5120, 32, 66, 300, "engine"),
              # k-sliced items (p past 256; 768 was past the one-stage layout)
              # and the grouping's counters in scratch (nlist past 19,349)
              (1536, 64, 4, 3, 5, "random"), (768, 256, 4, 3, 5, "random"),
              (64, 32, 8, 6, 20_000, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("p,pad,b,n_probe,nlist,kind", CARD_CASES)
def test_kernels_match_plain_on_card(p, pad, b, n_probe, nlist, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(p)
    tw = 8

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, device="cuda", generator=g,
                             dtype=torch.int64).to(torch.int32)

    probe = _t(_group_probe(kind, b, n_probe, nlist,
                            np.random.default_rng(p + pad))).cuda().contiguous()
    for got, want in zip(group_probes(probe, nlist), group_probes_reference(probe, nlist)):
        assert torch.equal(got, want)
    codes = ri(-127, 128, (nlist, pad, p)).to(torch.int8)
    q8 = ri(-127, 128, (b, p)).to(torch.int8)
    before = (proj_blocks.launches, proj_gated_blocks.launches)
    raw = proj_blocks(probe, codes, q8)
    torch.cuda.synchronize()
    assert torch.equal(raw, proj_blocks_reference(probe, codes, q8))
    w_full, _ = tproj.gate_widths(tw)
    words = ri(-2**31, 2**31 - 1, (nlist, w_full, pad))
    words[:, 2] = (torch.rand((nlist, pad), device="cuda", generator=g)).view(torch.int32)
    qmeta = torch.stack([ri(0, 3, (b,)), ri(0, 3, (b,)), ri(0, 3, (b,)),
                         ri(0, 3, (b,)), ri(0, 2, (b,)), ri(0, 2, (b,)), ri(0, 2, (b,)),
                         ri(0, 2, (b,))], 1).contiguous()
    qbits = ri(0, 2**31 - 1, (b, 3 * tw))
    for level in (0, 1, 2):
        s, r = proj_gated_blocks(probe, qmeta, qbits, codes, words, q8, tw=tw,
                                 tag_level=level)
        torch.cuda.synchronize()
        rs, rr = proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8, tw=tw,
                                             tag_level=level)
        assert torch.equal(s, rs) and torch.equal(r, rr)
    assert (proj_blocks.launches, proj_gated_blocks.launches) == (before[0] + 1,
                                                                   before[1] + 3)
