"""The device IVF build of the port (index/ivf.py, ops/quant.py
fill_cluster_packed) against the JAX package on the same numpy inputs.

Tolerances: k-means centroids from the same init rows within 1e-4
(float32 sums in another order; no assignment flips on these inputs);
the capacity assignment and member fill bitwise given the same choice
arrays; on a corpus of well-separated clusters the whole build's member
tables identical and its centroids within 1e-4."""
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu.index import ivf as jivf
from mobius_rag_tpu.ops.quant import fill_cluster_packed as jfill
from mobius_rag_tpu_torch.index import ivf as tivf
from mobius_rag_tpu_torch.ops.quant import fill_cluster_packed as tfill

torch.set_num_threads(1)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("raw", [0, 1, 7, 8, 9, 150, 511, 512, 513, 2000, 4888])
def test_aligned_pad(raw):
    assert tivf._aligned_pad(raw) == jivf._aligned_pad(raw)


@pytest.mark.parametrize("n,nlist,block", [(400, 8, None), (600, 12, 128)])
def test_kmeans_same_init(n, nlist, block):
    """Same vectors, same init rows → centroids within 1e-4. block=128
    walks several row blocks (the JAX side pads to whole blocks)."""
    rng = np.random.default_rng(n)
    v = _unit(rng.standard_normal((n, 32)))
    init = rng.choice(n, size=nlist, replace=False).astype(np.int32)
    n_pad = n if block is None else -(-n // block) * block
    with mock.patch.object(jivf, "_KM_BLOCK", block or jivf._KM_BLOCK), \
            mock.patch.object(tivf, "_KM_BLOCK", block or tivf._KM_BLOCK):
        want = np.asarray(jivf._kmeans(jnp.asarray(v), jnp.asarray(init), nlist, 6, n_pad))
        got = tivf._kmeans(torch.from_numpy(v), torch.from_numpy(init), nlist, 6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_topj_block():
    rng = np.random.default_rng(1)
    cents = _unit(rng.standard_normal((20, 32)))
    blk = _unit(rng.standard_normal((50, 32)))
    wv, wi = (np.asarray(a) for a in jivf._topj_block(jnp.asarray(cents), jnp.asarray(blk), 5))
    gv, gi = tivf._topj_block(torch.from_numpy(cents), torch.from_numpy(blk), 5)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_assign_and_fill_bitwise(seed):
    """Tight capacity forces every round and the spill."""
    rng = np.random.default_rng(seed)
    n, nlist, j = 500, 10, 4
    ch_i = np.stack([rng.permutation(nlist)[:j] for _ in range(n)]).astype(np.int32)
    ch_v = -np.sort(-rng.random((n, j)).astype(np.float32), axis=1)
    ch_v[::7, 0] = ch_v[::7, 1]  # ties in affinity
    cap = 40
    want = jivf._capacity_assign(ch_i, ch_v, nlist, cap)
    got = tivf._capacity_assign(ch_i, ch_v, nlist, cap)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got >= 0).any()
    live_rows = np.sort(rng.choice(2 * n, size=n, replace=False))
    for a, b in zip(tivf._fill_members(live_rows, got, nlist, 48),
                    jivf._fill_members(live_rows, want, nlist, 48)):
        np.testing.assert_array_equal(a, b)


def _separated(n=640, k=8, d=32, seed=5):
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((k, d)))
    v = centers[rng.integers(0, k, n)] + 0.01 * rng.standard_normal((n, d))
    valid = (rng.random(n) > 0.1).astype(np.float32)
    return _unit(v), valid


def test_ivf_build_separated_corpus():
    v, valid = _separated()
    j = jivf.IVFIndex.build(jnp.asarray(v), valid, nlist=8, iters=5)
    t = tivf.IVFIndex.build(torch.from_numpy(v), valid, nlist=8, iters=5)
    assert (t.nlist, t.pad) == (j.nlist, j.pad)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-4)
    for f in ("members", "member_valid", "spill", "spill_valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    assert t.spill_count == j.spill_count


def test_ivf_build_empty_and_default_nlist():
    v, _ = _separated(n=300)
    t = tivf.IVFIndex.build(torch.from_numpy(v), np.zeros(300))
    j = jivf.IVFIndex.build(jnp.asarray(v), np.zeros(300))
    assert (t.nlist, t.pad, t.spill_count) == (j.nlist, j.pad, j.spill_count)
    assert not t.member_valid.any()
    t = tivf.IVFIndex.build(torch.from_numpy(v))
    assert t.nlist == jivf.IVFIndex.build(jnp.asarray(v)).nlist == 17


@pytest.mark.parametrize("nlist,pad,block", [(5, 8, 1000), (7, 8, 24), (6, 16, 32)])
def test_fill_cluster_packed(nlist, pad, block):
    """Blockwise fill into final-shape buffers, the last block shifted back
    to overlap, equals the JAX fill."""
    rng = np.random.default_rng(nlist)
    src = rng.standard_normal((nlist * pad, 3)).astype(np.float32)

    def enc_t(lo, hi):
        x = torch.from_numpy(src[lo:hi])
        return x * 2.0, x[:, 0]

    def enc_j(lo, hi):
        x = jnp.asarray(src[lo:hi])
        return x * 2.0, x[:, 0]

    got = tfill(nlist, pad, enc_t, (torch.float32, torch.float32), (3, 0), block=block)
    want = jfill(nlist, pad, enc_j, (jnp.float32, jnp.float32), (3, 0), block=block)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
