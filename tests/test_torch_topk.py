"""The masked cosine top-k: the port's plain version (what masked_topk
runs on CPU tensors) against the JAX package's XLA path and its Pallas
kernel (interpret mode), against a numpy oracle of the engine's vector
arm, and on ties. The CUDA kernel itself is held against the plain
version on the card (marked `cuda`; skipped without one).

Tolerances: values atol 1e-5 (float32 summation order at D=256); ids
exact wherever neighbouring values differ by more than 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu.ops.topk import cosine_topk_pallas, cosine_topk_xla
from mobius_rag_tpu_torch.ops.topk import (NEG_INF, bf16_parts, masked_topk,
                                           masked_topk_reference, topk_stable)

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def assert_topk_equal(vals, idx, want_vals, want_idx, tie=TIE, atol=ATOL):
    """Values within atol; ids equal except inside runs of tied values."""
    vals, want_vals = np.asarray(vals, np.float64), np.asarray(want_vals, np.float64)
    idx, want_idx = np.asarray(idx), np.asarray(want_idx)
    assert vals.shape == want_vals.shape and idx.shape == want_idx.shape
    live = want_vals > NEG_INF / 2
    assert ((vals > NEG_INF / 2) == live).all()
    np.testing.assert_allclose(vals[live], want_vals[live], rtol=0, atol=atol)
    tied = np.abs(np.diff(want_vals, axis=1)) <= tie
    strict = np.ones_like(live)
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    sel = strict & live
    np.testing.assert_array_equal(idx[sel], want_idx[sel])


CASES = [(1000, 4, 10), (513, 1, 7), (2048, 32, 25), (1536, 8, 128)]


@pytest.fixture(scope="module")
def topk_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for n, b, k in CASES:
        v = _normalize(rng.standard_normal((n, 256)).astype(np.float32))
        q = _normalize(rng.standard_normal((b, 256)).astype(np.float32))
        pen = np.where(rng.random(n) < 0.3, NEG_INF, 0.0).astype(np.float32)
        out[(n, b, k)] = (v, q, pen)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n,b,k", CASES)
def test_masked_topk_matches_jax(topk_inputs, impl, n, b, k):
    v, q, pen = topk_inputs[(n, b, k)]
    jfn = cosine_topk_xla if impl == "xla" else cosine_topk_pallas
    jv, ji = jax.device_get(jfn(v, q, pen, k))
    tv, ti = masked_topk(torch.from_numpy(q), torch.from_numpy(v),
                         torch.from_numpy(pen), None, k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert_topk_equal(tv, ti, jv, ji)


@pytest.mark.parametrize("qkind", ["bf16", "float32"])
@pytest.mark.parametrize("n,b,k", CASES[:3])
def test_bf16_rows_match_jax(qkind, n, b, k):
    """bf16 rows in both packages: the function the kernel's tensor-core
    core computes (every product exact in float32), with bf16-rounded
    queries (the engine's) and with float32 ones."""
    rng = np.random.default_rng(n + b)
    vj = jnp.asarray(_normalize(rng.standard_normal((n, 256)).astype(np.float32)), jnp.bfloat16)
    v = np.array(vj.astype(jnp.float32))  # the bf16 values, exactly
    q = _normalize(rng.standard_normal((b, 256)).astype(np.float32))
    if qkind == "bf16":
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    pen = np.where(rng.random(n) < 0.3, NEG_INF, 0.0).astype(np.float32)
    jv, ji = jax.device_get(cosine_topk_xla(vj, q, pen, k))
    tv, ti = masked_topk(torch.from_numpy(q), torch.from_numpy(v).to(torch.bfloat16),
                         torch.from_numpy(pen), None, k)
    assert_topk_equal(tv, ti, jv, ji)


def _engine_oracle(q, v, pen, min_sim, m):
    """numpy form of engine.py:477-485 (float32, stable order)."""
    cos = q @ v.T
    scores = cos + pen + np.where(cos < min_sim[:, None], NEG_INF, 0.0).astype(np.float32)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :m]
    return np.take_along_axis(scores, idx, axis=1), idx


@pytest.mark.parametrize("c,b,m", [(1024, 6, 40), (700, 3, 700), (300, 5, 64)])
def test_batched_penalty_and_min_sim(c, b, m):
    rng = np.random.default_rng(c)
    v = _normalize(rng.standard_normal((c, 256)).astype(np.float32))
    q = _normalize(rng.standard_normal((b, 256)).astype(np.float32))
    pen = np.where(rng.random((b, c)) < 0.4, NEG_INF, 0.0).astype(np.float32)
    pen[1] = NEG_INF  # one query with every row gated
    min_sim = np.where(np.arange(b) % 2 == 0, 0.05, 0.0).astype(np.float32)
    tv, ti = masked_topk(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(pen),
                         torch.from_numpy(min_sim), m)
    ov, oi = _engine_oracle(q, v, pen, min_sim, m)
    assert_topk_equal(tv, ti, ov, oi)
    assert (tv[1] <= NEG_INF / 2).all()


def test_duplicate_rows_tie_order_matches_lax_top_k():
    # entries on a 1/8 grid: every dot is exact in float32, so duplicated
    # rows tie exactly whatever the summation order
    rng = np.random.default_rng(1)
    base = rng.integers(-2, 3, size=(200, 64)).astype(np.float32) / 8
    v = np.concatenate([base, base[::-1], base[:50]])  # each row 2-3 times
    q = rng.integers(-2, 3, size=(4, 64)).astype(np.float32) / 8
    pen = np.zeros(len(v), np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(q @ v.T), 60)
    tv, ti = masked_topk(torch.from_numpy(q), torch.from_numpy(v),
                         torch.from_numpy(pen), None, 60)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("b,n,k", [(1, 50, 10), (8, 3000, 80), (32, 1000, 1000)])
def test_topk_stable_matches_lax_top_k(b, n, k):
    x = np.random.default_rng(n).integers(0, 5, size=(b, n)).astype(np.float32) + 1.0
    x[:, ::7] = NEG_INF
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("bad", ["m>C", "m>1024", "shape", "dtype", "device"])
def test_masked_topk_rejects(bad):
    q = torch.zeros(2, 32)
    v = torch.zeros(2000, 32)
    pen = torch.zeros(2000)
    m = 10
    if bad == "m>C":
        v, pen, m = v[:5], pen[:5], 6
    elif bad == "m>1024":
        m = 1025
    elif bad == "shape":
        pen = torch.zeros(3, 2000)
    elif bad == "dtype":
        q = q.double()
    else:
        q, v, pen = q.to("meta"), v.to("meta"), pen.to("meta")
    with pytest.raises((ValueError, TypeError)):
        masked_topk(q, v, pen, None, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,c,m,pen_form,special", [
    (32, 70144, 40, "bc", None), (4, 1000, 40, "bc", None), (8, 4096, 1024, "bc", None),
    (1, 3000, 40, "c", None), (1, 70144, 40, "bc", None),
    # every row one row (all scores tie); one query with every row gated;
    # m on either side of pass 1's partial width (128)
    (4, 5000, 40, "c", "ties"), (4, 20000, 40, "bc", "gated"),
    (8, 20000, 128, "bc", None), (8, 20000, 129, "bc", None)])
def test_kernel_matches_plain_on_card(dtype, b, c, m, pen_form, special):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from mobius_rag_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device="cuda").manual_seed(c + m)
    v = torch.randn(1 if special == "ties" else c, 1536, device="cuda", generator=g)
    v = (v / v.norm(dim=1, keepdim=True)).expand(c, 1536)
    scales = None
    if dtype == "int8":
        v, scales = quantize_rows(v)
    v = v.to(getattr(torch, dtype)).contiguous()
    q = torch.randn(b, 1536, device="cuda", generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    shape = (b, c) if pen_form == "bc" else (c,)
    gate = 0.0 if special == "ties" else 0.3
    pen = torch.where(torch.rand(shape, device="cuda", generator=g) < gate, NEG_INF, 0.0)
    if special == "gated":
        pen[1] = NEG_INF
    min_sim = torch.where(torch.arange(b, device="cuda") % 2 == 1, 0.02, 0.0)
    before = masked_topk.launches
    kv, ki = masked_topk(q, v, pen, min_sim, m, row_scales=scales)
    torch.cuda.synchronize()
    assert masked_topk.launches == before + 1
    rv, ri = masked_topk_reference(q, v, pen, min_sim, m, row_scales=scales)
    assert_topk_equal(kv.cpu(), ki.cpu(), rv.cpu(), ri.cpu(), tie=1e-5, atol=1e-4)
    if special == "ties":  # equal rows score equal: the lower row first, exactly
        assert torch.equal(ki.cpu(), torch.arange(m, dtype=torch.int32).expand(b, m))
    if special == "gated":
        assert (kv[1] <= NEG_INF / 2).all()


# (query kind, B, D, C, m, penalty form, special) of the tensor-core core's
# card tests: the engine's bf16-exact queries (one query part a k-step),
# float32 queries with a nonzero lo part (three), and one tile mixing both;
# D not a multiple of 16 (under one k-slice; past 24 of them), B=5 (an
# 8-query tile) and B=33 (a second 32-query tile), a [C] penalty; every
# row one row: all scores tie, the lower row first
ON_CARD_ROWS = [
    ("exact", 32, 1536, 20000, 40, "bc", None), ("split", 32, 1536, 20000, 40, "bc", None),
    ("mixed", 32, 1536, 20000, 40, "bc", None),
    ("split", 5, 20, 3000, 10, "bc", None), ("exact", 5, 20, 3000, 10, "c", None),
    ("mixed", 33, 1540, 5000, 40, "bc", None), ("split", 33, 1540, 5000, 40, "c", None),
    ("exact", 12, 1536, 5000, 40, "c", None), ("split", 1, 1536, 70144, 40, "bc", None),
    ("exact", 4, 1536, 5000, 40, "c", "ties"), ("split", 4, 1536, 5000, 40, "c", "ties")]


def _rows_on_card(dtype, qkind, b, d, c, m, pen_form, special):
    """`dtype` rows on the tensor cores against the plain version, for
    every kind of float32 query the kernel's exact split meets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from mobius_rag_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device="cuda").manual_seed(c + d + b)
    v = torch.randn(1 if special == "ties" else c, d, device="cuda", generator=g)
    v = (v / v.norm(dim=1, keepdim=True)).expand(c, d)
    scales = None
    if dtype == torch.int8:
        v, scales = quantize_rows(v)
    v = v.to(dtype).contiguous()
    q = torch.randn(b, d, device="cuda", generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    if qkind == "exact":
        q = q.to(torch.bfloat16).float()
    elif qkind == "mixed":
        q[1::2] = q[1::2].to(torch.bfloat16).float()
    lo = bf16_parts(q)[2]
    assert bool(lo[0].ne(0).any()) == (qkind != "exact")  # query 0 needs three parts or one
    shape = (b, c) if pen_form == "bc" else (c,)
    gate = 0.0 if special == "ties" else 0.3
    pen = torch.where(torch.rand(shape, device="cuda", generator=g) < gate, NEG_INF, 0.0)
    min_sim = torch.where(torch.arange(b, device="cuda") % 2 == 1, 0.02, 0.0)
    before = masked_topk.launches
    kv, ki = masked_topk(q, v, pen, min_sim, m, row_scales=scales)
    torch.cuda.synchronize()
    assert masked_topk.launches == before + 1
    rv, ri = masked_topk_reference(q, v, pen, min_sim, m, row_scales=scales)
    assert_topk_equal(kv.cpu(), ki.cpu(), rv.cpu(), ri.cpu(), tie=1e-5, atol=1e-4)
    if special == "ties":
        assert torch.equal(ki.cpu(), torch.arange(m, dtype=torch.int32).expand(b, m))


@pytest.mark.cuda
@pytest.mark.parametrize("qkind,b,d,c,m,pen_form,special", ON_CARD_ROWS)
def test_bf16_rows_on_card(qkind, b, d, c, m, pen_form, special):
    """bf16 rows on the tensor cores against the plain version, for every
    kind of float32 query the kernel's exact split meets."""
    _rows_on_card(torch.bfloat16, qkind, b, d, c, m, pen_form, special)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("qkind,b,d,c,m,pen_form,special", ON_CARD_ROWS)
def test_f32_int8_rows_on_card(dtype, qkind, b, d, c, m, pen_form, special):
    """float32 rows (three bf16 parts each) and int8 rows (widened to bf16
    exactly) through the k-permuted fragments of the tensor-core core,
    against the plain version, for every kind of float32 query."""
    _rows_on_card(getattr(torch, dtype), qkind, b, d, c, m, pen_form, special)
