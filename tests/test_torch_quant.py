"""int8 rows in the port (ops/quant.py, the int8-row form of ops/topk.py)
against the JAX package on the same numpy inputs.

- ``_quantize_block`` / ``quantize_rows``: int8 values and scales bitwise,
  including zero rows, rows whose max-abs is tied at ±max, values that
  land on .5 after the division, and the row blocking.
- ``cosine_topk_int8``: values within 1e-5 (float32 order of the two scale
  products and the penalty), ids equal except inside runs of values tied
  within 1e-6; the recall and penalty properties of
  tests/test_quant_ivf.py:31-62.
- ``masked_topk_reference`` with int8 rows and ``row_scales`` against the
  JAX dense arm's arithmetic (``engine.py:277-279,483-485``: cast, dot,
  times the scale, penalty and min_sim, ``lax.top_k``): values within
  1e-5 (float32 summation order at D=256), ids tie-aware.
The CUDA kernel's int8-row form is held against the plain version on the
card (marked `cuda`; skipped without one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu.ops import quant as jquant
from mobius_rag_tpu.ops.topk import cosine_topk_xla
from mobius_rag_tpu_torch.ops import quant as tquant
from mobius_rag_tpu_torch.ops.topk import NEG_INF, masked_topk, masked_topk_reference

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6


def _rows(seed, n=600, d=256):
    """Normalized rows plus the edge rows: a zero row, a row whose max-abs
    is tied at +max and -max, rows on exact .5 boundaries after the
    division, and one with a single non-zero entry."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[0] = 0.0
    v[1, :] = 0.01
    v[1, 3], v[1, 7] = 0.5, -0.5
    v[2] = np.arange(d, dtype=np.float32) % 255 - 127  # integers: .0 after the scale
    v[3] = (np.arange(d) % 2 * 2 - 1).astype(np.float32) * 0.25
    v[4] = 0.0
    v[4, 9] = -3.0
    v[5] = (np.arange(d, dtype=np.float32) - d / 2) * 0.5 + 0.25  # .5 steps
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_block_bitwise(seed):
    v = _rows(seed)
    jq, js = (np.asarray(a) for a in jquant._quantize_block(jnp.asarray(v)))
    tq, ts = tquant._quantize_block(torch.from_numpy(v))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts[0] == 1.0 and not tq[0].any()  # a zero row: scale 1, zeros
    assert {int(tq[1, 3]), int(tq[1, 7])} == {127, -127}


@pytest.mark.parametrize("block", [64, 599, 600, 4096])
def test_quantize_rows_blocks_bitwise(block):
    v = _rows(3)
    jq, js = (np.asarray(a) for a in jquant.quantize_rows(v, block=block))
    tq, ts = tquant.quantize_rows(torch.from_numpy(v), block=block)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_rows_bf16_input_bitwise():
    """bf16 rows (a bf16 store's tensor) widen exactly before quantizing."""
    v = _rows(4)
    u16 = torch.from_numpy(v).to(torch.bfloat16)
    jv = jnp.asarray(u16.float().numpy()).astype(jnp.bfloat16)
    jq, js = (np.asarray(a) for a in jquant.quantize_rows(jv))
    tq, ts = tquant.quantize_rows(u16)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_int8_quantization_roundtrip():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((100, 256)).astype(np.float32)
    q, scale = tquant.quantize_rows(torch.from_numpy(v))
    deq = q.numpy().astype(np.float32) * scale.numpy()[:, None]
    assert np.abs(deq - v).max() / np.abs(v).max() < 0.01
    assert q.dtype == torch.int8


def _corpus(rng, n=4000, d=256, n_clusters=32, noise=0.02):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, n_clusters, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def assert_topk_equal(vals, idx, want_vals, want_idx, atol=ATOL):
    vals, want_vals = np.asarray(vals, np.float64), np.asarray(want_vals, np.float64)
    idx, want_idx = np.asarray(idx), np.asarray(want_idx)
    live = want_vals > NEG_INF / 2
    assert ((vals > NEG_INF / 2) == live).all()
    np.testing.assert_allclose(vals[live], want_vals[live], rtol=0, atol=atol)
    tied = np.abs(np.diff(want_vals, axis=1)) <= TIE
    strict = np.ones_like(live)
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    np.testing.assert_array_equal(idx[strict], want_idx[strict])


@pytest.mark.parametrize("gate", [0.0, 0.5])
def test_cosine_topk_int8_matches_jax(gate):
    rng = np.random.default_rng(1)
    v = _corpus(rng, n=1500, noise=0.1)
    q = v[:12] + 0.1 * rng.standard_normal((12, 256)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pen = np.where(rng.random(len(v)) < gate, NEG_INF, 0.0).astype(np.float32)
    jv8, js = jquant.quantize_rows(v)
    jvals, jidx = (np.asarray(a) for a in jquant.cosine_topk_int8(
        jv8, js, jnp.asarray(q), jnp.asarray(pen), 20))
    tv8, ts = tquant.quantize_rows(torch.from_numpy(v))
    tvals, tidx = tquant.cosine_topk_int8(tv8, ts, torch.from_numpy(q),
                                          torch.from_numpy(pen), 20)
    assert tidx.dtype == torch.int32
    assert_topk_equal(tvals.numpy(), tidx.numpy(), jvals, jidx)


def test_int8_topk_recall():
    rng = np.random.default_rng(0)
    v = _corpus(rng, noise=0.1)
    q = v[rng.choice(len(v), 16)] + 0.1 * rng.standard_normal((16, 256)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pen = np.zeros(len(v), np.float32)
    _, exact = cosine_topk_xla(v, q, pen, 10)
    qv, scale = tquant.quantize_rows(torch.from_numpy(v))
    _, idx8 = tquant.cosine_topk_int8(qv, scale, torch.from_numpy(q), torch.from_numpy(pen), 10)
    recall = np.mean([len(set(map(int, a)) & set(map(int, b))) / 10
                      for a, b in zip(np.asarray(exact), idx8.numpy())])
    assert recall >= 0.97


def test_int8_respects_penalty():
    rng = np.random.default_rng(0)
    v = _corpus(rng, n=500)
    qv, scale = tquant.quantize_rows(torch.from_numpy(v))
    pen = np.zeros(len(v), np.float32)
    pen[100:] = NEG_INF
    _, idx = tquant.cosine_topk_int8(qv, scale, torch.from_numpy(v[:2]), torch.from_numpy(pen), 5)
    assert (idx.numpy() < 100).all()


# ---------------------------------------------------------------------------
# the int8-row form of the masked top-k
# ---------------------------------------------------------------------------

def _arm_inputs(seed, b=6, c=900, d=256, pen_form="bc"):
    rng = np.random.default_rng(seed)
    v = _corpus(rng, n=c, d=d, noise=0.1)
    v8, scales = (np.array(a) for a in jquant.quantize_rows(v))
    q = v[rng.choice(c, b)] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shape = (b, c) if pen_form == "bc" else (c,)
    pen = np.where(rng.random(shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
    min_sim = np.where(np.arange(b) % 2 == 1, 0.2, 0.0).astype(np.float32)
    return q, v8, scales, pen, min_sim


def _jax_dense_arm(q, v8, scales, pen, min_sim, m):
    """engine.py:277-279,483-485: the JAX dense vector arm over int8 rows."""
    cos = jnp.dot(jnp.asarray(q), jnp.asarray(v8).astype(jnp.float32).T,
                  preferred_element_type=jnp.float32) * jnp.asarray(scales)[None, :]
    pen = jnp.asarray(pen)
    scores = cos + (pen if pen.ndim == 2 else pen[None, :]) + jnp.where(
        cos < jnp.asarray(min_sim)[:, None], NEG_INF, 0.0)
    return (np.asarray(a) for a in jax.lax.top_k(scores, m))


@pytest.mark.parametrize("pen_form,m", [("bc", 40), ("c", 40), ("bc", 512)])
def test_int8_rows_masked_topk_matches_jax_arm(pen_form, m):
    q, v8, scales, pen, min_sim = _arm_inputs(5, pen_form=pen_form)
    want_v, want_i = _jax_dense_arm(q, v8, scales, pen, min_sim, m)
    tv, ti = masked_topk(torch.from_numpy(q), torch.from_numpy(v8), torch.from_numpy(pen),
                         torch.from_numpy(min_sim), m, row_scales=torch.from_numpy(scales))
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert_topk_equal(tv.numpy(), ti.numpy(), want_v, want_i)


def test_int8_rows_every_row_gated():
    q, v8, scales, pen, min_sim = _arm_inputs(6)
    pen[2] = NEG_INF
    tv, _ = masked_topk_reference(torch.from_numpy(q), torch.from_numpy(v8),
                                  torch.from_numpy(pen), torch.from_numpy(min_sim), 30,
                                  torch.from_numpy(scales))
    assert (tv[2] <= NEG_INF / 2).all() and (tv[0] > NEG_INF / 2).any()


def test_row_scales_validated():
    q, v8, scales, pen, min_sim = (torch.from_numpy(a) for a in _arm_inputs(7))
    with pytest.raises(ValueError, match="row_scales"):
        masked_topk(q, v8, pen, min_sim, 10, row_scales=scales[:-1])
    with pytest.raises(ValueError, match="row_scales"):
        masked_topk(q, v8, pen, min_sim, 10, row_scales=scales.double())
    with pytest.raises(TypeError):
        masked_topk(q, v8.to(torch.int16), pen, min_sim, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,pen_form", [(70_144, 40, "bc"), (4096, 1024, "bc"),
                                          (3000, 40, "c")])
def test_int8_kernel_matches_plain_on_card(c, m, pen_form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(c)
    b, d = 32 if c > 10_000 else 8, 1536
    v = torch.randn(c, d, device="cuda", generator=g)
    v8, scales = tquant.quantize_rows(v / v.norm(dim=1, keepdim=True))
    q = torch.randn(b, d, device="cuda", generator=g)
    q = q / q.norm(dim=1, keepdim=True)
    shape = (b, c) if pen_form == "bc" else (c,)
    pen = torch.where(torch.rand(shape, device="cuda", generator=g) < 0.3, NEG_INF, 0.0)
    if pen_form == "bc":
        pen[1] = NEG_INF  # a query whose every row is gated
    before = masked_topk.launches
    kv, ki = masked_topk(q, v8, pen.contiguous(), None, m, row_scales=scales)
    torch.cuda.synchronize()
    rv, ri = masked_topk_reference(q, v8, pen, None, m, row_scales=scales)
    assert masked_topk.launches == before + 1
    assert_topk_equal(kv.cpu().numpy(), ki.cpu().numpy(), rv.cpu().numpy(),
                      ri.cpu().numpy(), atol=1e-4)
