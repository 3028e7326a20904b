"""The port's encoder (mobius_rag_tpu_torch.models) against the JAX package's
on the same parameters: the tokenizer, ``encode`` at EncoderConfig.tiny()
with and without the hybrid anchor, sequence buckets, the batch ladder
(``_bucket`` against the JAX rule; padded blocks, their padded rows
dropped and finite), EncoderModel as an embed_fn, and the npz checkpoint
both ways.

The JAX parameters are drawn on the CPU with PRNGKey and carried across as
numpy arrays (parity at init cannot hold: the RNGs differ). Tolerances:
float32 activations agree within 1e-5 max abs (summation order only);
bfloat16 activations within a per-row cosine of 0.999 and 3e-2 max abs on
the unit-norm outputs (bf16 rounds each product to 8 bits of mantissa, and
the two libraries round the intermediate results of elementwise chains in
different places). The card cases (marked ``cuda``, run by
scripts/card_tests.py) hold bf16 against float32 on the card at the full
width's layer shapes, and every captured (batch bucket, sequence bucket)
graph bitwise against the eager forward.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu.models import checkpoint as jckpt
from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from mobius_rag_tpu_torch.models import checkpoint as tckpt
from mobius_rag_tpu_torch.models import encoder as tenc
from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer

F32_TOL = 1e-5
BF16_COS = 0.999
BF16_ABS = 3e-2

TEXTS = [
    "Timely filing deadline for Sunshine Health claims is 180 days.",
    "Prior authorization is required for H0019 behavioral health services.",
    "Molina corrected claims must be resubmitted within 90 days of the denial.",
    "What is the appeals window for a denied Medicaid claim?",
    "",
    "A much longer paragraph about claims submission windows, corrected claim "
    "resubmission requirements, coordination of benefits and the documentation "
    "a participating provider keeps for retrospective review by the plan.",
]


def _cfgs(dtype: str, hybrid: bool):
    jcfg = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=dtype, hybrid_anchor=hybrid)
    return jcfg, tenc.EncoderConfig(**dataclasses.asdict(jcfg))


def _jax_params(jcfg, seed: int = 3):
    return jenc.init_params(jcfg, jax.random.PRNGKey(seed))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(cfg, texts=TEXTS, length=None):
    toks = HashTokenizer(cfg.vocab_size, cfg.max_seq).encode_batch(texts)
    return toks[:, :length] if length else toks


def _rowwise_cos(a, b):
    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    live = (na > 0) & (nb > 0)
    return (a * b).sum(1)[live] / (na[live] * nb[live])


def _port(tcfg, jparams):
    return tenc.Encoder(tcfg, tenc.params_from_numpy(_numpy_tree(jparams)), device="cpu")


@torch.no_grad()
def _port_encode(tcfg, jparams, toks):
    return _port(tcfg, jparams)(torch.from_numpy(toks)).numpy()


@pytest.mark.parametrize("vocab,max_len", [(1024, 16), (32768, 512), (50, 8)])
def test_tokenizer_ids_equal(vocab, max_len):
    texts = TEXTS + ["timely filings deadlines for claim", "H0019 H0019 H0019 " * 200]
    want = JaxTokenizer(vocab, max_len).encode_batch(texts)
    got = HashTokenizer(vocab, max_len).encode_batch(texts)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_encode_float32_matches_jax(hybrid):
    jcfg, tcfg = _cfgs("float32", hybrid)
    params = _jax_params(jcfg)
    toks = _tokens(jcfg)
    want = np.asarray(jenc.encode_jit(params, jnp.asarray(toks), jcfg))
    got = _port_encode(tcfg, params, toks)
    assert got.shape == want.shape == (len(TEXTS), jcfg.out_dim)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_encode_bfloat16_matches_jax(hybrid):
    jcfg, tcfg = _cfgs("bfloat16", hybrid)
    params = _jax_params(jcfg, seed=5)
    toks = _tokens(jcfg)
    want = np.asarray(jenc.encode_jit(params, jnp.asarray(toks), jcfg))
    got = _port_encode(tcfg, params, toks)
    assert got.dtype == np.float32
    assert _rowwise_cos(got, want).min() >= BF16_COS
    assert np.abs(got - want).max() <= BF16_ABS


def test_hybrid_anchor_alpha_zero_is_the_bag_of_tokens():
    """At alpha=0 the hybrid encoder returns the normalized anchor bag (the
    hash baseline), whatever the transformer computes."""
    jcfg, tcfg = _cfgs("float32", True)
    params = _numpy_tree(_jax_params(jcfg))
    params["alpha"] = np.zeros((), np.float32)
    toks = _tokens(jcfg)[:4]
    got = tenc.Encoder(tcfg, tenc.params_from_numpy(params), device="cpu")(torch.from_numpy(toks))
    mask = toks != 0
    bag = (params["anchor_proj"][toks] * mask[..., None]).sum(1)
    bag /= np.linalg.norm(bag, axis=1, keepdims=True)
    np.testing.assert_allclose(got.detach().numpy(), bag, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_bucket_equals_full_length(dtype, monkeypatch):
    """Trimming PAD columns to a bucket is exact: PAD positions are masked
    out of attention and pooling."""
    monkeypatch.setattr(tenc, "_SEQ_BUCKETS", (8, 16, 32))
    _, tcfg = _cfgs(dtype, False)
    model = tenc.Encoder(tcfg, tenc.init_params(tcfg, torch.Generator().manual_seed(1)),
                         device="cpu")
    full = _tokens(tcfg, TEXTS[:4])
    trimmed = tenc.seq_bucket(full)
    assert trimmed.shape[1] < full.shape[1]
    with torch.no_grad():
        a = model(torch.from_numpy(full)).numpy()
        b = model(torch.from_numpy(trimmed)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6 if dtype == "float32" else 1e-2)
    assert _rowwise_cos(a, b).min() >= 1 - 1e-6


def test_pad_invariance_against_jax():
    """The same text at two pad lengths gives one embedding, in both
    packages."""
    jcfg, tcfg = _cfgs("float32", False)
    params = _jax_params(jcfg)
    for length in (16, 64):
        toks = _tokens(jcfg, TEXTS[:2], length)
        want = np.asarray(jenc.encode_jit(params, jnp.asarray(toks), jcfg))
        got = _port_encode(tcfg, params, toks)
        assert np.abs(got - want).max() <= F32_TOL
        if length == 16:
            short = got
    np.testing.assert_allclose(got, short, atol=F32_TOL)


def test_encoder_model_matches_jax_across_batch_chunks(monkeypatch):
    """EncoderModel (the embed_fn) on 40 texts, in chunks of 32 (a ladder
    whose top is 32) so a batch boundary is crossed, against the JAX
    EncoderModel (bf16)."""
    jcfg, tcfg = _cfgs("bfloat16", False)
    params = _jax_params(jcfg, seed=7)
    texts = [f"{TEXTS[i % len(TEXTS)]} variant {i} of the policy" for i in range(40)]
    want = jenc.EncoderModel(jcfg, params)(texts)
    monkeypatch.setattr(tenc, "_BATCH_BUCKETS", (1, 8, 32))
    model = tenc.EncoderModel(tcfg, tenc.params_from_numpy(_numpy_tree(params)), device="cpu")
    got = model(texts)
    assert got.shape == want.shape == (40, jcfg.out_dim) and got.dtype == np.float32
    assert _rowwise_cos(got, want).min() >= BF16_COS
    assert np.abs(got - want).max() <= BF16_ABS
    assert model([]).shape == (0, jcfg.out_dim)


def test_encoder_model_default_is_the_env_config_on_cuda():
    """No config → EncoderConfig.from_env() (the served width), and the
    device defaults to cuda."""
    import inspect

    assert inspect.signature(tenc.EncoderModel).parameters["device"].default == "cuda"
    cfg = tenc.EncoderConfig.from_env()
    assert (cfg.num_layers, cfg.num_heads, cfg.model_dim, cfg.mlp_dim, cfg.max_seq,
            cfg.dtype) == (12, 12, 768, 3072, 512, "bfloat16")
    assert tenc.flops_per_token(dataclasses.replace(cfg, out_dim=1536), 256) == 181_665_792


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_checkpoint_from_jax_npz(tmp_path, monkeypatch, hybrid):
    """JAX save_encoder (orbax hidden, so it writes its npz fallback) →
    the port's load_encoder: the same parameters, bit for bit."""
    jcfg, tcfg = _cfgs("bfloat16", hybrid)
    params = _jax_params(jcfg)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jckpt.save_encoder(str(tmp_path), params, jcfg)
    assert json.load(open(tmp_path / "encoder.json"))["backend"] == "npz"
    tree, cfg = tckpt.load_encoder(str(tmp_path))
    assert cfg == tcfg
    want = jax.tree_util.tree_leaves(_numpy_tree(params))
    got = tenc.flatten_params(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    model = tenc.Encoder(cfg, tree, device="cpu")
    for p, w in zip(tenc.flatten_params(model.params_tree()), want):
        np.testing.assert_array_equal(p.detach().numpy(), w)


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_checkpoint_to_jax(tmp_path, hybrid):
    """The port's save_encoder → JAX load_encoder: the same parameters, bit
    for bit, and the same embeddings in float32."""
    jcfg, tcfg = _cfgs("float32", hybrid)
    model = tenc.Encoder(tcfg, tenc.init_params(tcfg, torch.Generator().manual_seed(9)),
                         device="cpu")
    tckpt.save_encoder(str(tmp_path), model.params_tree(), tcfg)
    params, cfg = jckpt.load_encoder(str(tmp_path))
    assert cfg == jcfg
    got = jax.tree_util.tree_leaves(params)
    want = tenc.flatten_params(model.params_tree())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.detach().numpy())
    toks = _tokens(jcfg)
    with torch.no_grad():
        mine = model(torch.from_numpy(toks)).numpy()
    theirs = np.asarray(jenc.encode_jit(params, jnp.asarray(toks), jcfg))
    assert np.abs(mine - theirs).max() <= F32_TOL


@pytest.mark.parametrize("kind", ["bi", "cross"])
def test_checkpoint_from_jax_orbax(tmp_path, kind):
    """JAX save_encoder with orbax (its first choice) → the port's
    load_encoder, which reads the orbax files through tensorstore without
    JAX: the same parameters, bit for bit, for the encoder and the
    cross-encoder."""
    pytest.importorskip("orbax.checkpoint")
    pytest.importorskip("tensorstore")
    from mobius_rag_tpu.models import cross_encoder as jce

    jcfg, tcfg = _cfgs("float32", False)
    if kind == "cross":
        params = jce.init_cross_params(jce.CrossEncoderConfig(jcfg), jax.random.PRNGKey(4))
    else:
        params = _jax_params(jcfg)
    jckpt.save_encoder(str(tmp_path), jax.device_get(params), jcfg, kind=kind)
    assert json.load(open(tmp_path / "encoder.json"))["backend"] == "orbax"
    tree, cfg = tckpt.load_encoder(str(tmp_path))
    assert cfg == tcfg
    want = jax.tree_util.tree_leaves(_numpy_tree(params))
    got = tenc.flatten_params(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


def test_checkpoint_refuses_what_the_port_cannot_read(tmp_path, monkeypatch):
    """An orbax checkpoint is refused only where tensorstore is missing
    (it reads orbax's files); an unknown kind and too few leaves raise."""
    _, tcfg = _cfgs("float32", False)
    with open(tmp_path / "encoder.json", "w") as f:
        json.dump({"backend": "orbax", "kind": "bi", "config": dataclasses.asdict(tcfg)}, f)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        tckpt.load_encoder(str(tmp_path))
    with pytest.raises(ValueError, match="kind"):
        tckpt.save_encoder(str(tmp_path / "x"), {}, tcfg, kind="mono")
    with pytest.raises(ValueError, match="fewer leaves"):
        tenc.unflatten_params(tcfg, [])


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_mesh_encoder_matches_encoder_model(dp):
    """MeshEncoderModel over dp CPU devices splits each batch over them; its
    rows equal EncoderModel's on the same (JAX-drawn) parameters, within
    the float32 bound; one replica per distinct device."""
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    jcfg, tcfg = _cfgs("float32", False)
    params = tenc.params_from_numpy(_numpy_tree(_jax_params(jcfg)))
    one = tenc.EncoderModel(tcfg, params, device="cpu")
    mesh = tenc.MeshEncoderModel(make_mesh(dp, devices=["cpu"] * dp), tcfg, params)
    texts = TEXTS * 3
    assert np.abs(mesh(texts) - one(texts)).max() <= F32_TOL
    assert len({id(m) for m in mesh.modules}) == 1
    assert mesh([]).shape == (0, tcfg.out_dim)


_MESH_BUCKETS_PROBE = r"""
import json
import types
from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu_torch.models import encoder as tenc
ns = range(1, 301)
print(json.dumps([[[tenc.MeshEncoderModel._bucket(types.SimpleNamespace(dp=dp), n) for n in ns],
                   [jenc.MeshEncoderModel._bucket(types.SimpleNamespace(dp=dp), n) for n in ns]]
                  for dp in range(1, 9)]))
"""


@pytest.mark.parametrize("ladder", [None, "2,16,48"], ids=["default", "custom"])
def test_mesh_bucket_matches_jax(ladder):
    """MeshEncoderModel's batch bucket (the smallest batch bucket that dp
    divides, else a multiple of max(top bucket, dp)) against the JAX
    MeshEncoderModel._bucket for dp = 1..8 and n = 1..300, under the
    default ladder and a custom MRAG_ENCODER_BATCH_BUCKETS (read at import
    by both packages, so each runs in a fresh interpreter)."""
    got_want = json.loads(_probe(_MESH_BUCKETS_PROBE, ladder))
    for dp, (got, want) in enumerate(got_want, start=1):
        assert got == want, dp
        assert all(b >= n for n, b in enumerate(got, start=1))


@pytest.mark.parametrize("dp", [2, 8])
def test_mesh_model_matches_jax_mesh_model(dp):
    """MeshEncoderModel's rows against the JAX MeshEncoderModel's over dp
    devices (the JAX model over dp of the 8 virtual CPU devices, as
    tests/test_encoder.py runs it), on the same float32 parameters, at
    n = 1, 3, 8 and 17 (a sub-dp batch, uneven ones, a bucket past 8),
    within F32_TOL."""
    from mobius_rag_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    jcfg, tcfg = _cfgs("float32", False)
    params = _jax_params(jcfg, seed=13)
    jmesh = jenc.MeshEncoderModel(jmake_mesh(dp), jcfg, params)
    tmesh = tenc.MeshEncoderModel(make_mesh(dp, devices=["cpu"] * dp), tcfg,
                                  tenc.params_from_numpy(_numpy_tree(params)))
    for n in (1, 3, 8, 17):
        texts = [f"timely filing rule variant {i}" for i in range(n)]
        want, got = jmesh(texts), tmesh(texts)
        assert got.shape == want.shape == (n, jcfg.out_dim)
        assert np.abs(got - want).max() <= F32_TOL, n


# a grid of dp = 4 positions over two distinct (CPU) devices
_MESH_DEVICES = ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]


def _mesh_stand_in(mesh) -> list:
    """`mesh` replaying through the stand-in capture: one per distinct
    device, as on a card."""
    from test_torch_compiled import StandIn

    caches = []
    for rep in dict.fromkeys(mesh.replicas):
        rep._programs = StandIn(rep.device)
        rep._graphs = True
        caches.append(rep._programs)
    return caches


def test_mesh_encoder_keys_are_part_rows_and_length():
    """Captured (the stand-in), each distinct device of the grid keeps its
    own programs, one graph per (part rows, sequence bucket): bucket / dp
    rows a part; every call gives the eager model's rows bitwise, and
    EncoderModel's within F32_TOL."""
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    jcfg, tcfg = _cfgs("float32", False)
    tcfg = dataclasses.replace(tcfg, max_seq=256)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(6))
    grid = make_mesh(4, devices=_MESH_DEVICES)
    mesh = tenc.MeshEncoderModel(grid, tcfg, params)
    eager = tenc.MeshEncoderModel(grid, tcfg, params, graphs=False)
    one = tenc.EncoderModel(tcfg, params, device="cpu")
    assert mesh.graphs is False and len({id(m) for m in mesh.modules}) == 2
    caches = _mesh_stand_in(mesh)
    calls = [(3, 10), (3, 10), (9, 100), (130, 10), (3, 200), (9, 100)]
    for n, words in calls:
        texts = [" ".join(f"w{(i * 7 + j) % 50}" for j in range(words)) + f" r{i}"
                 for i in range(n)]
        got = mesh(texts)
        np.testing.assert_array_equal(got, eager(texts))
        assert np.abs(got - one(texts)).max() <= F32_TOL
    # 3 texts: bucket 8, 2 rows a part; 9: 32, 8; 130: 128 and 8 (32, 2)
    keys = {(2, 64), (8, 128), (32, 64), (2, 256)}
    for cache in caches:
        assert {key for key, _ in cache.graphs} == keys
        assert cache.captures == len(keys)
    # each device runs 2 of the 4 parts a block: 7 blocks, 14 parts a device
    assert [c.captures + c.replays for c in caches] == [14, 14]


def test_mesh_encoder_graphs_true_on_cpu_raises():
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="CUDA"):
        tenc.MeshEncoderModel(grid, tenc.EncoderConfig.tiny(), graphs=True)
    mesh = tenc.MeshEncoderModel(grid, tenc.EncoderConfig.tiny())
    assert mesh.graphs is False
    with pytest.raises(ValueError, match="CUDA"):
        mesh.graphs = True
    assert mesh.graphs is False


def _probe(code: str, ladder) -> str:
    """The last line `code` prints in a fresh interpreter with the JAX
    package on the CPU, under the batch ladder `ladder` (None: the
    default)."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("MRAG_ENCODER_BATCH_BUCKETS", None)
    if ladder:
        env["MRAG_ENCODER_BATCH_BUCKETS"] = ladder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return run.stdout.strip().splitlines()[-1]


_BUCKETS_PROBE = r"""
import json
from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu_torch.models import encoder as tenc
ns = range(1, 301)
print(json.dumps([tenc._BATCH_BUCKETS, [tenc._bucket(n) for n in ns],
                  [jenc.EncoderModel._bucket(None, n) for n in ns]]))
"""


@pytest.mark.parametrize("ladder", [None, "2,16,48"], ids=["default", "custom"])
def test_batch_bucket_matches_jax(ladder):
    """The port's batch ladder and _bucket(n) against the JAX
    EncoderModel._bucket for n = 1..300, under the default ladder and a
    custom MRAG_ENCODER_BATCH_BUCKETS (read at import by both packages, so
    each runs in a fresh interpreter)."""
    ladder_got, got, want = json.loads(_probe(_BUCKETS_PROBE, ladder))
    assert ladder_got == [int(x) for x in (ladder or "1,8,32,128").split(",")]
    assert got == want
    assert got[300 - 1] == -(-300 // ladder_got[-1]) * ladder_got[-1]


@pytest.mark.parametrize("n", [3, 9, 33, 130])
def test_padded_model_matches_jax_model(n, monkeypatch):
    """EncoderModel pads each chunk to its batch bucket (130 texts: a chunk
    of 128 and one of 2, padded to 8) and drops the padded rows: float32
    rows against the JAX EncoderModel's within F32_TOL."""
    jcfg, tcfg = _cfgs("float32", False)
    params = _jax_params(jcfg, seed=11)
    texts = [f"{TEXTS[i % len(TEXTS)]} padded batch row {i}" for i in range(n)]
    want = jenc.EncoderModel(jcfg, params)(texts)
    model = tenc.EncoderModel(tcfg, tenc.params_from_numpy(_numpy_tree(params)), device="cpu")
    shapes = []
    real = model._forward

    def forward(block, rows):
        shapes.append((block.shape[0], rows))
        return real(block, rows)

    monkeypatch.setattr(model, "_forward", forward)
    got = model(texts)
    assert got.shape == want.shape == (n, jcfg.out_dim)
    chunks = [min(128, n - off) for off in range(0, n, 128)]
    assert shapes == [(tenc._bucket(c), c) for c in chunks]
    assert all(b > c for b, c in shapes if c not in tenc._BATCH_BUCKETS)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_rows_match_unpadded(dtype):
    """A block's real rows padded to their bucket (5 → 8, 20 → 32) against
    the same rows through the module unpadded, within the file's
    tolerances."""
    _, tcfg = _cfgs(dtype, False)
    model = tenc.EncoderModel(tcfg, tenc.init_params(tcfg, torch.Generator().manual_seed(2)),
                              device="cpu")
    for n in (5, 20):
        toks = _tokens(tcfg, [f"{TEXTS[i % len(TEXTS)]} row {i}" for i in range(n)])
        padded = model.encode_tokens(toks).numpy()
        with torch.no_grad():
            alone = model.module(torch.from_numpy(toks)).numpy()
        assert padded.shape == alone.shape == (n, tcfg.out_dim)
        if dtype == "float32":
            assert np.abs(padded - alone).max() <= F32_TOL
        else:
            assert _rowwise_cos(padded, alone).min() >= BF16_COS
            assert np.abs(padded - alone).max() <= BF16_ABS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_all_pad_row_is_finite(dtype, hybrid):
    """A padded row (all PAD: its mask all false, its softmax uniform, its
    pooled denominator clamped to 1) gives a finite output, and leaves the
    real rows as they are alone."""
    _, tcfg = _cfgs(dtype, hybrid)
    module = tenc.Encoder(tcfg, tenc.init_params(tcfg, torch.Generator().manual_seed(4)),
                          device="cpu")
    toks = tenc.pad_rows(_tokens(tcfg, TEXTS[:2]), 8)
    assert not toks[2:].any()
    with torch.no_grad():
        out = module(torch.from_numpy(toks))
    assert torch.isfinite(out).all()
    assert out[2:].abs().max() == 0  # nothing pooled, nothing projected


@pytest.mark.cuda
def test_bf16_matches_float32_on_card():
    """On the card, at the served width's layer shapes (2 of 12 layers, to
    keep the test short): bf16 activations hold a per-row cosine of 0.99
    against float32 activations on the same parameters (chip_smoke.py's
    phase 7 bound at all 12 layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(tenc.EncoderConfig(), num_layers=2)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    bf = tenc.EncoderModel(cfg, params, device="cuda")
    f32 = tenc.EncoderModel(dataclasses.replace(cfg, dtype="float32"), params, device="cuda")
    texts = [f"{TEXTS[i % len(TEXTS)]} card case {i}" for i in range(200)]
    a, b = bf(texts), f32(texts)
    assert a.shape == b.shape == (200, cfg.out_dim)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert _rowwise_cos(a, b).min() >= 0.99
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _long_texts(words: int, n: int) -> list[str]:
    base = " ".join(TEXTS).split()
    return [" ".join(base[(i + j) % len(base)] for j in range(words)) + f" r{i}"
            for i in range(n)]


# texts per call and their words: every batch bucket at every sequence
# bucket (64, 128, 256 and max_seq 512)
CARD_CALLS = [(n, w) for n in (1, 5, 20, 100) for w in (30, 100, 200, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_captured_forward_bitwise_on_card(hybrid):
    """On the card, the served width's layers (2 of 12): one graph per
    (batch bucket, sequence bucket), all 16 of them, each replay bitwise
    the eager forward (graphs=False) on the same padded block, every row;
    the padded rows dropped from the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import _graphs_bitwise

    cfg = dataclasses.replace(tenc.EncoderConfig(), num_layers=2, hybrid_anchor=hybrid)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    model = tenc.EncoderModel(cfg, params, device="cuda")
    eager = tenc.EncoderModel(cfg, params, device="cuda", graphs=False)
    assert model.graphs and not eager.graphs
    for n, words in CARD_CALLS:
        texts = _long_texts(words, n)
        first, again, want = model(texts), model(texts), eager(texts)
        assert first.shape == again.shape == (n, cfg.out_dim)
        np.testing.assert_array_equal(again, want)
        np.testing.assert_array_equal(first, want)
    keys = {key for key, _ in model._programs.graphs}
    assert keys == {(b, length) for b in (1, 8, 32, 128) for length in (64, 128, 256, 512)}
    assert model._programs.captures == 16 and model._programs.replays == 16
    assert _graphs_bitwise(model, "encoder") == 16


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [2, 4])
def test_mesh_encoder_captured_bitwise_on_card(dp):
    """On the card, the served width's layers (2 of 12) over [cuda:0] * dp:
    each part replays its device's graph of (bucket / dp, sequence bucket),
    bitwise the eager model (graphs=False: the same parts eagerly) over
    keys that switch, first run and replay alike; the rows within a
    per-row cosine of 0.999 of EncoderModel's (other GEMM shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(tenc.EncoderConfig(), num_layers=2)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    grid = make_mesh(dp, devices=["cuda:0"] * dp)
    mesh = tenc.MeshEncoderModel(grid, cfg, params)
    eager = tenc.MeshEncoderModel(grid, cfg, params, graphs=False)
    one = tenc.EncoderModel(cfg, params, device="cuda")
    assert mesh.graphs and not eager.graphs and len(set(mesh.replicas)) == 1
    calls = [(5, 30), (100, 100), (5, 30), (20, 200), (100, 100), (1, 400), (20, 200)]
    for n, words in calls:
        texts = _long_texts(words, n)
        got, want = mesh(texts), eager(texts)
        assert got.shape == (n, cfg.out_dim)
        np.testing.assert_array_equal(got, want)
        assert _rowwise_cos(got, one(texts)).min() >= BF16_COS
    cache = mesh.replicas[0]._programs
    buckets = {5: 8, 100: 128, 20: 32, 1: 8 if dp > 1 else 1}
    lengths = {30: 64, 100: 128, 200: 256, 400: 512}
    keys = {(buckets[n] // dp, lengths[w]) for n, w in calls}
    assert {key for key, _ in cache.graphs} == keys and cache.captures == len(keys)
    assert cache.captures + cache.replays == dp * len(calls)


@pytest.mark.cuda
def test_mesh_encoder_over_cards_on_card():
    """With four cards or more: MeshEncoderModel over cuda:0..3 (dp 4, a
    replica a card, the parts joined on cuda:0 by copies between cards),
    the served width's layers (2 of 12), over keys that switch: captured
    bitwise its eager twin, and each part's rows bitwise EncoderModel's on
    cuda:0 for the same part (the same shapes on another card of the same
    kind)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(tenc.EncoderConfig(), num_layers=2)
    params = tenc.init_params(cfg, torch.Generator(device="cuda:0").manual_seed(0))
    grid = make_mesh(4, devices=[f"cuda:{i}" for i in range(4)])
    mesh = tenc.MeshEncoderModel(grid, cfg, params)
    eager = tenc.MeshEncoderModel(grid, cfg, params, graphs=False)
    one = tenc.EncoderModel(cfg, params, device="cuda:0")
    assert [r.device for r in mesh.replicas] == [torch.device("cuda", i) for i in range(4)]
    for n, words in [(5, 30), (100, 100), (5, 30), (128, 200), (100, 100)]:
        tokens = tenc.seq_bucket(mesh.tokenizer.encode_batch(_long_texts(words, n)))
        got = mesh.encode_tokens(tokens)
        assert got.device == torch.device("cuda", 0) and got.shape == (n, cfg.out_dim)
        np.testing.assert_array_equal(got.cpu().numpy(), eager.encode_tokens(tokens).cpu().numpy())
        rows = mesh._bucket(n) // 4
        block = tenc.pad_rows(tokens, 4 * rows)
        parts = torch.cat([one._forward(block[i * rows:(i + 1) * rows], rows) for i in range(4)])
        np.testing.assert_array_equal(got.cpu().numpy(), parts[:n].cpu().numpy())
    assert all(r._programs.captures == 3 for r in mesh.replicas)
