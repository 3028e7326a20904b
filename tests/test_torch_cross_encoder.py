"""The cross-encoder in the port (models/cross_encoder.py: serving and the
margin trainer, kind="cross" checkpoints, the engine's rescoring stage and
MRAG_CROSS_ENCODER_CKPT in AppContext.build) against the JAX package.

The JAX parameters are drawn with PRNGKey on the CPU and carried across as
numpy arrays (the two RNGs differ). Tolerances: float32 logits within 1e-5
(summation order only); bfloat16 logits within BF16_REL = 2% of the
largest float32 logit's magnitude, against the JAX bf16 forward and
against the port's own float32 forward of the same parameters (bf16 keeps
8 bits of mantissa and the two libraries round elementwise chains in
different places; at EncoderConfig.tiny() the gap measures under 0.5%,
and chip_smoke.py holds the full width on the card to the same bound).
The margin loss's gradients against ``jax.grad``: in float32 within
GRAD_F32 = 5e-5 of each parameter's largest |gradient| (summation order;
measured 9e-6: the CLS readout funnels every pair through one position);
in bfloat16 test_torch_train.py's criterion (no further from the float32
gradient than the JAX package's own bf16 gradient, within its factor and
floor; both measure 3-13% here, most of it in the embedding table's bf16
accumulation).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.models import checkpoint as jckpt
from mobius_rag_tpu.models import cross_encoder as jce
from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.models import checkpoint as tckpt
from mobius_rag_tpu_torch.models import cross_encoder as tce
from mobius_rag_tpu_torch.models import encoder as tenc
from mobius_rag_tpu_torch.models.tokenizer import CLS_ID, SEP_ID, HashTokenizer
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_REL = 0.02
GRAD_F32 = 5e-5

QUERY = "What is the timely filing deadline for Sunshine Health claims?"
DOCS = [
    "Timely filing deadline for Sunshine Health claims is 180 days.",
    "Prior authorization is required for H0019 behavioral health services.",
    "",
    "A much longer paragraph about claims submission windows, corrected claim "
    "resubmission requirements, coordination of benefits and the documentation "
    "a participating provider keeps for retrospective review by the plan. " * 3,
    "molina",
]


def _cfgs(dtype: str):
    jbase = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=dtype)
    tbase = tenc.EncoderConfig(**dataclasses.asdict(jbase))
    return jce.CrossEncoderConfig(jbase), tce.CrossEncoderConfig(tbase)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pairs(max_len, query=QUERY, docs=DOCS):
    tok = JaxTokenizer(jenc.EncoderConfig.tiny().vocab_size, max_len)
    return np.stack([jce.encode_pair(tok, query, d) for d in docs])


@pytest.mark.parametrize("max_len", [8, 32, 64, 512])
@pytest.mark.parametrize("query", [QUERY, "", "x"])
def test_encode_pair_bitwise(max_len, query):
    jt, tt = JaxTokenizer(1024, max_len), HashTokenizer(1024, max_len)
    for doc in DOCS:
        want = jce.encode_pair(jt, query, doc)
        got = tce.encode_pair(tt, query, doc)
        assert got.dtype == want.dtype and got.shape == (max_len,)
        np.testing.assert_array_equal(got, want)
        assert got[0] == CLS_ID and SEP_ID in got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_pairs_float32_matches_jax(seed):
    jcfg, tcfg = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(seed))
    pairs = _pairs(jcfg.base.max_seq)
    want = np.asarray(jce.score_pairs_jit(params, jnp.asarray(pairs), jcfg))
    module = tce.CrossEncoder(tcfg, tenc.params_from_numpy(_np_tree(params)), device="cpu")
    with torch.no_grad():
        got = module(torch.from_numpy(pairs)).numpy()
    assert got.shape == want.shape == (len(DOCS),) and got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_score_pairs_bfloat16_matches_jax(seed):
    jcfg, tcfg = _cfgs("bfloat16")
    j32, t32 = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(seed))
    pairs = _pairs(jcfg.base.max_seq)
    want = np.asarray(jce.score_pairs_jit(params, jnp.asarray(pairs), jcfg))
    want32 = np.asarray(jce.score_pairs_jit(params, jnp.asarray(pairs), j32))
    tree = tenc.params_from_numpy(_np_tree(params))
    with torch.no_grad():
        got = tce.CrossEncoder(tcfg, tree, device="cpu")(torch.from_numpy(pairs)).numpy()
        got32 = tce.CrossEncoder(t32, tree, device="cpu")(torch.from_numpy(pairs)).numpy()
    bound = BF16_REL * np.abs(want32).max()
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - got32).max() <= bound


def test_model_matches_jax_model():
    """CrossEncoderModel (tokenize, trim to the sequence bucket, one
    forward) against the JAX CrossEncoderModel (its batch padded to 8):
    float32 within 1e-5; empty texts give an empty array."""
    jcfg, tcfg = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(7))
    jm = jce.CrossEncoderModel(jcfg, params)
    tm = tce.CrossEncoderModel(tcfg, tenc.params_from_numpy(_np_tree(params)), device="cpu")
    want, got = jm(QUERY, DOCS), tm(QUERY, DOCS)
    assert np.abs(got - want).max() <= F32_TOL
    assert tm(QUERY, []).shape == (0,)
    assert tm.module.score_head.dtype == torch.float32


def test_pair_bucket_matches_jax(monkeypatch):
    """pair_bucket at the reference's step (32) pads b pairs to the rows
    the JAX CrossEncoderModel hands score_pairs_jit (8, or a multiple of
    32), for b = 1..70; at step 8, to 8 or a multiple of 8."""
    jcfg, _ = _cfgs("float32")
    jm = jce.CrossEncoderModel(jcfg, jce.init_cross_params(jcfg, jax.random.PRNGKey(0)))
    rows = []

    def score_pairs_jit(params, tokens, cfg):
        rows.append(tokens.shape[0])
        return jnp.zeros((tokens.shape[0],), jnp.float32)

    monkeypatch.setattr(jce, "score_pairs_jit", score_pairs_jit)
    for b in range(1, 71):
        assert jm(QUERY, ["molina"] * b).shape == (b,)
    assert rows == [tce.pair_bucket(b) for b in range(1, 71)]
    assert tce.pair_bucket(10) == 32 and tce.pair_bucket(10, 8) == 16
    assert [tce.pair_bucket(b, 8) for b in (1, 8, 9, 16, 17, 33)] == [8, 8, 16, 16, 24, 40]


@pytest.mark.parametrize("step", [32, 8])
@pytest.mark.parametrize("n", [3, 9, 33, 130])
def test_padded_pairs_match_jax_model(n, step, monkeypatch):
    """CrossEncoderModel pads each batch of pairs to pair_bucket at its
    step and drops the padded rows: float32 logits against the JAX
    CrossEncoderModel's (padded to its own ladder) within F32_TOL."""
    jcfg, tcfg = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(5))
    docs = [f"{DOCS[i % len(DOCS)]} pair {i}" for i in range(n)]
    want = jce.CrossEncoderModel(jcfg, params)(QUERY, docs)
    tm = tce.CrossEncoderModel(tcfg, tenc.params_from_numpy(_np_tree(params)), device="cpu")
    monkeypatch.setattr(tm, "pair_step", step)
    shapes = []
    real = tm._forward

    def forward(block, rows):
        shapes.append((block.shape[0], rows))
        return real(block, rows)

    monkeypatch.setattr(tm, "_forward", forward)
    got = tm(QUERY, docs)
    assert shapes == [(tce.pair_bucket(n, step), n)] and shapes[0][0] > n
    assert got.shape == want.shape == (n,)
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_pairs_match_unpadded(dtype):
    """A batch's real logits padded (5 → 8, 10 → 32) against the same pairs
    through the module unpadded: float32 within F32_TOL, bfloat16 within
    BF16_REL of the largest logit; an all-PAD row's logit is finite."""
    _, tcfg = _cfgs(dtype)
    tm = tce.CrossEncoderModel(tcfg, seed=3, device="cpu")
    for n in (5, 10):
        docs = [f"{DOCS[i % len(DOCS)]} unpadded {i}" for i in range(n)]
        got = tm(QUERY, docs)
        pairs = tenc.seq_bucket(np.stack([tce.encode_pair(tm.tokenizer, QUERY, d)
                                          for d in docs]))
        block = tenc.pad_rows(pairs, tce.pair_bucket(n))
        with torch.no_grad():
            alone = tm.module(torch.from_numpy(pairs)).numpy()
            padded = tm.module(torch.from_numpy(block))
        assert torch.isfinite(padded).all()
        bound = F32_TOL if dtype == "float32" else BF16_REL * np.abs(alone).max()
        assert got.shape == alone.shape == (n,)
        assert np.abs(got - alone).max() <= bound


def test_init_cross_params_tree():
    """The port's fresh tree has the JAX tree's keys and shapes (its values
    come from another RNG)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = _np_tree(jce.init_cross_params(jcfg, jax.random.PRNGKey(0)))
    tp = tce.init_cross_params(tcfg, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp) and "proj" not in tp
    for a, b in zip(tenc.flatten_params(tp), jax.tree_util.tree_leaves(jp)):
        assert tuple(a.shape) == b.shape
    assert tp["score_head"].shape == (tcfg.base.model_dim, 1)


def test_cross_checkpoints_both_ways(tmp_path, monkeypatch):
    """kind="cross" npz checkpoints: written by the JAX package, read by
    the port (leaves in jax.tree_util order: embed, layers, ln_f_scale,
    pos, score_head) and the other way, leaf for leaf."""
    monkeypatch.setitem(__import__("sys").modules, "orbax.checkpoint", None)
    jcfg, tcfg = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(3))
    jckpt.save_encoder(str(tmp_path / "j"), jax.device_get(params), jcfg.base, kind="cross")
    got, cfg = tckpt.load_encoder(str(tmp_path / "j"))
    assert cfg == tcfg.base
    want = jax.tree_util.tree_leaves(_np_tree(params))
    assert sorted(got) == ["embed", "layers", "ln_f_scale", "pos", "score_head"]
    for g, w in zip(tenc.flatten_params(got), want):
        np.testing.assert_array_equal(g.numpy(), w)
    module = tce.CrossEncoder(tcfg, got, device="cpu")
    tckpt.save_encoder(str(tmp_path / "t"), module.params_tree(), tcfg.base, kind="cross")
    back, bcfg = jckpt.load_encoder(str(tmp_path / "t"))
    assert bcfg == jcfg.base
    for g, w in zip(jax.tree_util.tree_leaves(_np_tree(back)), want):
        np.testing.assert_array_equal(g, w)
    pairs = _pairs(jcfg.base.max_seq)
    with torch.no_grad():
        mine = module(torch.from_numpy(pairs)).numpy()
    assert np.abs(mine - np.asarray(jce.score_pairs_jit(back, jnp.asarray(pairs), jcfg))
                  ).max() <= F32_TOL


class _FlipCE:
    """Scores the hits in ascending order of their position."""

    def __call__(self, query, texts):
        return np.arange(len(texts), dtype=np.float32)


def test_engine_cross_rerank_hook():
    """tests/test_cross_encoder.py::test_engine_cross_rerank_hook in both
    packages: the stage reverses the hits, every hit carries the signal,
    and the confidence label keeps the linear rerank score."""
    out = {}
    for name, (store, lex, engine, request, embed) in {
            "jax": (JStore(), jtesting.sample_lexicon(), JEngine, JRequest,
                    jtesting.hash_embed),
            "port": (TStore(device="cpu"), ttesting.sample_lexicon(),
                     lambda *a, **kw: SearchEngine(*a, device="cpu", **kw), QueryRequest,
                     ttesting.hash_embed)}.items():
        store.add_chunks((jtesting if name == "jax" else ttesting).toy_corpus(lex, pad_docs=20))
        eng = engine(store, lex, embed_fn=embed)
        base = eng.search(request(query="timely filing deadline"), k=5)[0]
        eng.cross_encoder = _FlipCE()
        flipped = eng.search(request(query="timely filing deadline"), k=5)[0]
        eng.cross_encoder = None
        assert [h.chunk_id for h in flipped.hits] == [h.chunk_id for h in reversed(base.hits)]
        assert all("cross_encoder" in h.signals for h in flipped.hits)
        assert flipped.confidence_label == base.confidence_label
        out[name] = [(h.chunk_id, h.signals["cross_encoder"]) for h in flipped.hits]
    assert out["port"] == out["jax"]


def test_engine_stage_with_the_model_matches_jax():
    """A float32 CrossEncoderModel on both engines: the same hits in the
    same stable order of the model's logit, logits within 1e-5."""
    jcfg, tcfg = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(11))
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=30))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=30))
    je = JEngine(js, jlex, embed_fn=jtesting.hash_embed)
    te = SearchEngine(ts, tlex, embed_fn=ttesting.hash_embed, device="cpu")
    je.cross_encoder = jce.CrossEncoderModel(jcfg, params)
    te.cross_encoder = tce.CrossEncoderModel(tcfg, tenc.params_from_numpy(_np_tree(params)),
                                             device="cpu")
    queries = ["timely filing deadline", "prior authorization for durable medical equipment"]
    jres = je.search([JRequest(query=q) for q in queries], k=6)
    tres = te.search([QueryRequest(query=q) for q in queries], k=6)
    for a, b in zip(jres, tres):
        assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits] and b.hits
        ce = [h.signals["cross_encoder"] for h in b.hits]
        np.testing.assert_allclose(ce, [h.signals["cross_encoder"] for h in a.hits],
                                   rtol=0, atol=F32_TOL)
        assert ce == sorted(ce, reverse=True)


def test_appcontext_attaches_cross_encoder_from_env(tmp_path, monkeypatch):
    """MRAG_CROSS_ENCODER_CKPT (a checkpoint the JAX package wrote) wires
    the model into AppContext's engine on the context's device; searches
    then carry the signal on every hit."""
    monkeypatch.setitem(__import__("sys").modules, "orbax.checkpoint", None)
    from mobius_rag_tpu_torch.api import server

    jcfg, _ = _cfgs("bfloat16")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(0))
    ckpt = tmp_path / "ce"
    jckpt.save_encoder(str(ckpt), jax.device_get(params), jcfg.base, kind="cross")
    patched = dataclasses.replace(server.get_config(), cross_encoder_ckpt=str(ckpt))
    monkeypatch.setattr(server, "get_config", lambda: patched)
    ctx = server.AppContext.build(embed_fn=ttesting.hash_embed,
                                  lexicon=ttesting.sample_lexicon(), device="cpu")
    model = ctx.engine.cross_encoder
    assert isinstance(model, tce.CrossEncoderModel) and model.device.type == "cpu"
    assert model.cfg.base.dtype == "bfloat16"
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon, pad_docs=5))
    res = ctx.engine.search(QueryRequest(query="timely filing"), k=3)[0]
    assert res.hits and all("cross_encoder" in h.signals for h in res.hits)


def test_appcontext_serves_an_orbax_cross_checkpoint(tmp_path, monkeypatch):
    """The JAX package's first choice, an orbax checkpoint, is served
    through MRAG_CROSS_ENCODER_CKPT where tensorstore imports: the loaded
    score head equals the saved one, bit for bit."""
    pytest.importorskip("orbax.checkpoint")
    pytest.importorskip("tensorstore")
    from mobius_rag_tpu_torch.api import server

    jcfg, _ = _cfgs("float32")
    params = jce.init_cross_params(jcfg, jax.random.PRNGKey(6))
    ckpt = tmp_path / "ce_orbax"
    jckpt.save_encoder(str(ckpt), jax.device_get(params), jcfg.base, kind="cross")
    assert json.load(open(ckpt / "encoder.json"))["backend"] == "orbax"
    patched = dataclasses.replace(server.get_config(), cross_encoder_ckpt=str(ckpt))
    monkeypatch.setattr(server, "get_config", lambda: patched)
    ctx = server.AppContext.build(embed_fn=ttesting.hash_embed,
                                  lexicon=ttesting.sample_lexicon(), device="cpu")
    model = ctx.engine.cross_encoder
    assert isinstance(model, tce.CrossEncoderModel)
    np.testing.assert_array_equal(model.module.score_head.detach().numpy(),
                                  np.asarray(params["score_head"]))
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon, pad_docs=5))
    res = ctx.engine.search(QueryRequest(query="timely filing"), k=3)[0]
    assert res.hits and all("cross_encoder" in h.signals for h in res.hits)


# ---- training ---------------------------------------------------------------

def _margin_grads(jcfg, params, pos, neg):
    def loss_fn(p):
        s_pos = jce.score_pairs(p, jnp.asarray(pos), jcfg)
        s_neg = jce.score_pairs(p, jnp.asarray(neg), jcfg)
        return jnp.mean(jnp.maximum(0.0, 1.0 - s_pos + s_neg)), \
            jnp.mean((s_pos > s_neg).astype(jnp.float32))

    (loss, acc), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), float(acc), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_margin_loss_grads_match_jax(dtype):
    """One step of make_cross_train_step from the same parameters and pairs:
    the loss, accuracy and every parameter's gradient against jax.grad of
    the JAX step's loss."""
    from test_torch_train import assert_bf16_grads

    jcfg, tcfg = _cfgs(dtype)
    params = _np_tree(jce.init_cross_params(jcfg, jax.random.PRNGKey(4)))
    tok = JaxTokenizer(jcfg.base.vocab_size, jcfg.base.max_seq)
    pairs = [(QUERY, d) for d in DOCS] + [("prior authorization H0019", DOCS[1])]
    idx = np.arange(len(pairs))
    pos, neg = tce.cross_pairs(tok, pairs, idx)
    jloss, jacc, want = _margin_grads(jcfg, params, pos, neg)
    module = tce.CrossEncoder(tcfg, tenc.params_from_numpy(params),
                              device="cpu").requires_grad_(True)
    step, opt_init = tce.make_cross_train_step(tcfg, device="cpu")
    opt = opt_init(module)
    grads = {}
    orig = opt.step

    def capture(*a, **kw):  # the gradients the optimizer is handed
        grads["leaves"] = [p.grad.clone().numpy()
                           for p in tenc.flatten_params(module.params_tree())]
        return orig(*a, **kw)

    opt.step = capture
    _, _, m = step(module, opt, pos, neg)
    assert float(m["accuracy"]) == jacc
    assert len(grads["leaves"]) == len(want)
    if dtype == "float32":
        assert abs(float(m["loss"]) - jloss) <= GRAD_F32 * max(1.0, abs(jloss))
        for g, w in zip(grads["leaves"], want):
            assert np.abs(g - w).max() <= GRAD_F32 * max(np.abs(w).max(), 1e-30)
    else:
        j32 = dataclasses.replace(jcfg, base=dataclasses.replace(jcfg.base, dtype="float32"))
        assert abs(float(m["loss"]) - jloss) <= 0.01 * max(1.0, abs(jloss))
        assert_bf16_grads(grads["leaves"], want, _margin_grads(j32, params, pos, neg)[2])


def test_cross_optimizer_is_optax_adamw_default():
    """optax.adamw(1e-4): decay 1e-4 (torch's default is 0.01), no clip;
    two steps on the same gradients agree within 4 float32 ulps."""
    import optax

    jcfg, tcfg = _cfgs("float32")
    params = _np_tree(jce.init_cross_params(jcfg, jax.random.PRNGKey(2)))
    module = tce.CrossEncoder(tcfg, tenc.params_from_numpy(params),
                              device="cpu").requires_grad_(True)
    _, opt_init = tce.make_cross_train_step(tcfg, device="cpu")
    opt = opt_init(module)
    assert opt.defaults["weight_decay"] == tce.CROSS_WEIGHT_DECAY == 1e-4
    jopt = optax.adamw(1e-4)
    state, jp = jopt.init(params), params
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(  # large: no clip may shrink them
            lambda x: np.asarray(30 * rng.standard_normal(x.shape), np.float32), params)
        updates, state = jopt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tenc.flatten_params(module.params_tree()),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
    for p, w in zip(tenc.flatten_params(module.params_tree()), jax.tree_util.tree_leaves(jp)):
        w = np.asarray(w)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=4 * np.spacing(np.abs(w).max()))


def test_cross_training_pairs_match_jax():
    """The pairs the trainer draws (rng.choice without replacement, the
    batch shifted by one for negatives) and their token blocks are the
    JAX trainer's for the same store and seed."""
    from mobius_rag_tpu.models.data import mine_ict_pairs as jmine
    from mobius_rag_tpu_torch.models.data import mine_ict_pairs

    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon()))
    ts.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon()))
    jpairs, tpairs = jmine(js, max_pairs=160, seed=3), mine_ict_pairs(ts, max_pairs=160, seed=3)
    assert jpairs == tpairs
    jt, tt = JaxTokenizer(1024, 64), HashTokenizer(1024, 64)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        idx = jr.choice(len(jpairs), 8, replace=False)
        assert (tr.choice(len(tpairs), 8, replace=False) == idx).all()
        want_pos = np.stack([jce.encode_pair(jt, jpairs[i][0], jpairs[i][1]) for i in idx])
        want_neg = np.stack([jce.encode_pair(jt, jpairs[i][0], jpairs[idx[(j + 1) % 8]][1])
                             for j, i in enumerate(idx)])
        pos, neg = tce.cross_pairs(tt, tpairs, idx)
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(neg, want_neg)


def test_cross_training_learns_pairwise_order(monkeypatch):
    """tests/test_cross_encoder.py's training test, on the port, from the
    JAX trainer's initial parameters for the same seed (init_cross_params
    at PRNGKey(3), handed to the port's trainer in place of its own draw),
    so both train the same model on the same pairs; the
    minibatch losses follow the JAX trainer's loosely (within 0.15: 40
    AdamW steps of a tiny model in bfloat16)."""
    jstore, store = JStore(), TStore(device="cpu")
    jstore.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon()))
    store.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon()))
    jcfg, tcfg = _cfgs("bfloat16")
    _, want = jce.train_cross_encoder_on_corpus(jstore, cfg=jcfg, steps=40, batch=8, seed=3)
    init = tenc.params_from_numpy(_np_tree(jce.init_cross_params(jcfg, jax.random.PRNGKey(3))))
    monkeypatch.setattr(tce, "init_cross_params", lambda cfg, generator: init)
    params, history = tce.train_cross_encoder_on_corpus(
        store, cfg=tcfg, steps=40, batch=8, seed=3, device="cpu")
    assert history[-1]["accuracy"] >= 0.75, history
    assert history[-1]["loss"] < history[0]["loss"]
    assert [h["step"] for h in history] == [h["step"] for h in want]
    assert max(abs(h["loss"] - w["loss"]) for h, w in zip(history, want)) <= 0.15, \
        (history, want)
    assert set(params) == {"embed", "pos", "ln_f_scale", "score_head", "layers"}
    with pytest.raises(ValueError, match="too small"):
        tce.train_cross_encoder_on_corpus(TStore(device="cpu"), steps=2, batch=8,
                                          device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("step", [32, 8])
def test_captured_pairs_bitwise_on_card(step):
    """On the card, the served width's layers (2 of 12): one graph per
    (pair bucket, sequence bucket), L = 64 to 512, each replay bitwise the
    eager forward (graphs=False) on the same padded block, every row; the
    padded rows dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import _graphs_bitwise

    base = dataclasses.replace(tenc.EncoderConfig(), num_layers=2)
    cfg = tce.CrossEncoderConfig(base)
    model = tce.CrossEncoderModel(cfg, seed=1, device="cuda")
    eager = tce.CrossEncoderModel(cfg, model.module.params_tree(), device="cuda", graphs=False)
    model.pair_step = eager.pair_step = step
    words = " ".join(DOCS).split()
    for n in (3, 10, 40):
        for w in (30, 100, 200, 400):
            docs = [" ".join(words[(i + j) % len(words)] for j in range(w)) for i in range(n)]
            first, again, want = model(QUERY, docs), model(QUERY, docs), eager(QUERY, docs)
            assert first.shape == (n,)
            np.testing.assert_array_equal(again, want)
            np.testing.assert_array_equal(first, want)
    keys = {key for key, _ in model._programs.graphs}
    assert keys == {(tce.pair_bucket(n, step), length) for n in (3, 10, 40)
                    for length in (64, 128, 256, 512)}
    assert _graphs_bitwise(model, "cross-encoder") == 12
