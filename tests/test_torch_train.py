"""The port's training path (models/data.py, models/train.py) against the
JAX package's, at EncoderConfig.tiny()-like widths on the CPU.

The JAX parameters are drawn with PRNGKey and carried across as numpy
arrays (the two packages draw different random numbers). Layers are held
separately, as a trained model's parity is chaotic (AdamW's first step is
close to lr * sign(g)):

- mined pairs, augmented pairs and token arrays: identical;
- gradients of the contrastive loss against ``jax.grad``, per parameter:
  in float32 within GRAD_F32 = 1e-5 of that parameter's largest
  |gradient| (summation order; measured <= 3e-6); in bfloat16 activations
  no further from the float32 gradient than the JAX package's own bf16
  gradient is, by more than BF16_FACTOR = 1.25 plus BF16_FLOOR = 0.005
  (Frobenius norms relative to the float32 gradient's). bf16 keeps 8 bits
  of mantissa and both packages accumulate the embedding table's gradient
  in it, so either bf16 gradient sits a few % from the float32 one, and
  the two packages round in different places;
- optimizer steps on identical gradients against optax's
  clip_by_global_norm + adamw: parameters within OPT_ULPS = 4 float32
  ulps of each tensor's largest |parameter| after three steps (the two
  libraries order the update's operations differently; measured 2), the
  zero-gradient anchor decayed alike;
- a few steps' loss trajectory loosely (TRAJ_REL = 0.02).

The card case (marked ``cuda``; scripts/card_tests.py runs it) holds one
full training step on the card against the same step on the CPU copy of
the same tensors: gradients within TWIN_GRAD = 1e-4 of each parameter's
largest |gradient|, the updates within TWIN_STEP = 1e-6 (1% of the learning
rate) wherever |gradient| >= TWIN_FLOOR = 1e-3 of that largest (below it
Adam's sign can rightly differ), through chip_smoke.train_step_twin, which
phase 9a runs too (measured on an H100: 3.0e-6 and 3.7e-9); there the
card's step is a replay of its captured CUDA graph.

The captured step (``make_train_step(graphs=...)``): on the CPU
``graphs=True`` raises, and a stand-in capture (``StepStandIn``: its
capture changes no state and leaves its static outputs unwritten, its
replay runs the step again) holds the captured step's plumbing bitwise to
the eager step over steps whose trimmed lengths switch between two keys and
come back, with the hybrid anchor's zero gradient filled inside; the metrics
a step returns are copies no later step rewrites; ``init_opt_state`` makes
the optimizer's whole state before the first step, and steps keep its
tensors (optax's match held through it). On the card (``cuda``): the
captured step against ``graphs=False`` over such steps, per-step losses
and final parameters bitwise, as two eager runs are (measured on an H100);
the card's capturable AdamW within OPT_ULPS of the CPU's update on the
same gradients; a replayed step under
``torch.cuda.set_sync_debug_mode("error")``.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.models import checkpoint as jckpt
from mobius_rag_tpu.models import data as jdata
from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu.models import train as jtrain
from mobius_rag_tpu.models.tokenizer import HashTokenizer as JTokenizer
from mobius_rag_tpu.testing import sample_lexicon as jlexicon, toy_corpus as jtoy
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.models import checkpoint as tckpt
from mobius_rag_tpu_torch.models import data as tdata
from mobius_rag_tpu_torch.models import encoder as tenc
from mobius_rag_tpu_torch.models import train as ttrain
from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer
from mobius_rag_tpu_torch.query.compiled import CapturedPrograms, identity
from mobius_rag_tpu_torch.testing import sample_lexicon, toy_corpus

torch.set_num_threads(1)

GRAD_F32 = 1e-5
BF16_FACTOR = 1.25
BF16_FLOOR = 0.005
OPT_ULPS = 4
TRAJ_REL = 0.02
TWIN_GRAD = 1e-4
TWIN_STEP = 1e-6
TWIN_FLOOR = 1e-3
B, L = 8, 32


def _cfgs(dtype="float32", hybrid=False, **kw):
    kw = {"max_seq": L, "vocab_size": 512, **kw}
    jcfg = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=dtype, hybrid_anchor=hybrid,
                               **kw)
    return jcfg, tenc.EncoderConfig(**dataclasses.asdict(jcfg))


def _jax_params(jcfg, seed=1):
    return jax.tree_util.tree_map(np.asarray, jenc.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(vocab, seed=0):
    """Query/document blocks with PAD tails and a shared prefix."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2, vocab, (B, L)).astype(np.int32)
    d = rng.integers(2, vocab, (B, L)).astype(np.int32)
    q[:, 20:] = 0
    d[:, 28:] = 0
    d[:, :8] = q[:, :8]
    return q, d


def _port_module(tcfg, params):
    return tenc.Encoder(tcfg, tenc.params_from_numpy(params), device="cpu").requires_grad_(True)


def _port_grads(tcfg, params, q, d):
    m = _port_module(tcfg, params)
    loss, acc = ttrain.contrastive_loss(m, torch.from_numpy(q).long(),
                                        torch.from_numpy(d).long(), 20.0)
    loss.backward()
    ttrain.fill_missing_grads(m)
    return loss.item(), acc.item(), [p.grad.numpy() for p in
                                     tenc.flatten_params(m.params_tree())]


def _rel_err(got, want) -> float:
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


def _fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_bf16_grads(port16, jax16, jax32):
    """The port's bf16 gradients are no further from the float32 ones than
    the JAX package's bf16 gradients are (BF16_FACTOR, BF16_FLOOR)."""
    assert len(port16) == len(jax16) == len(jax32)
    for t, j, w in zip(port16, jax16, jax32):
        assert _fro(t, w) <= BF16_FACTOR * _fro(j, w) + BF16_FLOOR, (w.shape, _fro(t, w),
                                                                      _fro(j, w))


# ---- data -------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores():
    """The toy corpus and the fixture stack (hash_embed), in both packages."""
    from mobius_rag_tpu.eval_harness.fixture_corpus import build_fixture_stack as jfix
    from mobius_rag_tpu_torch.eval_harness.fixture_corpus import build_fixture_stack

    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtoy(jlexicon(), pad_docs=30))
    ts.add_chunks(toy_corpus(sample_lexicon(), pad_docs=30))
    jf, tf = jfix(), build_fixture_stack(device="cpu")
    return {"toy": (js, ts, jlexicon(), sample_lexicon()),
            "fixture": (jf[2], tf[2], jf[1].lexicon, tf[1].lexicon)}


@pytest.mark.parametrize("corpus", ["toy", "fixture"])
def test_pairs_and_token_arrays_identical(stores, corpus):
    js, ts, jlex, tlex = stores[corpus]
    for seed in (0, 7):
        want = jdata.mine_ict_pairs(js, max_pairs=400, seed=seed)
        got = tdata.mine_ict_pairs(ts, max_pairs=400, seed=seed)
        assert got == want and len(got) > 16
        assert tdata.augment_pairs(got, lexicon=tlex, factor=1.5, seed=seed) == \
            jdata.augment_pairs(want, lexicon=jlex, factor=1.5, seed=seed)
    jt, tt = JTokenizer(1024, 64), HashTokenizer(1024, 64)
    n = 0
    for (jq, jd), (tq, td) in zip(jdata.pretokenized_batches(want, jt, 8, steps=60, seed=3),
                                  tdata.pretokenized_batches(got, tt, 8, steps=60, seed=3)):
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(td, jd)
        n += 1
    assert n == 60
    for (jq, jd), (tq, td) in zip(jdata.batches(want, jt, 8, seed=2),
                                  tdata.batches(got, tt, 8, seed=2)):
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(td, jd)


# ---- gradients and the optimizer -------------------------------------------

def _jax_grads(jcfg, params, q, d):
    (loss, acc), g = jax.value_and_grad(
        lambda p: jtrain.contrastive_loss(p, jnp.asarray(q), jnp.asarray(d), jcfg, 20.0),
        has_aux=True)(params)
    return float(loss), float(acc), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contrastive_grads_match_jax(dtype, hybrid):
    jcfg, tcfg = _cfgs(dtype, hybrid)
    params = _jax_params(jcfg)
    q, d = _tokens(jcfg.vocab_size)
    jloss, jacc, want = _jax_grads(jcfg, params, q, d)
    loss, acc, grads = _port_grads(tcfg, params, q, d)
    assert len(grads) == len(want) and acc == jacc
    if dtype == "float32":
        assert abs(loss - jloss) <= GRAD_F32 * max(1.0, abs(jloss))
        assert _rel_err(grads, want) <= GRAD_F32
    else:
        _, _, truth = _jax_grads(dataclasses.replace(jcfg, dtype="float32"), params, q, d)
        assert abs(loss - jloss) <= 0.01 * max(1.0, abs(jloss))
        assert_bf16_grads(grads, want, truth)
    if hybrid:  # stop_gradient in JAX, a zero gradient (not None) in the port
        tree = tenc.unflatten_params(tcfg, grads)
        assert not tree["anchor_proj"].any() and tree["alpha"] != 0


def test_missing_gradient_is_zero_not_none():
    """The anchor takes no gradient, yet gets a zero one, so AdamW decays it."""
    _, tcfg = _cfgs(hybrid=True)
    m = tenc.Encoder(tcfg, tenc.init_params(tcfg, torch.Generator().manual_seed(0)), device="cpu")
    m.requires_grad_(True)
    q, d = _tokens(tcfg.vocab_size)
    loss, _ = ttrain.contrastive_loss(m, torch.from_numpy(q), torch.from_numpy(d), 20.0)
    loss.backward()
    assert m.anchor_proj.grad is None
    ttrain.fill_missing_grads(m)
    assert m.anchor_proj.grad is not None and not m.anchor_proj.grad.any()


def _steps_against_optax(scale, init_opt):
    """Three steps of clip_by_global_norm(1.0) + adamw(1e-4, wd 0.01) on the
    same gradients (the anchor's zero), the port's optimizer (``init_opt(module)``)
    against optax's: the parameters within OPT_ULPS, the anchor decayed.
    Returns (module, optimizer)."""
    jcfg, tcfg = _cfgs(hybrid=True)
    params = _jax_params(jcfg)
    tc = ttrain.TrainConfig()
    opt = jtrain.make_optimizer(jtrain.TrainConfig())
    state = opt.init(params)
    module = _port_module(tcfg, params)
    topt = init_opt(module)
    rng = np.random.default_rng(4)
    jp = params
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: np.asarray(scale * rng.standard_normal(x.shape), np.float32), params)
        grads["anchor_proj"] = np.zeros_like(grads["anchor_proj"])
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad(set_to_none=True)
        for p, g in zip(tenc.flatten_params(module.params_tree()),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.array(g))
        norm = ttrain.clip_by_global_norm_([p.grad for p in module.parameters()],
                                           tc.grad_clip)
        assert (float(norm) >= 1.0) == (scale > 1)
        topt.step()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    got = [p.detach().numpy() for p in tenc.flatten_params(module.params_tree())]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=OPT_ULPS * np.spacing(np.abs(w).max()))
    anchor = tenc.params_from_numpy(params)["anchor_proj"].numpy()
    decayed = module.anchor_proj.detach().numpy()
    np.testing.assert_allclose(decayed, anchor * (1 - 1e-4 * 0.01) ** 3, rtol=1e-6, atol=0)
    assert not np.array_equal(decayed, anchor)
    return module, topt


@pytest.mark.parametrize("scale", [1e-3, 50.0], ids=["under_clip", "clipped"])
def test_optimizer_steps_match_optax(scale):
    """Three steps of clip_by_global_norm(1.0) + adamw(1e-4, wd 0.01) on the
    same gradients (the anchor's zero), the port's against optax's."""
    _steps_against_optax(scale,
                         lambda m: ttrain.make_optimizer(m.parameters(), ttrain.TrainConfig()))


@pytest.mark.parametrize("scale", [1e-3, 50.0], ids=["under_clip", "clipped"])
def test_init_opt_state_makes_the_state_and_steps_keep_it(scale):
    """make_train_step's init_opt_state makes the optimizer's whole state
    before the first step (torch.optim would make it in the first step()),
    and steps update it in place: a captured step's graphs hold its
    tensors. Optax's match holds through it."""
    _, tcfg = _cfgs(hybrid=True)
    init = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), device="cpu")[3]
    made = {}

    def init_opt(module):
        opt = init(module)
        assert not opt.param_groups[0]["capturable"]  # the CPU's update
        for p in module.parameters():
            state = opt.state[p]
            assert sorted(state) == ["exp_avg", "exp_avg_sq", "step"]
            assert state["step"].device.type == "cpu" and float(state["step"]) == 0
            assert state["exp_avg"].shape == p.shape and not state["exp_avg"].any()
        made["held"] = ttrain._held(module, opt)
        made["ids"] = identity(made["held"])
        return opt

    module, opt = _steps_against_optax(scale, init_opt)
    held = ttrain._held(module, opt)
    assert identity(held) == made["ids"]
    assert all(a is b for a, b in zip(held, made["held"]))
    assert all(float(opt.state[p]["step"]) == 3 for p in module.parameters())


def test_loss_trajectory_follows_jax():
    """Five full steps from the same parameters and batches: losses within
    TRAJ_REL of the JAX trainer's (loosely: parity of training is chaotic)."""
    from mobius_rag_tpu.parallel.mesh import make_train_mesh

    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=2)
    q, d = _tokens(jcfg.vocab_size, seed=5)
    step, shard_params, shard_batch, init_opt = jtrain.make_train_step(
        jcfg, jtrain.TrainConfig(), make_train_mesh(dp=1, tp=1))
    jp = shard_params(jax.tree_util.tree_map(jnp.asarray, params))
    js = init_opt(jp)
    tstep, tshard, tbatch, tinit = ttrain.make_train_step(tcfg, ttrain.TrainConfig(),
                                                          device="cpu")
    module = tshard(tenc.params_from_numpy(params))
    topt = tinit(module)
    for _ in range(5):
        jp, js, jm = step(jp, js, shard_batch(jnp.asarray(q)), shard_batch(jnp.asarray(d)))
        module, topt, tm = tstep(module, topt, tbatch(q), tbatch(d))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_REL * float(jm["loss"])
    assert float(tm["loss"]) < 0.5 * ttrain.contrastive_loss(
        tenc.Encoder(tcfg, tenc.params_from_numpy(params), device="cpu"),
        torch.from_numpy(q).long(),
        torch.from_numpy(d).long(), 20.0)[0].item()


def test_trimmed_steps_match_untrimmed():
    """Bucket-trimmed token blocks give the full-length blocks' gradients
    (PAD columns are masked out of attention and pooling)."""
    _, tcfg = _cfgs(max_seq=128)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(6)
    q = np.zeros((B, 128), np.int32)
    d = np.zeros((B, 128), np.int32)
    q[:, :30] = rng.integers(2, tcfg.vocab_size, (B, 30))
    d[:, :50] = rng.integers(2, tcfg.vocab_size, (B, 50))
    _, tshard, tbatch, _ = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), device="cpu")
    out = {}
    for trim in (True, False):
        module = tshard(params)
        qt, dt = (tbatch(q), tbatch(d)) if trim else \
            (torch.from_numpy(q).long(), torch.from_numpy(d).long())
        assert (qt.shape[1], dt.shape[1]) == ((64, 64) if trim else (128, 128))
        loss, _ = ttrain.contrastive_loss(module, qt, dt, 20.0)
        loss.backward()
        ttrain.fill_missing_grads(module)
        out[trim] = (float(loss), [p.grad.clone().numpy()
                                   for p in tenc.flatten_params(module.params_tree())])
    assert abs(out[True][0] - out[False][0]) <= 1e-6
    assert _rel_err(out[True][1], out[False][1]) <= GRAD_F32


# ---- the captured step -------------------------------------------------------

# trimmed lengths by step: (query, document) buckets 64 x 64 or 64 x 128,
# switching between the two keys and coming back to the first
SWITCHING = (64, 64, 128, 64, 128, 128, 64)


def switching_batches(vocab: int, b: int = B, seed: int = 0, lengths=SWITCHING) -> list:
    """[b, 128] query and document blocks whose documents trim to each
    length of `lengths` (queries to 64), from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for ld in lengths:
        q = np.zeros((b, 128), np.int32)
        d = np.zeros((b, 128), np.int32)
        for i in range(b):
            nq, nd = rng.integers(8, 64), rng.integers(ld // 2 + 1, ld + 1)
            q[i, :nq] = rng.integers(2, vocab, nq)
            d[i, :nd] = rng.integers(2, vocab, nd)
            d[i, :4] = q[i, :4]
        out.append((q, d))
    return out


def run_steps(cfg, params, batches, mesh=None, device="cpu", graphs=None) -> tuple:
    """make_train_step's steps over `batches` from `params` (a tree on
    `device`): (each step's (loss, accuracy) read right after it, the
    metrics the steps returned, the final parameters flat on the CPU, the
    train_step)."""
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh,
                                                      device=device, graphs=graphs)
    model = shard(params)
    opt = init(model)
    seen, metrics = [], []
    for q, d in batches:
        model, opt, m = step(model, opt, batch(q), batch(d))
        metrics.append(m)
        seen.append((float(m["loss"]), float(m["accuracy"])))
    final = [t.detach().cpu() for t in tenc.flatten_params(model.params_tree())]
    return seen, metrics, final, step


def assert_steps_equal(got, want) -> None:
    """Per-step losses and accuracies and final parameters of two runs,
    bitwise."""
    (seen, _, final, _), (wseen, _, wfinal, _) = got, want
    assert seen == wseen
    assert len(final) == len(wfinal) and all(torch.equal(t, w) for t, w in zip(final, wfinal))


class _StepReplay:
    """A stand-in graph: a replay runs the step again on the static inputs
    and writes its metrics into the static outputs."""

    def __init__(self, program, static, outputs):
        self.program, self.static, self.outputs = program, static, outputs

    def replay(self):
        for name, value in self.program(self.static).items():
            self.outputs[name].copy_(value)


class StepStandIn(CapturedPrograms):
    """CapturedPrograms for a training step on the CPU. As a real capture,
    its capture changes no state (it runs the step and puts the held
    tensors back) and leaves the static outputs unwritten (NaN) until a
    replay."""

    def _check_device(self) -> None:
        pass

    def run(self, key, held, q, program):
        self._held = held
        return super().run(key, held, q, program)

    def _capture(self, program, static):
        saved = [t.detach().clone() for t in self._held]
        outputs = program(static)
        with torch.no_grad():
            for t, v in zip(self._held, saved):
                t.copy_(v)
            for v in outputs.values():
                v.fill_(float("nan"))
        return _StepReplay(program, static, outputs), outputs


def test_graphs_true_on_cpu_raises():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="CUDA device"):
        ttrain.make_train_step(tcfg, ttrain.TrainConfig(), device="cpu", graphs=True)
    for graphs in (None, False):  # eager on the CPU
        assert ttrain.make_train_step(tcfg, ttrain.TrainConfig(), device="cpu",
                                      graphs=graphs)[0].programs is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stand_in_captured_steps_equal_eager(monkeypatch, dtype):
    """The captured step's path (host blocks uploaded into a graph's static
    input, one graph per trimmed shape, the first step of a key eager,
    replays after it) over a stand-in capture, bitwise the eager step
    over 7 steps switching between two keys, the anchor's zero gradient
    filled inside; the returned metrics are copies no later replay
    rewrites."""
    _, tcfg = _cfgs(dtype, hybrid=True, max_seq=128)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(5))
    batches = switching_batches(tcfg.vocab_size)
    eager = run_steps(tcfg, params, batches)
    monkeypatch.setattr(ttrain, "CapturedPrograms", StepStandIn)
    captured = run_steps(tcfg, params, batches, graphs=True)
    assert_steps_equal(captured, eager)
    seen, metrics, _, step = captured
    assert [(float(m["loss"]), float(m["accuracy"])) for m in metrics] == seen
    assert step.programs.captures == 2 and step.programs.replays == len(batches) - 2
    assert sorted(k[1][0][1] + k[1][1][1] for k in step.programs.graphs) == \
        [(B, 64, B, 64), (B, 64, B, 128)]
    with pytest.raises(TypeError, match="host blocks"):
        step(None, None, torch.zeros(B, 64, dtype=torch.long), torch.zeros(B, 64))


# ---- the corpus trainer (tests/test_train_corpus.py's twins) ----------------

def test_train_on_corpus_loss_moves(stores):
    _, ts, _, _ = stores["toy"]
    params, history = ttrain.train_encoder_on_corpus(
        ts, cfg=tenc.EncoderConfig.tiny(), steps=12, batch=8, log_every=4, device="cpu")
    assert [h["step"] for h in history] == [4, 8, 12]
    assert history[-1]["loss"] < history[0]["loss"] * 1.5  # moving, not NaN
    assert np.isfinite(history[-1]["loss"])
    assert all(not t.requires_grad for t in tenc.flatten_params(params))


def test_trained_encoder_retrieval_stays_sharp(stores):
    """Fine-tune → re-embed → sentence-queries still retrieve their source
    chunk (no representation collapse)."""
    _, ts, _, _ = stores["toy"]
    cfg = tenc.EncoderConfig.tiny()
    params, _ = ttrain.train_encoder_on_corpus(ts, cfg=cfg, steps=30, batch=8, seed=7,
                                               device="cpu")
    untrained = tenc.EncoderModel(cfg, seed=7, device="cpu")
    trained = tenc.EncoderModel(cfg, params=params, device="cpu")
    texts = [r.text for r in ts.records if r is not None]
    queries = [t.split(". ")[0] for t in texts]

    def recall_at_1(model):
        docs, qs = model(texts), model(queries)
        return np.mean((qs @ docs.T).argmax(axis=1) == np.arange(len(texts)))

    assert recall_at_1(untrained) >= 0.8  # task sanity: solvable before training
    assert recall_at_1(trained) >= 0.8


def test_corpus_too_small_raises():
    with pytest.raises(ValueError, match="too small"):
        ttrain.train_encoder_on_corpus(TStore(device="cpu"), cfg=tenc.EncoderConfig.tiny(),
                                       steps=2, batch=8, device="cpu")


def test_train_demo_loss_moves():
    history = ttrain.train_demo(num_steps=4, batch=8, device="cpu")
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["loss"] < history[0]["loss"]


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (ttrain.make_train_step, ttrain.train_encoder_on_corpus, ttrain.train_demo):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = ttrain.recipe_config(1536)
    assert (cfg.num_layers, cfg.model_dim, cfg.num_heads, cfg.mlp_dim, cfg.max_seq,
            cfg.vocab_size) == (4, 512, 8, 2048, 128, 16384)


# ---- checkpoints of trained models, both ways -------------------------------

def test_port_trained_checkpoint_embeds_alike_in_jax(stores, tmp_path):
    _, ts, _, _ = stores["toy"]
    jcfg, tcfg = _cfgs(max_seq=64)
    params, _ = ttrain.train_encoder_on_corpus(ts, cfg=tcfg, steps=3, batch=8, device="cpu")
    tckpt.save_encoder(str(tmp_path), params, tcfg)
    jparams, cfg = jckpt.load_encoder(str(tmp_path))
    assert cfg == jcfg
    texts = [r.text for r in ts.records if r is not None][:12]
    want = jenc.EncoderModel(jcfg, params=jparams)(texts)
    got = tenc.EncoderModel(tcfg, params=params, device="cpu")(texts)
    assert np.abs(got - want).max() <= 1e-5


def test_jax_trained_checkpoint_embeds_alike_in_port(stores, tmp_path, monkeypatch):
    from mobius_rag_tpu.parallel.mesh import make_train_mesh

    js, ts, _, _ = stores["toy"]
    jcfg, tcfg = _cfgs(max_seq=64)
    params, _ = jtrain.train_encoder_on_corpus(js, cfg=jcfg, steps=3, batch=8,
                                               mesh=make_train_mesh(dp=1, tp=1))
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jckpt.save_encoder(str(tmp_path), jax.device_get(params), jcfg)
    assert json.load(open(tmp_path / "encoder.json"))["backend"] == "npz"
    tree, cfg = tckpt.load_encoder(str(tmp_path))
    assert cfg == tcfg
    texts = [r.text for r in ts.records if r is not None][:12]
    want = jenc.EncoderModel(jcfg, params=jax.device_get(params))(texts)
    got = tenc.EncoderModel(tcfg, params=tree, device="cpu")(texts)
    assert np.abs(got - want).max() <= 1e-5


# ---- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_train_step_on_card_matches_cpu_twin():
    """chip_smoke.train_step_twin: one step of the tiny float32 config on the
    card and on the CPU copy of the same parameters and tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step runs on it")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert (chip_smoke.TWIN_GRAD, chip_smoke.TWIN_STEP, chip_smoke.TWIN_FLOOR) == \
        (TWIN_GRAD, TWIN_STEP, TWIN_FLOOR)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    grad_err, step_err, _ = chip_smoke.train_step_twin("cuda")
    assert grad_err <= TWIN_GRAD and step_err <= TWIN_STEP


def _card_cfg(**kw):
    """test_torch_train's tiny widths without the JAX package (the card's
    machine has none): max_seq 128 for two sequence buckets."""
    return dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=128, vocab_size=512, **kw)


@pytest.mark.cuda
def test_captured_steps_equal_eager_on_card():
    """The captured step against graphs=False on the card, 7 steps
    switching between two keys and back, the hybrid anchor's zero gradient
    filled inside the graph: per-step losses and final parameters bitwise
    (two eager runs are bitwise alike on the card: no kernel of the step
    accumulates in a varying order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured on it")
    cfg = _card_cfg(hybrid_anchor=True)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    batches = switching_batches(cfg.vocab_size)
    eager = [run_steps(cfg, params, batches, device="cuda", graphs=False) for _ in range(2)]
    captured = run_steps(cfg, params, batches, device="cuda")
    assert_steps_equal(eager[1], eager[0])
    assert_steps_equal(captured, eager[0])
    step = captured[3]
    assert step.programs.captures == 2 and step.programs.replays == len(batches) - 2
    assert [(float(m["loss"]), float(m["accuracy"])) for m in captured[1]] == captured[0]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-3, 50.0], ids=["under_clip", "clipped"])
def test_capturable_adamw_on_card_matches_cpu(scale):
    """Three clipped AdamW steps on the same gradients: the card's
    capturable update (step counts on the device) within OPT_ULPS of each
    tensor's largest |parameter| of the CPU's, which
    test_optimizer_steps_match_optax pins to optax."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update runs on it")
    cfg = _card_cfg(hybrid_anchor=True, dtype="float32")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(1))
    tc = ttrain.TrainConfig()
    out = {}
    for where in ("cpu", "cuda"):
        module = tenc.Encoder(cfg, params, device=where).requires_grad_(True)
        opt = ttrain.make_optimizer(module.parameters(), tc)
        assert opt.param_groups[0]["capturable"] == (where == "cuda")
        rng = np.random.default_rng(4)
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            for name, p in module.named_parameters():
                g = np.asarray(scale * rng.standard_normal(p.shape), np.float32)
                if name == "anchor_proj":
                    g = np.zeros_like(g)
                p.grad = torch.from_numpy(g).to(where)
            ttrain.clip_by_global_norm_([p.grad for p in module.parameters()], tc.grad_clip)
            opt.step()
        out[where] = [p.detach().cpu() for p in module.parameters()]
    for got, want in zip(out["cuda"], out["cpu"]):
        ulp = float(np.spacing(np.float32(want.abs().max())))
        assert float((got - want).abs().max()) <= OPT_ULPS * ulp


@pytest.mark.cuda
def test_captured_step_syncs_nothing_on_card():
    """A replayed training step (upload, replay, the metrics' copies) under
    torch.cuda.set_sync_debug_mode("error"): nothing in it waits for the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured on it")
    cfg = _card_cfg()
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(),
                                                      device="cuda")
    model = shard(tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    opt = init(model)
    (q, d), = switching_batches(cfg.vocab_size, lengths=(64,))
    step(model, opt, batch(q), batch(d))  # eager, then captured
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, m = step(model, opt, batch(q), batch(d))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert step.programs.captures == 1 and step.programs.replays == 1
    assert np.isfinite(float(m["loss"]))
