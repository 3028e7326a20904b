"""Training over a ("dp", "tp") device grid (the port's make_train_mesh,
param_specs, shard_tree/gather_tree, GridEncoder and the grid trainer, and
the graft_entry twin) against the JAX package's mesh trainer on the 8
virtual CPU devices of tests/conftest.py. The port runs its grid on
``["cpu"] * 8``; the widths are EncoderConfig.tiny()'s (2 layers, 4 heads,
model 128) with max_seq 32 and vocab 512, as in tests/test_torch_train.py,
whose constants and helpers these tests reuse:

- the layout: each grid position's shard bitwise equal to the shard that
  JAX's NamedSharding puts on the same position of the same mesh shape;
- gradients after the dp sum, gathered: in float32 within GRAD_F32 = 1e-5
  of each parameter's largest |gradient|, against jax.grad of
  contrastive_loss under make_train_mesh(4, 2) and against the port's
  single-device gradients; in bfloat16 no further from JAX's float32
  gradient than JAX's own mesh bf16 gradient is, by BF16_FACTOR = 1.25
  plus BF16_FLOOR = 0.005 (Frobenius norms relative to the float32 one);
- the clip's global norm within CLIP_REL = 1e-6 relative of the single
  device's (the shards' sums of squares add in another order), and one
  step's updates within TWIN_STEP = 1e-6 of the single device's wherever
  |gradient| >= TWIN_FLOOR = 1e-3 of that parameter's largest (as
  chip_smoke.train_step_twin bounds them);
- five steps' losses within TRAJ_REL = 0.02 of the JAX mesh trainer's at
  (4, 2) and (2, 4), from the same parameters and batches;
- entry()'s bf16 forward against JAX entry()'s on carried-across
  parameters within test_torch_encoder.py's bf16 bounds (per-row cosine
  BF16_COS = 0.999, BF16_ABS = 3e-2 max abs on unit rows), and the same
  forward at float32 activations within its F32_TOL = 1e-5.

The captured grid step: on ``["cpu"] * 4`` as (2, 2), through
test_torch_train's stand-in capture, bitwise the eager grid step over steps
switching between two keys; ``graphs=True`` on a grid over several devices
raises (a capture records one device's stream), and such a grid trains
eagerly by default.

The card cases (marked ``cuda``; scripts/card_tests.py runs them) hold a
(2, 2) grid step on ``["cuda:0"] * 4``, a replay of its captured graph,
against the same step on the CPU copy within TWIN_GRAD = 1e-4 and
TWIN_STEP, and the captured grid step against ``graphs=False`` on that grid
over the switching steps, as test_torch_train's one-device card case.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mobius_rag_tpu.models import encoder as jenc
from mobius_rag_tpu.models import train as jtrain
from mobius_rag_tpu.parallel.mesh import make_train_mesh as jmake_train_mesh
from mobius_rag_tpu_torch import graft_entry
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.models import checkpoint as tckpt
from mobius_rag_tpu_torch.models import encoder as tenc
from mobius_rag_tpu_torch.models import segments as tsegments
from mobius_rag_tpu_torch.models import train as ttrain
from mobius_rag_tpu_torch.parallel import sharded as tsharded
from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh
from mobius_rag_tpu_torch.query import compiled
from mobius_rag_tpu_torch.testing import sample_lexicon, toy_corpus
from test_torch_encoder import BF16_ABS, BF16_COS, F32_TOL, _rowwise_cos
from test_torch_train import (GRAD_F32, TRAJ_REL, TWIN_FLOOR, TWIN_GRAD, TWIN_STEP,
                              StepStandIn, _card_cfg, _cfgs, _jax_grads, _jax_params,
                              _port_grads, _rel_err, _tokens, assert_bf16_grads,
                              assert_steps_equal, run_steps, switching_batches)

CLIP_REL = 1e-6
CPU8 = ["cpu"] * 8
SHAPES = [(4, 2), (2, 4)]


def _grid(dp, tp):
    return make_train_mesh(dp, tp, devices=CPU8)


def _jax_sharded(jmesh, jcfg, params):
    specs = jenc.param_specs(jcfg)
    return jax.tree_util.tree_map(lambda s, x: jax.device_put(x, NamedSharding(jmesh, s)),
                                  specs, params, is_leaf=lambda x: isinstance(x, JP))


def _grid_grads(tcfg, params, q, d, dp=4, tp=2):
    """Loss, accuracy and the gathered gradients (flatten order) of one grid
    forward and backward after the dp sum."""
    mesh = _grid(dp, tp)
    _, shard_params, shard_batch, _ = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), mesh)
    model = shard_params(tenc.params_from_numpy(params))
    loss, acc = ttrain.contrastive_loss(model, shard_batch(q), shard_batch(d), 20.0)
    loss.backward()
    model.sum_grads_over_dp()
    ttrain.fill_missing_grads(model)
    grads = np.empty(model.grid.shape, dtype=object)
    for idx in np.ndindex(grads.shape):
        grads[idx] = tenc.tree_map(lambda p: p.grad, model.grid[idx])
    tree = tenc.gather_tree(grads, model.specs, mesh)
    return loss.item(), acc.item(), [g.numpy() for g in tenc.flatten_params(tree)]


# ---- grids and layout --------------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 1), (8, 1), (1, 8)])
def test_make_train_mesh_shapes(dp, tp):
    want = jmake_train_mesh(dp, tp)
    got = _grid(dp, tp)
    assert got.axis_names == want.axis_names == ("dp", "tp")
    assert got.devices.shape == want.devices.shape == (dp, tp)
    assert got.shape == {"dp": dp, "tp": tp}
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_train_mesh_errors_as_jax():
    with pytest.raises(ValueError, match=r"dp\*tp=16 > 8 devices") as jerr:
        jmake_train_mesh(4, 4)
    with pytest.raises(ValueError) as terr:
        make_train_mesh(4, 4, devices=CPU8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
def test_param_specs_equal_jax(hybrid):
    jcfg, tcfg = _cfgs(hybrid=hybrid)
    want, got = jenc.param_specs(jcfg), tenc.param_specs(tcfg)
    assert jax.tree_util.tree_structure(want, is_leaf=lambda x: isinstance(x, JP)) == \
        jax.tree_util.tree_structure(tenc.tree_map(lambda s: 0, got))
    flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, JP))
    flat_g = []
    tenc.tree_map(flat_g.append, got)
    assert [tuple(s) for s in flat_g] == [tuple(s) for s in flat_w]
    assert all(isinstance(s, tenc.PartitionSpec) for s in flat_g)


@pytest.mark.parametrize("dp,tp", SHAPES)
def test_shards_bitwise_equal_jax_addressable_shards(dp, tp):
    jcfg, tcfg = _cfgs(hybrid=True)
    params = _jax_params(jcfg)
    jmesh = jmake_train_mesh(dp, tp)
    jtree = _jax_sharded(jmesh, jcfg, params)
    mesh = _grid(dp, tp)
    grid = tenc.shard_tree(tenc.params_from_numpy(params), tenc.param_specs(tcfg), mesh)
    assert grid.shape == (dp, tp)
    jleaves = jax.tree_util.tree_leaves(jtree)
    n = 0
    for k, jarr in enumerate(jleaves):
        for shard in jarr.addressable_shards:
            pos = tuple(np.argwhere(jmesh.devices == shard.device)[0])
            mine = tenc.flatten_params(grid[pos])[k]
            assert mine.is_contiguous()
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data))
            n += 1
    assert n == len(jleaves) * dp * tp
    # every position holds its own copy, though every position is the CPU
    ptrs = [t.data_ptr() for tree in grid.flat for t in tenc.flatten_params(tree)]
    assert len(set(ptrs)) == len(ptrs)
    back = tenc.gather_tree(grid, tenc.param_specs(tcfg), mesh)
    for a, b in zip(tenc.flatten_params(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_tp_must_divide_the_split_widths():
    _, tcfg = _cfgs()  # 4 heads
    with pytest.raises(ValueError, match="tp must divide num_heads"):
        ttrain.make_train_step(tcfg, ttrain.TrainConfig(), make_train_mesh(1, 3, CPU8))[1](
            tenc.init_params(tcfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="tp must divide out_dim"):
        tenc.check_tp(dataclasses.replace(tcfg, out_dim=254), 4)


@pytest.mark.parametrize("dp,tp", [(1, 1), (4, 2)])
def test_grid_forward_equals_encoder(dp, tp):
    """A dp row's tensor-parallel forward computes Encoder's function."""
    _, tcfg = _cfgs(hybrid=True)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(3))
    q, _ = _tokens(tcfg.vocab_size)
    want = tenc.Encoder(tcfg, params, device="cpu")(torch.from_numpy(q)).detach()
    mesh = _grid(dp, tp)
    grid = tenc.shard_tree(params, tenc.param_specs(tcfg), mesh)
    row = tenc.GridEncoder(tcfg, list(grid[0]), list(mesh.devices[0]))
    got = row(torch.from_numpy(q)).detach()
    assert float((got - want).abs().max()) <= F32_TOL


# ---- gradients, the clip and one step ----------------------------------------

@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid_anchor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_grads_match_jax_mesh_and_single_device(dtype, hybrid):
    jcfg, tcfg = _cfgs(dtype, hybrid)
    params = _jax_params(jcfg)
    q, d = _tokens(jcfg.vocab_size)
    jmesh = jmake_train_mesh(4, 2)
    batch = NamedSharding(jmesh, JP("dp", None))
    jq, jd = jax.device_put(jnp.asarray(q), batch), jax.device_put(jnp.asarray(d), batch)

    def jax_mesh_grads(cfg):
        (loss, acc), g = jax.jit(jax.value_and_grad(
            lambda p: jtrain.contrastive_loss(p, jq, jd, cfg, 20.0), has_aux=True))(
                _jax_sharded(jmesh, cfg, params))
        return float(loss), float(acc), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]

    jloss, jacc, want = jax_mesh_grads(jcfg)
    loss, acc, grads = _grid_grads(tcfg, params, q, d)
    _, _, single = _port_grads(tcfg, params, q, d)
    assert len(grads) == len(want) == len(single)
    if dtype == "float32":
        assert abs(loss - jloss) <= GRAD_F32 * max(1.0, abs(jloss)) and acc == jacc
        assert _rel_err(grads, want) <= GRAD_F32
        assert _rel_err(grads, single) <= GRAD_F32
    else:
        _, _, truth = _jax_grads(dataclasses.replace(jcfg, dtype="float32"), params, q, d)
        assert abs(loss - jloss) <= 0.01 * max(1.0, abs(jloss))
        assert_bf16_grads(grads, want, truth)
    if hybrid:  # the anchor's gradient is zero, not missing
        tree = tenc.unflatten_params(tcfg, grads)
        assert not tree["anchor_proj"].any() and tree["alpha"] != 0


def _one_step(model, shard_batch, q, d, tc):
    """train_step's body with the clip's norm kept: (norm, gradients,
    parameters before, parameters after), gathered where on a grid."""
    opt = ttrain.make_optimizer(model.parameters(), tc)
    before = [t.detach().clone() for t in tenc.flatten_params(model.params_tree())]
    loss, _ = ttrain.contrastive_loss(model, shard_batch(q), shard_batch(d), tc.temperature)
    loss.backward()
    if isinstance(model, ttrain.GridModel):
        model.sum_grads_over_dp()
    ttrain.fill_missing_grads(model)
    norm = ttrain.clip_by_global_norm_([p.grad for p in model.parameters()], tc.grad_clip)
    opt.step()
    if isinstance(model, ttrain.GridModel):
        model.copy_from_owners()
    after = [t.detach().clone() for t in tenc.flatten_params(model.params_tree())]
    return float(norm), before, after


@pytest.mark.parametrize("dp,tp", SHAPES)
def test_clip_norm_and_one_step_match_single_device(dp, tp):
    _, tcfg = _cfgs(hybrid=True)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(4))
    q, d = _tokens(tcfg.vocab_size, seed=3)
    tc = ttrain.TrainConfig()
    _, sshard, sbatch, _ = ttrain.make_train_step(tcfg, tc, device="cpu")
    single = sshard(params)
    s_norm, s_before, s_after = _one_step(single, sbatch, q, d, tc)
    s_grads = [p.grad for p in tenc.flatten_params(single.params_tree())]
    _, gshard, gbatch, _ = ttrain.make_train_step(tcfg, tc, _grid(dp, tp))
    model = gshard(params)
    g_norm, g_before, g_after = _one_step(model, gbatch, q, d, tc)
    assert s_norm >= tc.grad_clip  # the clip scales
    assert abs(g_norm - s_norm) <= CLIP_REL * s_norm
    for sb, sa, gb, ga, g in zip(s_before, s_after, g_before, g_after, s_grads):
        assert torch.equal(sb, gb)
        live = g.abs() >= TWIN_FLOOR * g.abs().max()
        if live.any():
            assert float(((ga - gb) - (sa - sb)).abs()[live].max()) <= TWIN_STEP
    # every position follows its owner after the step
    for idx in np.ndindex(model.grid.shape):
        for leaf, owner in model._pairs[idx]:
            assert torch.equal(leaf, owner)


# ---- the trainer -------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", SHAPES)
def test_loss_trajectory_follows_jax_mesh(dp, tp):
    """Five steps over different batches from the same parameters: losses
    within TRAJ_REL of the JAX trainer on the same mesh shape."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=2)
    tc, jtc = ttrain.TrainConfig(), jtrain.TrainConfig()
    step, shard_params, shard_batch, init_opt = jtrain.make_train_step(
        jcfg, jtc, jmake_train_mesh(dp, tp))
    jp = shard_params(jax.tree_util.tree_map(jnp.asarray, params))
    js = init_opt(jp)
    tstep, tshard, tbatch, tinit = ttrain.make_train_step(tcfg, tc, _grid(dp, tp))
    model = tshard(tenc.params_from_numpy(params))
    topt = tinit(model)
    for seed in range(5, 10):
        q, d = _tokens(jcfg.vocab_size, seed=seed)
        jp, js, jm = step(jp, js, shard_batch(jnp.asarray(q)), shard_batch(jnp.asarray(d)))
        model, topt, tm = tstep(model, topt, tbatch(q), tbatch(d))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_REL * float(jm["loss"])
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1 / 8 + 1e-6)


def test_odd_batch_raises_in_both_packages():
    jcfg, tcfg = _cfgs()
    q = np.ones((6, 32), np.int32)
    _, _, jbatch, _ = jtrain.make_train_step(jcfg, jtrain.TrainConfig(), jmake_train_mesh(4, 2))
    with pytest.raises(ValueError, match="divisible by 4"):
        jbatch(jnp.asarray(q))
    _, _, tbatch, _ = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), _grid(4, 2))
    with pytest.raises(ValueError, match="divisible by 4"):
        tbatch(q)
    assert [p.shape for p in tbatch(np.ones((8, 32), np.int32))] == [(2, 32)] * 4


@pytest.fixture(scope="module")
def toy_store():
    s = TStore(device="cpu")
    s.add_chunks(toy_corpus(sample_lexicon()))
    return s


def test_train_on_corpus_over_grid_loss_moves(toy_store, tmp_path):
    """tests/test_train_corpus.py's mesh test: dp 4 x tp 2; the returned tree
    is whole, loads into EncoderModel and round-trips through save_encoder."""
    cfg = tenc.EncoderConfig.tiny()
    params, history = ttrain.train_encoder_on_corpus(
        toy_store, cfg=cfg, steps=12, batch=8, mesh=_grid(4, 2), log_every=4)
    assert [h["step"] for h in history] == [4, 8, 12]
    assert history[-1]["loss"] < history[0]["loss"] * 1.5  # moving, not NaN
    assert np.isfinite(history[-1]["loss"])
    leaves = tenc.flatten_params(params)
    assert all(not t.requires_grad and t.device.type == "cpu" for t in leaves)
    assert params["embed"].shape == (cfg.vocab_size, cfg.model_dim)
    tckpt.save_encoder(str(tmp_path / "enc"), params, cfg)
    loaded, cfg2 = tckpt.load_encoder(str(tmp_path / "enc"))
    assert cfg2 == cfg
    for a, b in zip(tenc.flatten_params(loaded), leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    texts = ["timely filing deadline", "prior authorization for dme"]
    va = tenc.EncoderModel(cfg, params=params, device="cpu")(texts)
    vb = tenc.EncoderModel(cfg2, params=loaded, device="cpu")(texts)
    np.testing.assert_allclose(va, vb, atol=1e-5)


def test_grid_trained_encoder_retrieval_stays_sharp(toy_store):
    """Fine-tune over the grid → re-embed → sentence-queries still retrieve
    their source chunk (no representation collapse)."""
    cfg = tenc.EncoderConfig.tiny()
    params, _ = ttrain.train_encoder_on_corpus(toy_store, cfg=cfg, steps=30, batch=8,
                                               mesh=_grid(4, 2), seed=7)
    untrained = tenc.EncoderModel(cfg, seed=7, device="cpu")
    trained = tenc.EncoderModel(cfg, params=params, device="cpu")
    texts = [r.text for r in toy_store.records if r is not None]
    queries = [t.split(". ")[0] for t in texts]

    def recall_at_1(model):
        docs, qs = model(texts), model(queries)
        return np.mean((qs @ docs.T).argmax(axis=1) == np.arange(len(texts)))

    assert recall_at_1(untrained) >= 0.8  # task sanity: solvable before training
    assert recall_at_1(trained) >= 0.8


def test_train_demo_sharded_loss_decreases():
    history = ttrain.train_demo(num_steps=8, mesh=_grid(4, 2), batch=16)
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0], losses


def test_train_demo_wide_tp_grid():
    history = ttrain.train_demo(num_steps=2, mesh=_grid(2, 4), batch=8)
    assert np.isfinite(history[-1]["loss"])


def test_grid_of_a_missing_device_raises():
    """No quiet fall-back: a grid naming a device that is not there fails."""
    _, tcfg = _cfgs()
    with pytest.raises((AssertionError, RuntimeError)):
        ttrain.train_demo(1, mesh=make_train_mesh(1, 2, devices=["cpu", "cuda:7"]), cfg=tcfg,
                          batch=2)


def test_new_entry_points_default_to_cuda():
    import inspect

    assert inspect.signature(graft_entry.entry).parameters["device"].default == "cuda"
    for fn in (graft_entry.dryrun_multichip, make_train_mesh):
        assert inspect.signature(fn).parameters["devices"].default is None
    # devices=None: every visible CUDA device, none here
    if torch.cuda.is_available():
        assert make_train_mesh(1, 1).devices[0, 0].type == "cuda"
    else:
        with pytest.raises(ValueError, match="> 0 devices"):
            make_train_mesh(1, 1)


def test_stand_in_captured_grid_steps_equal_eager(monkeypatch):
    """The captured grid step's path (one host block uploaded, cut into dp
    parts on the grid's device) over a stand-in capture on a (2, 2) grid of
    the CPU, bitwise the eager grid step over the switching steps."""
    _, tcfg = _cfgs(hybrid=True, max_seq=128)
    params = tenc.init_params(tcfg, torch.Generator().manual_seed(5))
    batches = switching_batches(tcfg.vocab_size)
    mesh = make_train_mesh(2, 2, devices=["cpu"] * 4)
    eager = run_steps(tcfg, params, batches, mesh)
    monkeypatch.setattr(ttrain, "CapturedPrograms", StepStandIn)
    captured = run_steps(tcfg, params, batches, mesh, graphs=True)
    assert_steps_equal(captured, eager)
    seen, metrics, _, step = captured
    assert [(float(m["loss"]), float(m["accuracy"])) for m in metrics] == seen
    assert step.programs.captures == 2 and step.programs.replays == len(batches) - 2
    assert {k[0] for k in step.programs.graphs} == {("train", 2, 2)}


def test_graphs_true_on_a_grid_over_several_devices_raises(monkeypatch):
    """A grid over several devices (named CPU devices here) trains eagerly
    off a card by default, graphs=True there raises (a capture needs a
    card), and where captures exist (a stand-in here) it selects the
    segmented route: a ProgramsByDevice of segment graphs."""
    _, tcfg = _cfgs()
    mesh = make_train_mesh(1, 2, devices=["cpu", "cpu:1"])
    assert ttrain.make_train_step(tcfg, ttrain.TrainConfig(), mesh)[0].programs is None
    for grid in (mesh, _grid(2, 2)):  # several devices, or one that is not a card
        with pytest.raises(ValueError, match="CUDA device"):
            ttrain.make_train_step(tcfg, ttrain.TrainConfig(), grid, graphs=True)
    monkeypatch.setattr(ttrain, "CapturedPrograms", SegmentStandIn)
    step = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), mesh, graphs=True)[0]
    assert isinstance(step.programs, compiled.ProgramsByDevice)
    assert isinstance(step, tsegments.SegmentedStep)
    one = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), _grid(2, 2), graphs=True)[0]
    assert isinstance(one.programs, SegmentStandIn)  # one device: one graph a key


# ---- the segmented route: a grid over several devices -------------------------

def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in (x or ()) for t in _tensors(v)]


class _Rerun:
    """A stand-in graph: a replay runs the program again and writes what
    it returns into the static outputs of the capture (held detached, as a
    real graph holds memory and no autograd graph)."""

    def __init__(self, program, static, outputs):
        self.program, self.static = program, static
        self.outputs = [t.detach() for t in _tensors(outputs)]

    def replay(self):
        new = self.program(self.static)
        with torch.no_grad():
            for old, value in zip(self.outputs, _tensors(new)):
                if old.data_ptr() != value.data_ptr():
                    old.copy_(value)


class SegmentStandIn(StepStandIn):
    """CapturedPrograms for the segmented route on the CPU: a capture runs
    the segment's program once (so a forward leaves its autograd graph for
    its backward's capture, as a real capture does) and puts back the
    tensors it holds (the tail's parameters and optimizer state: a real
    capture changes no state); a replay runs it again."""

    def capture(self, key, held, program):
        self._held = held
        return super().capture(key, held, program)

    def _capture(self, program, static):
        saved = [t.detach().clone() for t in self._held]
        outputs = program(static)
        with torch.no_grad():
            for t, v in zip(self._held, saved):
                t.copy_(v)
        return _Rerun(program, static, outputs), outputs


@pytest.fixture
def segmented(monkeypatch):
    """The segmented route forced through the predicate the trainer and the
    sharded engine share, over stand-in captures."""
    monkeypatch.setattr(tsharded, "on_one_device", lambda groups, device: False)
    monkeypatch.setattr(ttrain, "CapturedPrograms", SegmentStandIn)


def _segment_cfg(dtype):
    return _cfgs(dtype, hybrid=True, max_seq=128)[1]


# float32 CPU matmuls on several threads differ from run to run (two eager
# runs disagree), so float32 runs on one thread; bfloat16 agrees on any
SEGMENT_CASES = [(2, 2, "bfloat16"), (4, 1, "bfloat16"), (2, 4, "bfloat16"),
                 (2, 2, "float32")]


@pytest.mark.parametrize("dp,tp,dtype", SEGMENT_CASES)
def test_segmented_grid_steps_equal_eager(segmented, dp, tp, dtype):
    """The segmented route (every position on the CPU, forced) bitwise the
    eager grid step over the switching steps: per-step losses and
    accuracies, the final parameters and the owners' gradients. At tp = 4
    the normed stream's gradient sums four shards': only eager autograd's
    order (the last shard first) is bitwise."""
    threads = torch.get_num_threads()
    if dtype == "float32":
        torch.set_num_threads(1)
    try:
        cfg = _segment_cfg(dtype)
        params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
        batches = switching_batches(cfg.vocab_size)
        mesh = make_train_mesh(dp, tp, devices=["cpu"] * (dp * tp))
        eager = run_steps(cfg, params, batches, mesh, graphs=False)
        captured = run_steps(cfg, params, batches, mesh, graphs=True)
    finally:
        torch.set_num_threads(threads)
    assert_steps_equal(captured, eager)
    seen, metrics, _, step = captured
    assert isinstance(step, tsegments.SegmentedStep)
    assert [(float(m["loss"]), float(m["accuracy"])) for m in metrics] == seen


def trim_apart_batches(vocab: int) -> list:
    """Four [8, 128] blocks over a dp = 2 grid: queries of 20 tokens (64),
    documents of 40 tokens (64) but 100 (128) in rows {0}, {5}, {0} and
    {0, 6}, so that the document parts alone would trim to (128, 64), (64,
    128), the first again, then (128, 128); every block trims to (64, 128)
    whole."""
    rng = np.random.default_rng(3)

    def block(long_rows):
        q, d = np.zeros((8, 128), np.int32), np.zeros((8, 128), np.int32)
        for i in range(8):
            q[i, :20] = rng.integers(2, vocab, 20)
            d[i, :100 if i in long_rows else 40] = rng.integers(2, vocab,
                                                                100 if i in long_rows else 40)
        return q, d

    return [block({0}), block({5}), block({0}), block({0, 6})]


def test_segmented_parts_trim_as_eager(segmented):
    """Every dp part of a block runs at the block's sequence bucket, as the
    eager step's shard_batch trims it (the block once, then split), where
    the parts alone would trim apart too, and the steps stay bitwise eager.
    The key is the block's (B, Lq, Ld), the one graph's; the four blocks
    share it, so each row's tower is captured once, at the block's widths,
    and the key's tail once."""
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(7))
    batches = trim_apart_batches(cfg.vocab_size)
    mesh = _grid(2, 2)
    captured = run_steps(cfg, params, batches, mesh, graphs=True)
    assert_steps_equal(captured, run_steps(cfg, params, batches, mesh, graphs=False))
    step = captured[3]
    _, _, tbatch, _ = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh)
    for q, d in batches:
        assert [p.shape[1] for p in tbatch(q)] == [64, 64]  # eager's parts
        assert [p.shape[1] for p in tbatch(d)] == [128, 128]
        assert step.key(q, d) == ("train", 2, 2, 8, 64, 128)
    graphs = [k[0][1:] for k in step.programs.graphs]  # (device, *key): the key
    assert {k[:6] for k in graphs if "tail" in k} == {("train", 2, 2, 8, 64, 128)}
    rows = {k[4:7] for k in graphs if k[4] in tsegments.TOWERS}
    assert rows == {("q", 0, 64), ("q", 1, 64), ("d", 0, 128), ("d", 1, 128)}
    plan = tsegments.graphs_per_key(cfg, 2, 2)
    assert step.programs.captures == len(rows) * plan["row"] + 2 + plan["tail"]
    assert step.programs.replays == 3 * plan["graphs"]


def _trained_state(cfg, params, batches, mesh, graphs) -> tuple:
    """Per-step losses and accuracies, and the final parameters of every
    grid position and the optimizer's state (copies), of make_train_step's
    steps over `batches`."""
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh,
                                                      graphs=graphs)
    model = shard(params)
    opt = init(model)
    seen = []
    for q, d in batches:
        model, opt, m = step(model, opt, batch(q), batch(d))
        seen.append((float(m["loss"]), float(m["accuracy"])))
    return seen, [t.detach().clone() for t in ttrain._held(model, opt)], step


def test_three_routes_read_one_width(monkeypatch):
    """On blocks whose dp parts alone would trim to different buckets,
    eager, the one graph (the stand-in capture on a (2, 2) grid of one
    device) and the segment graphs (its stand-in, forced) read one width
    and give bitwise the same per-step losses and accuracies, final
    parameters and optimizer state, with the same key."""
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(7))
    batches = trim_apart_batches(cfg.vocab_size)
    mesh = _grid(2, 2)
    eager = _trained_state(cfg, params, batches, mesh, False)
    monkeypatch.setattr(ttrain, "CapturedPrograms", StepStandIn)
    one = _trained_state(cfg, params, batches, mesh, True)
    monkeypatch.setattr(tsharded, "on_one_device", lambda groups, device: False)
    monkeypatch.setattr(ttrain, "CapturedPrograms", SegmentStandIn)
    segmented = _trained_state(cfg, params, batches, mesh, True)
    assert isinstance(segmented[2], tsegments.SegmentedStep)
    assert not isinstance(one[2], tsegments.SegmentedStep)
    for got in (one, segmented):
        assert got[0] == eager[0]
        assert all(torch.equal(t, w) for t, w in zip(got[1], eager[1]))
    (graph_key, layout), = one[2].programs.graphs  # one key: the block's shapes
    assert graph_key == ("train", 2, 2)
    assert [shape for _, shape, _ in layout] == [(8, 64), (8, 128)]
    assert set(segmented[2]._keys) == {("train", 2, 2, 8, 64, 128)}


NAMED4 = ["cpu", "cpu:1", "cpu:2", "cpu:3"]


@pytest.mark.parametrize("dp,tp", [(2, 2), (2, 4)])
def test_eager_grid_step_feeds_accumulators_on_their_device(dp, tp, monkeypatch):
    """The eager grid step over named devices (they compare unequal, so a
    read on another position copies between devices, as between cards):
    no parameter's AccumulateGrad node takes its gradient straight from a
    copy between devices (on cards that copy's backward runs on the
    reading card's stream, which torch reports as the AccumulateGrad
    node's stream mismatch); each goes through a view on the parameter's
    own device. Every activation read on other devices is copied to all of
    them by one node, which sums their gradients in one order: the steps
    equal the same grid's on one device bitwise (at tp = 4 the normed
    stream's gradient has four terms). No loss, whose autograd graph holds
    the step's AccumulateGrad nodes, outlives its step."""
    import gc
    import weakref

    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(9))
    batches = switching_batches(cfg.vocab_size, lengths=(64, 128))
    losses, loss_fn = [], ttrain.contrastive_loss

    def recording(*a, **kw):
        loss, acc = loss_fn(*a, **kw)
        losses.append(weakref.ref(loss))
        if len(losses) == 1:
            graphs.append(loss.grad_fn)
        return loss, acc

    graphs = []

    monkeypatch.setattr(ttrain, "contrastive_loss", recording)
    named = make_train_mesh(dp, tp, devices=(NAMED4 * 2)[:dp * tp])
    got = _trained_state(cfg, params, batches, named, False)
    monkeypatch.setattr(ttrain, "contrastive_loss", loss_fn)
    one = _trained_state(cfg, params, batches, _grid(dp, tp), False)
    assert got[0] == one[0]
    assert all(torch.equal(t, w) for t, w in zip(got[1], one[1]))

    def moves(node) -> bool:  # a copy that keeps the type: between devices
        return (node.name() == "ToCopyBackward0" and node._input_metadata[0].dtype
                == node.next_functions[0][0]._input_metadata[0].dtype)

    seen, edges, stack = set(), [], [graphs[0]]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None:
                edges.append((node, nxt))
                stack.append(nxt)
    accumulator = "torch::autograd::AccumulateGrad"
    fed = [a for a, b in edges if b.name() == accumulator]
    assert fed and not [a for a in fed if moves(a)]
    assert [a for a, b in edges if moves(a) and b.name() == "ViewBackward0"
            and b.next_functions[0][0].name() == accumulator]
    assert any(a.name() == "_BroadcastBackward" for a, _ in edges)
    del graphs[:], seen, edges, fed, node, stack, nxt
    gc.collect()
    assert len(losses) == len(batches) and not [r for r in losses if r() is not None]


def test_segmented_keys_past_the_limit_drop_their_captures(segmented, monkeypatch):
    """Past MAX_KEYS keys the least recently used key's tail goes, and with
    it the rows' captures and the losses no kept key uses (their pools);
    a key that comes back is captured again, and every step stays bitwise
    eager."""
    monkeypatch.setattr(tsegments, "MAX_KEYS", 1)
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(8))
    batches = switching_batches(cfg.vocab_size, lengths=(64, 128, 64))
    mesh = _grid(2, 1)
    captured = run_steps(cfg, params, batches, mesh, graphs=True)
    assert_steps_equal(captured, run_steps(cfg, params, batches, mesh, graphs=False))
    step = captured[3]
    plan = tsegments.graphs_per_key(cfg, 2, 1)
    # three keys in turn: the documents' rows at 64 captured twice
    assert step.programs.captures == 8 * plan["row"] + 2 + 3 * plan["tail"]
    assert len(step._keys) == 1 and sorted(step._rows) == [
        (8, "d", 0, 64), (8, "d", 1, 64), (8, "q", 0, 64), (8, "q", 1, 64)]
    assert {g for g, _ in step.programs.groups} == {("loss", 8)} | {
        ("rows",) + n for n in step._rows}
    assert len(step.programs.graphs) == plan["graphs"]


def test_segmented_named_devices_unforced(monkeypatch):
    """Named CPU devices compare unequal: the grid is over several devices,
    so the route is chosen without forcing, and stays bitwise eager."""
    monkeypatch.setattr(ttrain, "CapturedPrograms", SegmentStandIn)
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(6))
    batches = switching_batches(cfg.vocab_size, lengths=(64, 128, 64))
    mesh = make_train_mesh(2, 2, devices=["cpu", "cpu:1", "cpu:2", "cpu:3"])
    captured = run_steps(cfg, params, batches, mesh, graphs=True)
    assert isinstance(captured[3].programs, compiled.ProgramsByDevice)
    assert_steps_equal(captured, run_steps(cfg, params, batches, mesh, graphs=False))


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)])
def test_segment_captures_follow_the_plan(segmented, dp, tp):
    """Replays per step equal the plan's graph count, and captures are the
    plan's: each row's tower once a width, the loss once, a tail a key.
    Every graph's key names its grid position and segment; a (4, 1) grid
    has one forward segment per row and tower (and the loss)."""
    cfg = _segment_cfg("bfloat16")
    plan = tsegments.graphs_per_key(cfg, dp, tp)
    assert plan["graphs"] == 2 * plan["forward"] + plan["tail"]
    assert plan["forward"] == dp * plan["row"] + 1
    if tp == 1:
        assert plan["row"] == 2
    else:  # the embedding and every layer's 2 tp + ... segments
        assert plan["row"] == 2 * (1 + 2 * tp * cfg.num_layers)
    params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
    batches = switching_batches(cfg.vocab_size)  # queries at 64, documents at 64 or 128
    step = run_steps(cfg, params, batches, make_train_mesh(dp, tp, ["cpu"] * (dp * tp)),
                     graphs=True)[3]
    keys = 2
    assert step.graphs_per_key == plan["graphs"]
    assert step.programs.captures == 3 * dp * plan["row"] + 2 + keys * plan["tail"]
    assert step.programs.replays == (len(batches) - keys) * plan["graphs"]
    graphs = [k[0][1:] for k in step.programs.graphs]  # (device, *key): the key
    assert len(graphs) == len(set(graphs)) == step.programs.captures
    assert {k[1:3] for k in graphs} == {(dp, tp)}
    assert {k[-2] for k in graphs} == set(np.ndindex(dp, tp))  # each one's position
    assert step.ops_per_step > plan["graphs"]  # its replays, joins and uploads


def test_segmented_loss_follows_jax_mesh(segmented):
    """Five steps of the segmented route at (2, 2) over different batches:
    losses within TRAJ_REL of the JAX trainer on the same mesh shape."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=2)
    step, shard_params, shard_batch, init_opt = jtrain.make_train_step(
        jcfg, jtrain.TrainConfig(), jmake_train_mesh(2, 2))
    jp = shard_params(jax.tree_util.tree_map(jnp.asarray, params))
    js = init_opt(jp)
    tstep, tshard, tbatch, tinit = ttrain.make_train_step(tcfg, ttrain.TrainConfig(), _grid(2, 2),
                                                          graphs=True)
    assert isinstance(tstep, tsegments.SegmentedStep)
    model = tshard(tenc.params_from_numpy(params))
    topt = tinit(model)
    for seed in range(5, 10):
        q, d = _tokens(jcfg.vocab_size, seed=seed)
        jp, js, jm = step(jp, js, shard_batch(jnp.asarray(q)), shard_batch(jnp.asarray(d)))
        model, topt, tm = tstep(model, topt, tbatch(q), tbatch(d))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TRAJ_REL * float(jm["loss"])
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1 / 8 + 1e-6)
    assert tstep.programs.replays == 4 * tstep.graphs_per_key  # one key, one capture


def test_segment_captures_keep_no_autograd_graph(segmented, monkeypatch):
    """After a key's capture no segment's forward outputs stay alive with
    their autograd graph: on a card that graph holds the parameters'
    gradient accumulators, made on the capture stream, and a later eager
    backward that found them would accumulate on that stream."""
    import gc
    import weakref

    alive = []
    forward = tsegments.Segment.forward

    def recording(self):
        out = forward(self)
        alive.extend(weakref.ref(t) for t in out.values() if t.grad_fn is not None)
        return out

    monkeypatch.setattr(tsegments.Segment, "forward", recording)
    cfg = _segment_cfg("bfloat16")
    (q, d), = switching_batches(cfg.vocab_size, lengths=(64,))
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), _grid(2, 2),
                                                      graphs=True)
    model = shard(tenc.init_params(cfg, torch.Generator().manual_seed(5)))
    step(model, init(model), batch(q), batch(d))  # eager, then every capture
    gc.collect()
    assert alive and not [r for r in alive if r() is not None]


def test_segments_of_a_device_capture_on_one_stream(monkeypatch):
    """Every segment graph of a device is captured on one stream, its
    pools' groups alike: a tower's forward graphs keep the AccumulateGrad
    nodes of the parameters they read alive until their backward is
    captured, and the other tower's segments read the same parameters; on
    a card, captured on a stream of their own, they fed those nodes from
    another stream (torch's AccumulateGrad stream mismatch). Each device
    has its own."""
    monkeypatch.setattr(ttrain, "CapturedPrograms", SegmentStandIn)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
    seen = []
    real = SegmentStandIn._capture

    def capture(self, program, static):
        seen.append((self.device, id(self.capture_stream())))
        return real(self, program, static)

    monkeypatch.setattr(SegmentStandIn, "_capture", capture)
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
    batches = switching_batches(cfg.vocab_size, lengths=(64, 128))
    step = run_steps(cfg, params, batches, make_train_mesh(2, 2, devices=NAMED4),
                     graphs=True)[3]
    streams = {}
    for device, stream in seen:
        streams.setdefault(device, set()).add(stream)
    assert len(seen) == step.programs.captures and len(step.programs.groups) > 4
    assert set(streams) == {torch.device(d) for d in NAMED4}
    assert all(len(s) == 1 for s in streams.values()) and len(set.union(*streams.values())) == 4


def test_segment_optimizers_read_one_gradient_buffer(segmented, monkeypatch):
    """The tail's per-position optimizers read the same ``.grad`` tensors
    when captured and at every replay (a graph bakes in what it read)."""
    seen = {}
    adamw_step = torch.optim.AdamW.step

    def recording(self, *a, **k):
        params = self.param_groups[0]["params"]
        seen.setdefault(tuple(id(p) for p in params), set()).add(
            tuple(id(p.grad) for p in params))
        return adamw_step(self, *a, **k)

    monkeypatch.setattr(torch.optim.AdamW, "step", recording)
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
    step = run_steps(cfg, params, switching_batches(cfg.vocab_size, lengths=(64, 64, 64)),
                     _grid(2, 2), graphs=True)[3]
    trained = step._trained
    for sub in trained.sub.values():
        reads = seen[tuple(id(p) for p in sub.param_groups[0]["params"])]
        assert len(reads) == 1
        assert reads == {tuple(id(p.grad) for p in sub.param_groups[0]["params"])}


def _failing_capture(monkeypatch, after: int) -> None:
    """Captures of the stand-in fail from the `after`-th on."""
    calls = {"n": 0}
    real = SegmentStandIn._capture

    def capture(self, program, static):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("capture failed")
        return real(self, program, static)

    monkeypatch.setattr(SegmentStandIn, "_capture", capture)


def test_failed_segment_capture_raises(segmented, monkeypatch):
    """A failed segment capture raises, keeps none of the key's graphs and
    leaves the parameters and the optimizer's state as they were before the
    key's eager first step; nothing trains eagerly in its place: the next
    step of the key tries the capture again, and raises again."""
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
    (q, d), = switching_batches(cfg.vocab_size, lengths=(64,))
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(),
                                                      _grid(2, 2), graphs=True)
    model = shard(params)
    opt = init(model)
    before = [t.clone() for t in ttrain._held(model, opt)]
    _failing_capture(monkeypatch, after=30)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            step(model, opt, batch(q), batch(d))
        assert not step.programs.graphs and step.programs.replays == 0
        assert all(torch.equal(t, b) for t, b in zip(ttrain._held(model, opt), before))
    assert isinstance(step.programs, compiled.ProgramsByDevice)


def test_failed_capture_of_a_new_width_keeps_the_others(segmented, monkeypatch):
    """A key whose new width fails to capture raises and drops only what
    its step made: the earlier key's graphs and rows' captures stay, the
    parameters and optimizer state are as before the failed step, and the
    earlier key still replays, bitwise the eager steps without the failed
    one."""
    cfg = _segment_cfg("bfloat16")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(5))
    b64, b128 = switching_batches(cfg.vocab_size, lengths=(64, 128))
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(),
                                                      _grid(2, 2), graphs=True)
    model = shard(params)
    opt = init(model)
    step(model, opt, batch(b64[0]), batch(b64[1]))  # eager, then its captures
    kept, rows = set(step.programs.graphs), set(step._rows)
    before = [t.clone() for t in ttrain._held(model, opt)]
    _failing_capture(monkeypatch, after=10)  # inside the documents' new width
    with pytest.raises(RuntimeError, match="capture failed"):
        step(model, opt, batch(b128[0]), batch(b128[1]))
    assert set(step.programs.graphs) == kept and set(step._rows) == rows
    assert all(torch.equal(t, b) for t, b in zip(ttrain._held(model, opt), before))
    monkeypatch.undo()
    monkeypatch.setattr(tsharded, "on_one_device", lambda groups, device: False)
    _, metrics = step(model, opt, batch(b64[0]), batch(b64[1]))[1:]
    assert step.programs.replays == tsegments.graphs_per_key(cfg, 2, 2)["graphs"]
    want = run_steps(cfg, params, [b64, b64], _grid(2, 2), graphs=False)
    assert float(metrics["loss"]) == want[0][1][0]
    final = [t.detach().cpu() for t in tenc.flatten_params(model.params_tree())]
    assert all(torch.equal(t, w) for t, w in zip(final, want[2]))


# ---- the graft_entry twin ----------------------------------------------------

def test_dryrun_multichip_runs_all_stages_on_cpu(capsys):
    graft_entry.dryrun_multichip(8, devices=CPU8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(" ok")[0] for line in lines] == [
        "dryrun train step", "dryrun sharded search", "dryrun sparse-sharded search",
        "dryrun live republish", "dryrun sharded IVF", "dryrun mesh encode",
        "dryrun 2D serve mesh", "dryrun sharded host residency", "dryrun multi-slice"]
    assert "dp=4 tp=2" in lines[0]


def test_entry_forward_matches_jax_entry():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as jentry

    jfwd, (jparams, jtokens) = jentry.entry()
    fwd, (params, tokens) = graft_entry.entry("cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    assert tenc.flatten_params(params)[0].shape == (8192, 512)
    carried = tenc.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    want = np.asarray(jax.jit(jfwd)(jparams, jtokens))
    got = fwd(carried, tokens).numpy()
    assert got.shape == want.shape == (8, 1536)
    assert _rowwise_cos(got, want).min() >= BF16_COS
    assert np.abs(got - want).max() <= BF16_ABS
    # the same forward at float32 activations
    cfg = tenc.EncoderConfig(vocab_size=8192, num_layers=4, num_heads=8, model_dim=512,
                             mlp_dim=2048, max_seq=128, out_dim=1536, dtype="float32")
    jcfg = jenc.EncoderConfig(**dataclasses.asdict(cfg))
    want32 = np.asarray(jenc.encode_jit(jparams, jtokens, jcfg))
    got32 = tenc.Encoder(cfg, carried, device="cpu")(tokens).detach().numpy()
    assert np.abs(got32 - want32).max() <= F32_TOL


# ---- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_grid_step_on_card_matches_cpu_twin():
    """chip_smoke.train_step_twin over a (2, 2) grid of ["cuda:0"] * 4 against
    the same grid step on ["cpu"] * 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grid step runs on it")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    grad_err, step_err, _ = chip_smoke.train_step_twin("cuda", grid=(2, 2))
    assert grad_err <= TWIN_GRAD and step_err <= TWIN_STEP


@pytest.mark.cuda
def test_captured_grid_steps_equal_eager_on_card():
    """The captured (2, 2) grid step on ["cuda:0"] * 4 against graphs=False
    there, over the switching steps: per-step losses and final parameters
    bitwise, as two eager runs are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grid step is captured on it")
    cfg = _card_cfg(hybrid_anchor=True)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    batches = switching_batches(cfg.vocab_size)
    mesh = make_train_mesh(2, 2, devices=["cuda:0"] * 4)
    eager = [run_steps(cfg, params, batches, mesh, graphs=False) for _ in range(2)]
    captured = run_steps(cfg, params, batches, mesh)
    assert_steps_equal(eager[1], eager[0])
    assert_steps_equal(captured, eager[0])
    assert captured[3].programs.captures == 2


@pytest.fixture
def forced(monkeypatch):
    """The segmented route on this card: every grid position cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segments are captured on it")
    monkeypatch.setattr(tsharded, "on_one_device", lambda groups, device: False)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)])
def test_segmented_grid_steps_equal_eager_on_card(forced, dp, tp):
    """The segmented route over ["cuda:0"] * dp * tp, forced, against
    graphs=False on that grid over the switching steps: per-step losses,
    accuracies and final parameters bitwise, as two eager runs are; the
    captures and replays are the plan's."""
    cfg = _card_cfg(hybrid_anchor=True)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    batches = switching_batches(cfg.vocab_size)
    mesh = make_train_mesh(dp, tp, devices=["cuda:0"] * (dp * tp))
    eager = [run_steps(cfg, params, batches, mesh, graphs=False) for _ in range(2)]
    captured = run_steps(cfg, params, batches, mesh)
    assert_steps_equal(eager[1], eager[0])
    assert_steps_equal(captured, eager[0])
    step = captured[3]
    assert isinstance(step, tsegments.SegmentedStep)
    plan = tsegments.graphs_per_key(cfg, dp, tp)
    assert step.programs.captures == 3 * dp * plan["row"] + 2 + 2 * plan["tail"]
    assert step.programs.replays == (len(batches) - 2) * plan["graphs"]


@pytest.mark.cuda
def test_segmented_parts_trim_apart_on_card(forced, monkeypatch):
    """Blocks whose dp parts alone would trim to different widths: on the
    segmented route forced on this card every part runs at the block's
    width, bitwise the eager step and the one graph; one key (B, Lq, Ld),
    each row's tower captured once, every later step a replay."""
    cfg = _card_cfg(hybrid_anchor=True)
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    batches = trim_apart_batches(cfg.vocab_size)
    batches += batches  # the key again: replays only
    mesh = make_train_mesh(2, 2, devices=["cuda:0"] * 4)
    eager = run_steps(cfg, params, batches, mesh, graphs=False)
    captured = run_steps(cfg, params, batches, mesh)
    assert_steps_equal(captured, eager)
    plan = tsegments.graphs_per_key(cfg, 2, 2)
    step = captured[3]
    assert set(step._keys) == {("train", 2, 2, 8, 64, 128)}
    assert step.programs.captures == 4 * plan["row"] + 2 + plan["tail"]
    assert step.programs.replays == 7 * plan["graphs"]
    monkeypatch.undo()  # the one graph of this card's grid
    one = run_steps(cfg, params, batches, mesh)
    assert not isinstance(one[3], tsegments.SegmentedStep) and one[3].programs.captures == 1
    assert_steps_equal(one, eager)


_STREAM_WARNING_RUN = """
import dataclasses, sys, warnings
import numpy as np, torch
sys.path.insert(0, {root!r})
warnings.filterwarnings("error", message="The AccumulateGrad node's stream")
from mobius_rag_tpu_torch.models import encoder as tenc, train as ttrain
from mobius_rag_tpu_torch.parallel import sharded
from mobius_rag_tpu_torch.parallel.mesh import make_train_mesh
sharded.on_one_device = lambda groups, device: False
cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=128, vocab_size=512)
mesh = make_train_mesh(2, 2, devices={devices!r})
rng = np.random.default_rng(0)
for graphs in (False, True):
    step, shard, batch, init = ttrain.make_train_step(cfg, ttrain.TrainConfig(), mesh,
                                                      graphs=graphs)
    model = shard(tenc.init_params(cfg, torch.Generator(device="cuda:0").manual_seed(0)))
    opt = init(model)
    for width in (64, 128, 64):
        q = rng.integers(2, 512, (8, 128)).astype(np.int32)
        q[:, width:] = 0
        model, opt, m = step(model, opt, batch(q), batch(q))
        float(m["loss"])
print("no warning")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 4], ids=["forced_on_one_card", "over_cards"])
def test_grid_steps_raise_no_stream_warning_on_card(cards):
    """In a fresh process (torch warns once a process), with torch's
    AccumulateGrad stream warning made an error: the eager (2, 2) step
    and the segmented route, forced on cuda:0 or over cuda:0..3, three
    steps over two keys. Captured with a stream of its own, each tower's
    group fed AccumulateGrad nodes made on another's."""
    import subprocess

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA cards")
    devices = [f"cuda:{i % cards}" for i in range(4)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c",
                        _STREAM_WARNING_RUN.format(root=root, devices=devices)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "no warning" in r.stdout, r.stderr[-3000:]


@pytest.mark.cuda
def test_segmented_grid_step_on_card_matches_cpu_twin():
    """chip_smoke.train_step_twin over a (4, 2) grid of ["cuda:0"] * 8 on
    the segmented route (its second step, a replay of every graph) against
    the same grid step on ["cpu"] * 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segments are captured on it")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    grad_err, step_err, _ = chip_smoke.train_step_twin("cuda", grid=(4, 2), segmented=True)
    assert grad_err <= TWIN_GRAD and step_err <= TWIN_STEP


@pytest.mark.cuda
def test_failed_segment_capture_on_card_raises(forced, monkeypatch):
    """A segment capture that fails on the card raises, keeps none of the
    key's graphs and leaves the parameters and optimizer state as before
    the call; the next step raises again (no eager step in its place)."""
    cfg = _card_cfg()
    params = tenc.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    (q, d), = switching_batches(cfg.vocab_size, lengths=(64,))
    step, shard, batch, init = ttrain.make_train_step(
        cfg, ttrain.TrainConfig(), make_train_mesh(2, 2, devices=["cuda:0"] * 4))
    model = shard(params)
    opt = init(model)
    before = [t.clone() for t in ttrain._held(model, opt)]
    calls = {"n": 0}
    real = compiled.CapturedPrograms._capture

    def capture(self, program, static):
        calls["n"] += 1
        if calls["n"] > 30:
            raise RuntimeError("capture failed")
        return real(self, program, static)

    monkeypatch.setattr(compiled.CapturedPrograms, "_capture", capture)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            step(model, opt, batch(q), batch(d))
        assert not step.programs.graphs and step.programs.replays == 0
        assert all(torch.equal(t, b) for t, b in zip(ttrain._held(model, opt), before))
    monkeypatch.undo()
    assert isinstance(step.programs, compiled.ProgramsByDevice)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1), (2, 4)])
def test_segmented_grid_over_cards_on_card(dp, tp):
    """With four cards or more: a grid over cuda:0..3 (at (2, 4) each row
    over them; real copies between cards, no forcing) on the segmented
    route against its eager step on the same cards, bitwise. At tp = 4 the
    normed stream's gradient fans in from four cards: the eager step sums
    it in one order (``encoder._Broadcast``). Neither route raises
    torch's AccumulateGrad stream warning (made an error here)."""
    import warnings

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cfg = _card_cfg(hybrid_anchor=True)
    params = tenc.init_params(cfg, torch.Generator(device="cuda:0").manual_seed(5))
    batches = switching_batches(cfg.vocab_size)
    cards = [f"cuda:{i}" for i in range(4)]
    mesh = make_train_mesh(dp, tp, devices=(cards * 2)[:dp * tp])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="The AccumulateGrad node's stream")
        eager = run_steps(cfg, params, batches, mesh, graphs=False)
        captured = run_steps(cfg, params, batches, mesh)
    assert isinstance(captured[3], tsegments.SegmentedStep)
    assert_steps_equal(captured, eager)
    assert set(captured[3].programs.by_device) == {torch.device("cuda", i) for i in range(4)}
