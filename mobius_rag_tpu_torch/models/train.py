"""Contrastive training of the encoder on (query, chunk) pairs, on one device
or over a ("dp", "tp") device grid (the port of
``mobius_rag_tpu.models.train``).

Fine-tunes the encoder on in-domain pairs mined from the corpus
(``models/data.py``): symmetric InfoNCE over in-batch negatives at a logit
scale of 20. The optimizer is the JAX package's optax chain,
``clip_by_global_norm(1.0)`` then ``adamw(1e-4, weight_decay=0.01)``:
the clip keeps optax's formula (``g / norm * max_norm`` when the norm
reaches ``max_norm``; ``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6``) and ``torch.optim.AdamW`` computes optax's decoupled
update. A parameter that no gradient reaches (the hybrid anchor, under
JAX's ``stop_gradient``) gets a zero gradient, not None, so AdamW still
decays it as optax does.

Over a training grid (``parallel.mesh.make_train_mesh``) the parameters
lie as ``models.encoder.param_specs`` says, every grid position holding
its own copy of its shard (``GridModel``), and the batch splits
contiguously over dp. Each dp row runs the tensor-parallel forward
(``models.encoder.GridEncoder``); the rows' embeddings meet on the grid's
first device, where the loss of the whole batch is taken, as JAX takes it
over the logical array. After the backward each shard's gradient is summed
over the dp rows onto row 0, whose shards alone are clipped (each logical
element counted once) and stepped, with AdamW's moments beside them, as JAX
keeps ``opt_state`` sharded like the parameters; the other rows then copy
them. A grid of one device repeated runs the whole program on one card.
``mesh=None`` means one device, ``device=``: the JAX package then builds a
mesh over every device, which on one card is dp=1, tp=1, the same program.

On a card the step is the port of the JAX ``train_step`` (one XLA program,
``params`` and ``opt_state`` donated): one captured CUDA graph per key
(``query/compiled.CapturedPrograms``), covering both towers' forward, the
loss, the backward, the zero fill of missing gradients, the clip and AdamW,
with the parameters and the optimizer's state updated in place (JAX's
donation). A step then costs the host one upload of its token blocks into
the graph's static input and one replay. The key is the batch's shape:
(B, Lq, Ld), with (dp, tp) on a grid. JAX pads every batch to ``max_seq``
to bound its compiles; the port trims each token block to the encoder's
sequence buckets (``seq_bucket``), so at most a few lengths each, and the
buckets are the graph keys: PAD columns are masked out of attention and
pooling, so their gradients are zero either way. A grid whose positions
span several devices cannot be one graph (a capture records one device's
stream): its step is captured as segment graphs, one forward and one
backward per run of the step on one grid position between two edges
across devices, and a tail per position, joined by copies
(``models/segments.py``).

    python -m mobius_rag_tpu_torch.models.train [--steps 200] [--batch 64]
        [--distractors 1200] [--out DIR] [--device cuda]

trains ``scripts/train_encoder.py``'s recipe (the fixture stack plus
distractor documents; 4 x 512, heads 8, mlp 2048, max_seq 128, vocab
16,384) and saves an npz checkpoint that both packages load.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from mobius_rag_tpu_torch.models.encoder import (Encoder, EncoderConfig, GridEncoder,
                                                 check_tp, gather_tree, init_params,
                                                 param_specs, seq_bucket, shard_tree,
                                                 tree_map)
from mobius_rag_tpu_torch.query.compiled import LOCK, CapturedPrograms, ProgramsByDevice


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    temperature: float = 20.0  # logit scale (1 / 0.05)
    grad_clip: float = 1.0


def make_optimizer(params, tc: TrainConfig) -> torch.optim.AdamW:
    """optax.adamw's update (b1 0.9, b2 0.999, eps 1e-8, decoupled decay).
    Its whole state is made here, on the parameters' devices, as optax's
    ``opt_state`` exists before the first step. torch.optim would make it
    in the first ``step()``: under a capture it would land in the graphs'
    pool, and a captured step needs its tensors to keep their identities.
    On a card the update is capturable (its step counts on the device),
    eager and captured alike, so that both run one program; on the CPU the
    step counts stay on the host."""
    params = list(params)
    capturable = all(p.device.type == "cuda" for p in params)
    opt = torch.optim.AdamW(params, lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tc.weight_decay, capturable=capturable)
    for p in params:  # the state torch.optim's Adam makes lazily
        opt.state[p] = {
            "step": torch.zeros((), device=p.device if capturable else "cpu"),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
    return opt


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each gradient is kept when the
    global norm is below ``max_norm``, else becomes ``g / norm * max_norm``.
    Stays on the devices (no read-back); the gradients may lie on several,
    and the norm is taken on the first's. Returns the norm."""
    home = grads[0].device
    norm = torch.sqrt(sum((g * g).sum().to(home) for g in grads))
    div, mul = clip_factors(norm, max_norm)
    for g in grads:
        g.div_(div.to(g.device)).mul_(mul.to(g.device))
    return norm


def clip_factors(norm: torch.Tensor, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The clip's (divisor, multiplier) for a global norm, on its device:
    (1, 1) below ``max_norm``, else (norm, max_norm)."""
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    return torch.where(keep, one, norm), torch.where(keep, one, max_norm * one)


def contrastive_loss(module: "Encoder | GridModel", q_tokens, d_tokens,
                     temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE over in-batch negatives: (loss, accuracy). The
    tokens are what ``module`` takes: [B, L] tensors for an ``Encoder``,
    one part per dp row for a ``GridModel`` (the loss is the whole
    batch's either way)."""
    qe = module(q_tokens)  # [B, out] normalized
    de = module(d_tokens)
    return infonce(qe, de, temperature)


def infonce(qe: torch.Tensor, de: torch.Tensor, temperature: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """contrastive_loss's (loss, accuracy) from the batch's embeddings."""
    logits = (qe @ de.T) * temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, acc


def fill_missing_grads(module: torch.nn.Module) -> None:
    """A zero gradient for every parameter that none reached (JAX's zero
    cotangent), so the optimizer updates it (weight decay) like optax."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def detached_tree(tree):
    """A parameter tree's tensors without their autograd history."""
    if isinstance(tree, dict):
        return {k: detached_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [detached_tree(v) for v in tree]
    return tree.detach()


def host_batch(tokens: np.ndarray) -> np.ndarray:
    """A [B, L] token block as int32, trimmed to its sequence bucket: what a
    captured step uploads into its graph's static input (4-byte types
    only; the forward widens the tokens on the device)."""
    return np.ascontiguousarray(seq_bucket(tokens), dtype=np.int32)


def to_device(tokens: np.ndarray, device: torch.device) -> torch.Tensor:
    """A [B, L] token block on ``device`` as int64 (the embedding gather's
    backward needs long indices), trimmed to its sequence bucket."""
    host = torch.from_numpy(np.ascontiguousarray(seq_bucket(tokens)))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True).long()


class GridModel:
    """The encoder over a ("dp", "tp") training grid: every position's shard
    tree (``shard_tree`` under ``param_specs``, taking gradients), one
    ``GridEncoder`` per dp row. ``model(parts)`` runs row i on ``parts[i]``
    and returns the rows' embeddings concatenated on the grid's first
    device. ``parameters()`` are the owners: row 0's shards of the split
    parameters and position (0, 0)'s copy of the replicated ones, each
    logical element once; the other positions follow them."""

    def __init__(self, cfg: EncoderConfig, params: dict, mesh):
        if mesh.axis_names != ("dp", "tp"):
            raise ValueError(f"a training grid has axes ('dp', 'tp'), not {mesh.axis_names}")
        check_tp(cfg, mesh.devices.shape[1])
        self.cfg, self.mesh, self.specs = cfg, mesh, param_specs(cfg)
        self.grid = shard_tree(params, self.specs, mesh)
        for tree in self.grid.flat:
            tree_map(lambda leaf: leaf.requires_grad_(True), tree)
        self.home = mesh.devices[0, 0]
        self.rows = [GridEncoder(cfg, list(self.grid[i]), list(mesh.devices[i]))
                     for i in range(mesh.devices.shape[0])]
        # per grid position, (leaf, owner leaf) pairs in tree order
        split = [any(spec) for spec in _leaves(self.specs)]
        leaves = {idx: _leaves(self.grid[idx]) for idx in np.ndindex(self.grid.shape)}
        self._pairs = {idx: [(leaf, leaves[(0, idx[1]) if s else (0, 0)][k])
                             for k, (leaf, s) in enumerate(zip(mine, split))]
                       for idx, mine in leaves.items()}

    def __call__(self, parts: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([row(t).to(self.home) for row, t in zip(self.rows, parts)])

    def parameters(self) -> list[torch.Tensor]:
        return [owner for pairs in self._pairs.values()
                for leaf, owner in pairs if leaf is owner]

    def sum_grads_over_dp(self) -> None:
        """Adds the gradient of each position of rows 1.. into its owner's
        and drops it: row 0 then holds the gradient of the whole batch. (A
        row's replicated parameters take their gradient at its shard 0, the
        only copy its forward reads.)"""
        for idx, pairs in self._pairs.items():
            if idx[0] == 0:
                continue
            for leaf, owner in pairs:
                if leaf.grad is not None:
                    g = leaf.grad.to(owner.device)
                    owner.grad = g if owner.grad is None else owner.grad.add_(g)
                    leaf.grad = None

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Every position's shard of ``tree`` written in place (as
        ``Encoder.load_tree``): the tensors, and so a captured step's
        graphs, stay."""
        fresh = shard_tree(tree, self.specs, self.mesh)
        for idx in np.ndindex(self.grid.shape):
            for leaf, new in zip(_leaves(self.grid[idx]), _leaves(fresh[idx])):
                leaf.copy_(new)

    @torch.no_grad()
    def copy_from_owners(self) -> None:
        for pairs in self._pairs.values():
            for leaf, owner in pairs:
                if leaf is not owner:
                    leaf.copy_(owner)

    def params_tree(self) -> dict:
        """The parameters whole, as the JAX package's tree, on the grid's first
        device (new tensors)."""
        with torch.no_grad():
            return gather_tree(self.grid, self.specs, self.mesh)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _step(model: "Encoder | GridModel", opt, q, d, tc: TrainConfig) -> dict:
    """One training step in place, eager or under capture alike: the
    gradients from None (so a capture allocates them in its pool and every
    replay writes them there), the loss's backward, on a grid the dp sum,
    the missing gradients zero, the clip by their global norm, AdamW, on a
    grid the copies from the owners. Returns the metrics on the device."""
    opt.zero_grad(set_to_none=True)
    loss, acc = contrastive_loss(model, q, d, tc.temperature)
    loss.backward()
    grid = isinstance(model, GridModel)
    if grid:
        model.sum_grads_over_dp()
    fill_missing_grads(model)
    clip_by_global_norm_([p.grad for p in model.parameters()], tc.grad_clip)
    opt.step()
    if grid:
        model.copy_from_owners()
    return {"loss": loss.detach(), "accuracy": acc}


def _held(model: "Encoder | GridModel", opt) -> list[torch.Tensor]:
    """Every tensor a captured step reads or writes in place: the
    parameters (every grid position's) and the optimizer's state."""
    params = ([leaf for tree in model.grid.flat for leaf in _leaves(tree)]
              if isinstance(model, GridModel) else list(model.parameters()))
    return params + [t for group in opt.param_groups for p in group["params"]
                     for t in opt.state[p].values()]


def _train_step(tc: TrainConfig, programs: CapturedPrograms | None, key: tuple, split):
    """train_step over ``shard_batch``'s batches: eager when ``programs`` is
    None, else one CUDA graph per (``key``, the blocks' shapes) of
    ``programs``. ``split`` cuts an uploaded [B, L] block into what the
    model takes (a grid: one part per dp row)."""
    def train_step(model, opt, q_tokens, d_tokens):
        if programs is None:
            return model, opt, _step(model, opt, q_tokens, d_tokens, tc)
        if not (isinstance(q_tokens, np.ndarray) and isinstance(d_tokens, np.ndarray)):
            raise TypeError("a captured train_step takes the host blocks its shard_batch "
                            f"gives, not {type(q_tokens).__name__}")

        def program(static: dict) -> dict:
            return _step(model, opt, split(static["q"]), split(static["d"]), tc)

        # a replay rewrites the static outputs of every graph in the pool,
        # so the metrics go back as copies, enqueued under the lock
        with LOCK:
            out = programs.run(key, _held(model, opt), {"q": q_tokens, "d": d_tokens},
                               program)
            return model, opt, {name: v.clone() for name, v in out.items()}

    train_step.programs = programs
    return train_step


def _programs(home: torch.device, devices, graphs: bool | None, grid: bool = False
              ) -> CapturedPrograms | ProgramsByDevice | None:
    """The step's captured programs, or None for an eager step.
    ``graphs=None`` captures on a card and runs eagerly on the CPU; True
    off a card raises. A capture records one device's stream, so a grid
    whose positions are all ``home`` (``parallel.sharded.on_one_device``,
    the predicate the sharded engine reads) captures the whole step as one
    graph per key (a ``CapturedPrograms``); a grid over several devices
    captures it as segment graphs per device (a ``ProgramsByDevice``:
    ``models/segments.py``)."""
    if graphs is None:
        graphs = all(torch.device(d).type == "cuda" for d in devices)
    if not graphs:
        return None
    if grid:
        from mobius_rag_tpu_torch.parallel import sharded

        if not sharded.on_one_device([list(devices)], home):
            return ProgramsByDevice(devices, make=CapturedPrograms)
    return CapturedPrograms(home)  # raises off a card


def make_train_step(cfg: EncoderConfig, tc: TrainConfig, mesh=None, *, device="cuda",
                    graphs: bool | None = None):
    """Returns (train_step, shard_params, shard_batch, init_opt_state), the
    JAX package's four functions: ``shard_params(tree)`` gives the model
    (parameters taking gradients), ``shard_batch(np tokens)`` the batch
    (trimmed to its sequence bucket), ``init_opt_state(model)`` the
    optimizer with its whole state (``make_optimizer``) and
    ``train_step(model, opt, q, d) -> (model, opt, {"loss", "accuracy"})``,
    which updates the model and the optimizer in place, with the metrics
    on the device (copies of a captured step's static outputs).

    ``graphs``: None (the default) captures the step on a card and runs it
    eagerly on the CPU; False runs it eagerly on a card too; True off a
    card raises. Captured, one CUDA graph per (B, Lq, Ld) (and (dp, tp)) of
    ``train_step.programs`` (a ``CapturedPrograms``: its captures, replays
    and pool) holds every parameter and the optimizer's state: a new model
    or optimizer drops the graphs at its first step. On a grid over several
    devices the step is a ``models.segments.SegmentedStep``, its programs a
    ``ProgramsByDevice`` of segment graphs, a key the widths of the dp parts
    as the eager ``shard_batch`` trims them (a row's tower captured once a
    width, a tail a key). The first step of a key runs
    eagerly (its result) and is then captured; a failed capture or replay
    raises, and nothing trains eagerly after one. Every captured step holds
    ``compiled.LOCK`` across its upload, its replay (or eager run and
    capture) and the copies of its metrics. ``shard_batch`` then keeps the
    batch on the host (int32, ``host_batch``): the step uploads it into
    the graph's static input. A parameter's ``.grad`` after a captured step
    lies in the graphs' pool: the gradient of the last captured key's
    latest replay.

    ``mesh=None``: an ``Encoder`` on ``device`` and [B, L] tensors there.
    A training grid (``make_train_mesh``): a ``GridModel``, batches as one
    [B / dp, L] part per dp row on the row's first device (B must split
    evenly, as JAX's device_put onto P("dp", None) requires), the metrics
    on the grid's first device; ``device`` is not read."""
    if mesh is not None:
        return _grid_train_step(cfg, tc, mesh, graphs)
    device = torch.device(device)
    programs = _programs(device, [device], graphs)

    def shard_params(params: dict) -> Encoder:
        return Encoder(cfg, params, device=device).requires_grad_(True)

    def shard_batch(tokens: np.ndarray):
        return host_batch(tokens) if programs is not None else to_device(tokens, device)

    def init_opt_state(module: Encoder) -> torch.optim.AdamW:
        return make_optimizer(module.parameters(), tc)

    return (_train_step(tc, programs, ("train",), lambda t: t), shard_params, shard_batch,
            init_opt_state)


def _grid_train_step(cfg: EncoderConfig, tc: TrainConfig, mesh, graphs: bool | None):
    row_devices = list(mesh.devices[:, 0])
    dp, tp = mesh.devices.shape
    programs = _programs(mesh.devices[0, 0], list(mesh.devices.flat), graphs, grid=True)

    def shard_params(params: dict) -> GridModel:
        return GridModel(cfg, params, mesh)

    def shard_batch(tokens: np.ndarray):
        if len(tokens) % dp:
            raise ValueError(f"a batch of {len(tokens)} rows does not split evenly over "
                             f"dp={dp}: its size should be divisible by {dp}")
        if programs is not None:
            return host_batch(tokens)
        tokens = seq_bucket(tokens)
        n = len(tokens) // dp
        return [to_device(tokens[i * n:(i + 1) * n], d) for i, d in enumerate(row_devices)]

    def init_opt_state(model: GridModel) -> torch.optim.AdamW:
        return make_optimizer(model.parameters(), tc)

    def split(block: torch.Tensor) -> list[torch.Tensor]:
        return list(block.split(len(block) // dp))  # every row's device is the block's

    if isinstance(programs, ProgramsByDevice):
        from mobius_rag_tpu_torch.models.segments import SegmentedStep

        step = SegmentedStep(tc, mesh, programs)
    else:
        step = _train_step(tc, programs, ("train", dp, tp), split)
    return step, shard_params, shard_batch, init_opt_state


def train_encoder_on_corpus(
    store,
    *,
    cfg: EncoderConfig | None = None,
    params: dict | None = None,
    steps: int = 100,
    batch: int = 32,
    mesh=None,
    tc: TrainConfig | None = None,
    seed: int = 0,
    log_every: int = 10,
    lexicon=None,
    augment: float = 0.0,
    device="cuda",
):
    """Fine-tune the encoder on ICT pairs mined from a ChunkStore (mine →
    train → re-embed with the result). Returns (parameter tree, history):
    the tree whole on ``device``, or with a training grid ``mesh`` on the
    grid's first device. ``augment`` > 0 adds that multiple of
    paraphrase-augmented pairs (``models/data.augment_pairs``). The pairs
    and batches are the JAX package's for the same store and seed; the
    initial parameters come from ``torch.Generator(device).manual_seed(seed)``
    when ``params`` is None."""
    from mobius_rag_tpu_torch.models.data import (augment_pairs, mine_ict_pairs,
                                                  pretokenized_batches)
    from mobius_rag_tpu_torch.models.tokenizer import HashTokenizer

    cfg = cfg or EncoderConfig.from_env()
    tc = tc or TrainConfig()
    device = _home(mesh, device)
    tokenizer = HashTokenizer(cfg.vocab_size, cfg.max_seq)
    pairs = mine_ict_pairs(store, max_pairs=steps * batch * 2, seed=seed)
    if len(pairs) < batch:
        raise ValueError(f"corpus too small to mine {batch}-pair batches "
                         f"({len(pairs)} pairs)")
    if augment > 0:
        pairs = augment_pairs(pairs, lexicon=lexicon, factor=augment, seed=seed)

    step_fn, shard_params, shard_batch, init_opt = make_train_step(cfg, tc, mesh,
                                                                   device=device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    module = shard_params(params)
    opt = init_opt(module)
    history = []
    for done, (qs, ds) in enumerate(
            pretokenized_batches(pairs, tokenizer, batch, steps=steps, seed=seed), start=1):
        module, opt, metrics = step_fn(module, opt, shard_batch(qs), shard_batch(ds))
        if done % log_every == 0 or done == steps:
            history.append({"step": done, **{k: float(v) for k, v in metrics.items()}})
    return detached_tree(module.params_tree()), history


def _home(mesh, device) -> torch.device:
    """The device that holds the parameters whole: ``device``, or a grid's
    first."""
    return torch.device(device) if mesh is None else mesh.devices.flat[0]


def demo_tokens(cfg: EncoderConfig, batch: int, seed: int, device) -> tuple:
    """train_demo's random pairs: queries of random ids, documents sharing
    their first half (a learnable task)."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    base = torch.randint(2, cfg.vocab_size, (batch, cfg.max_seq), generator=g, device=device)
    noise = torch.randint(2, cfg.vocab_size, (batch, cfg.max_seq), generator=g, device=device)
    half = torch.arange(cfg.max_seq, device=device)[None, :] < cfg.max_seq // 2
    return base, torch.where(half, base, noise)


def train_demo(num_steps: int = 3, mesh=None, cfg: EncoderConfig | None = None,
               batch: int = 16, seed: int = 0, device="cuda") -> list[dict]:
    """Tiny smoke-train on random token pairs, on ``device`` or over a
    training grid ``mesh``. Returns the metrics history."""
    cfg = cfg or EncoderConfig.tiny()
    device = _home(mesh, device)
    step, shard_params, shard_batch, init_opt = make_train_step(cfg, TrainConfig(), mesh,
                                                                device=device)
    module = shard_params(init_params(cfg, torch.Generator(device=device).manual_seed(seed)))
    opt = init_opt(module)
    q_tokens, d_tokens = (shard_batch(t.cpu().numpy())
                          for t in demo_tokens(cfg, batch, seed, device))
    history = []
    for _ in range(num_steps):
        module, opt, metrics = step(module, opt, q_tokens, d_tokens)
        history.append({k: float(v) for k, v in metrics.items()})
    return history


def recipe_config(out_dim: int) -> EncoderConfig:
    """scripts/train_encoder.py's model: 4 x 512, heads 8, mlp 2048,
    max_seq 128, vocab 16,384."""
    return EncoderConfig(vocab_size=16384, num_layers=4, num_heads=8, model_dim=512,
                         mlp_dim=2048, max_seq=128, out_dim=out_dim)


def main(argv: list[str] | None = None) -> None:
    import argparse
    import os
    import sys
    import time

    from mobius_rag_tpu_torch.config import get_config
    from mobius_rag_tpu_torch.eval_harness.fixture_corpus import (build_fixture_stack,
                                                                  distractor_corpus)
    from mobius_rag_tpu_torch.models.checkpoint import save_encoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--distractors", type=int, default=1200)
    ap.add_argument("--out", default=os.path.expanduser("~/.mobius_rag_tpu/encoder_r2"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config()
    _, engine, store, _, _ = build_fixture_stack(device=args.device)
    store.add_chunks(distractor_corpus(args.distractors, engine.lexicon, cfg))
    print(f"fixture stack with distractors: {store.size} chunks", file=sys.stderr)
    enc_cfg = recipe_config(cfg.embed_dim)
    t0 = time.perf_counter()
    params, history = train_encoder_on_corpus(store, cfg=enc_cfg, steps=args.steps,
                                              batch=args.batch, device=args.device)
    print(f"train done in {time.perf_counter() - t0:.0f}s: {history[-1]}", file=sys.stderr)
    save_encoder(args.out, params, enc_cfg)
    print(f"saved to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
