"""Transformer text encoder on the card (the port of
``mobius_rag_tpu.models.encoder``).

Replaces the reference's external embedding providers (OpenAI batch-100 /
Vertex gemini-embedding-001 batch-1; app/services/embedding_provider.py:
24-149) with an on-device batched encoder that writes embeddings straight
into the chunk index.

The parameters keep the JAX package's tree (``embed``, ``pos``,
``ln_f_scale``, ``proj``, ``layers[i]`` with ``ln1_scale``, ``ln2_scale``,
``qkv [D, 3, H, Dh]``, ``attn_out [H, Dh, D]``, ``mlp_in``, ``mlp_out``;
``anchor_proj`` and ``alpha`` under ``hybrid_anchor``), held in float32 by
an ``nn.Module``. The forward mirrors the JAX numerics: activations in
the config's dtype (bfloat16 by default), RMS norms in float32, attention
logits promoted to float32 by the 1/sqrt(Dh) scale, masked with -1e30 and
soft-maxed in float32, probabilities cast back; tanh GELU; masked mean
pool, float32 projection and L2 normalisation. The matmuls and attention
products are plain ``torch.einsum`` (the JAX package has no kernel of its
own there either).

``param_specs``, ``shard_tree`` and ``GridEncoder`` lay the parameters over
a ("dp", "tp") device grid in the JAX package's Megatron layout and run
one dp row's forward in tensor-parallel form (``models/train.py`` trains
over the grid).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.models.tokenizer import PAD_ID, HashTokenizer
from mobius_rag_tpu_torch.query.compiled import LOCK, CapturedPrograms, join, to_device


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    num_layers: int = 12
    num_heads: int = 12
    model_dim: int = 768
    mlp_dim: int = 3072
    max_seq: int = 512
    out_dim: int = 1536
    dtype: str = "bfloat16"  # activation dtype
    # Hybrid anchor: embedding = normalize(bag-of-tokens random projection
    # + |alpha| * transformer output); at alpha=0 the model equals the hash
    # baseline (see the JAX package's EncoderConfig).
    hybrid_anchor: bool = False

    @classmethod
    def from_env(cls) -> "EncoderConfig":
        cfg = get_config()
        return cls(
            vocab_size=cfg.encoder_vocab_size,
            num_layers=cfg.encoder_layers,
            num_heads=cfg.encoder_heads,
            model_dim=cfg.encoder_model_dim,
            mlp_dim=cfg.encoder_mlp_dim,
            max_seq=cfg.encoder_max_seq,
            out_dim=cfg.embed_dim,
        )

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Small config for tests / dryruns."""
        return cls(vocab_size=1024, num_layers=2, num_heads=4,
                   model_dim=128, mlp_dim=256, max_seq=64, out_dim=256)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _layer_shapes(cfg: EncoderConfig) -> dict[str, tuple[int, ...]]:
    dm, h = cfg.model_dim, cfg.num_heads
    dh = dm // h
    return {
        "ln1_scale": (dm,),
        "ln2_scale": (dm,),
        "qkv": (dm, 3, h, dh),
        "attn_out": (h, dh, dm),
        "mlp_in": (dm, cfg.mlp_dim),
        "mlp_out": (cfg.mlp_dim, dm),
    }


def init_params(cfg: EncoderConfig, generator: torch.Generator) -> dict:
    """A fresh parameter tree on ``generator.device``: N(0, 0.02) matrices,
    unit norm scales, and under ``hybrid_anchor`` an N(0, 1/out_dim) anchor
    and alpha 0.5 — the JAX package's distributions (its values differ:
    the two RNGs do)."""
    dev = generator.device

    def dense(*shape):
        return 0.02 * torch.randn(shape, generator=generator, device=dev)

    def ones(n):
        return torch.ones(n, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        shapes = _layer_shapes(cfg)
        layers.append({name: ones(shape[0]) if name.startswith("ln")
                       else dense(*shape) for name, shape in shapes.items()})
    params = {
        "embed": dense(cfg.vocab_size, cfg.model_dim),
        "pos": dense(cfg.max_seq, cfg.model_dim),
        "ln_f_scale": ones(cfg.model_dim),
        "proj": dense(cfg.model_dim, cfg.out_dim),
        "layers": layers,
    }
    if cfg.hybrid_anchor:
        params["anchor_proj"] = torch.randn(
            (cfg.vocab_size, cfg.out_dim), generator=generator,
            device=dev) / (cfg.out_dim ** 0.5)
        params["alpha"] = torch.tensor(0.5, device=dev)
    return params


def params_from_numpy(tree) -> dict:
    """A JAX-package parameter tree given as numpy arrays (nested dicts and
    lists) → the same tree of float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32, copy=True))


def flatten_params(tree) -> list:
    """Leaves in ``jax.tree_util`` flatten order: dict keys sorted, lists in
    order (the npz checkpoint's ``p0..pN``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_params(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten_params(v)]
    return [tree]


def unflatten_params(cfg: EncoderConfig, leaves: list, kind: str = "bi") -> dict:
    """Inverse of :func:`flatten_params` for this config's tree: the
    encoder's (``kind="bi"``) or the cross-encoder's (``"cross"``: a
    ``score_head`` in place of ``proj``)."""
    template = {
        "embed": 0, "pos": 0, "ln_f_scale": 0, "proj": 0,
        "layers": [dict.fromkeys(_layer_shapes(cfg), 0)
                   for _ in range(cfg.num_layers)],
    }
    if kind == "cross":
        del template["proj"]
        template["score_head"] = 0
    if cfg.hybrid_anchor:
        template.update(anchor_proj=0, alpha=0)
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [fill(v) for v in t]
        leaf = next(it, None)
        if leaf is None:
            raise ValueError("fewer leaves than the config's parameter tree")
        return leaf

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the config's parameter tree")
    return out


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _param(shape, device) -> nn.Parameter:
    # serving needs no gradients; the trainer turns them on
    # (models/train.py: module.requires_grad_(True))
    return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)


def _attention(y: torch.Tensor, mask: torch.Tensor, qkv: torch.Tensor,
               attn_out: torch.Tensor, scale: float) -> torch.Tensor:
    """Self-attention over the heads that ``qkv`` [D, 3, h, Dh] and
    ``attn_out`` [h, Dh, D] hold, projected back to [B, L, D] in y's dtype
    (all heads: the layer's output; a tensor-parallel shard's heads: its
    partial sum)."""
    dt = y.dtype
    qkv = torch.einsum("bld,dshe->bslhe", y, qkv.to(dt))
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [B, L, h, Dh]
    # bf16 logits / a float32 scalar promote to float32 in JAX
    logits = torch.einsum("blhe,bmhe->bhlm", q, k).float() / scale
    logits.masked_fill_(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(dt)
    del logits
    ctx = torch.einsum("bhlm,bmhe->blhe", probs, v)
    return torch.einsum("blhe,hed->bld", ctx, attn_out.to(dt))


def _mlp(y: torch.Tensor, mlp_in: torch.Tensor, mlp_out: torch.Tensor) -> torch.Tensor:
    """The MLP over the hidden columns that ``mlp_in`` [D, f] and ``mlp_out``
    [f, D] hold (all of them, or a tensor-parallel shard's: its partial sum)."""
    dt = y.dtype
    hmid = F.gelu(torch.einsum("bld,df->blf", y, mlp_in.to(dt)), approximate="tanh")
    return torch.einsum("blf,fd->bld", hmid, mlp_out.to(dt))


def _scale(cfg: EncoderConfig) -> float:
    # the logits' divisor: a float32 constant, as np.sqrt(dh).astype(f32)
    return float(np.float32(np.sqrt(cfg.model_dim // cfg.num_heads)))


def _embed_tokens(tokens: torch.Tensor, embed: torch.Tensor, pos: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
    # cast the table first, then gather (as the JAX code does)
    return embed.to(dt)[tokens] + pos.to(dt)[None, :tokens.shape[1]]


def _pool_project(cfg: EncoderConfig, x: torch.Tensor, mask: torch.Tensor,
                  tokens: torch.Tensor, proj: torch.Tensor, anchor_proj=None,
                  alpha=None) -> torch.Tensor:
    """Masked mean pool of the final states, float32 projection, L2
    normalisation, and under ``hybrid_anchor`` the mix with the anchor's
    normalized bag of tokens."""
    maskf = mask[..., None].float()
    denom = torch.clamp(mask.sum(dim=1, keepdim=True).float(), min=1.0)
    pooled = (x.float() * maskf).sum(dim=1) / denom
    out = pooled @ proj
    out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-6)
    if cfg.hybrid_anchor:
        # a fixed projection: no gradient reaches it (JAX's stop_gradient)
        bag = (anchor_proj.detach()[tokens] * maskf).sum(dim=1)  # tf-weighted
        bag = bag / torch.clamp(torch.linalg.vector_norm(bag, dim=-1, keepdim=True), min=1e-6)
        mix = bag + torch.abs(alpha) * out
        out = mix / torch.clamp(torch.linalg.vector_norm(mix, dim=-1, keepdim=True), min=1e-6)
    return out


class _Block(nn.Module):
    def __init__(self, cfg: EncoderConfig, device):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            self.register_parameter(name, _param(shape, device))
        self.scale = _scale(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + _attention(_rms_norm(x, self.ln1_scale), mask, self.qkv, self.attn_out,
                           self.scale)
        return x + _mlp(_rms_norm(x, self.ln2_scale), self.mlp_in, self.mlp_out)


class Encoder(nn.Module):
    """tokens [B, L] int → L2-normalized embeddings [B, out_dim] float32."""

    HEAD = "proj"  # the output head's parameter (the tree's key)

    def __init__(self, cfg: EncoderConfig, params: dict | None = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        dm = cfg.model_dim
        self.embed = _param((cfg.vocab_size, dm), device)
        self.pos = _param((cfg.max_seq, dm), device)
        self.ln_f_scale = _param((dm,), device)
        self.register_parameter(self.HEAD, _param(self.head_shape(cfg), device))
        self.layers = nn.ModuleList(_Block(cfg, device) for _ in range(cfg.num_layers))
        if cfg.hybrid_anchor:
            self.anchor_proj = _param((cfg.vocab_size, cfg.out_dim), device)
            self.alpha = _param((), device)
        if params is not None:
            self.load_tree(params)

    @staticmethod
    def head_shape(cfg: EncoderConfig) -> tuple[int, ...]:
        return (cfg.model_dim, cfg.out_dim)

    def _named(self, tree: dict):
        """(parameter, tree leaf) pairs; raises on a missing or extra key."""
        top = {"embed", "pos", "ln_f_scale", self.HEAD, "layers"}
        if self.cfg.hybrid_anchor:
            top |= {"anchor_proj", "alpha"}
        if set(tree) != top or len(tree["layers"]) != self.cfg.num_layers:
            raise ValueError(f"parameter tree keys {sorted(tree)} do not match "
                             f"the config's {sorted(top)}")
        for name in sorted(top - {"layers"}):
            yield getattr(self, name), tree[name]
        for block, layer in zip(self.layers, tree["layers"]):
            if set(layer) != set(_layer_shapes(self.cfg)):
                raise ValueError(f"layer keys {sorted(layer)} do not match")
            for name in sorted(layer):
                yield getattr(block, name), layer[name]

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        for p, leaf in self._named(tree):
            leaf = torch.as_tensor(leaf)
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(leaf.shape)} != {tuple(p.shape)}")
            p.copy_(leaf)

    def params_tree(self) -> dict:
        """The parameters as the JAX package's tree (tensors, not copies)."""
        tree = {"embed": self.embed, "pos": self.pos,
                "ln_f_scale": self.ln_f_scale, self.HEAD: getattr(self, self.HEAD),
                "layers": [{name: getattr(b, name) for name in _layer_shapes(self.cfg)}
                           for b in self.layers]}
        if self.cfg.hybrid_anchor:
            tree.update(anchor_proj=self.anchor_proj, alpha=self.alpha)
        return tree

    def trunk(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The transformer blocks and the final norm: (states [B, L, dm] in
        the config's dtype, mask [B, L] of non-PAD tokens)."""
        tokens = tokens.long()
        mask = tokens != PAD_ID  # [B, L]
        x = _embed_tokens(tokens, self.embed, self.pos, self.cfg.torch_dtype)
        for block in self.layers:
            x = block(x, mask)
        return _rms_norm(x, self.ln_f_scale), mask

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x, mask = self.trunk(tokens)
        anchor = (self.anchor_proj, self.alpha) if self.cfg.hybrid_anchor else ()
        return _pool_project(self.cfg, x, mask, tokens.long(), self.proj, *anchor)


class PartitionSpec(tuple):
    """How a parameter lies on a device grid: for each of its dimensions the
    grid axis it is split over, or None; shorter than the parameter (``P()``
    is fully replicated) leaves the remaining dimensions whole. The port's
    form of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: str | None):
        return super().__new__(cls, axes)


P = PartitionSpec


def param_specs(cfg: EncoderConfig) -> dict:
    """The Megatron-style tensor-parallel layout over a ("dp", "tp") grid,
    the JAX package's: heads (``qkv``, ``attn_out``) and MLP hidden columns
    (``mlp_in``, ``mlp_out``) split over tp, so each tp position's partial
    outputs at ``attn_out`` and ``mlp_out`` sum to the layer's; the tables'
    columns (``embed``, ``pos``, ``proj``, ``anchor_proj``) split over tp;
    the norms' scales and ``alpha`` replicated."""
    layer = {
        "ln1_scale": P(),
        "ln2_scale": P(),
        "qkv": P(None, None, "tp", None),
        "attn_out": P("tp", None, None),
        "mlp_in": P(None, "tp"),
        "mlp_out": P("tp", None),
    }
    specs = {
        "embed": P(None, "tp"),
        "pos": P(None, "tp"),
        "ln_f_scale": P(),
        "proj": P(None, "tp"),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if cfg.hybrid_anchor:
        specs["anchor_proj"] = P(None, "tp")
        specs["alpha"] = P()
    return specs


def check_tp(cfg: EncoderConfig, tp: int) -> None:
    """param_specs splits heads, MLP columns, model and output columns over
    tp: each must divide evenly (JAX's device_put refuses an uneven split)."""
    for name in ("num_heads", "mlp_dim", "model_dim", "out_dim"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"tp must divide {name}: tp={tp}, {name}={getattr(cfg, name)}")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of parameter trees of one structure, in
    :func:`flatten_params` order (dicts and lists are nodes, dict keys
    sorted; anything else, a PartitionSpec too, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _split_dims(spec: PartitionSpec, mesh) -> list[tuple[int, int, int]]:
    """(dimension, grid axis index, parts) for each split dimension."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is not None:
            a = mesh.axis_names.index(axis)
            out.append((dim, a, mesh.devices.shape[a]))
    return out


def shard_tree(tree: dict, specs: dict, mesh) -> np.ndarray:
    """A parameter tree laid out over ``mesh`` as ``specs`` says: an object
    array of ``mesh.devices``' shape whose element at grid position ``idx``
    is the tree of what JAX's ``NamedSharding(mesh, spec)`` places on
    ``mesh.devices[idx]``, each leaf a contiguous copy of its own on that
    device (a device named twice in the grid holds two copies)."""
    grid = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        def piece(leaf, spec, idx=idx):
            sl = [slice(None)] * leaf.ndim
            for dim, a, n in _split_dims(spec, mesh):
                if leaf.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of a {tuple(leaf.shape)} parameter "
                                     f"does not split into {n} parts")
                size = leaf.shape[dim] // n
                sl[dim] = slice(idx[a] * size, (idx[a] + 1) * size)
            return leaf[tuple(sl)].to(mesh.devices[idx], copy=True,
                                      memory_format=torch.contiguous_format)
        grid[idx] = tree_map(piece, tree, specs)
    return grid


def gather_tree(grid: np.ndarray, specs: dict, mesh) -> dict:
    """Inverse of :func:`shard_tree`: each leaf whole on the grid's first
    device, its split dimensions concatenated from the positions along
    their axes (every other coordinate 0)."""
    home = mesh.devices.flat[0]
    order = {idx: k for k, idx in enumerate(np.ndindex(grid.shape))}

    def whole(spec, *leaves):  # one leaf per position, in grid.flat order
        def build(idx, dims):
            if not dims:
                return leaves[order[idx]].to(home)
            (dim, a, n), rest = dims[0], dims[1:]
            return torch.cat([build(idx[:a] + (c,) + idx[a + 1:], rest) for c in range(n)],
                             dim)
        return build((0,) * grid.ndim, _split_dims(spec, mesh))

    return tree_map(whole, specs, *grid.flat)


@dataclasses.dataclass(eq=False)
class Piece:
    """One step of a dp row's forward on one grid position: ``fn(env)``
    reads the names ``reads`` from ``env`` and writes ``writes``."""
    pos: tuple
    reads: tuple
    writes: tuple
    fn: Callable[[dict], None]


def row_pieces(cfg: EncoderConfig, tower: str, i: int, tp: int) -> list[Piece]:
    """Row i's forward in tensor-parallel form as pieces, in order (the one
    definition of it: ``GridEncoder`` runs them eagerly, the segmented
    training step captures runs of them, ``models/segments.py``). Names:
    (tower, i, ...) for activations, ("p", i, j, *path) for grid position
    (i, j)'s parameters. The embedding and the first norm, then per layer
    each shard's attention on its position, the psum of the partials, the
    residual and the next norm on the row's first position, each shard's
    MLP, the psum, the residual and the next norm; then the final norm,
    the pooling and the projection."""
    def a(*s):
        return (tower, i) + s

    def w(j, *path):
        return ("p", i, j) + path

    home, dt, scale, last = (i, 0), cfg.torch_dtype, _scale(cfg), cfg.num_layers - 1
    shards = range(tp)
    pieces = []

    def embed(env):
        tokens = env[a("tok")].long()
        mask = tokens != PAD_ID
        x = _embed_tokens(tokens, torch.cat([env[w(j, "embed")] for j in shards], dim=1),
                          torch.cat([env[w(j, "pos")] for j in shards], dim=1), dt)
        env[a("tokens")], env[a("mask")], env[a("x", 0)] = tokens, mask, x
        env[a("y", 0)] = _rms_norm(x, env[w(0, "layers", 0, "ln1_scale")])

    pieces.append(Piece(home, (a("tok"), *(w(j, t) for t in ("embed", "pos") for j in shards),
                               w(0, "layers", 0, "ln1_scale")),
                        (a("tokens"), a("mask"), a("x", 0), a("y", 0)), embed))

    def attention(env, l, j):
        env[a("pa", l, j)] = _attention(env[a("y", 2 * l)], env[a("mask")],
                                        env[w(j, "layers", l, "qkv")],
                                        env[w(j, "layers", l, "attn_out")], scale)

    def mlp(env, l, j):
        env[a("pm", l, j)] = _mlp(env[a("y", 2 * l + 1)], env[w(j, "layers", l, "mlp_in")],
                                  env[w(j, "layers", l, "mlp_out")])

    def residual(env, s, part, l, norm):  # the psum over tp, the residual, a norm
        total = env[a(part, l, 0)]
        for j in shards[1:]:
            total = total + env[a(part, l, j)]
        x = env[a("x", s - 1)] + total
        env[a("x", s)] = x
        if norm is not None:
            env[a("y", s)] = _rms_norm(x, env[norm])

    def head(env):
        x = _rms_norm(env[a("x", 2 * last + 2)], env[w(0, "ln_f_scale")])
        anchor = ((torch.cat([env[w(j, "anchor_proj")] for j in shards], dim=1),
                   env[w(0, "alpha")]) if cfg.hybrid_anchor else ())
        env[a("out")] = _pool_project(cfg, x, env[a("mask")], env[a("tokens")],
                                      torch.cat([env[w(j, "proj")] for j in shards], dim=1),
                                      *anchor)

    for l in range(cfg.num_layers):
        for part, s, fn, params in (("pa", 2 * l + 1, attention, ("qkv", "attn_out")),
                                    ("pm", 2 * l + 2, mlp, ("mlp_in", "mlp_out"))):
            for j in shards:
                reads = (a("y", s - 1), *((a("mask"),) if part == "pa" else ()),
                         *(w(j, "layers", l, p) for p in params))
                pieces.append(Piece((i, j), reads, (a(part, l, j),),
                                    functools.partial(fn, l=l, j=j)))
            if part == "pa":
                norm = w(0, "layers", l, "ln2_scale")
            else:
                norm = w(0, "layers", l + 1, "ln1_scale") if l < last else None
            pieces.append(Piece(home, (a("x", s - 1), *(a(part, l, j) for j in shards),
                                       *((norm,) if norm else ())),
                                (a("x", s),) + ((a("y", s),) if norm else ()),
                                functools.partial(residual, s=s, part=part, l=l, norm=norm)))
    reads = [a("x", 2 * last + 2), w(0, "ln_f_scale"), a("mask"), a("tokens"),
             *(w(j, "proj") for j in shards)]
    if cfg.hybrid_anchor:
        reads += [*(w(j, "anchor_proj") for j in shards), w(0, "alpha")]
    pieces.append(Piece(home, tuple(reads), (a("out"),), head))
    return pieces


class _Broadcast(torch.autograd.Function):
    """An activation copied at once to every other device that reads it, so
    that its gradients come back into one node and are summed in one order,
    from the last reader down, on the activation's device: the order of
    eager autograd on one device (``((g[tp-1] + g[tp-2]) + ...)``, then the
    source's own use) and of the segmented route. Separate copies would
    have autograd add each gradient as its device's thread delivers it:
    no fixed order past two terms."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.home = x.device
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in reversed(grads):
            if g is not None:
                g = g.to(ctx.home)
                total = g if total is None else total + g
        return (total, *(None for _ in grads))


class _RowEnv(dict):
    """The names of one eager run of :func:`row_pieces`: a read from a piece
    on another device than the tensor's copies it there (once a device,
    differentiable: autograd carries each shard its gradient); a parameter
    name reads its shard's leaf.

    Between devices an activation goes to all of its readers at once
    (:class:`_Broadcast`; ``readers``: name -> the devices of the pieces
    that read it, else the reading one), and a parameter goes through a
    view of it made on its own device: its accumulator then takes its
    gradient from a node on its own device and stream. Copied straight
    from the leaf, the gradient would reach the accumulator from the
    reading device's stream, which torch reports as a stream mismatch of
    the AccumulateGrad node."""

    def __init__(self, shards: list[dict], devices: list[torch.device], readers: dict):
        super().__init__()
        self.shards, self.at, self.readers, self.copies = shards, devices[0], readers, {}

    def __getitem__(self, name):
        if (name, self.at) in self.copies:
            return self.copies[(name, self.at)]
        if name[0] == "p":
            value = self.shards[name[2]]
            for k in name[3:]:
                value = value[k]
        else:
            value = super().__getitem__(name)
        if value.device == self.at:
            return value
        if name[0] == "p":
            self.copies[(name, self.at)] = value.view_as(value).to(self.at)
        elif value.requires_grad:
            to = [d for d in self.readers.get(name, [self.at]) if d != value.device]
            self.copies.update(((name, d), c) for d, c in zip(to, _Broadcast.apply(value, *to)))
        else:
            self.copies[(name, self.at)] = value.to(self.at)
        return self.copies[(name, self.at)]


class GridEncoder:
    """One dp row of the encoder in Megatron tensor-parallel form: ``Encoder``'s
    function over the row's tp shard trees (``shard_tree`` under
    ``param_specs``), ``devices[j]`` holding shard j.

    Each shard runs its heads through ``qkv`` and ``attn_out`` and its hidden
    columns through ``mlp_in`` and ``mlp_out`` on its own device; the partial
    outputs are summed on the row's first device (JAX's psum over tp, in the
    activations' dtype), where the residual stream, the RMS norms, the
    pooling, the output norm and the anchor mix run once, with shard 0's
    copy of the replicated parameters, so that each gets one gradient. The
    column-split tables are concatenated there where they are used. All of
    it is differentiable, so the backward carries each shard its gradient:
    autograd sums the activations' gradients copied back from the shards.
    The forward is :func:`row_pieces`, run in order, each piece on its
    shard's device."""

    def __init__(self, cfg: EncoderConfig, shards: list[dict], devices: list[torch.device]):
        self.cfg, self.shards, self.devices = cfg, shards, devices

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] on the row's first device → [B, out_dim] float32 there."""
        pieces = row_pieces(self.cfg, "x", 0, len(self.shards))
        readers: dict = {}  # activation -> the devices that read it, in order
        for piece in pieces:
            for name in piece.reads:
                if name[0] != "p":
                    readers.setdefault(name, {})[self.devices[piece.pos[1]]] = None
        env = _RowEnv(self.shards, self.devices, {n: list(d) for n, d in readers.items()})
        env[("x", 0, "tok")] = tokens
        for piece in pieces:
            env.at = self.devices[piece.pos[1]]
            piece.fn(env)
        return env[("x", 0, "out")]


def flops_per_token(cfg: EncoderConfig, length: int) -> int:
    """Matmul and attention FLOPs of one token at sequence length ``length``
    (2 per multiply-add; elementwise work not counted)."""
    dm, f = cfg.model_dim, cfg.mlp_dim
    per_layer = 2 * dm * 3 * dm + 2 * dm * dm + 2 * 2 * dm * f + 2 * 2 * length * dm
    return cfg.num_layers * per_layer + 2 * dm * cfg.out_dim


# Batch buckets (the JAX package's ladder, MRAG_ENCODER_BATCH_BUCKETS): each
# batch is padded with PAD rows up to the smallest bucket that holds it (past
# the top, to a multiple of the top), and the padded rows are dropped from the
# output. On a card each (bucket, sequence bucket) is one captured CUDA graph,
# as each is one XLA program in the JAX package; the CPU and eager runs pad
# alike, so all three compute the same shapes. An all-PAD row is finite: its
# mask is all false, its softmax uniform, its pooled denominator 1.
_BATCH_BUCKETS = tuple(
    int(x) for x in os.getenv("MRAG_ENCODER_BATCH_BUCKETS", "1,8,32,128").split(","))


def _bucket(n: int) -> int:
    """The batch bucket of n rows (``mobius_rag_tpu/models/encoder.py``'s
    ``EncoderModel._bucket``)."""
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    top = _BATCH_BUCKETS[-1]
    return -(-n // top) * top


def pad_rows(tokens: np.ndarray, rows: int) -> np.ndarray:
    """A [B, L] token block as int32, with PAD rows appended up to `rows`."""
    tokens = np.asarray(tokens, np.int32)
    if rows == len(tokens):
        return np.ascontiguousarray(tokens)
    out = np.full((rows, tokens.shape[1]), PAD_ID, np.int32)
    out[:len(tokens)] = tokens
    return out


# Sequence buckets: each batch trims to the smallest bucket covering its
# longest text; PAD columns are masked out of attention and pooling, so
# trimming them is exact and cuts the FLOPs of short texts.
# MRAG_ENCODER_SEQ_BUCKETS=0 disables (single full-length forward).
_SEQ_BUCKETS = tuple(
    int(x) for x in os.getenv("MRAG_ENCODER_SEQ_BUCKETS",
                              "64,128,256").split(",") if int(x or 0) > 0)


def seq_bucket(tokens: np.ndarray) -> np.ndarray:
    """Trim a [B, max_seq] token block to the smallest seq bucket covering
    its longest text (exact: see _SEQ_BUCKETS)."""
    if not _SEQ_BUCKETS:
        return tokens
    longest = int((tokens != PAD_ID).sum(axis=1).max()) if tokens.size else 0
    for sb in _SEQ_BUCKETS:
        if longest <= sb < tokens.shape[1]:
            return tokens[:, :sb]
    return tokens


class CapturedForward:
    """The forward of ``self.module`` (an :class:`Encoder`) over padded
    token blocks, eager or replayed from captured CUDA graphs: the port of
    ``encode_jit`` and ``score_pairs_jit``, jitted once per input shape.

    ``graphs``: None (the default) captures on a card and runs eagerly on
    the CPU; False runs eagerly on a card too; True on the CPU raises.
    Captured, one :class:`~mobius_rag_tpu_torch.query.compiled.CapturedPrograms`
    per model keeps one graph per (rows, length) of the padded block, over
    the module's parameters: an in-place ``load_tree`` (or a training
    step) keeps the graphs, a new module drops them. Every captured call
    holds ``compiled.LOCK`` across its upload, its replay (or its eager
    first run and capture: ``torch.cuda.graph`` synchronizes the device)
    and the enqueue of a copy of its real rows, since the next replay of
    any graph of the model rewrites the static output; the callers (the
    micro-batcher's thread, the ingest worker, the retag thread, the
    request handlers) may be on any thread. A failed capture or replay
    raises; nothing falls back to the eager forward."""

    module: "Encoder"
    device: torch.device

    def _init_graphs(self, graphs: bool | None) -> None:
        self._programs: CapturedPrograms | None = None
        self.graphs = self.device.type == "cuda" if graphs is None else graphs

    @property
    def graphs(self) -> bool:
        """Whether the forward replays captured CUDA graphs (see the class
        docstring); settable, so one model can run both ways in turns."""
        return self._graphs

    @graphs.setter
    def graphs(self, on: bool) -> None:
        if on and self._programs is None:
            self._programs = CapturedPrograms(self.device)  # raises off a card
        self._graphs = bool(on)

    def _program(self, static: dict) -> torch.Tensor:
        return self.module(static["tokens"])

    def _run(self, block: np.ndarray) -> torch.Tensor:
        """The module's output for `block`, a padded int32 [rows, L] token
        block, on the device: the eager output, or the captured program's
        static output (the caller holds ``compiled.LOCK`` and copies it
        before the next replay of any of this forward's graphs)."""
        host = {"tokens": block}
        if not self.graphs:
            return self._program(to_device(host, self.device))
        return self._programs.run(block.shape, list(self.module.parameters()), host,
                                  self._program)

    @torch.inference_mode()
    def _forward(self, block: np.ndarray, n: int) -> torch.Tensor:
        """The module's output for the first `n` rows of `block` on the
        device: a copy of the captured program's static output, or the
        eager output's rows."""
        if not self.graphs:
            return self._run(block)[:n]
        with LOCK:
            return self._run(block)[:n].clone()


class EncoderModel(CapturedForward):
    """Host handle bundling config, parameters on the device and the
    tokenizer — the ``embed_fn`` plugged into SearchEngine and the ingest
    pipeline: ``model(texts) -> np.ndarray [N, out_dim] float32``. On a
    card the forward replays one CUDA graph per (batch bucket, sequence
    bucket) (:class:`CapturedForward`; ``graphs=False`` runs it eagerly)."""

    def __init__(self, cfg: EncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0, device="cuda", graphs: bool | None = None):
        self.cfg = cfg or EncoderConfig.from_env()
        self.device = torch.device(device)
        if params is None:
            params = init_params(
                self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        # the parameters go to the device once, here
        self.module = Encoder(self.cfg, params, device=self.device).eval()
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)
        self._init_graphs(graphs)

    def encode_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """One forward of a [B, L] token block (no trimming), padded to its
        batch bucket → [B, out_dim] float32 on the device, the padded rows
        dropped. The upload does not wait for the device: the tokens go up
        from page-locked memory."""
        return self._forward(pad_rows(tokens, _bucket(len(tokens))), len(tokens))

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        # every chunk is enqueued before the one read back, so the host
        # tokenizes chunk i+1 while the device encodes chunk i
        top = _BATCH_BUCKETS[-1]
        outs = [self.encode_tokens(seq_bucket(self.tokenizer.encode_batch(texts[off:off + top])))
                for off in range(0, len(texts), top)]
        return (torch.cat(outs) if len(outs) > 1 else outs[0]).cpu().numpy()


class _Replica(CapturedForward):
    """One device's encoder of a :class:`MeshEncoderModel`, with its own
    captured forward (one ``CapturedPrograms``: a pool and a capture stream
    belong to one device)."""

    def __init__(self, module: "Encoder", device: torch.device, graphs: bool | None):
        self.module, self.device = module, device
        self._init_graphs(graphs)


class MeshEncoderModel:
    """Data-parallel encode over a device grid (``parallel.mesh.Mesh``): the
    port of the JAX ``MeshEncoderModel``, ``encode_jit`` as one SPMD program
    with the batch split over the grid's first axis. One process pads each
    token batch to the JAX model's bucket (:meth:`_bucket`: the smallest
    batch bucket that dp divides, else a multiple of max(top bucket, dp)),
    gives each data position a contiguous part of ``bucket / dp`` rows
    (rounded up where dp does not divide it) and runs the same forward on
    each, where the reference ran N embedding workers over a row-locked
    queue. The parameters go once to each distinct device of that axis (a
    device listed twice holds one replica, which runs both parts);
    batch-parallel encode needs no communication, so each row is
    EncoderModel's function of the same parameters. A drop-in
    ``embed_fn``, like EncoderModel.

    ``graphs``, as on EncoderModel: None (the default) captures on a card,
    False runs eagerly, True on the CPU raises. Captured, each distinct
    device keeps its own forward (:class:`CapturedForward`: one graph per
    (part rows, length)); a call holds ``compiled.LOCK`` across every
    part's upload, replay (or eager first run and capture) and the copy of
    its output to the first device, made right behind its replay (the
    next part on that device replays the same graph), on the device's
    stream behind an event (``compiled.join``)."""

    def __init__(self, mesh, cfg: EncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0, graphs: bool | None = None):
        self.cfg = cfg or EncoderConfig.from_env()
        self.mesh = mesh
        grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
        self.devices = [torch.device(d) for d in grid[:, 0]]  # one per data position
        self.dp = len(self.devices)
        if params is None:
            params = init_params(
                self.cfg, torch.Generator(device=self.devices[0]).manual_seed(seed))
        replicas: dict[torch.device, _Replica] = {}
        self.replicas = [replicas.setdefault(
            d, _Replica(Encoder(self.cfg, params, device=d).eval(), d, graphs))
            for d in self.devices]
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)

    @property
    def modules(self) -> list["Encoder"]:
        """Each data position's module (positions on one device share it)."""
        return [r.module for r in self.replicas]

    @property
    def graphs(self) -> bool:
        """Whether the parts replay captured CUDA graphs; settable."""
        return self.replicas[0].graphs

    @graphs.setter
    def graphs(self, on: bool) -> None:
        for r in dict.fromkeys(self.replicas):
            r.graphs = on

    def _bucket(self, n: int) -> int:
        """The rows a batch of n texts is padded to (the JAX
        ``MeshEncoderModel._bucket``)."""
        for b in _BATCH_BUCKETS:
            if n <= b and b % self.dp == 0:
                return b
        step = max(_BATCH_BUCKETS[-1], self.dp)
        return -(-n // step) * step

    @torch.inference_mode()
    def encode_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """One [B, L] token block padded to its bucket and split over the
        data positions → [B, out_dim] float32 on the first device, the
        padded rows dropped; every part is enqueued before any result is
        used."""
        rows = -(-self._bucket(len(tokens)) // self.dp)
        block = pad_rows(tokens, rows * self.dp)
        home = self.devices[0]
        outs = []
        with LOCK if self.graphs else contextlib.nullcontext():
            for i, rep in enumerate(self.replicas):
                part = rep._run(block[i * rows:(i + 1) * rows])
                out = torch.empty(part.shape, dtype=part.dtype, device=home)
                join(out, part)
                outs.append(out)
        return torch.cat(outs)[:len(tokens)]

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        step = max(_BATCH_BUCKETS[-1], self.dp)
        outs = [self.encode_tokens(seq_bucket(self.tokenizer.encode_batch(texts[off:off + step])))
                for off in range(0, len(texts), step)]
        return torch.cat(outs).cpu().numpy()
