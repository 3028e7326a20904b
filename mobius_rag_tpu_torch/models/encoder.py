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
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.models.tokenizer import PAD_ID, HashTokenizer


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


class _Block(nn.Module):
    def __init__(self, cfg: EncoderConfig, device):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            self.register_parameter(name, _param(shape, device))
        # the logits' divisor: a float32 constant, as np.sqrt(dh).astype(f32)
        self.scale = float(np.float32(np.sqrt(cfg.model_dim // cfg.num_heads)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = _rms_norm(x, self.ln1_scale)
        qkv = torch.einsum("bld,dshe->bslhe", y, self.qkv.to(dt))
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [B, L, H, Dh]
        # bf16 logits / a float32 scalar promote to float32 in JAX
        logits = torch.einsum("blhe,bmhe->bhlm", q, k).float() / self.scale
        logits.masked_fill_(~mask[:, None, None, :], -1e30)
        probs = torch.softmax(logits, dim=-1).to(dt)
        del logits
        ctx = torch.einsum("bhlm,bmhe->blhe", probs, v)
        x = x + torch.einsum("blhe,hed->bld", ctx, self.attn_out.to(dt))

        y = _rms_norm(x, self.ln2_scale)
        hmid = F.gelu(torch.einsum("bld,df->blf", y, self.mlp_in.to(dt)),
                      approximate="tanh")
        return x + torch.einsum("blf,fd->bld", hmid, self.mlp_out.to(dt))


class Encoder(nn.Module):
    """tokens [B, L] int → L2-normalized embeddings [B, out_dim] float32."""

    HEAD = "proj"  # the output head's parameter (the tree's key)

    def __init__(self, cfg: EncoderConfig, params: dict | None = None,
                 device="cpu"):
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
        dt = self.cfg.torch_dtype
        tokens = tokens.long()
        length = tokens.shape[1]
        mask = tokens != PAD_ID  # [B, L]
        # cast the table first, then gather (as the JAX code does)
        x = self.embed.to(dt)[tokens] + self.pos.to(dt)[None, :length]
        for block in self.layers:
            x = block(x, mask)
        return _rms_norm(x, self.ln_f_scale), mask

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x, mask = self.trunk(tokens)
        tokens = tokens.long()
        maskf = mask[..., None].float()
        denom = torch.clamp(mask.sum(dim=1, keepdim=True).float(), min=1.0)
        pooled = (x.float() * maskf).sum(dim=1) / denom
        out = pooled @ self.proj
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True),
                                min=1e-6)
        if cfg.hybrid_anchor:
            # a fixed projection: no gradient reaches it (JAX's stop_gradient)
            bag = (self.anchor_proj.detach()[tokens] * maskf).sum(dim=1)  # tf-weighted
            bag = bag / torch.clamp(torch.linalg.vector_norm(bag, dim=-1, keepdim=True),
                                    min=1e-6)
            mix = bag + torch.abs(self.alpha) * out
            out = mix / torch.clamp(torch.linalg.vector_norm(mix, dim=-1, keepdim=True),
                                    min=1e-6)
        return out


def flops_per_token(cfg: EncoderConfig, length: int) -> int:
    """Matmul and attention FLOPs of one token at sequence length ``length``
    (2 per multiply-add; elementwise work not counted)."""
    dm, f = cfg.model_dim, cfg.mlp_dim
    per_layer = 2 * dm * 3 * dm + 2 * dm * dm + 2 * 2 * dm * f + 2 * 2 * length * dm
    return cfg.num_layers * per_layer + 2 * dm * cfg.out_dim


# Batch chunking. The JAX package pads each batch up to a bucket of this
# ladder to bound XLA compiles; eager PyTorch compiles nothing, so the port
# pads nothing and keeps only the ladder's top as the largest batch one
# forward takes (MRAG_ENCODER_BATCH_BUCKETS, same variable).
_MAX_BATCH = int(os.getenv("MRAG_ENCODER_BATCH_BUCKETS", "1,8,32,128").split(",")[-1])

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


class EncoderModel:
    """Host handle bundling config, parameters on the device and the
    tokenizer — the ``embed_fn`` plugged into SearchEngine and the ingest
    pipeline: ``model(texts) -> np.ndarray [N, out_dim] float32``."""

    def __init__(self, cfg: EncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg or EncoderConfig.from_env()
        self.device = torch.device(device)
        if params is None:
            params = init_params(
                self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        # the parameters go to the device once, here
        self.module = Encoder(self.cfg, params, device=self.device).eval()
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)

    @torch.inference_mode()
    def encode_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """One forward of a [B, L] token block (no trimming) → [B, out_dim]
        float32 on the device. The upload does not wait for the device: the
        tokens go up from page-locked memory."""
        host = torch.from_numpy(np.ascontiguousarray(tokens))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return self.module(host.to(self.device, non_blocking=True))

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        # every batch is enqueued before the one read back, so the host
        # tokenizes batch i+1 while the device encodes batch i
        outs = [self.encode_tokens(seq_bucket(
                    self.tokenizer.encode_batch(texts[off:off + _MAX_BATCH])))
                for off in range(0, len(texts), _MAX_BATCH)]
        return torch.cat(outs).cpu().numpy()


class MeshEncoderModel:
    """Data-parallel encode over a device grid (``parallel.mesh.Mesh``): one
    process splits each token batch contiguously over the grid's first
    axis and runs the same forward on each part, where the reference ran N
    embedding workers over a row-locked queue. The parameters go once to
    each distinct device of that axis (a device listed twice holds one
    replica); batch-parallel encode needs no communication, so each row
    equals EncoderModel's for the same parameters. A drop-in ``embed_fn``,
    like EncoderModel."""

    def __init__(self, mesh, cfg: EncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0):
        self.cfg = cfg or EncoderConfig.from_env()
        self.mesh = mesh
        grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
        self.devices = [torch.device(d) for d in grid[:, 0]]  # one per data position
        if params is None:
            params = init_params(
                self.cfg, torch.Generator(device=self.devices[0]).manual_seed(seed))
        replicas: dict[torch.device, Encoder] = {}
        self.modules = [replicas.setdefault(d, Encoder(self.cfg, params, device=d).eval())
                        for d in self.devices]
        self.tokenizer = HashTokenizer(self.cfg.vocab_size, self.cfg.max_seq)

    @torch.inference_mode()
    def encode_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """One [B, L] token block split over the devices (contiguous parts
        of ceil(B / dp) rows) → [B, out_dim] float32 on the first device;
        every part is enqueued before any result is used."""
        n = len(self.devices)
        step = -(-len(tokens) // n)
        outs = []
        for i, (dev, module) in enumerate(zip(self.devices, self.modules)):
            part = tokens[i * step:(i + 1) * step]
            if not len(part):
                continue
            host = torch.from_numpy(np.ascontiguousarray(part))
            if dev.type == "cuda":
                host = host.pin_memory()
            outs.append(module(host.to(dev, non_blocking=True)).to(self.devices[0],
                                                                   non_blocking=True))
        return torch.cat(outs)

    def __call__(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.out_dim), np.float32)
        step = max(_MAX_BATCH, len(self.devices))
        outs = [self.encode_tokens(seq_bucket(self.tokenizer.encode_batch(texts[off:off + step])))
                for off in range(0, len(texts), step)]
        return torch.cat(outs).cpu().numpy()
