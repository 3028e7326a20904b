"""Cross-encoder reranker on the card (the port of
``mobius_rag_tpu.models.cross_encoder``): serving and pairwise training.

A transformer reads ``[CLS] query [SEP] chunk`` jointly and scores
relevance from the CLS state: the encoder's blocks and parameter layout
(``models/encoder.py``) with a float32 scalar ``score_head [dm, 1]`` in
place of the projection. Plugged into ``SearchEngine.cross_encoder`` it
rescores each result's hits (``MRAG_CROSS_ENCODER_CKPT`` attaches one in
``AppContext.build``).

The numerics are the encoder's (float32 logits, tanh GELU, float32 RMS
norms). The JAX package pads each pair batch to 8 or a multiple of 32 to
bound XLA compiles (``score_pairs_jit``); the port pads it too, since on a
card each (pair bucket, sequence bucket) is one captured CUDA graph, and
drops the padded rows. Its step past 8 pairs is ``PAIR_STEP`` (8, where
the reference's is 32): the engine scores one query's k hits a call (10
by default), which multiples of 32 would pad to 32 rows. The pairs are
trimmed to the encoder's sequence buckets: PAD columns are masked, so
trimming them is exact.

Training (``make_cross_train_step``, ``train_cross_encoder_on_corpus``)
ranks each ICT pair above the same query with the next pair's document,
by a margin loss. The JAX optimizer is ``optax.adamw(1e-4)`` with optax's
default decay of 1e-4 and no clip; ``torch.optim.AdamW`` is given that
decay (its own default is 0.01).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mobius_rag_tpu_torch.models.encoder import (CapturedForward, Encoder, EncoderConfig,
                                                 init_params, pad_rows, seq_bucket)
from mobius_rag_tpu_torch.models.tokenizer import CLS_ID, PAD_ID, SEP_ID, HashTokenizer

# Pair buckets past 8 pairs: multiples of PAIR_STEP. The reference pads to
# multiples of 32; the port to multiples of 8, which pads the engine's 10
# hits a query to 16 rows, not 32: 8.09-9.37 ms a query against 13.77-14.63
# captured on an H100 (chip_smoke.py phase 7d). Padded rows are dropped,
# so every ladder gives the same logits.
PAIR_STEP = 8


@dataclasses.dataclass(frozen=True)
class CrossEncoderConfig:
    base: EncoderConfig

    @classmethod
    def tiny(cls) -> "CrossEncoderConfig":
        return cls(base=EncoderConfig.tiny())


def init_cross_params(cfg: CrossEncoderConfig, generator: torch.Generator) -> dict:
    """A fresh parameter tree on ``generator.device``: the encoder's,
    without ``proj``, and ``score_head`` N(0, 0.02) [dm, 1] (the JAX
    package's distributions; its values differ, the two RNGs do)."""
    params = init_params(cfg.base, generator)
    del params["proj"]  # no embedding projection: a scalar head instead
    params["score_head"] = 0.02 * torch.randn((cfg.base.model_dim, 1), generator=generator,
                                              device=generator.device)
    return params


class CrossEncoder(Encoder):
    """``score_pairs``: tokens [B, L] ([CLS] q [SEP] d, padded) → relevance
    logits [B] float32, the CLS state after the final norm widened to
    float32 times ``score_head``."""

    HEAD = "score_head"

    def __init__(self, cfg: CrossEncoderConfig, params: dict | None = None, device="cuda"):
        super().__init__(cfg.base, params, device)

    @staticmethod
    def head_shape(cfg: EncoderConfig) -> tuple[int, ...]:
        return (cfg.model_dim, 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x, _ = self.trunk(tokens)
        return (x[:, 0].float() @ self.score_head)[:, 0]


def encode_pair(tokenizer: HashTokenizer, query: str, doc: str) -> np.ndarray:
    """[CLS] query-tokens [SEP] doc-tokens, the query kept to a third of
    max_len and the doc truncated: [max_len] int32."""
    q_ids = tokenizer.encode(query)
    d_ids = tokenizer.encode(doc)
    q_body = q_ids[(q_ids != PAD_ID) & (q_ids != CLS_ID)]
    d_body = d_ids[(d_ids != PAD_ID) & (d_ids != CLS_ID)]
    max_len = tokenizer.max_len
    q_keep = q_body[: max(1, max_len // 3)]
    out = np.full(max_len, PAD_ID, np.int32)
    out[0] = CLS_ID
    pos = 1
    out[pos:pos + len(q_keep)] = q_keep
    pos += len(q_keep)
    if pos < max_len:
        out[pos] = SEP_ID
        pos += 1
    d_keep = d_body[: max_len - pos]
    out[pos:pos + len(d_keep)] = d_keep
    return out


def pair_bucket(b: int, step: int = 32) -> int:
    """The rows a batch of b pairs is padded to: 8 up to 8 pairs, else the
    next multiple of `step`. At step 32 this is the JAX package's rule
    (``mobius_rag_tpu/models/cross_encoder.py:105``)."""
    return 8 if b <= 8 else -(-b // step) * step


class CrossEncoderModel(CapturedForward):
    """Host handle: ``model(query, texts) -> np.ndarray [len(texts)]``
    relevance logits, the parameters on the device once. Each batch of
    pairs is padded with PAD rows to :func:`pair_bucket` at ``pair_step``
    and trimmed to the encoder's sequence buckets; the padded rows are
    dropped. On a card the forward replays one CUDA graph per (pair
    bucket, sequence bucket) (``models.encoder.CapturedForward``;
    ``graphs=False`` runs it eagerly)."""

    pair_step = PAIR_STEP

    def __init__(self, cfg: CrossEncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0, device="cuda", graphs: bool | None = None):
        self.cfg = cfg or CrossEncoderConfig(EncoderConfig.from_env())
        self.device = torch.device(device)
        if params is None:
            params = init_cross_params(
                self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.module = CrossEncoder(self.cfg, params, device=self.device).eval()
        self.tokenizer = HashTokenizer(self.cfg.base.vocab_size, self.cfg.base.max_seq)
        self._init_graphs(graphs)

    def __call__(self, query: str, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0,), np.float32)
        pairs = seq_bucket(np.stack([encode_pair(self.tokenizer, query, t) for t in texts]))
        block = pad_rows(pairs, pair_bucket(len(texts), self.pair_step))
        return self._forward(block, len(texts)).cpu().numpy()


CROSS_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def make_cross_train_step(cfg: CrossEncoderConfig, learning_rate: float = 1e-4, *,
                          device="cuda"):
    """Pairwise training: positives are ICT (query, source paragraph)
    pairs, negatives the batch shifted by one; margin ranking loss
    ``mean(max(0, 1 - s_pos + s_neg))``. Returns (step, opt_init):
    ``opt_init(module) -> optimizer`` and ``step(module, opt, pos, neg) ->
    (module, opt, {"loss", "accuracy"})`` over [B, max_len] numpy token
    blocks, the metrics left on the device."""
    from mobius_rag_tpu_torch.models.train import fill_missing_grads, to_device

    device = torch.device(device)

    def opt_init(module: CrossEncoder) -> torch.optim.AdamW:
        return torch.optim.AdamW(module.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=CROSS_WEIGHT_DECAY)

    def step(module: CrossEncoder, opt, pos_tokens: np.ndarray, neg_tokens: np.ndarray):
        opt.zero_grad(set_to_none=True)
        s_pos = module(to_device(pos_tokens, device))
        s_neg = module(to_device(neg_tokens, device))
        loss = torch.clamp(1.0 - s_pos + s_neg, min=0.0).mean()
        loss.backward()
        fill_missing_grads(module)
        opt.step()
        return module, opt, {"loss": loss.detach(),
                             "accuracy": (s_pos > s_neg).float().mean()}

    return step, opt_init


def cross_pairs(tokenizer: HashTokenizer, pairs: list, idx: np.ndarray) -> tuple:
    """(positive, negative) token blocks for the pairs ``idx``: each query
    with its own document, and with the next pair's."""
    pos = np.stack([encode_pair(tokenizer, pairs[i][0], pairs[i][1]) for i in idx])
    neg = np.stack([encode_pair(tokenizer, pairs[i][0], pairs[idx[(j + 1) % len(idx)]][1])
                    for j, i in enumerate(idx)])
    return pos, neg


def train_cross_encoder_on_corpus(store, *, cfg: CrossEncoderConfig | None = None,
                                  steps: int = 50, batch: int = 16, seed: int = 0,
                                  device="cuda"):
    """Mine ICT pairs → pairwise margin training. Returns (parameter tree
    on ``device``, history). The pairs drawn are the JAX package's for the
    same store and seed; the initial parameters come from
    ``torch.Generator(device).manual_seed(seed)``."""
    from mobius_rag_tpu_torch.models.data import mine_ict_pairs
    from mobius_rag_tpu_torch.models.train import detached_tree

    cfg = cfg or CrossEncoderConfig.tiny()
    device = torch.device(device)
    tokenizer = HashTokenizer(cfg.base.vocab_size, cfg.base.max_seq)
    pairs = mine_ict_pairs(store, max_pairs=steps * batch * 2, seed=seed)
    if len(pairs) < batch:
        raise ValueError(f"corpus too small ({len(pairs)} pairs)")
    step, opt_init = make_cross_train_step(cfg, device=device)
    params = init_cross_params(cfg, torch.Generator(device=device).manual_seed(seed))
    module = CrossEncoder(cfg, params, device=device).requires_grad_(True)
    opt = opt_init(module)
    rng = np.random.default_rng(seed)
    history = []
    for s in range(steps):
        idx = rng.choice(len(pairs), batch, replace=False)
        module, opt, m = step(module, opt, *cross_pairs(tokenizer, pairs, idx))
        if (s + 1) % 10 == 0 or s + 1 == steps:
            history.append({"step": s + 1, **{k: float(v) for k, v in m.items()}})
    return detached_tree(module.params_tree()), history
