"""Cross-encoder reranker on the card, its serving half (the port of
``mobius_rag_tpu.models.cross_encoder``; training waits for the training
slice).

A transformer reads ``[CLS] query [SEP] chunk`` jointly and scores
relevance from the CLS state: the encoder's blocks and parameter layout
(``models/encoder.py``) with a float32 scalar ``score_head [dm, 1]`` in
place of the projection. Plugged into ``SearchEngine.cross_encoder`` it
rescores each result's hits (``MRAG_CROSS_ENCODER_CKPT`` attaches one in
``AppContext.build``).

The numerics are the encoder's (float32 logits, tanh GELU, float32 RMS
norms). The JAX package pads each pair batch to 8 or a multiple of 32 to
bound XLA compiles; eager PyTorch compiles nothing, so the port scores the
batch as it is (the padded rows are discarded there, so the result is the
same). The pairs are trimmed to the encoder's sequence buckets: PAD
columns are masked, so trimming them is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mobius_rag_tpu_torch.models.encoder import (Encoder, EncoderConfig, init_params,
                                                 seq_bucket)
from mobius_rag_tpu_torch.models.tokenizer import CLS_ID, PAD_ID, SEP_ID, HashTokenizer


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

    def __init__(self, cfg: CrossEncoderConfig, params: dict | None = None, device="cpu"):
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


class CrossEncoderModel:
    """Host handle: ``model(query, texts) -> np.ndarray [len(texts)]``
    relevance logits, the parameters on the device once."""

    def __init__(self, cfg: CrossEncoderConfig | None = None, params: dict | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg or CrossEncoderConfig(EncoderConfig.from_env())
        self.device = torch.device(device)
        if params is None:
            params = init_cross_params(
                self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.module = CrossEncoder(self.cfg, params, device=self.device).eval()
        self.tokenizer = HashTokenizer(self.cfg.base.vocab_size, self.cfg.base.max_seq)

    @torch.inference_mode()
    def __call__(self, query: str, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0,), np.float32)
        pairs = seq_bucket(np.stack([encode_pair(self.tokenizer, query, t) for t in texts]))
        host = torch.from_numpy(np.ascontiguousarray(pairs))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return self.module(host.to(self.device, non_blocking=True)).cpu().numpy()
