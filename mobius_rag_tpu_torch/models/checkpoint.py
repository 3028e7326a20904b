"""Encoder parameter checkpoints in the JAX package's npz layout (the port
of ``mobius_rag_tpu.models.checkpoint``).

A checkpoint directory holds ``encoder.json`` ({"backend", "kind",
"config"}) and, for the npz backend, ``params.npz`` with the leaves as
``p0..pN`` in ``jax.tree_util`` flatten order (dict keys sorted, the
``layers`` list in order). The port reads and writes that layout, so a
checkpoint passes between the two packages either way, for the encoder
(``kind="bi"``) and the cross-encoder (``kind="cross"``: leaves ``embed,
layers, ln_f_scale, pos, score_head``; the config saved is its base
encoder config). It writes npz only; an orbax checkpoint (the JAX
package's first choice) raises.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mobius_rag_tpu_torch.models.encoder import (EncoderConfig, flatten_params,
                                                 unflatten_params)


def save_encoder(path: str, params: dict, cfg: EncoderConfig, *,
                 kind: str = "bi") -> None:
    """Write ``params`` (a parameter tree of tensors or arrays, e.g.
    ``Encoder.params_tree()``) and ``cfg`` (the cross-encoder's base
    config for ``kind="cross"``) as an npz checkpoint."""
    if kind not in ("bi", "cross"):
        raise ValueError(f"checkpoint kind {kind!r} must be 'bi' or 'cross'")
    os.makedirs(path, exist_ok=True)
    leaves = [torch.as_tensor(x).detach().float().cpu().numpy()
              for x in flatten_params(params)]
    np.savez_compressed(os.path.join(path, "params.npz"),
                        **{f"p{i}": x for i, x in enumerate(leaves)})
    with open(os.path.join(path, "encoder.json"), "w") as f:
        json.dump({"backend": "npz", "kind": kind,
                   "config": dataclasses.asdict(cfg)}, f)


def load_encoder(path: str) -> tuple[dict, EncoderConfig]:
    """(parameter tree of float32 CPU tensors, config) from a checkpoint
    written by either package with the npz backend; the tree is the
    cross-encoder's for ``kind="cross"`` (wrap the config in
    ``CrossEncoderConfig``)."""
    with open(os.path.join(path, "encoder.json")) as f:
        meta = json.load(f)
    if meta.get("backend") != "npz":
        raise NotImplementedError(
            f"{path}: {meta.get('backend')!r} checkpoints are not readable "
            "without orbax; re-save it with the npz backend")
    cfg = EncoderConfig(**meta["config"])
    with np.load(os.path.join(path, "params.npz")) as data:
        n = len(data.files)
        leaves = [torch.from_numpy(np.array(data[f"p{i}"], np.float32))
                  for i in range(n)]
    return unflatten_params(cfg, leaves, meta.get("kind", "bi")), cfg
