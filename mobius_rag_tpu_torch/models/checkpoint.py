"""Encoder parameter checkpoints in the JAX package's layouts (the port of
``mobius_rag_tpu.models.checkpoint``).

A checkpoint directory holds ``encoder.json`` ({"backend", "kind",
"config"}) and, for the npz backend, ``params.npz`` with the leaves as
``p0..pN`` in ``jax.tree_util`` flatten order (dict keys sorted, the
``layers`` list in order). The port reads and writes that layout, so a
checkpoint passes between the two packages either way, for the encoder
(``kind="bi"``) and the cross-encoder (``kind="cross"``: leaves ``embed,
layers, ln_f_scale, pos, score_head``; the config saved is its base
encoder config). It writes npz only. It also reads an orbax checkpoint
(``backend: "orbax"``, the JAX package's first choice where orbax is
installed) without JAX: ``params/_METADATA`` names each leaf's key path,
and ``tensorstore`` opens the leaf as a zarr array inside the directory's
OCDBT key-value store. Where ``tensorstore`` is missing, an orbax
checkpoint raises and says so.
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
    cfg = EncoderConfig(**meta["config"])
    if meta.get("backend") == "orbax":
        arrays = _orbax_leaves(path)
    elif meta.get("backend") == "npz":
        with np.load(os.path.join(path, "params.npz")) as data:
            arrays = [data[f"p{i}"] for i in range(len(data.files))]
    else:
        raise NotImplementedError(
            f"{path}: {meta.get('backend')!r} checkpoints are not readable; "
            "re-save it with the npz backend")
    leaves = [torch.from_numpy(np.array(a, np.float32)) for a in arrays]
    return unflatten_params(cfg, leaves, meta.get("kind", "bi")), cfg


def _orbax_leaves(path: str) -> list[np.ndarray]:
    """The leaves of an orbax PyTree checkpoint in ``jax.tree_util`` order
    (dict keys sorted, sequences in order), read through tensorstore."""
    try:
        import tensorstore as ts
    except ImportError:
        raise NotImplementedError(
            f"{path}: an orbax checkpoint is read through the tensorstore "
            "package, which is not installed; re-save it with the npz backend")
    params = os.path.join(os.path.abspath(path), "params")
    with open(os.path.join(params, "_METADATA")) as f:
        tree_meta = json.load(f)["tree_metadata"]
    base = "file://" + params + "/"
    keyed = []
    for entry in tree_meta.values():
        # key_type 1 is a sequence index, 2 a dict key
        key = tuple((int(k["key"]), "") if k["key_type"] == 1 else (0, k["key"])
                    for k in entry["key_metadata"])
        keyed.append((key, ".".join(k["key"] for k in entry["key_metadata"])))
    keyed.sort()
    return [ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base},
                     "path": leaf}).result().read().result()
            for _, leaf in keyed]
