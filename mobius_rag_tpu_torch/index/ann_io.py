"""ANN table persistence (the port of ``mobius_rag_tpu.index.ann_io``), for
every table class: :class:`~mobius_rag_tpu_torch.index.ivf.IVFIndex`,
:class:`~mobius_rag_tpu_torch.index.ivf.PackedIVF`,
:class:`~mobius_rag_tpu_torch.ops.pq.PackedPQ` and
:class:`~mobius_rag_tpu_torch.ops.proj.PackedProj`.

The file is the JAX package's ``.npz``: a ``__header__`` entry holding
JSON ``{"class", "aux", "meta"}`` as uint8 bytes (``aux`` is the JAX
pytree's static aux), then one array per field. A file either package
writes loads into the other. An ann file is only valid for the snapshot
it was written with; the engine's ``load_ann`` checks the backend and the
row count.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np

from mobius_rag_tpu_torch.index.ivf import IVFIndex, PackedIVF
from mobius_rag_tpu_torch.ops.pq import PackedPQ
from mobius_rag_tpu_torch.ops.proj import PackedProj

_HEADER_KEY = "__header__"
_CLASSES = {c.__name__: c for c in (IVFIndex, PackedIVF, PackedPQ, PackedProj)}


def save_ann(ann: Any, path: str, *, meta: dict[str, Any] | None = None) -> None:
    """Write one ANN table object to `path` (numpy appends ``.npz`` when
    missing, as the JAX writer does)."""
    name = type(ann).__name__
    if _CLASSES.get(name) is not type(ann):
        raise ValueError(f"unsupported ANN table type {name}")
    arrays = {f: getattr(ann, f).detach().cpu().numpy() for f in type(ann).FIELDS}
    header = {"class": name, "aux": list(ann.aux), "meta": meta or {}}
    np.savez(path, **{_HEADER_KEY: np.frombuffer(json.dumps(header).encode(),
                                                 dtype=np.uint8)}, **arrays)


def load_ann(path: str, device) -> tuple[Any, dict[str, Any]]:
    """Load (ann, meta) onto `device`. A PackedProj gets its host slot
    mirrors (``build_rowids``/``build_valid``) too, so the engine's
    incremental insert path survives a restore."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z[_HEADER_KEY]).decode())
        name = header["class"]
        if name not in _CLASSES:
            raise ValueError(f"unknown ANN table class {name!r}")
        arrays = {f: z[f] for f in _CLASSES[name].FIELDS}
    return _CLASSES[name].from_numpy(arrays, header["aux"], device), header.get("meta", {})
