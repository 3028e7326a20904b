"""ANN table persistence (the port of ``mobius_rag_tpu.index.ann_io``),
for the proj backend's :class:`~mobius_rag_tpu_torch.ops.proj.PackedProj`.

The file is the JAX package's ``.npz``: a ``__header__`` entry holding
JSON ``{"class", "aux", "meta"}`` as uint8 bytes, then one array per
field. A file either package writes loads into the other. An ann file is
only valid for the snapshot it was written with; the engine's
``load_ann`` checks the backend and the row count.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np

from mobius_rag_tpu_torch.ops.proj import PackedProj

_HEADER_KEY = "__header__"
_NOT_PORTED = ("IVFIndex", "PackedIVF", "PackedPQ")


def save_ann(ann: PackedProj, path: str, *, meta: dict[str, Any] | None = None) -> None:
    """Write one PackedProj to `path` (numpy appends ``.npz`` when
    missing, as the JAX writer does)."""
    if not isinstance(ann, PackedProj):
        raise ValueError(f"unsupported ANN table type {type(ann).__name__}")
    arrays = {f: getattr(ann, f).detach().cpu().numpy() for f in PackedProj.FIELDS}
    header = {"class": "PackedProj", "aux": list(ann.aux), "meta": meta or {}}
    np.savez(path, **{_HEADER_KEY: np.frombuffer(json.dumps(header).encode(),
                                                 dtype=np.uint8)}, **arrays)


def load_ann(path: str, device) -> tuple[PackedProj, dict[str, Any]]:
    """Load (ann, meta) onto `device`. The host slot mirrors
    (``build_rowids``/``build_valid``) come back too, so the engine's
    incremental insert path survives a restore."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z[_HEADER_KEY]).decode())
        name = header["class"]
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"{name} tables are not ported yet (ROADMAP queue 1, items 2-3)")
        if name != "PackedProj":
            raise ValueError(f"unknown ANN table class {name!r}")
        arrays = {f: z[f] for f in PackedProj.FIELDS}
    return PackedProj.from_numpy(arrays, header["aux"], device), header.get("meta", {})
