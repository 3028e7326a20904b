"""Device grids for sharded serving and training (the port of
``mobius_rag_tpu.parallel.mesh``).

The JAX package scales out with a ``jax.sharding.Mesh``: one process,
``shard_map`` over the devices. The port keeps that shape, a single
process that owns a grid of ``torch.device``: the corpus shards over the
``shard`` axis and, in a serving grid, is replicated over the ``data``
axis, whose groups each take a contiguous part of the query batch
(``parallel/sharded.py``). A device may appear more than once: a grid of
``cuda:0`` repeated S times runs the S-shard program on one card (S times
the launches and the real merge), and the same code over ``cuda:0..3`` is
the four-card deployment. A training grid ([dp, tp], ``make_train_mesh``)
splits the batch over ``dp`` and the encoder's heads and hidden columns
over ``tp`` (``models/train.py``).

Beyond one host the corpus splits at the host layer, as in the JAX
package: one engine (or one ``index.service.RemoteIndexClient`` endpoint)
per slice, queries fanned out to every slice and the results merged on
the host (``parallel/slices.py``); ingest reaches every slice through the
durable host queue, never through device traffic.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device`` whose dimensions are ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid needs {devices.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def groups(self, axis: str) -> list[list[torch.device]]:
        """The grid as rows of the ``axis`` dimension: one row per position
        of the other axes (the data-parallel groups), each listing the
        devices along ``axis`` in order."""
        a = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, a, -1)
        return [list(row) for row in grid.reshape(-1, grid.shape[-1])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _device_list(devices) -> list[torch.device]:
    """`devices` as torch devices, a CUDA device always with its index; by
    default every visible CUDA device."""
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def _grid(devices: list[torch.device]) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid


def make_mesh(num_shards: int = 0, axis: str = "shard", devices=None) -> Mesh:
    """A 1-d grid of ``num_shards`` devices (default: all of them)."""
    devices = _device_list(devices)
    n = num_shards or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"requested {n} shards but {len(devices)} devices")
    return Mesh(_grid(devices[:n]), (axis,))


def make_serve_mesh(dp: int, num_shards: int = 0, *, data_axis: str = "data",
                    shard_axis: str = "shard", devices=None) -> Mesh:
    """A [dp, shards] serving grid: the corpus shards over ``shard_axis``
    and is replicated over ``data_axis``, and the query batch splits over
    ``data_axis`` (each data group scans its own replica, so throughput
    grows with dp at the same per-query latency)."""
    devices = _device_list(devices)
    n = num_shards or len(devices) // max(dp, 1)
    if dp < 1 or n < 1:
        raise ValueError(f"dp={dp} and shards={n} must be >= 1")
    if dp * n > len(devices):
        raise ValueError(f"dp*shards={dp * n} > {len(devices)} devices")
    return Mesh(_grid(devices[: dp * n]).reshape(dp, n), (data_axis, shard_axis))


def make_train_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """A [dp, tp] training grid with axes ("dp", "tp") (default devices:
    every visible CUDA device)."""
    devices = _device_list(devices)
    if dp * tp > len(devices):
        raise ValueError(f"dp*tp={dp * tp} > {len(devices)} devices")
    return Mesh(_grid(devices[: dp * tp]).reshape(dp, tp), ("dp", "tp"))
