"""Probed cluster-block scans of the proj ANN backend (the port of
``mobius_rag_tpu/ops/pallas_proj.py``).

- :func:`proj_blocks` (replaces ``_kernel``, ``pallas_proj.py:41``): the
  raw exact int dots of every probed int8 cluster block against the
  query's int8 projection, ``[B, P, pad]`` float32.
- :func:`proj_gated_blocks` (replaces ``_gated_kernel``,
  ``pallas_proj.py:141``): the same dots times the slot's dequant scale
  where the slot passes the query's strict/relaxed/auto filter gate, else
  NEG_INF, and the slot's row id.

Each dispatches on where the tensors lie: on the CPU it calls its plain
PyTorch version (``*_reference``), on a CUDA device it launches the
hand-written Hopper kernels (``ops/csrc/proj_scan.cu``) or raises; it never
falls back. ``.launches`` on each wrapper counts its calls that launched
(each launches the grouping kernel, then the scan).

On the card both scans first group the (b, j) probe pairs by cluster
(:func:`group_probes`, whose plain twin is :func:`group_probes_reference`)
into an int32 scratch tensor the wrapper allocates, so that each probed
cluster tile is read once for every query that probes it.

The plain versions are the arithmetic of the JAX package's XLA twins
(``ops/proj.py:387-389,672-674``): int8 x int8 products summed in int32,
converted to float32 once, so raw dots are exact and equal bitwise
between the kernel, the plain version and the JAX package.
"""
from __future__ import annotations

import ctypes
import os

import torch

from mobius_rag_tpu_torch.ops._build import NVCC_FLAGS, build_library, find_nvcc

NEG_INF = -1e30
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "proj_scan.cu")
_LIB: ctypes.CDLL | None = None
# Shared memory a block may use on Hopper (dynamic, after opting in).
_MAX_SMEM = 232_448
# (b, j) probe pairs one scan takes (the grouping's int32 scratch).
_MAX_PAIRS = 1 << 22
# Elements of the int32 product the plain version materialises at once.
_REF_CHUNK = 1 << 27


def proj_blocks_reference(probe: torch.Tensor, codes: torch.Tensor,
                          q8: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`proj_blocks`: gather each probed block and
    sum the int32 products (exact), then one conversion to float32. Works
    on any device; chunked over the probe axis to bound the int32
    transient."""
    b, n_probe = probe.shape
    _, pad, p = codes.shape
    q32 = q8.to(torch.int32)[:, None, None, :]
    step = max(1, _REF_CHUNK // max(b * pad * p, 1))
    parts = []
    for lo in range(0, n_probe, step):
        blk = codes[probe[:, lo:lo + step].long()].to(torch.int32)  # [B, s, pad, p]
        parts.append((blk * q32).sum(dim=-1, dtype=torch.int32))
    return torch.cat(parts, dim=1).to(torch.float32)


def proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8, *,
                                tw: int, tag_level: int):
    """Plain version of :func:`proj_gated_blocks`: the raw dots of
    :func:`proj_blocks_reference` and the plain gate
    (``ops.proj._gate_blocks_xla``) over the gathered word blocks."""
    from mobius_rag_tpu_torch.ops.proj import _gate_blocks_xla

    b, n_probe = probe.shape
    pad = codes.shape[1]
    raw = proj_blocks_reference(probe, codes, q8)  # [B, P, pad]
    wblk = words[probe.long()]  # [B, P, W, pad]
    scale = wblk[:, :, 2].contiguous().view(torch.float32)
    rid = wblk[:, :, 3]

    def slot_major(lo, hi):  # word rows [lo, hi) → [B, P·pad, hi-lo]
        return wblk[:, :, lo:hi].movedim(2, -1).reshape(b, n_probe * pad, hi - lo)

    meta = slot_major(0, 2)
    jw = slot_major(4, 4 + tw) if tag_level >= 1 else None
    dpw = slot_major(4 + tw, 4 + 3 * tw) if tag_level >= 2 else None
    ok = _gate_blocks_xla(meta, jw, dpw, qmeta, qbits, tw, tag_level)
    score = torch.where(ok.reshape(b, n_probe, pad), raw * scale,
                        torch.tensor(NEG_INF, dtype=torch.float32, device=raw.device))
    return score, rid


def group_probes_reference(probe: torch.Tensor, nlist: int):
    """Plain version of the kernels' grouping: the flat (b, j) indices of
    ``probe`` [B, P] sorted by clamped cluster id, stable in (b, j) order
    (members [B·P]), the probed clusters in ascending order (cells [G]) and
    each group's first member (starts [G + 1], the last is B·P); all
    int32."""
    flat = probe.reshape(-1).clamp(0, nlist - 1)
    order = torch.argsort(flat, stable=True)
    cells, counts = torch.unique_consecutive(flat[order], return_counts=True)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return order.to(torch.int32), cells.to(torch.int32), starts.to(torch.int32)


def build_kernel() -> tuple[ctypes.CDLL, float]:
    """Build (at first use) and load the kernel library. Returns (library,
    seconds spent compiling, 0.0 when it was already built)."""
    global _LIB
    path, seconds = build_library("mrag_proj_scan", [SOURCE], find_nvcc(), NVCC_FLAGS)
    if _LIB is None:
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mrag_proj_blocks.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.mrag_proj_blocks.restype = i
        lib.mrag_proj_gated_blocks.argtypes = [p, p, p, p, p, p, p, p, p,
                                               i, i, i, i, i, i, i, i, p]
        lib.mrag_proj_gated_blocks.restype = i
        lib.mrag_proj_group.argtypes = [p, p, i, i, i, p]
        lib.mrag_proj_group.restype = i
        lib.mrag_proj_smem_bytes.argtypes = [i, i, i]
        lib.mrag_proj_smem_bytes.restype = i
        lib.mrag_proj_scratch_ints.argtypes = [i, i, i]
        lib.mrag_proj_scratch_ints.restype = ctypes.c_longlong
        lib.mrag_proj_record_ints.argtypes = []
        lib.mrag_proj_record_ints.restype = i
        _LIB = lib
    return _LIB, seconds


def _expect(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check(probe, codes, q8):
    if probe.dim() != 2 or codes.dim() != 3 or q8.dim() != 2:
        raise ValueError(f"need probe [B, P], codes [nlist, pad, p], q8 [B, p]; got "
                         f"{tuple(probe.shape)}, {tuple(codes.shape)}, {tuple(q8.shape)}")
    b, n_probe = probe.shape
    nlist, pad, p = codes.shape
    _expect("probe", probe, torch.int32, (b, n_probe))
    _expect("codes", codes, torch.int8, (nlist, pad, p))
    _expect("q8", q8, torch.int8, (b, p))
    if min(b, n_probe, nlist, pad, p) < 1 or b > 65535 or n_probe > 65535 \
            or b * n_probe > _MAX_PAIRS:
        raise ValueError(f"empty or oversized scan: B={b} P={n_probe} nlist={nlist} "
                         f"pad={pad} p={p}")


def _device_of(*tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the proj scan runs on cpu or cuda tensors, not {device}")
    for t in tensors:
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel needs contiguous inputs")
    return device


def _lib_for(p: int, tw: int, tag_level: int) -> ctypes.CDLL:
    """The loaded library, after checking that a scan block's shared memory
    fits (a k-slice of codes and the word rows per ring stage, the batch's
    query rows: any p fits, a very wide tag pack may not); tag_level -1
    for proj_blocks."""
    lib = _LIB or build_kernel()[0]
    smem = lib.mrag_proj_smem_bytes(p, tw, tag_level)
    if smem > _MAX_SMEM:
        raise ValueError(f"p={p}, tw={tw}, tag_level={tag_level} needs {smem} bytes of "
                         f"shared memory, over {_MAX_SMEM}")
    return lib


def _scratch(lib, b: int, n_probe: int, nlist: int, device) -> torch.Tensor:
    """The grouping's int32 scratch: group records [B·P, R] (cluster, first
    member, member count, 0, the first members), members [B·P], the group
    count, and past the clusters the grouping counts in shared memory its
    per-cluster counters [3, nlist]."""
    n = lib.mrag_proj_scratch_ints(b, n_probe, nlist)
    if n < 0:
        raise ValueError(f"B={b}, P={n_probe}, nlist={nlist}: the grouping's scratch is past "
                         "int32 offsets")
    return torch.empty((n,), dtype=torch.int32, device=device)


def group_probes(probe: torch.Tensor, nlist: int):
    """The kernels' grouping of probe [B, P] int32 by clamped cluster id:
    (members [B·P], cells [G], starts [G + 1]) int32, as
    :func:`group_probes_reference` gives them. On a CUDA tensor it runs
    the grouping kernel the scans launch first and reads its scratch back
    (one synchronisation, for checks); on the CPU it is the plain
    version."""
    if probe.dtype != torch.int32 or probe.dim() != 2 or min(probe.shape) < 1 or nlist < 1:
        raise ValueError(f"probe must be int32 [B, P] and nlist >= 1, got {probe.dtype} "
                         f"{tuple(probe.shape)}, nlist={nlist}")
    device = _device_of(probe)
    if device.type == "cpu":
        return group_probes_reference(probe, nlist)
    b, n_probe = probe.shape
    lib = _lib_for(1, 1, -1)
    scratch = _scratch(lib, b, n_probe, nlist, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mrag_proj_group(probe.data_ptr(), scratch.data_ptr(), b, n_probe, nlist,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"proj grouping kernel launch failed: CUDA error {rc}")
    bp, recw = b * n_probe, lib.mrag_proj_record_ints()
    n_groups = int(scratch[bp * (recw + 1)].item())
    rec = scratch[:n_groups * recw].view(n_groups, recw)
    starts = torch.cat([rec[:, 1], rec.new_full((1,), bp)])
    return scratch[bp * recw:bp * (recw + 1)], rec[:, 0].contiguous(), starts


def proj_blocks(probe: torch.Tensor, codes: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Raw exact int dots of every probed cluster block: probe [B, P] int32
    cluster ids in [0, nlist), codes [nlist, pad, p] int8, q8 [B, p] int8
    → [B, P, pad] float32."""
    _check(probe, codes, q8)
    device = _device_of(probe, codes, q8)
    if device.type == "cpu":
        return proj_blocks_reference(probe, codes, q8)
    b, n_probe = probe.shape
    nlist, pad, p = codes.shape
    lib = _lib_for(p, 0, -1)
    scratch = _scratch(lib, b, n_probe, nlist, device)
    out = torch.empty((b, n_probe, pad), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mrag_proj_blocks(probe.data_ptr(), codes.data_ptr(), q8.data_ptr(),
                                  scratch.data_ptr(), out.data_ptr(), b, n_probe, nlist, pad,
                                  p, stream)
    if rc != 0:
        raise RuntimeError(f"proj_blocks kernel launch failed: CUDA error {rc}")
    proj_blocks.launches += 1
    return out


proj_blocks.launches = 0


def proj_gated_blocks(probe, qmeta, qbits, codes, words, q8, *, tw: int,
                      tag_level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated block scores [B, P, pad] float32 (raw int dot x the slot's
    dequant scale where the slot passes the query's filter gate, NEG_INF
    otherwise) and the slot row ids [B, P, pad] int32. qmeta [B, 8] and
    qbits [B, 3·tw] int32 from ``ops.proj.encode_qmeta``; words
    [nlist, W, pad] int32, the ``ProjGate`` pack; ``tag_level`` (0, 1, 2)
    bounds the word rows read (``query.gating.batch_tag_level``)."""
    _check(probe, codes, q8)
    b, n_probe = probe.shape
    nlist, pad, p = codes.shape
    if tag_level not in (0, 1, 2) or tw < 1:
        raise ValueError(f"tag_level must be 0, 1 or 2 and tw >= 1 (got {tag_level}, {tw})")
    _expect("qmeta", qmeta, torch.int32, (b, 8))
    _expect("qbits", qbits, torch.int32, (b, 3 * tw))
    if words.dtype != torch.int32 or words.dim() != 3 or words.shape[0] != nlist \
            or words.shape[2] != pad or words.shape[1] < 4 + 3 * tw:
        raise ValueError(f"words must be int32 [{nlist}, >= {4 + 3 * tw}, {pad}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    device = _device_of(probe, qmeta, qbits, codes, words, q8)
    if device.type == "cpu":
        return proj_gated_blocks_reference(probe, qmeta, qbits, codes, words, q8,
                                           tw=tw, tag_level=tag_level)
    lib = _lib_for(p, tw, tag_level)
    scratch = _scratch(lib, b, n_probe, nlist, device)
    score = torch.empty((b, n_probe, pad), dtype=torch.float32, device=device)
    rowid = torch.empty((b, n_probe, pad), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mrag_proj_gated_blocks(
            probe.data_ptr(), qmeta.data_ptr(), qbits.data_ptr(), codes.data_ptr(),
            words.data_ptr(), q8.data_ptr(), scratch.data_ptr(), score.data_ptr(),
            rowid.data_ptr(), b, n_probe, nlist, pad, p, words.shape[1], tw, tag_level,
            stream)
    if rc != 0:
        raise RuntimeError(f"proj_gated_blocks kernel launch failed: CUDA error {rc}")
    proj_gated_blocks.launches += 1
    return score, rowid


proj_gated_blocks.launches = 0
