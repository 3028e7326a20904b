"""The host exact re-rank's fused gather + dequant + dot (the port of
``mobius_rag_tpu.utils.native.gather_cos``): a ctypes binding to
``mrag_gather_cos`` in ``cpp/rerank.cc``.

The port builds its own copy of the library from ``cpp/rerank.cc`` into
its build directory (``ops/_build.py``) with g++ at first use and never
writes into ``cpp/``. Without a C++ compiler :func:`gather_cos` returns
None and the engine's numpy expression serves (the same cosines within
float32 summation order). This is host code serving host residency's
second stage, not a device kernel. ``gather_cos.native_calls`` counts the
calls the library served.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from mobius_rag_tpu_torch.ops._build import CXX_FLAGS, REPO_DIR, build_library

_SOURCE = os.path.join(REPO_DIR, "cpp", "rerank.cc")

_LIB: ctypes.CDLL | None | bool = False  # False = not yet attempted


def _load_lib() -> ctypes.CDLL | None:
    if not os.path.exists(_SOURCE):
        return None
    try:
        path, _ = build_library("mrag_rerank", [_SOURCE], "g++", CXX_FLAGS, timeout=120)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None  # no C++ toolchain: the caller's numpy path serves
    p = ctypes.c_void_p
    lib.mrag_gather_cos.restype = ctypes.c_int
    lib.mrag_gather_cos.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p,
                                    ctypes.c_int, ctypes.c_int, p, p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The process-wide library handle, or None without a C++ toolchain."""
    global _LIB
    if _LIB is False:
        _LIB = _load_lib()
    return _LIB


def gather_cos(hv: np.ndarray, hs: np.ndarray, idx: np.ndarray,
               qv: np.ndarray) -> np.ndarray | None:
    """cos[b, w] = hs[r] · dot(hv[r], qv[b]) with r = clip(idx[b, w], 0,
    N - 1). hv [N, D] int8 host rows, hs [N] f32 scales, idx [B, W] int,
    qv [B, D] f32. Returns None when the library is unavailable (the
    caller computes the numpy expression instead)."""
    lib = get_lib()
    if lib is None:
        return None
    hv = np.ascontiguousarray(hv, np.int8)
    hs = np.ascontiguousarray(hs, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    qv = np.ascontiguousarray(qv, np.float32)
    b, w = idx.shape
    out = np.empty((b, w), np.float32)
    rc = lib.mrag_gather_cos(hv.ctypes.data, hs.ctypes.data, hv.shape[0], hv.shape[1],
                             idx.ctypes.data, b, w, qv.ctypes.data, out.ctypes.data)
    if rc != 0:
        return None
    gather_cos.native_calls += 1
    return out


gather_cos.native_calls = 0
