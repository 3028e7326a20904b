"""Aho-Corasick matcher: ctypes binding to the C++ automaton
(cpp/ahocorasick.cc) with a pure-Python fallback.

The port builds its own copy of the library from ``cpp/ahocorasick.cc``
into its build directory (``ops/_build.py``) and never writes into
``cpp/``. Without a C++ compiler the Python automaton keeps everything
working (slower, same results). This is host-side tagging, not the
device path.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
from typing import Iterable

from mobius_rag_tpu_torch.ops._build import CXX_FLAGS, REPO_DIR, build_library

_SOURCE = os.path.join(REPO_DIR, "cpp", "ahocorasick.cc")


def _load_lib() -> ctypes.CDLL | None:
    if not os.path.exists(_SOURCE):
        return None
    try:
        path, _ = build_library("mrag_aho", [_SOURCE], "g++", CXX_FLAGS,
                                timeout=120)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None  # no C++ toolchain: the Python automaton serves
    lib.ac_create.restype = ctypes.c_void_p
    lib.ac_add_pattern.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int]
    lib.ac_build.argtypes = [ctypes.c_void_p]
    lib.ac_match.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.ac_match_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_int]
    lib.ac_free.argtypes = [ctypes.c_void_p]
    return lib


_LIB: ctypes.CDLL | None | bool = False  # False = not yet attempted


def _lib() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is False:
        _LIB = _load_lib()
    return _LIB


class AhoCorasick:
    """Case-insensitive multi-pattern matcher with word boundaries.

    >>> ac = AhoCorasick(["prior authorization", "dme"])
    >>> ac.match_set("DME needs prior authorization")
    {0, 1}
    """

    def __init__(self, patterns: Iterable[str], *, word_boundary: bool = True):
        self.patterns = [p.lower() for p in patterns]
        self.word_boundary = word_boundary
        self._handle = None
        self._native = False
        lib = _lib()
        if lib is not None and self.patterns:
            handle = lib.ac_create()
            ok = True
            for i, p in enumerate(self.patterns):
                b = p.encode("utf-8")
                if lib.ac_add_pattern(handle, b, len(b), i) != 0:
                    ok = False
                    break
            if ok and lib.ac_build(handle) == 0:
                self._handle = handle
                self._native = True
            else:
                lib.ac_free(handle)
        if not self._native:
            self._build_python()

    # -- python fallback -----------------------------------------------------

    def _build_python(self) -> None:
        self._py_patterns = []
        for i, p in enumerate(self.patterns):
            if self.word_boundary:
                pat = re.compile(r"(?<![a-z0-9])" + re.escape(p) + r"(?![a-z0-9])")
            else:
                pat = re.compile(re.escape(p))
            self._py_patterns.append((pat, i))

    @property
    def is_native(self) -> bool:
        return self._native

    # -- matching ------------------------------------------------------------

    def match_set(self, text: str) -> set[int]:
        """Distinct pattern ids present in text."""
        t = text.lower()
        if self._native:
            data = t.encode("utf-8")
            flags = (ctypes.c_uint8 * len(self.patterns))()
            _lib().ac_match_set(self._handle, data, len(data),
                                1 if self.word_boundary else 0, flags,
                                len(self.patterns))
            return {i for i in range(len(self.patterns)) if flags[i]}
        return {i for pat, i in self._py_patterns if pat.search(t)}

    def match_positions(self, text: str, max_out: int = 4096) -> list[tuple[int, int]]:
        """All (pattern id, end offset in utf-8 bytes) matches."""
        t = text.lower()
        if self._native:
            data = t.encode("utf-8")
            ids = (ctypes.c_int32 * max_out)()
            ends = (ctypes.c_int32 * max_out)()
            n = _lib().ac_match(self._handle, data, len(data),
                                1 if self.word_boundary else 0, ids, ends, max_out)
            n = min(n, max_out)
            return [(ids[i], ends[i]) for i in range(n)]
        out = []
        for pat, i in self._py_patterns:
            for m in pat.finditer(t):
                out.append((i, m.end()))
        return sorted(out, key=lambda x: (x[1], x[0]))

    def __del__(self):
        if self._native and self._handle:
            lib = _lib()
            if lib is not None:
                lib.ac_free(self._handle)
            self._handle = None
