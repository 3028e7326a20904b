"""Build-and-load for the port's native code.

Every shared library is compiled from the repository's own sources at
first use, into ``mobius_rag_tpu_torch/_build/`` (listed in .gitignore),
and loaded by the caller with ``ctypes``. The file name carries a hash of the sources
and the command, so an edited source rebuilds and a stale library is never
loaded. The compiler writes to a private temporary name that is renamed
into place, so processes that build at the same time never see a
half-written library.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
REPO_DIR = os.path.dirname(PKG_DIR)

# Hopper: keep the "a" — wgmma/setmaxnreg exist only for sm_90a.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH. Raises when there is none."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def build_library(name: str, sources: list[str], compiler: str,
                  flags: tuple[str, ...], timeout: float = 600.0) -> tuple[str, float]:
    """Compile `sources` into BUILD_DIR/lib<name>-<hash>.so unless that
    file exists. Returns (path, seconds spent building; 0.0 on a hit).
    Raises RuntimeError with the compiler's output when it fails."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join((os.path.basename(compiler),) + flags).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0
