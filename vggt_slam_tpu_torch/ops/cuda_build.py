"""Build and load the port's CUDA kernels at first use.

Each source under `vggt_slam_tpu_torch/csrc/` is compiled with plain
`nvcc` for `sm_90a` into a shared library with a C interface under
`<repo>/build/vggt_slam_tpu_torch/`, rebuilt only when the source is newer
than the library, and loaded with ctypes (the `native/kdtree.py` pattern of
the JAX package). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vggt_slam_tpu_torch")
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc per library by this process (0.0 when up to date),
# and nvcc's output (ptxas register/shared-memory report).
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into lib<name>.so if stale; return its path."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        build_seconds.setdefault(name, 0.0)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name and rename, so processes building at once never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build if needed, load, and declare `signatures` {fn: (argtypes,
    restype)} on the library."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return _loaded[name]
