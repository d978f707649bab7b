"""Build and load the port's CUDA kernels at first use: each csrc/ source is
compiled by plain `nvcc` for `sm_90a` into a C-interface library under
`<repo>/build/vggt_slam_tpu_torch/` (rebuilt when it or a `csrc/*.cuh`
header is newer than the library or its ptxas report) and loaded with
ctypes. Nothing runs at import.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vggt_slam_tpu_torch")
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc per library by this process (0.0 when up to date),
# and nvcc's output (ptxas register/shared-memory report), kept beside each
# library as lib<name>.ptxas.log and read from there when it is up to date.
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


def build(name: str, src: str | None = None) -> str:
    """Compile `src` (default csrc/<name>.cu) into lib<name>.so if stale;
    return its path."""
    src = src or os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    report = os.path.join(BUILD_DIR, f"lib{name}.ptxas.log")
    newest = max(os.path.getmtime(f) for f in [src] + glob.glob(
        os.path.join(os.path.dirname(src), "*.cuh")))
    if all(os.path.exists(f) and os.path.getmtime(f) >= newest
           for f in (lib, report)):
        build_seconds.setdefault(name, 0.0)
        with open(report) as f:
            build_log.setdefault(name, f.read())
        return lib
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to private names and rename, so processes building at once never
    # load a half-written library; the report first, so that a library is
    # never newer than its report.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    text = proc.stdout + proc.stderr
    with open(tmp + ".log", "w") as f:
        f.write(text)
    os.replace(tmp + ".log", report)
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = text
    return lib


def build_all() -> list[str]:
    """Build every csrc/*.cu at once, one nvcc process each."""
    names = sorted(os.path.basename(f)[:-3]
                   for f in glob.glob(os.path.join(CSRC, "*.cu")))
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str, signatures: dict, src: str | None = None) -> ctypes.CDLL:
    """Build if needed (see `build`), load, and declare `signatures` {fn:
    (argtypes, restype)} on the library."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build(name, src))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return _loaded[name]
