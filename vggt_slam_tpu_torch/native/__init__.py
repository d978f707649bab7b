"""Host C++ libraries of the port, built with g++ at first use into
<repo>/build/vggt_slam_tpu_torch/, never beside their sources."""
from __future__ import annotations

import os
import subprocess
import tempfile

from vggt_slam_tpu_torch.ops.cuda_build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))


def paths(name: str) -> tuple[str, str]:
    """(<name>.cpp beside this file, lib<name>.so in the build directory)."""
    return (os.path.join(_HERE, f"{name}.cpp"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def build_library(src: str, lib: str) -> str:
    """`lib`, (re)built from `src` when missing or older than it."""
    if not os.path.exists(lib) or \
            os.path.getmtime(lib) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a private name, renamed when done: concurrent builds never load a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o",
                            tmp], check=True, capture_output=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib
