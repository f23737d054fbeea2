"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each source into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named after
a hash of the source and the flags so that an edited source rebuilds.
The library goes to ``build/kernels/`` beside the package and is loaded
with ``ctypes``.  Importing this module builds nothing; a missing
``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# -fmad=false keeps each product rounded before its sum, as the plain
# PyTorch versions do (see the note at the top of csrc/farneback.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildResult(NamedTuple):
    """A loaded kernel library with the record of how it was built."""

    lib: ctypes.CDLL
    path: pathlib.Path
    command: list  # the nvcc command; empty when the library was already built
    log: str       # nvcc's output, with ptxas' register and spill report
    seconds: float


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


@functools.lru_cache(maxsize=None)
def load(source: str) -> BuildResult:
    """Build (unless already built) and load ``csrc/<source>``."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if out.exists():
        cmd = []
        log = log_path.read_text() if log_path.exists() else ""
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    return BuildResult(lib, out, cmd, log, time.perf_counter() - t0)
