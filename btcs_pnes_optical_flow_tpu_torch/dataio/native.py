"""ctypes bindings of the native (C++) video IO library.

Port of ``btcs_pnes_optical_flow_tpu/dataio/native.py``: ``NativeSource``
reads raw .npy stacks (gray or BGR) and .y4m files through
``native/videoio.cpp``, an mmap + prefetch-ring frame loader with exact
fixed-point BGR→gray conversion.  The library is built from that source
with g++ and the flags of ``native/Makefile`` into ``build/native/`` at
first use, named after a hash of source and flags; the prebuilt
``native/libvideoio.so`` in the repository is not loaded (it was built
for another host).  ``open_source`` does not dispatch here, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np

from btcs_pnes_optical_flow_tpu_torch.dataio.video import VideoSource

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "videoio.cpp"
BUILD_DIR = _REPO / "build" / "native"
# native/Makefile's CXXFLAGS and link step.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

KIND_RAW_GRAY = 0
KIND_RAW_BGR = 1
KIND_Y4M = 2


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (unless already built) and load the native library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libvideoio_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cxx = os.environ.get("CXX", "g++")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    lib.vio_open.restype = ctypes.c_void_p
    lib.vio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.vio_info.restype = ctypes.c_int
    lib.vio_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 3 + [
        ctypes.POINTER(ctypes.c_double)]
    lib.vio_next.restype = ctypes.c_int
    lib.vio_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vio_read.restype = ctypes.c_int
    lib.vio_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.vio_close.restype = None
    lib.vio_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeSource(VideoSource):
    """Native mmap + prefetch source for raw .npy stacks and .y4m files."""

    def __init__(self, path: str, fps: Optional[float] = None, prefetch_depth: int = 4):
        lib = load_library()
        if path.endswith(".y4m"):
            kind = KIND_Y4M
        else:
            # The npy header's shape tells gray from BGR stacks.
            arr = np.load(path, mmap_mode="r")
            kind = KIND_RAW_BGR if arr.ndim == 4 else KIND_RAW_GRAY
            del arr
        self._h = lib.vio_open(path.encode(), kind, float(fps or 30.0), prefetch_depth)
        if not self._h:
            raise RuntimeError(f"vio_open failed: {path}")
        self._lib = lib
        t, hh, ww = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fr = ctypes.c_double()
        lib.vio_info(self._h, ctypes.byref(t), ctypes.byref(hh), ctypes.byref(ww), ctypes.byref(fr))
        self.n_frames = t.value
        self.height = hh.value
        self.width = ww.value
        self.fps = float(fps) if fps else fr.value

    def frames(self):
        buf = np.empty((self.height, self.width), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.c_char_p)
        while self._lib.vio_next(self._h, ptr) >= 0:
            yield buf.copy(), None

    def read(self, idx: int) -> np.ndarray:
        buf = np.empty((self.height, self.width), np.uint8)
        if self._lib.vio_read(self._h, idx, buf.ctypes.data_as(ctypes.c_char_p)) < 0:
            raise IndexError(idx)
        return buf

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
