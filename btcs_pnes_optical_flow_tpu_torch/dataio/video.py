"""Video sources for the port.

The JAX package's ``dataio/video.py`` readers are jax-free and are
imported as they are.  Its ``ArraySource`` (on colour input) and
``OpenCVSource`` convert with ``ops.cvx.bgr2gray_u8_np`` from a module
that imports JAX, so the port has its own two, converting with the port's
integer-exact copy, and its own ``open_source`` that dispatches to them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from btcs_pnes_optical_flow_tpu.dataio.video import (  # noqa: F401
    ChunkPrefetcher,
    NpyGraySource,
    VideoSource,
    Y4MSource,
)
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import bgr2gray_u8_np


class ArraySource(VideoSource):
    """In-memory (T, H, W) gray or (T, H, W, 3) BGR uint8 frames."""

    def __init__(self, frames: np.ndarray, fps: float, pos_msec: Optional[np.ndarray] = None):
        frames = np.asarray(frames)
        if frames.ndim == 4:  # BGR → gray with the OpenCV-exact weights
            frames = bgr2gray_u8_np(frames)
        self._frames = frames.astype(np.uint8)
        self._pos = pos_msec
        self.fps = float(fps)
        self.n_frames, self.height, self.width = frames.shape[:3]

    def frames(self):
        for i in range(self.n_frames):
            pm = float(self._pos[i]) if self._pos is not None else None
            yield self._frames[i], pm


class OpenCVSource(VideoSource):
    """cv2.VideoCapture decode with the reference's timestamps
    (CAP_PROP_POS_MSEC read after each cap.read()); needs cv2."""

    def __init__(self, path: str, fallback_fps: float = 30.0):
        import cv2

        self._cv2 = cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise RuntimeError(f"VideoCapture failed: {path}")
        fps = cap.get(cv2.CAP_PROP_FPS)
        self.fps = float(fps) if fps and fps > 0 else float(fallback_fps)
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.n_frames = None
        self._cap = cap

    def frames(self):
        cv2 = self._cv2
        while True:
            ret, frame = self._cap.read()
            if not ret:
                break
            pm = self._cap.get(cv2.CAP_PROP_POS_MSEC)
            yield bgr2gray_u8_np(frame), (float(pm) if pm is not None else None)
        self._cap.release()


def open_source(path_or_array, fps: Optional[float] = None) -> VideoSource:
    """Dispatch on type / extension, as the JAX package's ``open_source``:
    arrays, .y4m, .npy, then the cv2-free codec decoders, and
    cv2.VideoCapture only as the last resort."""
    if isinstance(path_or_array, np.ndarray):
        return ArraySource(path_or_array, fps or 30.0)
    if hasattr(path_or_array, "__array__") and getattr(path_or_array, "ndim", 0) == 3:
        return ArraySource(np.asarray(path_or_array), fps or 30.0)
    p = str(path_or_array)
    if p.endswith(".y4m"):
        return Y4MSource(p)
    if p.endswith(".npy"):
        return NpyGraySource(p, fps or 30.0)
    from btcs_pnes_optical_flow_tpu.dataio.codecs import open_codec_source

    try:
        return open_codec_source(p, fallback_fps=fps or 30.0)
    except (RuntimeError, OSError, ValueError):  # no cv2-free decoder fits
        return OpenCVSource(p, fallback_fps=fps or 30.0)
