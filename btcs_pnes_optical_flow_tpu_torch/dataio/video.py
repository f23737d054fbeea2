"""Host-side video sources and chunked prefetching.

Mirrors ``btcs_pnes_optical_flow_tpu/dataio/video.py``: the same sources,
``open_source`` dispatch and ``ChunkPrefetcher``, copied so that the port
imports nothing of the JAX package.  Colour frames convert with the port's
integer-exact ``ops.cvx.bgr2gray_u8_np``.

Sources:
- ``ArraySource``     — in-memory (T, H, W[, 3]) arrays (tests, bench).
- ``NpyGraySource``   — memory-mapped .npy uint8 frame stacks.
- ``Y4MSource``       — self-contained YUV4MPEG2 parser (pure NumPy);
                        the luma plane is the grayscale signal.
- ``OpenCVSource``    — cv2.VideoCapture for real codecs (mp4/avi), with
                        CAP_PROP_POS_MSEC timestamps like the reference;
                        needs cv2 only if used.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.ops.cvx import bgr2gray_u8_np
from btcs_pnes_optical_flow_tpu_torch.utils.device import pinned_empty, stages_pinned


class VideoSource:
    """Iterator of grayscale uint8 frames with metadata."""

    fps: float
    width: int
    height: int
    n_frames: Optional[int]  # None when unknown up front

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[float]]]:
        """Yield (gray_u8 (H, W), pos_msec or None)."""
        raise NotImplementedError


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


class NpyGraySource(VideoSource):
    """Memory-mapped (T, H, W) uint8 .npy stack."""

    def __init__(self, path: str, fps: float):
        self._arr = np.load(path, mmap_mode="r")
        if self._arr.ndim != 3 or self._arr.dtype != np.uint8:
            raise ValueError(f"expected (T,H,W) uint8 stack, got {self._arr.shape} {self._arr.dtype}")
        self.fps = float(fps)
        self.n_frames, self.height, self.width = self._arr.shape

    def frames(self):
        for i in range(self.n_frames):
            yield np.asarray(self._arr[i]), None


class Y4MSource(VideoSource):
    """Minimal YUV4MPEG2 reader (luma plane only), pure NumPy."""

    def __init__(self, path: str):
        self._path = path
        with open(path, "rb") as f:
            header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {path}")
        self.width = self.height = 0
        num, den = 30, 1
        self._subsampling = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = (int(v) for v in tok[1:].split(":"))
            elif tok[0] == "C":
                self._subsampling = tok[1:]
        self.fps = num / den
        self._header_len = len(header) + 1
        if self._subsampling.startswith("420"):
            self._frame_bytes = self.width * self.height * 3 // 2
        elif self._subsampling.startswith("422"):
            self._frame_bytes = self.width * self.height * 2
        elif self._subsampling.startswith("444"):
            self._frame_bytes = self.width * self.height * 3
        elif self._subsampling.startswith("mono"):
            self._frame_bytes = self.width * self.height
        else:
            raise ValueError(f"unsupported y4m subsampling {self._subsampling}")
        # The Y4M spec allows per-frame parameters ('FRAME <params>\n'):
        # the marker length comes from the first frame's marker line.
        with open(path, "rb") as f:
            f.seek(self._header_len)
            marker = f.readline()
        if marker and not marker.startswith(b"FRAME"):
            raise ValueError(f"corrupt y4m frame marker in {path}")
        payload = os.path.getsize(path) - self._header_len
        per = self._frame_bytes + max(len(marker), 1)
        self.n_frames = payload // per

    def frames(self):
        ysize = self.width * self.height
        with open(self._path, "rb") as f:
            f.seek(self._header_len)
            while True:
                marker = f.readline()
                if not marker:
                    return
                if not marker.startswith(b"FRAME"):
                    raise ValueError("corrupt y4m frame marker")
                data = f.read(self._frame_bytes)
                if len(data) < self._frame_bytes:
                    return
                y = np.frombuffer(data, np.uint8, count=ysize).reshape(self.height, self.width)
                yield y, None


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
    """Dispatch on type / extension: arrays, .y4m, .npy, then the cv2-free
    codec decoders (``dataio/codecs.py``), and cv2.VideoCapture only as the
    last resort."""
    if isinstance(path_or_array, np.ndarray):
        return ArraySource(path_or_array, fps or 30.0)
    if isinstance(path_or_array, torch.Tensor) and path_or_array.ndim == 3:
        # A clip on the card is read back once here; the batched cohort
        # path (parallel/cohort.py) keeps such clips on the device.
        return ArraySource(path_or_array.cpu().numpy(), fps or 30.0)
    if hasattr(path_or_array, "__array__") and getattr(path_or_array, "ndim", 0) == 3:
        return ArraySource(np.asarray(path_or_array), fps or 30.0)
    p = str(path_or_array)
    if p.endswith(".y4m"):
        return Y4MSource(p)
    if p.endswith(".npy"):
        return NpyGraySource(p, fps or 30.0)
    from btcs_pnes_optical_flow_tpu_torch.dataio.codecs import open_codec_source

    try:
        return open_codec_source(p, fallback_fps=fps or 30.0)
    except Exception:  # any failure of a cv2-free decoder (a probe timeout,
        # a truncated container header) falls back, as in the JAX package
        return OpenCVSource(p, fallback_fps=fps or 30.0)


class ChunkPrefetcher:
    """Background thread turning a frame iterator into overlapping
    frame-pair chunks.

    Emits (first_idx, frames (C+1, H, W) u8, pos_msec list) where
    consecutive chunks overlap by one frame so every (i-1, i) pair is
    covered — the carry the reference keeps as ``prev_gray``
    (optical_flow.py:242-249).  The bounded queue buffers decode against
    device compute.  For a CUDA ``device`` (the chunks' destination) the
    thread stacks each chunk's frames into a page-locked uint8 tensor
    (``utils/device.py pinned_empty``) in place of the array, so that the
    copy to the card needs no host sync.
    """

    def __init__(self, source: VideoSource, chunk_pairs: int, depth: int = 2, *,
                 device=None):
        self._source = source
        self._chunk = chunk_pairs
        self._pin = device is not None and stages_pinned(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            buf = []
            pos = []
            first = 0
            for gray, pm in self._source.frames():
                buf.append(gray)
                pos.append(pm)
                if len(buf) == self._chunk + 1:
                    self._q.put((first, self._stack(buf), list(pos)))
                    first += self._chunk
                    buf = buf[-1:]
                    pos = pos[-1:]
            if len(buf) > 1:
                self._q.put((first, self._stack(buf), list(pos)))
            elif len(buf) == 1 and first == 0:
                # Single-frame video: emit the lone frame (no pairs).
                self._q.put((0, self._stack(buf), list(pos)))
        except Exception as e:  # surface decode errors to the consumer
            self._q.put(e)
        finally:
            self._q.put(None)

    def _stack(self, buf):
        if not self._pin:
            return np.stack(buf)
        frames = pinned_empty((len(buf),) + buf[0].shape, torch.uint8)
        np.stack(buf, out=frames.numpy())
        return frames

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
