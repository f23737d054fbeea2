"""cv2-free codec decode for the production input path.

A copy of ``btcs_pnes_optical_flow_tpu/dataio/codecs.py`` on the port's
``VideoSource``, so that the port imports nothing of the JAX package.

The reference opens real video files with ``cv2.VideoCapture``
(optical_flow.py:62-85) and reads ``CAP_PROP_POS_MSEC`` after each
``cap.read()``.  These sources reproduce that contract without
requiring OpenCV on the production path:

- ``FFmpegSource``    — pipes any container/codec ffmpeg understands as
                        raw gray8 frames over a subprocess pipe (the
                        standard production decode: zero-copy into
                        NumPy, decode overlaps compute via the OS pipe
                        buffer + ChunkPrefetcher).  Gated on an ffmpeg
                        binary being present.
- ``MJPEGAviSource``  — self-contained AVI/RIFF container parser (pure
                        Python) + JPEG frame decode via PIL: a fully
                        cv2/ffmpeg-free path for MJPEG captures, the
                        common format of clinical video recorders.

Timestamps: both sources report ``pos_msec`` of the frame *after* it
is read — 1000 * frame_index / fps for fixed-rate containers — which is
what ``CAP_PROP_POS_MSEC`` returns for such files, keeping
``frame_ts = pos_msec/1000`` semantics identical to the reference
(optical_flow.py:110-119).
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from btcs_pnes_optical_flow_tpu_torch.dataio.video import VideoSource


def ffmpeg_binary() -> Optional[str]:
    """Path to an ffmpeg binary, or None (the source is then gated off)."""
    return shutil.which("ffmpeg")


class FFmpegSource(VideoSource):
    """Decode any ffmpeg-supported file as gray8 over a subprocess pipe.

    ffmpeg does the BT.601 luma conversion (``format=gray``) in its own
    swscale; frames arrive as raw ``H*W`` bytes with no container
    overhead.  Metadata (size/fps/frame count) comes from a fast
    ffprobe-style probe run (``-hide_banner -i``) parsed from stderr, or
    can be passed explicitly for headerless streams.
    """

    def __init__(
        self,
        path: str,
        fallback_fps: float = 30.0,
        width: Optional[int] = None,
        height: Optional[int] = None,
    ):
        bin_ = ffmpeg_binary()
        if bin_ is None:
            raise RuntimeError(
                "no ffmpeg binary on PATH; use MJPEGAviSource/OpenCVSource"
            )
        self._bin = bin_
        self._path = path
        if width is None or height is None:
            width, height, fps = self._probe(bin_, path)
        else:
            fps = None
        self.width = int(width)
        self.height = int(height)
        self.fps = float(fps) if fps else float(fallback_fps)
        self.n_frames = None  # streams don't announce length up front

    @staticmethod
    def _probe(bin_: str, path: str) -> Tuple[int, int, Optional[float]]:
        # `ffmpeg -i` exits nonzero (no output file) but prints the
        # stream description we need on stderr.
        proc = subprocess.run(
            [bin_, "-hide_banner", "-i", path],
            capture_output=True,
            text=True,
            timeout=30,
        )
        import re

        m = re.search(r"Video:.*?(\d{2,5})x(\d{2,5})", proc.stderr)
        if not m:
            raise RuntimeError(f"ffmpeg could not probe video stream in {path}")
        w, h = int(m.group(1)), int(m.group(2))
        fm = re.search(r"([\d.]+)\s*fps", proc.stderr)
        fps = float(fm.group(1)) if fm else None
        return w, h, fps

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[float]]]:
        nbytes = self.width * self.height
        cmd = [
            self._bin,
            "-hide_banner",
            "-loglevel", "error",
            "-i", self._path,
            "-f", "rawvideo",
            "-pix_fmt", "gray",
            "-",
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, bufsize=nbytes * 4
        )
        try:
            i = 0
            while True:
                data = proc.stdout.read(nbytes)
                if len(data) < nbytes:
                    break
                frame = np.frombuffer(data, np.uint8).reshape(self.height, self.width)
                i += 1
                yield frame, 1000.0 * i / self.fps
        finally:
            proc.stdout.close()
            err = proc.stderr.read().decode("utf-8", "replace").strip()
            rc = proc.wait()
            if rc != 0 and err:
                raise RuntimeError(f"ffmpeg decode failed (rc={rc}): {err}")


# ---------------------------------------------------------------------------
# AVI / RIFF container parsing (MJPEG)
# ---------------------------------------------------------------------------


def _riff_chunks(buf: memoryview, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for a RIFF chunk run."""
    off = start
    while off + 8 <= end:
        fourcc = bytes(buf[off : off + 4])
        (size,) = struct.unpack_from("<I", buf, off + 4)
        yield fourcc, off + 8, size
        off += 8 + size + (size & 1)  # chunks are word-aligned


class MJPEGAviSource(VideoSource):
    """Pure-Python AVI (RIFF) parser + PIL JPEG decode for MJPEG streams.

    Covers the reference's VideoCapture contract (fps/size metadata,
    per-frame pos_msec) for motion-JPEG captures with no cv2 or ffmpeg:
    the container walk is ~100 lines of struct unpacking, and each
    '00dc'/'00db' chunk payload is a complete JPEG image decoded with
    PIL.  Grayscale conversion uses PIL's "L" mode (ITU-R 601-2 luma,
    the same transform as the reference's cvtColor BGR2GRAY).
    """

    def __init__(self, path: str):
        self._path = path
        with open(path, "rb") as f:
            data = f.read()
        self._data = data
        buf = memoryview(data)
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise ValueError(f"not an AVI file: {path}")
        self.fps = 30.0
        self.width = self.height = 0
        self._offsets: List[Tuple[int, int]] = []  # (payload_start, size)
        self._walk(buf, 12, len(data))
        if not self._offsets:
            raise ValueError(f"no MJPEG video frames found in {path}")
        self.n_frames = len(self._offsets)

    def _walk(self, buf: memoryview, start: int, end: int):
        for fourcc, payload, size in _riff_chunks(buf, start, end):
            if fourcc == b"LIST":
                kind = bytes(buf[payload : payload + 4])
                if kind in (b"hdrl", b"strl", b"movi", b"INFO"):
                    self._walk(buf, payload + 4, payload + size)
            elif fourcc == b"avih":
                # dwMicroSecPerFrame, ..., dwWidth (off 32), dwHeight (36)
                (usec,) = struct.unpack_from("<I", buf, payload)
                if usec:
                    self.fps = 1e6 / usec
                self.width, self.height = struct.unpack_from("<II", buf, payload + 32)
            elif fourcc == b"strh":
                stype = bytes(buf[payload : payload + 4])
                if stype == b"vids":
                    scale, rate = struct.unpack_from("<II", buf, payload + 20)
                    if scale and rate:
                        self.fps = rate / scale
            elif fourcc[2:] in (b"dc", b"db") and size > 2:
                head = bytes(buf[payload : payload + 2])
                if head == b"\xff\xd8":  # JPEG SOI
                    self._offsets.append((payload, size))

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[float]]]:
        from PIL import Image

        for i, (off, size) in enumerate(self._offsets):
            img = Image.open(io.BytesIO(self._data[off : off + size]))
            if img.mode != "L":
                img = img.convert("L")
            gray = np.asarray(img, dtype=np.uint8)
            yield gray, 1000.0 * (i + 1) / self.fps


def open_codec_source(path: str, fallback_fps: float = 30.0) -> VideoSource:
    """Best cv2-free decoder for a codec file: ffmpeg pipe if a binary
    exists, native MJPEG-AVI parse otherwise; raises if neither fits
    (the caller may then fall back to OpenCVSource)."""
    if ffmpeg_binary() is not None:
        return FFmpegSource(path, fallback_fps=fallback_fps)
    if path.lower().endswith(".avi"):
        return MJPEGAviSource(path)
    raise RuntimeError(
        f"no cv2-free decoder available for {path!r} "
        "(no ffmpeg binary; native parse only covers MJPEG .avi)"
    )
