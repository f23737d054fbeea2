"""The work the cell's inputs need, counted from shapes, and the card's peaks.

A recording of n frames at (h, w) in chunks of c pairs, under the
configuration's Farnebäck settings, needs at each pyramid level k and
iteration the per-pixel work of each kernel over the pixels that feed its
ROIs' means: the ROI's bounding box widened by iters_at(k) x (winsize // 2)
+ 10 px at level k, halved and widened by 2 px to the next level (the
flow at a pixel depends on a bounded neighbourhood), clipped to the level.
This counts what the inputs need, whatever computes it: a path that runs
whole levels does more work than counted.  A kernel module under
``kernels/`` gives the bytes and float32 operations per pixel of one
launch; the bound of a launch is the larger of bytes over the HBM rate and
operations over the float32 rate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from benchmark.reference.farneback import Params
from benchmark.reference.roi import fill_poly

# NVIDIA H100 SXM (data sheet): HBM3 bandwidth and dense float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


@dataclasses.dataclass
class Level:
    k: int
    size: Tuple[int, int]
    box: Tuple[int, int, int, int]   # half-open (y0, y1, x0, x1) the ROIs need
    iters: int

    @property
    def pixels(self) -> int:
        y0, y1, x0, x1 = self.box
        return (y1 - y0) * (x1 - x0)


@dataclasses.dataclass
class FlowWork:
    """The Farnebäck work of one chunk of ``pairs`` pairs."""

    pairs: int
    levels: List[Level]
    precision: str
    winsize: int


def need_levels(p: Params, h: int, w: int, rois) -> List[Level]:
    masks = np.stack([fill_poly(h, w, r) for r in rois]).any(0)
    ys, xs = np.nonzero(masks)
    need = (int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1)
    out = []
    for k in range(p.num_levels(h, w) + 1):
        hk, wk = p.level_size(h, w, k)
        halo = p.iters_at(k) * (p.winsize // 2) + 10
        box = (need[0] - halo, need[1] + halo, need[2] - halo, need[3] + halo)
        out.append(Level(k, (hk, wk), (max(box[0], 0), min(box[1], hk), max(box[2], 0),
                                      min(box[3], wk)), p.iters_at(k)))
        need = (box[0] // 2 - 2, -(-box[1] // 2) + 2, box[2] // 2 - 2, -(-box[3] // 2) + 2)
    return out


def chunks_of(n_pairs: int, chunk: int) -> List[int]:
    return [min(chunk, n_pairs - s) for s in range(0, n_pairs, chunk)]


def recording_work(flow_cfg: dict, h: int, w: int, rois, n_frames: int,
                   chunk: int) -> List[FlowWork]:
    p = Params(**flow_cfg)
    levels = need_levels(p, h, w, rois)
    return [FlowWork(b, levels, p.warp_precision, p.winsize)
            for b in chunks_of(n_frames - 1, chunk)]


def bound_s(bytes_per_px: float, ops_per_px: float, pixels: float) -> float:
    return max(pixels * bytes_per_px / HBM_BYTES_PER_S, pixels * ops_per_px / FP32_OPS_PER_S)


def kernel_bound_s(kernel, work: List[FlowWork]) -> Tuple[float, int]:
    """(seconds, launches) of a kernel module's bound over the work."""
    total, launches = 0.0, 0
    for chunk in work:
        for lev in chunk.levels:
            for _ in range(lev.iters):
                bpp, opp = kernel.per_pixel(chunk)
                total += bound_s(bpp, opp, lev.pixels * chunk.pairs)
                launches += 1
    return total, launches


def roofline_pct(kernel, work, trace) -> Optional[float]:
    """The kernel's bound over its measured time in the trace, in %; None
    where the trace holds no launch of it."""
    secs, n = trace.kernel_seconds(kernel.PATTERN)
    if not n or secs <= 0:
        return None
    return 100.0 * kernel_bound_s(kernel, work)[0] / secs
