"""The public names of ``btcs_pnes_optical_flow_tpu/ops/farneback_fused.py``
over the port's Farnebäck engine.

The JAX module is its TPU path: the whole pyramid loop in the banded
Pallas kernels' channel-first layout, each frame's expansion shared by the
two pairs that use it, and per-pair clip counts where the banded warp left
its reach.  The port's level loop (``ops/farneback.py``) already keeps its
kernels' planes channel-first and shares the expansions
(``farneback_flow_seq``), and its warp samples directly, so it never clips.
Here the JAX module's entry points take the same arguments and give the
same results over that loop, with zero clip counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as _fb
from btcs_pnes_optical_flow_tpu_torch.ops.farneback import roi_dispatch_params  # noqa: F401


def fused_supported(params: FarnebackParams) -> bool:
    """The static envelope of the JAX package's fused Pallas kernels
    (polynomial and window radii of at most 8 rows), which decides there
    whether the fused path runs.  The port's kernels have run-time-radius
    instances and take any radius."""
    return params.poly_n <= 8 and params.winsize // 2 <= 8


def _with_clips(flow: torch.Tensor, return_clip: bool):
    """flow, or (flow, zero int32 clip counts, one per pair)."""
    if not return_clip:
        return flow
    return flow, torch.zeros(flow.shape[:-3], dtype=torch.int32, device=flow.device)


def farneback_flow_fused(prev: torch.Tensor, curr: torch.Tensor,
                         params: FarnebackParams = FarnebackParams(),
                         flow0: Optional[torch.Tensor] = None, return_clip: bool = False):
    """Flow of (B, H, W) or (H, W) frame pairs, (B, H, W, 2) or (H, W, 2);
    with ``return_clip`` also the per-pair clip counts, (B,) or (), zero."""
    return _with_clips(_fb.farneback_flow(prev, curr, params, flow0), return_clip)


def farneback_flow_seq(frames: torch.Tensor, params: FarnebackParams = FarnebackParams(),
                       flow0: Optional[torch.Tensor] = None, return_clip: bool = False):
    """Flow of the N consecutive pairs of (N+1, H, W) frames, (N, H, W, 2);
    with ``return_clip`` also the (N,) clip counts, zero."""
    return _with_clips(_fb.farneback_flow_seq(frames, params, flow0), return_clip)
