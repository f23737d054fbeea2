"""Flow feature extraction: batched dense flow + body-axis ROI reduction.

Port of ``btcs_pnes_optical_flow_tpu/models/flow.py`` (reference:
compute_roi_mean_body_flow, optical_flow.py:136-189).  Frame pairs are
the batch axis: a chunk of pairs goes through dense flow, the projection
onto per-pair body axes and the mean over each ROI mask.  The flow engine
follows the type of ``params``: ``FarnebackParams`` runs Farnebäck, whose
ROI boxes (``params.roi_active_px``) pass through to it; ``TVL1Params``
runs TV-L1 (``ops/tvl1.py tvl1_flow``, BASELINE config 5) over whole
frames, since a variational flow inside a cropped box is not the
full-frame flow there.  The JAX package's flow models run Farnebäck
alone.  JAX's
``roi_body_flow_checked`` is the escalation tier of its banded warp; here
it returns ``roi_body_flow``'s features with zero clip counts, since the
port's warp never clips.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops.farneback import farneback_flow, farneback_flow_seq
from btcs_pnes_optical_flow_tpu_torch.ops.tvl1 import TVL1Params, tvl1_flow


class FlowFeatures(NamedTuple):
    vx: torch.Tensor   # (B, R) mean body-x velocity per ROI
    vy: torch.Tensor   # (B, R)
    mag: torch.Tensor  # (B, R)


def to_device(frames, ex, ey, roi_masks, device):
    """The numpy inputs of the flow entry points as tensors on `device`:
    frames uint8, body axes float32, ROI masks bool."""
    return (
        torch.as_tensor(np.ascontiguousarray(frames, dtype=np.uint8), device=device),
        torch.as_tensor(np.ascontiguousarray(ex, dtype=np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(ey, dtype=np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(roi_masks, dtype=bool), device=device),
    )


def _project_reduce(flow, ex, ey, roi_masks) -> FlowFeatures:
    """Project flow (B, H, W, 2) onto (ex, ey) (B, 2) and average over
    each mask (R, H, W); flow is never NaN, so the mean is the nanmean.

    Each mask is reduced by its own product, so ROI r's features do not
    depend on which other ROIs the call holds: one (B, HW)·(HW, R) product
    sums in an order that changes with R (JAX's einsum does), and the
    features of a bilateral run would then differ in their last bits from
    a run of each ROI alone."""
    fx = flow[..., 0]
    fy = flow[..., 1]
    fx_body = fx * ex[:, 0, None, None] + fy * ex[:, 1, None, None]
    fy_body = fx * ey[:, 0, None, None] + fy * ey[:, 1, None, None]
    mag_body = cvx.magnitude(fx_body, fy_body)

    m = roi_masks.to(fx.dtype)  # (R, H, W)
    cnt = torch.clamp(m.sum((-2, -1)), min=1.0)

    def red(z):
        s = torch.cat([torch.einsum("bhw,rhw->br", z, m[r : r + 1]) for r in range(len(m))], 1)
        return s / cnt[None, :]

    return FlowFeatures(vx=red(fx_body), vy=red(fy_body), mag=red(mag_body))


def _project_reduce_pairs(flow, ex, ey, roi_masks) -> FlowFeatures:
    """``_project_reduce`` pair by pair, each at a batch of one.  The
    batched reduction's summation order depends on the batch size (on the
    CPU and on the card), so a pair's features would move in their last
    bits with the chunk it shares; one shape for every pair keeps them
    the pair's own.  TV-L1's answer is per pair (its ε stop is), so its
    features go through here; Farnebäck keeps the batched reduction."""
    parts = [_project_reduce(flow[i:i + 1], ex[i:i + 1], ey[i:i + 1], roi_masks)
             for i in range(flow.shape[0])]
    return FlowFeatures(*(torch.cat(f) for f in zip(*parts)))


def roi_body_flow(prev_gray, gray, ex, ey, roi_masks,
                  params: FarnebackParams = FarnebackParams()) -> FlowFeatures:
    """ROI-averaged body-axis flow features of (B, H, W) frame pairs.

    ex, ey: (B, 2) body-axis unit vectors of the current frames;
    roi_masks: (R, H, W) bool; ``params``: ``FarnebackParams`` or
    ``TVL1Params``.
    """
    if isinstance(params, TVL1Params):
        return _project_reduce_pairs(tvl1_flow(prev_gray, gray, params), ex, ey, roi_masks)
    return _project_reduce(farneback_flow(prev_gray, gray, params), ex, ey, roi_masks)


def roi_body_flow_seq(frames, ex, ey, roi_masks, params: FarnebackParams = FarnebackParams()):
    """ROI features for the B consecutive pairs of (B+1, H, W) frames.

    The main entry point of the flow stage.  Returns (features, clips);
    clips is a zero (B,) int32 tensor: the direct-sample warp has no
    reach limit, so no pair ever needs a re-run.  With ``TVL1Params`` the
    pairs go through ``tvl1_flow`` as (frames[:-1], frames[1:]) and are
    reduced pair by pair (``_project_reduce_pairs``).
    """
    clips = torch.zeros((frames.shape[0] - 1,), dtype=torch.int32, device=frames.device)
    if isinstance(params, TVL1Params):
        flow = tvl1_flow(frames[:-1], frames[1:], params)
        return _project_reduce_pairs(flow, ex, ey, roi_masks), clips
    flow = farneback_flow_seq(frames, params)
    return _project_reduce(flow, ex, ey, roi_masks), clips


def roi_body_flow_checked(prev_gray, gray, ex, ey, roi_masks,
                          params: FarnebackParams = FarnebackParams()):
    """``roi_body_flow`` with the per-pair clip counts, (features, (B,)
    int32 zeros): JAX's middle escalation tier (``models/flow.py:94``),
    whose fused banded warp counts the pixels it could not reach."""
    clips = torch.zeros(prev_gray.shape[:-2], dtype=torch.int32, device=prev_gray.device)
    return roi_body_flow(prev_gray, gray, ex, ey, roi_masks, params), clips


def frame_times(pos_msec: Optional[np.ndarray], n_frames: int, fps: float) -> np.ndarray:
    """Per-frame timestamps (host): the container timestamp when it is
    positive, else frame_idx/fps (optical_flow.py:110-119)."""
    idx_t = np.arange(n_frames, dtype=np.float64) / float(fps)
    if pos_msec is None:
        return idx_t
    pm = np.asarray(pos_msec, dtype=np.float64)
    return np.where(pm > 0, pm / 1000.0, idx_t)


def skel_indices(t_sec: np.ndarray, time_all: np.ndarray) -> np.ndarray:
    """Causal timestamp → upstream-index map (optical_flow.py:122-133):
    the largest idx with time_all[idx] <= t, clipped to the valid range."""
    idx = np.searchsorted(time_all, t_sec, side="right") - 1
    return np.clip(idx, 0, len(time_all) - 1).astype(np.int64)
