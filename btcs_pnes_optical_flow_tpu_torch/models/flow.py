"""Flow feature extraction: batched Farnebäck + body-axis ROI reduction.

Port of ``btcs_pnes_optical_flow_tpu/models/flow.py`` (reference:
compute_roi_mean_body_flow, optical_flow.py:136-189).  Frame pairs are
the batch axis: a chunk of pairs goes through dense flow, the projection
onto per-pair body axes and the mean over each ROI mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops.farneback import farneback_flow, farneback_flow_seq


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
    each mask (R, H, W); flow is never NaN, so the mean is the nanmean."""
    fx = flow[..., 0]
    fy = flow[..., 1]
    fx_body = fx * ex[:, 0, None, None] + fy * ex[:, 1, None, None]
    fy_body = fx * ey[:, 0, None, None] + fy * ey[:, 1, None, None]
    mag_body = cvx.magnitude(fx_body, fy_body)

    m = roi_masks.to(fx.dtype)  # (R, H, W)
    cnt = torch.clamp(m.sum((-2, -1)), min=1.0)

    def red(z):
        return torch.einsum("bhw,rhw->br", z, m) / cnt[None, :]

    return FlowFeatures(vx=red(fx_body), vy=red(fy_body), mag=red(mag_body))


def roi_body_flow(prev_gray, gray, ex, ey, roi_masks,
                  params: FarnebackParams = FarnebackParams()) -> FlowFeatures:
    """ROI-averaged body-axis flow features of (B, H, W) frame pairs.

    ex, ey: (B, 2) body-axis unit vectors of the current frames;
    roi_masks: (R, H, W) bool.
    """
    return _project_reduce(farneback_flow(prev_gray, gray, params), ex, ey, roi_masks)


def roi_body_flow_seq(frames, ex, ey, roi_masks, params: FarnebackParams = FarnebackParams()):
    """ROI features for the B consecutive pairs of (B+1, H, W) frames.

    The main entry point of the flow stage.  Returns (features, clips);
    clips is a zero (B,) int32 tensor: the direct-sample warp has no
    reach limit, so no pair ever needs a re-run.
    """
    flow = farneback_flow_seq(frames, params)
    clips = torch.zeros((frames.shape[0] - 1,), dtype=torch.int32, device=frames.device)
    return _project_reduce(flow, ex, ey, roi_masks), clips


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
