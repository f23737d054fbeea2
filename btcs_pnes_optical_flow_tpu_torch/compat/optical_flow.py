"""Drop-in equivalent of the reference's optical_flow.py entry point.

Same public surface as the reference (FB_PARAMS, open_video,
build_roi_mask, frame_time_sec, skel_index_from_time,
compute_roi_mean_body_flow, run_body_axis_flow_core — see
optical_flow.py:48-288) and as the JAX package's ``compat.optical_flow``,
on the port: the heavy path is the chunked pipeline with the card's
Farnebäck kernels; the per-frame helpers are there for API parity and
small-scale use.

Usage:  python -m btcs_pnes_optical_flow_tpu_torch.compat.optical_flow \\
            <video> <skeleton.npz> <out.csv> [roi polygon]
"""

from __future__ import annotations

import ast
import sys

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.dataio.video import open_source
from btcs_pnes_optical_flow_tpu_torch.models import pipeline as _pipeline
from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow, skel_indices
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device

# Reference FB_PARAMS (optical_flow.py:48-56) in dict form for parity.
FB_PARAMS = dict(
    pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, flags=0
)
# The ROI polygon main() uses when none is given (the JAX CLI's).
DEFAULT_ROI = np.array([[100, 100], [500, 120], [520, 380], [120, 400]], dtype=float)


def fb_params_from_dict(d: dict) -> FarnebackParams:
    return FarnebackParams(
        pyr_scale=d.get("pyr_scale", 0.5),
        levels=d.get("levels", 3),
        winsize=d.get("winsize", 15),
        iterations=d.get("iterations", 3),
        poly_n=d.get("poly_n", 5),
        poly_sigma=d.get("poly_sigma", 1.2),
        gaussian_win=bool(d.get("flags", 0) & 256),
        use_initial_flow=bool(d.get("flags", 0) & 4),
    )


def open_video(video_path: str, fallback_fps: float):
    """(source, fps, W, H) — mirror of optical_flow.py:62-85."""
    src = open_source(video_path, fps=fallback_fps)
    return src, float(src.fps), src.width, src.height


def build_roi_mask(height: int, width: int, roi_polygon_xy: np.ndarray) -> np.ndarray:
    """Polygon → bool mask (cv2.fillPoly-exact; optical_flow.py:88-107)."""
    return fill_poly_mask(height, width, roi_polygon_xy)


def frame_time_sec(pos_msec, frame_idx: int, fps: float) -> float:
    """Timestamp rule of optical_flow.py:110-119."""
    if pos_msec is not None and pos_msec > 0:
        return float(pos_msec) / 1000.0
    return float(frame_idx) / float(fps)


def skel_index_from_time(t_sec: float, time_all: np.ndarray) -> int:
    """Causal time → index map (optical_flow.py:122-133)."""
    return int(skel_indices(np.asarray([t_sec]), time_all)[0])


def compute_roi_mean_body_flow(prev_gray, gray, ex, ey, roi_mask, fb_params=FB_PARAMS, *,
                               device="cuda"):
    """Single-pair flow features (optical_flow.py:136-189) on ``device``."""
    params = fb_params_from_dict(fb_params) if isinstance(fb_params, dict) else fb_params
    dev = resolve_device(device)
    masks = np.asarray(roi_mask, bool)
    feats = roi_body_flow(
        torch.as_tensor(np.asarray(prev_gray)[None], device=dev),
        torch.as_tensor(np.asarray(gray)[None], device=dev),
        torch.as_tensor(np.asarray(ex, np.float32)[None], device=dev),
        torch.as_tensor(np.asarray(ey, np.float32)[None], device=dev),
        torch.as_tensor(masks[None] if masks.ndim == 2 else masks, device=dev),
        params,
    )
    return float(feats.vx[0, 0]), float(feats.vy[0, 0]), float(feats.mag[0, 0])


def run_body_axis_flow_core(video_path, inter_npz, roi_polygon_xy, out_csv, *,
                            device="cuda") -> None:
    """Full stage A: video + NPZ + ROI → flow.csv (optical_flow.py:195-259)."""
    skel = contracts.load_skeleton_npz(inter_npz)
    _pipeline.run_flow_stage(video_path, skel, [np.asarray(roi_polygon_xy)], PipelineConfig(),
                             out_csv=out_csv, device=resolve_device(device))


def main(argv=None, *, device="cuda") -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print(__doc__)
        raise SystemExit(2)
    device = resolve_device(device)
    video_path, inter_npz, out_csv = argv[0], argv[1], argv[2]
    roi = DEFAULT_ROI
    if len(argv) > 3:
        roi = np.asarray(ast.literal_eval(argv[3]), dtype=float)
    run_body_axis_flow_core(video_path, inter_npz, roi, out_csv, device=device)
    print("Saved:", out_csv)


if __name__ == "__main__":
    main()
