"""The benchmark's plain reference against the port's CPU path at a small
size: the flow features of each frame, the PC1 waveform and the metric
row.  The port's kernels are bit-equal to its plain versions on the card,
so what holds here holds of the timed path there up to the ROI means'
summation order."""

import numpy as np
import pytest
import torch

from benchmark.lib.render import render_pool
from benchmark.reference import farneback as rf
from benchmark.reference import pc1_metrics as rpm
from benchmark.reference.roi import fill_poly

H, W, N = 96, 128, 121
ROI = [[30, 20], [100, 25], [95, 80], [25, 75]]
THETA = 0.3


@pytest.fixture(scope="module")
def clip():
    return render_pool({"frames": N, "blobs": [{"x_frac": 0.5, "hz": 3.0}], "ax": 8, "ay": 4,
                        "sx": 10, "sy": 8}, 1, H, W, 30.0, 2**31 + 3, "cpu")[0]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_flow_features_match_the_ports_plain_path(clip, precision):
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    frames = torch.as_tensor(clip[:17])
    flow = rf.flow_seq(frames, rf.Params(warp_precision=precision, iter_schedule=[3, 3, 2, 1]))
    ref = rf.roi_features(flow, THETA, [fill_poly(H, W, ROI)])
    ex = torch.tensor([[np.cos(THETA), -np.sin(THETA)]] * 16, dtype=torch.float32)
    ey = torch.tensor([[np.sin(THETA), np.cos(THETA)]] * 16, dtype=torch.float32)
    masks = torch.as_tensor(fill_poly_mask(H, W, np.array(ROI, float))[None])
    feats, _ = roi_body_flow_seq(frames, ex, ey, masks,
                                 FarnebackParams(warp_precision=precision,
                                                 iter_schedule=(3, 3, 2, 1)))
    port = np.stack([f.numpy() for f in feats], 1)
    assert np.abs(port - ref).max() < 1e-6


def test_pc1_and_metric_row_match_the_ports_heads():
    from btcs_pnes_optical_flow_tpu_torch.models.metrics import pc1_metrics
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow

    rng = np.random.default_rng(0)
    t = np.arange(361) / 30.0
    vx = np.sin(2 * np.pi * 3 * t) * np.exp(-0.05 * t) + 0.05 * rng.normal(size=361)
    vy = 0.5 * np.cos(2 * np.pi * 2.9 * t) + 0.05 * rng.normal(size=361)
    vx[0] = vy[0] = np.nan
    ref = rpm.pc1_from_features(vx, vy, {})
    port = pc1_from_flow(torch.tensor(vx, dtype=torch.float32),
                         torch.tensor(vy, dtype=torch.float32)).numpy()
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    assert np.nanmax(np.abs(port - ref)) < 1e-5 * np.nanmax(np.abs(ref))
    row = rpm.metric_row(t, ref)
    got = pc1_metrics(t, ref, device="cpu")
    assert int(got.peak_n) == row["Peak_n"] and int(got.status) == 0
    for c, v in zip(("PC1_area_0_10", "ADS_slope_0_10", "ADS_R2_0_10", "Kendall_tau_0_10"),
                    (got.pc1_area, got.ads_slope, got.ads_r2, got.kendall_tau)):
        assert float(v) == pytest.approx(row[c], rel=1e-4, abs=1e-6), c
