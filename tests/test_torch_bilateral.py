"""BASELINE config 2 on the CPU: bilateral left/right ROIs on one recording
through the port's run_full against the JAX package's run_full and the
cv2/SciPy reference (tests/reference_impl.py), on tests/test_pipeline.py's
synthetic clip; and the JAX contracts' pandas frame helpers."""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

from btcs_pnes_optical_flow_tpu.config import MetricParams, PipelineConfig
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.dataio.video import ArraySource as JArraySource
from btcs_pnes_optical_flow_tpu.models import pipeline as jpipeline
from btcs_pnes_optical_flow_tpu.ops import farneback_fused as jfused
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
from tests import reference_impl as ri
from tests.test_pipeline import make_skeleton, render_clip

torch.set_num_threads(1)
CFG = PipelineConfig(metrics=MetricParams(window_sec=3.0))
TCFG = from_fields(CFG)
# The left and right parts of tests/test_pipeline.py's ROI, on either side
# of the blob's centre (x = 40, swinging ±12 px), with an 8-px gap.
LEFT = np.array([[8.0, 8.0], [36.0, 9.0], [36.0, 55.0], [10.0, 54.0]])
RIGHT = np.array([[44.0, 9.0], [72.0, 10.0], [70.0, 56.0], [44.0, 56.0]])
ROIS = [LEFT, RIGHT]
FEATURES = ("vx", "vy", "mag")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Once per module: the port's run_full with both ROIs (writing its
    three CSVs) and with each ROI alone, JAX's run_full with both, the
    reference flow stage per ROI, the skeleton and the CSV paths.  NaN axes
    on frames 40-43, chunks of 32 pairs."""
    import cv2

    clip = render_clip()
    skel = make_skeleton(len(clip), nan_rows=((40, 44),))
    tmp = tmp_path_factory.mktemp("bilateral")
    paths = {k: str(tmp / f"{k}.csv") for k in ("flow", "pc1", "summary")}

    def port(rois, **csvs):
        return pipeline.run_full(ArraySource(clip, fps=30.0), Skeleton(*skel), rois, TCFG,
                                 chunk_pairs=32, device="cpu", **csvs)

    both = port(ROIS, flow_csv=paths["flow"], pc1_csv=paths["pc1"],
                summary_csv=paths["summary"])
    alone = [port([roi]) for roi in ROIS]
    theirs = jpipeline.run_full(JArraySource(clip, fps=30.0), skel, ROIS, CFG, chunk_pairs=32)
    refs = []
    for roi in ROIS:
        mask = np.zeros(clip.shape[1:], np.uint8)
        cv2.fillPoly(mask, [roi.astype(np.int32)], 1)
        refs.append(ri.ref_flow_stage(clip, skel.time_all, 30.0, skel.ex, skel.ey,
                                      mask.astype(bool)))
    return both, alone, theirs, refs, skel, paths


def test_union_boxes_match_jax():
    """roi_dispatch_params boxes the union of the two masks, as JAX's does,
    and the union box is wider than each ROI's own."""
    h, w = 64, 80
    masks = np.stack([cvx.fill_poly_mask(h, w, roi) for roi in ROIS])
    assert not (masks[0] & masks[1]).any()
    assert not masks[:, :, 37:44].any()  # the gap between the two ROIs
    p = from_fields(CFG.flow)
    mine = fb.roi_dispatch_params(p, h, w, masks).roi_active_px
    want = jfused.roi_dispatch_params(CFG.flow, h, w, masks).roi_active_px
    assert mine == want and len(mine) == p.num_levels(h, w) + 1
    for m in masks:
        own = fb.roi_dispatch_params(p, h, w, m).roi_active_px[0]
        assert mine[0][2] < own[2] or mine[0][3] > own[3]


@pytest.mark.parametrize("roi", [0, 1])
def test_each_roi_matches_jax_and_reference(runs, roi):
    """ROI r's features of the bilateral run against JAX's bilateral run
    and the reference with ROI r's mask, under the one-ROI tolerances of
    tests/test_torch_pipeline.py."""
    (res, _, _), _, (jres, _, _), refs, _, _ = runs
    ref = refs[roi]
    assert res.vx.shape == jres.vx.shape == (96, 2)
    assert np.array_equal(res.t_sec, jres.t_sec)
    assert np.array_equal(res.axes_ok.astype(int), ref["axes_ok"].to_numpy())
    for name, col in zip(FEATURES, ("vx_body", "vy_body", "mag_body")):
        mine, want = getattr(res, name)[:, roi], getattr(jres, name)[:, roi]
        refv = ref[col].to_numpy()
        assert np.array_equal(np.isnan(mine), np.isnan(want))
        assert np.array_equal(np.isnan(mine), np.isnan(refv))
        fin = np.isfinite(refv)
        np.testing.assert_allclose(mine[fin], want[fin], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(mine[fin], refv[fin], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("roi", [0, 1])
def test_each_roi_pc1_and_metrics_match_jax_and_reference(runs, roi):
    import scipy.signal

    (_, pc1, mets), _, (_, jpc1, jmets), refs, _, _ = runs
    ref = refs[roi]
    assert pc1.shape == jpc1.shape == (96, 2) and pc1.dtype == np.float32
    sos = scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")
    ref_pc1 = ri.ref_dynamic_pc1(
        ref["t_sec"].to_numpy(),
        ri.ref_bandpass_nanrobust(ref["vx_body"].to_numpy(), sos),
        ri.ref_bandpass_nanrobust(ref["vy_body"].to_numpy(), sos))
    fin = np.isfinite(ref_pc1)
    assert np.array_equal(np.isnan(pc1[:, roi]), np.isnan(ref_pc1))
    assert np.corrcoef(pc1[fin, roi], ref_pc1[fin])[0, 1] > 0.999
    np.testing.assert_allclose(pc1[fin, roi], jpc1[fin, roi], rtol=0, atol=1e-5)

    assert len(mets) == len(jmets) == 2
    m, jm = mets[roi], jmets[roi]
    assert int(m.peak_n) == int(jm.peak_n) and int(m.status) == int(jm.status) == 0
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(m, f)), float(getattr(jm, f))
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, rel=1e-4, abs=1e-7), f
    ref_m = ri.ref_metrics(ref["t_sec"].to_numpy(), ref_pc1, window_sec=3.0)
    assert int(m.peak_n) == ref_m["Peak_n"]
    assert float(m.pc1_area) == pytest.approx(ref_m["PC1_area_0_10"], rel=5e-3)


@pytest.mark.parametrize("roi", [0, 1])
def test_each_roi_equals_a_run_with_it_alone(runs, roi):
    """ROI r's features and PC1 from the bilateral run are array_equal to a
    run with ROI r alone: inside ROI r both boxed flows equal the
    full-frame flow, and each mask is reduced on its own."""
    (res, pc1, mets), alone, _, _, _, _ = runs
    one, one_pc1, one_mets = alone[roi]
    assert one.vx.shape == (96, 1)
    for name in FEATURES:
        assert np.array_equal(getattr(res, name)[:, roi], getattr(one, name)[:, 0],
                              equal_nan=True), name
    assert np.array_equal(pc1[:, roi], one_pc1[:, 0], equal_nan=True)
    for f, a, b in zip(mets[roi]._fields, mets[roi], one_mets[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), f


def test_the_two_rois_differ(runs):
    """A mix-up of the two masks would fail the per-ROI checks: the blob
    swings into each ROI in turn, so their features differ."""
    (res, pc1, _), _, _, _, _, _ = runs
    for x in (res.vx, res.vy, res.mag, pc1):
        fin = np.isfinite(x[:, 0])
        assert np.abs(x[fin, 0] - x[fin, 1]).max() > 1e-3


def test_csvs_hold_roi_0_as_jax_writes_them(runs, tmp_path):
    """flow.csv, flow_pc1.csv and the summary of a bilateral run hold ROI 0,
    byte-equal to what the JAX package's writers give from the same data."""
    (res, pc1, mets), _, _, _, _, paths = runs
    jflow = jpipeline.FlowStageResult(**{f: getattr(res, f) for f in (
        "frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy", "mag")})
    jflow.to_frame(0).to_csv(tmp_path / "j_flow.csv", index=False)
    jcontracts.pc1_frame(res.t_sec, pc1[:, 0]).to_csv(tmp_path / "j_pc1.csv", index=False)
    jcontracts.summary_frame(mets[0], CFG.metrics.window_sec).to_csv(
        tmp_path / "j_summary.csv", index=False)
    for k, path in paths.items():
        assert open(path, "rb").read() == (tmp_path / f"j_{k}.csv").read_bytes(), k
    got = contracts.read_flow_csv(paths["flow"])
    assert np.array_equal(got["vx_body"], res.vx[:, 0], equal_nan=True)


@pytest.mark.parametrize("roi", [0, 1])
def test_frame_helpers_equal_jax(runs, roi):
    """flow_frame (through FlowStageResult.to_frame), pc1_frame and
    summary_frame equal the JAX contracts' frames: columns, order, dtypes
    and values, NaN rows included."""
    (res, pc1, mets), _, _, _, _, _ = runs
    fields = {f: getattr(res, f) for f in ("frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy",
                                             "mag")}
    mine = res.to_frame(roi)
    want = jpipeline.FlowStageResult(**fields).to_frame(roi)
    assert mine.isna().any().any()  # frame 0 and the NaN-axes frames
    pd.testing.assert_frame_equal(mine, want, check_exact=True)
    pd.testing.assert_frame_equal(
        contracts.flow_frame(res.frame, res.t_sec, res.skel_idx, res.axes_ok.astype(int),
                             res.vx[:, roi], res.vy[:, roi], res.mag[:, roi]), want,
        check_exact=True)
    pd.testing.assert_frame_equal(contracts.pc1_frame(res.t_sec, pc1[:, roi]),
                                  jcontracts.pc1_frame(res.t_sec, pc1[:, roi]), check_exact=True)
    pd.testing.assert_frame_equal(contracts.summary_frame(mets[roi], 3.0, "pc1_dyn"),
                                  jcontracts.summary_frame(mets[roi], 3.0, "pc1_dyn"),
                                  check_exact=True)


def test_frame_helpers_name_pandas_where_it_is_missing(monkeypatch):
    """The module loads without pandas (tests/test_torch_slice.py); the
    helpers then raise ImportError naming pandas."""
    monkeypatch.setitem(sys.modules, "pandas", None)  # `import pandas` raises ImportError
    with pytest.raises(ImportError, match="pandas"):
        contracts.pc1_frame([0.0], [1.0])
    with pytest.raises(ImportError, match="pandas"):
        pipeline.FlowStageResult(*(np.zeros(1),) * 4, *(np.zeros((1, 1)),) * 3).to_frame()
