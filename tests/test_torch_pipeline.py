"""The port's production pipeline (models/pipeline.py) on the CPU against the
JAX package's run_flow_stage / run_full and the cv2/SciPy reference
(tests/reference_impl.py), on tests/test_pipeline.py's synthetic clip."""

import logging

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.config import MetricParams, PipelineConfig
from btcs_pnes_optical_flow_tpu.dataio.checkpoint import ChunkStore
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.dataio.video import ArraySource as JArraySource
from btcs_pnes_optical_flow_tpu.models import pipeline as jpipeline
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource, open_source
from btcs_pnes_optical_flow_tpu_torch.models import pc1 as tpc1
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from tests import reference_impl as ri
from tests.test_pipeline import ROI, make_skeleton, render_clip

torch.set_num_threads(1)
CFG = PipelineConfig(metrics=MetricParams(window_sec=3.0))
TCFG = from_fields(CFG)


@pytest.fixture(scope="module")
def clip():
    return render_clip()


@pytest.fixture(scope="module")
def runs(clip):
    """(port run_full, JAX run_full, reference stage A, skeleton) once per
    module: NaN axes on frames 40-43, chunks of 32 pairs."""
    import cv2

    skel = make_skeleton(len(clip), nan_rows=((40, 44),))
    mine = pipeline.run_full(ArraySource(clip, fps=30.0), Skeleton(*skel), [ROI], TCFG,
                             chunk_pairs=32, device="cpu")
    theirs = jpipeline.run_full(JArraySource(clip, fps=30.0), skel, [ROI], CFG, chunk_pairs=32)
    roi_mask = np.zeros(clip.shape[1:], np.uint8)
    cv2.fillPoly(roi_mask, [ROI.astype(np.int32)], 1)
    ref = ri.ref_flow_stage(clip, skel.time_all, 30.0, skel.ex, skel.ey, roi_mask.astype(bool))
    return mine, theirs, ref, skel


def test_flow_stage_matches_jax_and_reference(runs):
    (res, _, _), (jres, _, _), ref, _ = runs
    assert len(res.frame) == len(jres.frame) == len(ref)
    for got in (jres.skel_idx, ref["skel_idx"].to_numpy()):
        assert np.array_equal(res.skel_idx, got)
    for got in (jres.axes_ok.astype(int), ref["axes_ok"].to_numpy()):
        assert np.array_equal(res.axes_ok.astype(int), got)
    assert np.array_equal(res.t_sec, jres.t_sec)
    np.testing.assert_allclose(res.t_sec, ref["t_sec"].to_numpy(), atol=1e-9)
    for name, col in (("vx", "vx_body"), ("vy", "vy_body"), ("mag", "mag_body")):
        mine, want, refv = getattr(res, name)[:, 0], getattr(jres, name)[:, 0], ref[col].to_numpy()
        assert mine.dtype == want.dtype == np.float64
        assert np.array_equal(np.isnan(mine), np.isnan(want))
        assert np.array_equal(np.isnan(mine), np.isnan(refv))
        fin = np.isfinite(refv)
        # The port's ROI-dispatched flow against JAX's full frames: flows
        # that agree to ~1e-5 px, averaged over the ROI in another order.
        np.testing.assert_allclose(mine[fin], want[fin], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(mine[fin], refv[fin], rtol=1e-3, atol=1e-3)


def test_full_chain_matches_jax_and_reference(runs):
    import scipy.signal

    (res, pc1, mets), (_, jpc1, jmets), ref, _ = runs
    assert pc1.shape == jpc1.shape and pc1.dtype == jpc1.dtype == np.float32
    sos = scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")
    ref_pc1 = ri.ref_dynamic_pc1(
        ref["t_sec"].to_numpy(),
        ri.ref_bandpass_nanrobust(ref["vx_body"].to_numpy(), sos),
        ri.ref_bandpass_nanrobust(ref["vy_body"].to_numpy(), sos))
    fin = np.isfinite(ref_pc1)
    assert np.array_equal(np.isnan(pc1[:, 0]), np.isnan(ref_pc1))
    assert np.corrcoef(pc1[fin, 0], ref_pc1[fin])[0, 1] > 0.999
    np.testing.assert_allclose(pc1[fin, 0], jpc1[fin, 0], rtol=0, atol=1e-5)

    m, jm = mets[0], jmets[0]
    assert int(m.peak_n) == int(jm.peak_n) and int(m.status) == int(jm.status) == 0
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(m, f)), float(getattr(jm, f))
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, rel=1e-4, abs=1e-7), f
    ref_m = ri.ref_metrics(ref["t_sec"].to_numpy(), ref_pc1, window_sec=3.0)
    assert int(m.peak_n) == ref_m["Peak_n"]
    assert float(m.pc1_area) == pytest.approx(ref_m["PC1_area_0_10"], rel=5e-3)


def test_csv_files_match_jax(runs, clip, tmp_path):
    """The CSVs the port writes are byte-equal to what the JAX package's
    writers produce from the same data."""
    _, _, _, skel = runs
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("flow", "pc1", "summary")}
    res, pc1, mets = pipeline.run_full(ArraySource(clip, fps=30.0), Skeleton(*skel), [ROI],
                                       TCFG, chunk_pairs=32, flow_csv=paths["flow"],
                                       pc1_csv=paths["pc1"], summary_csv=paths["summary"],
                                       device="cpu")
    jflow = jpipeline.FlowStageResult(**{f: getattr(res, f) for f in (
        "frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy", "mag")})
    jflow.to_frame(0).to_csv(tmp_path / "j_flow.csv", index=False)
    jcontracts.pc1_frame(res.t_sec, pc1[:, 0]).to_csv(tmp_path / "j_pc1.csv", index=False)
    jcontracts.summary_frame(mets[0], CFG.metrics.window_sec).to_csv(
        tmp_path / "j_summary.csv", index=False)
    for k in paths:
        mine = open(paths[k], "rb").read()
        assert mine == (tmp_path / f"j_{k}.csv").read_bytes(), k
    head = open(paths["summary"]).readline().strip().split(",")
    assert head == jcontracts.SUMMARY_COLUMNS


def test_chunk_size_invariance(clip):
    skel = Skeleton(*make_skeleton(len(clip)))
    a = pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=32,
                                device="cpu")
    b = pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=19,
                                device="cpu")
    fin = np.isfinite(a.vx[:, 0])
    np.testing.assert_allclose(a.vx[fin, 0], b.vx[fin, 0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.mag[fin, 0], b.mag[fin, 0], rtol=1e-6, atol=1e-7)


def test_checkpoint_resume(clip, tmp_path, monkeypatch):
    """A second run over the same store resumes every chunk from disk; a
    store missing one chunk recomputes just that one."""
    skel = Skeleton(*make_skeleton(len(clip), nan_rows=((40, 44),)))
    ck = str(tmp_path / "ck")
    calls = []
    flow_seq = pipeline.roi_body_flow_seq
    monkeypatch.setattr(pipeline, "roi_body_flow_seq",
                        lambda *a: calls.append(1) or flow_seq(*a))

    def run():
        calls.clear()
        res = pipeline.run_flow_stage(ArraySource(clip[:60], fps=30.0), skel, [ROI],
                                      chunk_pairs=16, checkpoint_dir=ck, device="cpu")
        return res, len(calls)

    first, n_first = run()
    assert n_first == 4 and ChunkStore(ck).completed_chunks() == [0, 16, 32, 48]
    again, n_again = run()
    (tmp_path / "ck" / "chunk_00000016.npz").unlink()
    partial, n_partial = run()
    assert (n_again, n_partial) == (0, 1)
    for r in (again, partial):
        for name in ("vx", "vy", "mag", "t_sec", "skel_idx", "axes_ok"):
            assert np.array_equal(getattr(r, name), getattr(first, name), equal_nan=True), name
    with pytest.raises(ValueError):  # a store written with other parameters
        pipeline.run_flow_stage(ArraySource(clip[:60], fps=30.0), skel, [ROI],
                                chunk_pairs=8, checkpoint_dir=ck, device="cpu")


def test_y4m_and_color_sources(tmp_path, clip):
    """Y4M through the port's open_source, and BGR frames through its
    ArraySource with the OpenCV-exact gray conversion."""
    import cv2

    path = tmp_path / "clip.y4m"
    h, w = clip.shape[1:]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for fr in clip[:10]:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            f.write(np.full((h // 2) * (w // 2) * 2, 128, np.uint8).tobytes())
    src = open_source(str(path))
    assert (src.width, src.height, src.fps) == (w, h, 30.0)
    np.testing.assert_array_equal(np.stack([g for g, _ in src.frames()]), clip[:10])

    bgr = np.random.default_rng(0).integers(0, 256, (3, 17, 23, 3), dtype=np.uint8)
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in bgr])
    got = np.stack([g for g, _ in ArraySource(bgr, fps=30.0).frames()])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cvx.bgr2gray_u8(torch.as_tensor(bgr)).numpy(), want)
    assert isinstance(open_source(bgr), ArraySource)


def test_pos_msec_timestamps(clip):
    skel = Skeleton(*make_skeleton(len(clip)))
    pos = 1000.0 * (np.arange(len(clip)) / 30.0) + 7.0  # offset container clock
    src = ArraySource(clip, fps=30.0, pos_msec=pos)
    res = pipeline.run_flow_stage(src, skel, [ROI], chunk_pairs=32, device="cpu")
    np.testing.assert_allclose(res.t_sec, pos / 1000.0, atol=1e-9)


def test_chunk_log_reports_escalation_counters(clip, caplog):
    """The log contract of tests/test_pipeline.py: every chunk line carries
    the escalation counters (0 / 0 on the port, whose warp never clips)."""
    skel = Skeleton(*make_skeleton(len(clip)))
    with caplog.at_level(logging.INFO, logger="btcs_pnes_optical_flow_tpu_torch"):
        pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=32,
                                device="cpu")
    lines = [r.getMessage() for r in caplog.records if "pairs done" in r.getMessage()]
    assert len(lines) == 3
    for line in lines:
        assert "escalated 0 (deep tier) / 0 (exact engine)" in line


def test_entry_points_take_an_explicit_device(clip):
    skel = Skeleton(*make_skeleton(len(clip)))
    with pytest.raises(TypeError):
        pipeline.run_full(ArraySource(clip, fps=30.0), skel, [ROI])
    with pytest.raises(TypeError):
        pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI])


def test_stage_timer_and_trace(tmp_path):
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer, trace

    timer = StageTimer("cpu")
    for _ in range(2):
        with timer.timed("sum", n_items=3):
            torch.ones(1000).sum()
    assert timer.items == {"sum": 6} and timer.times["sum"] > 0
    assert '"items": 6' in timer.report()
    with trace(str(tmp_path / "tr")):
        torch.ones(1000).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_pc1_from_flow_batch_rows_equal_single():
    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.normal(size=(2, 2, 200)).astype(np.float32))
    v[0, 1, 50:60] = float("nan")
    both = tpc1.pc1_from_flow_batch(v[:, 0], v[:, 1])
    assert both.shape == (2, 200)
    for r in range(2):
        torch.testing.assert_close(both[r], tpc1.pc1_from_flow(v[r, 0], v[r, 1]),
                                   rtol=0, atol=0, equal_nan=True)
