"""The port's 1080p path on the CPU at a size with its structure: 264×472
(33·8 × 59·8), so the frame has four pyramid levels as 1080×1920 has,
every coarser level takes ``_level_image``'s strided path, and the
coarsest level is odd-sized (33×59; 1080p: 135×240).  A centred ROI of
~15% of the frame boxes levels 0–1 and runs levels 2–3 whole (at 1080p
the bench ROI boxes levels 0–2; a level-2 box needs a frame of ~440×560
or more, since the boxes' halos are fixed pixels).

Against the JAX package: ``run_full`` under the JAX bench's iteration
schedule (3, 3, 2, 1), whose CPU path ignores the ROI boxes and so is the
full-frame reference.  In the port: ROI-dispatched against full-frame
features, and the checkpoint store's crash resume and short-tail resume,
both equal to an uninterrupted run.  The JAX package's ``run_flow_stage``
loads a short tail chunk into a longer run, which the port recomputes."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import render_clip
from btcs_pnes_optical_flow_tpu.config import FarnebackParams, PCAParams, PipelineConfig
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.dataio.video import ArraySource as JArraySource
from btcs_pnes_optical_flow_tpu.models import pipeline as jpipeline
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.dataio.checkpoint import ChunkStore
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource, VideoSource
from btcs_pnes_optical_flow_tpu_torch.models import flow as tflow
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

torch.set_num_threads(1)

H, W, N_FRAMES, THETA = 264, 472, 17, 0.3
# A quadrilateral of ~14% of the frame around its centre.
ROI = np.array([[141.0, 82.0], [331.0, 88.0], [323.0, 182.0], [145.0, 178.0]])
# The JAX bench's flow schedule in fp32; a one-section band-pass and 0.2-s
# PCA windows, so that the 16 samples give a finite PC1 and a metric row.
CFG = PipelineConfig(flow=FarnebackParams(iter_schedule=(3, 3, 2, 1)),
                     pca=PCAParams(bpf_order=1, win_sec=0.2))
TCFG = from_fields(CFG)
FIELDS = ("vx", "vy", "mag", "t_sec", "skel_idx", "axes_ok", "frame")


def _skeleton(n):
    return jcontracts.Skeleton(time_all=np.arange(n) / 30.0, fps=30.0,
                               ex=np.tile([np.cos(THETA), -np.sin(THETA)], (n, 1)),
                               ey=np.tile([np.sin(THETA), np.cos(THETA)], (n, 1)))


@pytest.fixture(scope="module")
def clip():
    return render_clip(N_FRAMES, H, W, seed=1)


@pytest.fixture(scope="module")
def runs(clip):
    skel = _skeleton(N_FRAMES)
    mine = pipeline.run_full(ArraySource(clip, 30.0), Skeleton(*skel), [ROI], TCFG, 8,
                             device="cpu")
    theirs = jpipeline.run_full(JArraySource(clip, fps=30.0), skel, [ROI], CFG, 8)
    return mine, theirs


def test_levels_and_box_split():
    p = fb.roi_dispatch_params(TCFG.flow, H, W, fill_poly_mask(H, W, ROI)[None])
    assert p.num_levels(H, W) == 3
    sizes = [p.level_size(H, W, k) for k in range(4)]
    assert sizes == [(264, 472), (132, 236), (66, 118), (33, 59)]
    assert all(s == (H // 2**k, W // 2**k) for k, s in enumerate(sizes))  # strided path
    boxed = [fb.box_tiles(p.roi_active_px[k], *sizes[k]) is not None for k in range(4)]
    assert boxed == [True, True, False, False]
    assert 0.12 < fill_poly_mask(H, W, ROI).mean() < 0.18


def test_run_full_matches_jax(runs):
    (res, pc1, mets), (jres, jpc1, jmets) = runs
    assert res.vx.shape == (N_FRAMES, 1) and np.array_equal(res.t_sec, jres.t_sec)
    for name in ("vx", "vy", "mag"):
        mine, want = getattr(res, name)[:, 0], getattr(jres, name)[:, 0]
        assert np.array_equal(np.isnan(mine), np.isnan(want)) and np.isnan(mine[0])
        # tests/test_torch_pipeline.py's bars.
        np.testing.assert_allclose(mine[1:], want[1:], rtol=1e-4, atol=1e-6)
    fin = np.isfinite(jpc1[:, 0])
    assert fin.sum() >= 10 and np.array_equal(np.isfinite(pc1[:, 0]), fin)
    assert np.corrcoef(pc1[fin, 0], jpc1[fin, 0])[0, 1] >= 0.9999
    np.testing.assert_allclose(pc1[fin, 0], jpc1[fin, 0], rtol=0, atol=1e-5)
    m, jm = mets[0], jmets[0]
    assert int(m.status) == int(jm.status) == 0 and int(m.peak_n) == int(jm.peak_n)
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(m, f)), float(getattr(jm, f))
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, rel=1e-4, abs=1e-7), f


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_roi_features_equal_full_frame(clip, precision):
    frames = clip[:9]
    mask = fill_poly_mask(H, W, ROI)[None]
    ex = np.tile(np.array([np.cos(THETA), -np.sin(THETA)], np.float32), (8, 1))
    ey = np.tile(np.array([np.sin(THETA), np.cos(THETA)], np.float32), (8, 1))
    full = dataclasses.replace(TCFG.flow, warp_precision=precision)
    boxed = fb.roi_dispatch_params(full, H, W, mask)
    args = tflow.to_device(frames, ex, ey, mask, "cpu")
    a, _ = tflow.roi_body_flow_seq(*args, full)
    b, _ = tflow.roi_body_flow_seq(*args, boxed)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-6


class _Crashing(VideoSource):
    """The clip's frames, raising after the first ``n_ok`` of them."""

    def __init__(self, frames, n_ok):
        self._frames, self._n_ok = frames, n_ok
        self.fps, self.n_frames = 30.0, len(frames)
        self.height, self.width = frames.shape[1:]

    def frames(self):
        for i, f in enumerate(self._frames):
            if i == self._n_ok:
                raise RuntimeError(f"decode failed at frame {i}")
            yield f, None


def _stage(video, ck):
    return pipeline.run_flow_stage(video, Skeleton(*_skeleton(N_FRAMES)), [ROI], TCFG, 4,
                                   checkpoint_dir=ck, device="cpu")


@pytest.fixture(scope="module")
def whole(clip):
    """The flow stage over the whole recording in chunks of 4, no store."""
    return _stage(ArraySource(clip, 30.0), None)


@pytest.fixture()
def counted(monkeypatch):
    """One entry per chunk the flow stage computes (not loaded)."""
    calls = []
    flow_seq = pipeline.roi_body_flow_seq
    monkeypatch.setattr(pipeline, "roi_body_flow_seq",
                        lambda *a: calls.append(1) or flow_seq(*a))
    return calls


def _assert_equal(a, b):
    for name in FIELDS:
        assert np.array_equal(getattr(a, name), getattr(b, name), equal_nan=True), name


def test_crash_resume_equals_uninterrupted(clip, whole, tmp_path, counted):
    """A decode error after 14 frames leaves chunk 0 stored (chunks 4 and 8
    were in flight); the resumed run computes the other 3 of 4 chunks."""
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="decode failed"):
        _stage(_Crashing(clip, 14), ck)
    assert len(counted) == 3 and ChunkStore(ck).completed_chunks() == [0]
    counted.clear()
    _assert_equal(_stage(ArraySource(clip, 30.0), ck), whole)
    assert len(counted) == 3 and ChunkStore(ck).completed_chunks() == [0, 4, 8, 12]


def test_short_tail_resume_equals_uninterrupted(clip, whole, tmp_path, counted, caplog):
    """A recording cut at 14 frames stores a 1-pair tail chunk at 12; a run
    over the whole recording recomputes that chunk (4 pairs there) and
    loads the rest.  The JAX package's run_flow_stage loads the short chunk
    into the whole recording: its features come out shorter than its
    timestamps.  Each package resumes a store of its own writing (the
    port's store also records the flow engine and its settings)."""
    ck = tmp_path / "ck"
    _stage(ArraySource(clip[:14], 30.0), str(ck))
    assert len(ChunkStore(str(ck)).load(12)["vx"]) == 1
    jpipeline.run_flow_stage(JArraySource(clip[:14], fps=30.0), _skeleton(N_FRAMES), [ROI], CFG,
                             4, checkpoint_dir=str(tmp_path / "jax_ck"))
    assert len(ChunkStore(str(tmp_path / "jax_ck")).load(12)["vx"]) == 1
    counted.clear()
    with caplog.at_level("WARNING", logger="btcs_pnes_optical_flow_tpu_torch"):
        resumed = _stage(ArraySource(clip, 30.0), str(ck))
    _assert_equal(resumed, whole)
    assert len(counted) == 1 and len(ChunkStore(str(ck)).load(12)["vx"]) == 4
    assert any("holds 1 pairs, this run 4" in r.getMessage() for r in caplog.records)

    jres = jpipeline.run_flow_stage(JArraySource(clip, fps=30.0), _skeleton(N_FRAMES), [ROI],
                                    CFG, 4, checkpoint_dir=str(tmp_path / "jax_ck"))
    assert len(jres.t_sec) == N_FRAMES and len(jres.vx) == N_FRAMES - 3
