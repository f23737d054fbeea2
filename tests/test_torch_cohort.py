"""The port's cohort runner (parallel/), its CSV table, NativeSource and
open_source's fallback on the CPU, against the JAX package and pandas."""

import struct

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams as JFarnebackParams
from btcs_pnes_optical_flow_tpu.config import MetricParams as JMetricParams
from btcs_pnes_optical_flow_tpu.config import PCAParams as JPCAParams
from btcs_pnes_optical_flow_tpu.config import PipelineConfig as JPipelineConfig
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.dataio import video as jvideo
from btcs_pnes_optical_flow_tpu.parallel import cohort as jcohort
from btcs_pnes_optical_flow_tpu.parallel import runner as jrunner
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.dataio import video as tvideo
from btcs_pnes_optical_flow_tpu_torch.dataio.native import NativeSource
from btcs_pnes_optical_flow_tpu_torch.parallel import cohort, mesh
from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem, run_cohort

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROI = np.array([[6.0, 6.0], [58.0, 8.0], [56.0, 42.0], [8.0, 40.0]])
FLOATS = ["PC1_area_0_10", "ADS_slope_0_10", "ADS_R2_0_10", "Kendall_tau_0_10",
          "Kendall_p_0_10"]


def _clips(n_videos, n_frames, h=48, w=64, seed=100):
    """tests/test_parallel.py's cohort: a blob on a texture per video, body
    axes at θ = 0.3 + 0.01·v, and an invalid-axes window in video 3."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for v in range(n_videos):
        r = np.random.default_rng(seed + v)
        t = np.arange(n_frames) / 30.0
        cx = w * 0.5 + 8 * np.sin(2 * np.pi * 2.5 * t + v)
        tex = 20 * np.sin(xx / 4.7) * np.cos(yy / 5.3) + r.normal(0, 3, (h, w))
        clip = np.empty((n_frames, h, w), np.uint8)
        for i in range(n_frames):
            blob = 150 * np.exp(-(((xx - cx[i]) / 6.0) ** 2 + ((yy - h / 2) / 6.0) ** 2))
            clip[i] = np.clip(70 + tex + blob, 0, 255).astype(np.uint8)
        theta = 0.3 + 0.01 * v
        ex = np.tile(np.array([np.cos(theta), -np.sin(theta)]), (n_frames, 1))
        ey = np.tile(np.array([np.sin(theta), np.cos(theta)]), (n_frames, 1))
        if v == 3:
            ex[10:13] = np.nan
            ey[10:13] = np.nan
        out.append((f"v{v}", clip, (t, 30.0, ex, ey)))
    return out


def _items(clips, video_of=lambda c: c):
    return [CohortItem(name, video_of(clip), contracts.Skeleton(*sk), [ROI])
            for name, clip, sk in clips]


def _assert_rows_equal(a, b, rtol=1e-6):
    """tests/test_parallel.py's bar between the cohort's paths (exact
    equality expected)."""
    assert [list(r) for r in a] == [list(r) for r in b]
    for ra, rb in zip(a, b):
        for k, va in ra.items():
            if isinstance(va, float):
                np.testing.assert_allclose(rb[k], va, rtol=rtol, atol=1e-9, equal_nan=True)
            else:
                assert rb[k] == va, k


@pytest.mark.parametrize("n_videos,n_frames,window,chunk", [(8, 33, 10.0, 16), (2, 121, 3.0, 32)])
def test_run_cohort_matches_jax_sequential(n_videos, n_frames, window, chunk):
    clips = _clips(n_videos, n_frames)
    jcfg = JPipelineConfig(metrics=JMetricParams(window_sec=window))
    ref = jrunner.run_cohort([jrunner.CohortItem(n, c, jcontracts.Skeleton(*s), [ROI])
                              for n, c, s in clips], jcfg, chunk_pairs=chunk)
    rows = run_cohort(_items(clips), from_fields(jcfg), chunk_pairs=chunk, device="cpu")
    assert list(rows[0]) == list(ref.columns) == contracts.COHORT_COLUMNS
    assert len(rows) == len(ref) == n_videos
    for row, (_, want) in zip(rows, ref.iterrows()):
        for k in ("video", "roi", "PC1_source", "window_sec", "Peak_n", "status", "error"):
            assert row[k] == want[k], k
        # Metrics of flows that agree to ~1e-5 px, through the float32 heads.
        np.testing.assert_allclose([row[k] for k in FLOATS], want[FLOATS].to_numpy(float),
                                   rtol=2e-3, atol=1e-6, equal_nan=True)
    if window == 3.0:
        assert all(r["status"] == 0 and np.isfinite(r["PC1_area_0_10"]) for r in rows)


def test_batched_path_equals_per_video_path():
    """With a mesh the uniform cohort takes the batched path (full frame,
    host or device-resident clips); its rows equal the per-video path's
    (ROI-dispatched, two flow workers)."""
    clips = _clips(4, 81)
    cfg = from_fields(JPipelineConfig(metrics=JMetricParams(window_sec=2.0)))
    per_video = run_cohort(_items(clips), cfg, chunk_pairs=32, flow_workers=2, device="cpu")
    batched = run_cohort(_items(clips), cfg, chunk_pairs=32, mesh=(CPU,), device="cpu")
    resident = run_cohort(_items(clips, torch.as_tensor), cfg, chunk_pairs=32, mesh=(CPU,),
                          device="cpu")
    assert all(r["status"] == 0 for r in per_video)
    _assert_rows_equal(per_video, batched)
    _assert_rows_equal(per_video, resident)
    with pytest.raises(ValueError):
        run_cohort(_items(clips), cfg, mesh=(torch.device("cuda", 0),), device="cpu")


def test_batched_flow_matches_flow_stage_and_falls_back():
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage

    clips = _clips(4, 21)
    items = _items(clips)
    cfg = from_fields(JPipelineConfig())
    flows = [None] * 4
    assert cohort.cohort_flow_sharded(items, flows, cfg, 8, (CPU,)) == [True] * 4
    for it, f in zip(items, flows):
        ref = run_flow_stage(it.video, it.skeleton, it.roi_polygons, cfg, 8, device="cpu")
        for name in ("frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy", "mag"):
            np.testing.assert_allclose(getattr(f, name), getattr(ref, name), rtol=1e-6,
                                       atol=1e-9, equal_nan=True)
    assert np.isnan(flows[3].vx[10:13]).all() and not flows[3].axes_ok[10:13].any()
    # Mixed or uneven cohorts are left to the per-video path.
    uneven = items[:1] + _items(_clips(1, 17))
    assert cohort.cohort_flow_sharded(uneven, [None] * 2, cfg, 8, (CPU,)) == [False] * 2
    mixed = items[:1] + _items(clips[1:2], torch.as_tensor)
    assert cohort.cohort_flow_sharded(mixed, [None] * 2, cfg, 8, (CPU,)) == [False] * 2


def test_cohort_step_matches_jax(rng):
    v, b, h, w = 3, 3, 40, 48
    prev = rng.integers(0, 255, (v, b, h, w)).astype(np.uint8)
    curr = np.clip(prev.astype(int) + rng.integers(-20, 20, prev.shape), 0, 255).astype(np.uint8)
    theta = rng.normal(size=(v, b))
    ex = np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)
    ey = np.stack([-np.sin(theta), np.cos(theta)], axis=-1).astype(np.float32)
    masks = np.zeros((2, h, w), bool)
    masks[0, 8:32, 8:40] = True
    masks[1, 20:38, 4:20] = True
    t_valid = np.ones((v, b), bool)
    t_valid[1, 2] = False
    params = JFarnebackParams(levels=1, winsize=7, poly_n=5)
    pca = JPCAParams(win_sec=0.1, step_sec=0.05, max_finite_runs=4)
    args = (prev, curr, ex, ey, masks, t_valid)
    ref = jcohort.cohort_step(*(jnp.asarray(a) for a in args), params, pca)
    placed = cohort.shard_cohort_inputs((CPU,), *args)
    out = cohort.cohort_step(*placed, from_fields(params), from_fields(pca), device="cpu")
    for name in ("vx", "vy", "mag", "cohort_mean_mag"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, equal_nan=True)
    assert out.pc1.shape == ref.pc1.shape == (v, 2, b + 1)
    assert np.array_equal(np.isnan(out.pc1.numpy()), np.isnan(np.asarray(ref.pc1)))
    assert torch.isnan(out.vx[1, 2]).all()


def test_cohort_csv_bytes_equal_pandas(tmp_path):
    base = {"video": "v0", "roi": 0, "PC1_source": "pc1_dyn", "window_sec": 10.0,
            "PC1_area_0_10": 1.5, "ADS_slope_0_10": -0.0, "ADS_R2_0_10": 1e-300,
            "Kendall_tau_0_10": 1 / 3, "Kendall_p_0_10": 1e16, "Peak_n": 7, "status": 0,
            "error": ""}
    nan = float("nan")
    rows = [base,
            dict(base, video="v,1", roi=1, PC1_area_0_10=nan, ADS_slope_0_10=nan, ADS_R2_0_10=nan,
                 Kendall_tau_0_10=nan, Kendall_p_0_10=nan, Peak_n=0, status=-1,
                 error='RuntimeError: VideoCapture failed: "a, b"\nnext line'),
            dict(base, video="v2", status=2, Peak_n=0, error="KeyError: 'x'")]
    for k, rs in enumerate([rows, rows[:1], rows[1:2]]):
        contracts.write_cohort_csv(str(tmp_path / f"t{k}.csv"), rs)
        pd.DataFrame(rs).to_csv(tmp_path / f"p{k}.csv", index=False)
        assert (tmp_path / f"t{k}.csv").read_bytes() == (tmp_path / f"p{k}.csv").read_bytes(), k


def test_cohort_runner_isolates_failures(tmp_path):
    from tests.test_pipeline import ROI as PROI
    from tests.test_pipeline import make_skeleton, render_clip

    clip = render_clip(n_frames=60)
    skel = make_skeleton(len(clip))
    cfg = JPipelineConfig(metrics=JMetricParams(window_sec=2.0))
    tskel = contracts.Skeleton(*skel)
    out = str(tmp_path / "cohort.csv")
    rows = run_cohort([CohortItem("good", tvideo.ArraySource(clip, fps=30.0), tskel, [PROI]),
                       CohortItem("bad", "/nonexistent/file.mp4", tskel, [PROI])],
                      from_fields(cfg), chunk_pairs=16, out_csv=out, device="cpu")
    ref = jrunner.run_cohort([jrunner.CohortItem("bad", "/nonexistent/file.mp4", skel, [PROI])],
                             cfg, chunk_pairs=16)
    good, bad = rows
    assert good["error"] == "" and good["status"] == 0
    assert bad["status"] == -1 and bad["error"] == ref["error"].iloc[0] != ""
    assert np.isnan(bad["PC1_area_0_10"]) and bad["Peak_n"] == 0
    back = pd.read_csv(out, keep_default_na=False)
    assert list(back.columns) == contracts.COHORT_COLUMNS and len(back) == 2
    assert back["error"].iloc[1] == bad["error"]


def test_native_source_matches_jax(tmp_path, rng):
    from btcs_pnes_optical_flow_tpu.dataio.native import NativeSource as JNativeSource

    g = rng.integers(0, 256, (12, 32, 40)).astype(np.uint8)
    b = rng.integers(0, 256, (6, 24, 30, 3)).astype(np.uint8)
    for name, arr, fps in (("g", g, 30), ("b", b, 25)):
        p = str(tmp_path / f"{name}.npy")
        np.save(p, arr)
        mine, theirs = NativeSource(p, fps=fps), JNativeSource(p, fps=fps)
        got = np.stack([f for f, _ in mine.frames()])
        want = np.stack([f for f, _ in theirs.frames()])
        np.testing.assert_array_equal(got, want)
        assert (mine.n_frames, mine.height, mine.width, mine.fps) == (
            theirs.n_frames, theirs.height, theirs.width, theirs.fps)
        np.testing.assert_array_equal(mine.read(3), theirs.read(3))
        with pytest.raises(IndexError):
            mine.read(100)
        mine.close()
        theirs.close()
    np.testing.assert_array_equal(np.stack([f for f, _ in NativeSource(str(tmp_path / "g.npy"),
                                                                       fps=30).frames()]), g)
    # The library is built from native/videoio.cpp into build/, not loaded
    # from the prebuilt native/libvideoio.so.
    from btcs_pnes_optical_flow_tpu_torch.dataio import native

    assert native.load_library()._name.startswith(str(native.BUILD_DIR))


def _truncated_avi(path):
    """An MJPEG AVI cut inside its avih header: the RIFF walk reads past
    the end (struct.error)."""
    avih = b"avih" + struct.pack("<I", 56) + b"\x00" * 8
    hdrl = b"LIST" + struct.pack("<I", 4 + len(avih) + 48) + b"hdrl" + avih
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(hdrl)) + b"AVI " + hdrl)


class _Stub:
    def __init__(self, path, fallback_fps=30.0):
        self.path = path


@pytest.mark.parametrize("fault", ["truncated_header", "probe_timeout"])
def test_open_source_falls_back_like_jax(fault, tmp_path, monkeypatch):
    """Every error of the cv2-free decoders falls back to OpenCVSource, in
    both packages: a truncated AVI header with no ffmpeg on PATH
    (struct.error) and an ffmpeg probe that times out."""
    import subprocess

    from btcs_pnes_optical_flow_tpu.dataio import codecs as jcodecs
    from btcs_pnes_optical_flow_tpu_torch.dataio import codecs as tcodecs

    path = str(tmp_path / "clip.avi")
    _truncated_avi(path)
    if fault == "truncated_header":
        monkeypatch.setenv("PATH", str(tmp_path))
        for codecs in (jcodecs, tcodecs):
            assert codecs.ffmpeg_binary() is None
            with pytest.raises(struct.error):
                codecs.MJPEGAviSource(path)
    else:
        def probe(*args, **kwargs):
            raise subprocess.TimeoutExpired("ffmpeg", 30)

        for codecs in (jcodecs, tcodecs):
            monkeypatch.setattr(codecs, "ffmpeg_binary", lambda: "/bin/ffmpeg")
            monkeypatch.setattr(codecs.FFmpegSource, "_probe", staticmethod(probe))
    for video in (jvideo, tvideo):
        monkeypatch.setattr(video, "OpenCVSource", type("OpenCVSource", (_Stub,), {}))
    src_j, src_t = jvideo.open_source(path), tvideo.open_source(path)
    assert type(src_j).__name__ == type(src_t).__name__ == "OpenCVSource"
    assert src_t.path == src_j.path == path


def test_open_source_reads_back_a_tensor_clip(rng):
    clip = rng.integers(0, 256, (3, 8, 10)).astype(np.uint8)
    src = tvideo.open_source(torch.as_tensor(clip), fps=25.0)
    assert isinstance(src, tvideo.ArraySource) and src.fps == 25.0
    np.testing.assert_array_equal(np.stack([f for f, _ in src.frames()]), clip)


def test_entry_points_raise_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):  # more cards than the machine has
        mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cohort(_items(_clips(1, 5)), device="cuda")
