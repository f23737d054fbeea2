"""The port's reference-compatible CLIs (compat/) on the CPU: the
three-script file chain against the JAX package's CLIs on the same clip
(as tests/test_compat.py runs it), the helpers' semantics, and the
pandas-free readers' errors."""

import csv

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.compat import optical_PC1 as jPC1
from btcs_pnes_optical_flow_tpu.compat import optical_PCA as jPCA
from btcs_pnes_optical_flow_tpu.compat import optical_flow as jflow
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu_torch.compat import optical_PC1, optical_PCA, optical_flow
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from tests.test_pipeline import ROI, make_skeleton, render_clip

torch.set_num_threads(1)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _num(rows, col):
    i = rows[0].index(col)
    return np.array([float(r[i]) if r[i] else np.nan for r in rows[1:]])


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both packages' three-script chains on a 96-frame clip (window
    shortened to 3 s through the module constant, as tests/test_compat.py
    does for a short clip); {name: path} per package."""
    tmp = tmp_path_factory.mktemp("compat")
    clip = render_clip(n_frames=96)
    npz, video = str(tmp / "skeleton_pc1.npz"), str(tmp / "clip.npy")
    jcontracts.save_skeleton_npz(npz, make_skeleton(len(clip)))
    np.save(video, clip)
    out = {}
    for tag, flow, pca, pc1, kw in (("jax", jflow, jPCA, jPC1, {}),
                                    ("port", optical_flow, optical_PCA, optical_PC1,
                                     {"device": "cpu"})):
        p = {k: str(tmp / f"{tag}_{k}.csv") for k in ("flow", "pc1", "summary")}
        if tag == "jax":
            flow.run_body_axis_flow_core(video, npz, ROI, p["flow"])
        else:
            flow.main([video, npz, p["flow"], str(ROI.tolist())], **kw)
        pca.main([p["flow"], p["pc1"]], **kw)
        old = pc1.WINDOW_SEC
        pc1.WINDOW_SEC = 3.0
        try:
            pc1.main([p["pc1"], p["summary"]], **kw)
        finally:
            pc1.WINDOW_SEC = old
        out[tag] = p
    out["n"] = len(clip)
    return out


def test_three_script_chain_matches_jax(chains):
    j, t = chains["jax"], chains["port"]
    fj, ft = _rows(j["flow"]), _rows(t["flow"])
    assert ft[0] == fj[0] == contracts.FLOW_COLUMNS and len(ft) == chains["n"] + 1
    for col in ("frame", "t_sec", "skel_idx", "axes_ok"):
        assert [r[ft[0].index(col)] for r in ft] == [r[fj[0].index(col)] for r in fj], col
    for col in ("vx_body", "vy_body", "mag_body"):
        a, b = _num(ft, col), _num(fj, col)
        assert np.isnan(a[0]) and np.array_equal(np.isnan(a), np.isnan(b))
        # tests/test_torch_slice.py's bar: flows that agree to ~1e-5 px,
        # ROI means summed in another order.
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-4, atol=1e-6)

    pj, pt = _rows(j["pc1"]), _rows(t["pc1"])
    assert pt[0] == pj[0] == contracts.PC1_COLUMNS
    a, b = _num(pt, "pc1_dyn"), _num(pj, "pc1_dyn")
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    assert fin.sum() > 0 and np.corrcoef(a[fin], b[fin])[0, 1] >= 0.999

    sj, st = _rows(j["summary"]), _rows(t["summary"])
    assert st[0] == sj[0] == contracts.SUMMARY_COLUMNS
    assert len(st) == 2 and st[1][0] == "pc1_dyn" and st[1][1] == sj[1][1]


def test_pc1_and_summary_clis_on_the_jax_files(chains, tmp_path):
    """Stages B and C of the port on the JAX chain's own input files: the
    same flow.csv gives the same PC1 (both run the sequential scan), and
    the same flow_pc1.csv the same summary."""
    j = chains["jax"]
    pc1 = str(tmp_path / "pc1.csv")
    optical_PCA.main([j["flow"], pc1], device="cpu")
    a, b = _num(_rows(pc1), "pc1_dyn"), _num(_rows(j["pc1"]), "pc1_dyn")
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    assert np.corrcoef(a[fin], b[fin])[0, 1] >= 0.9999
    assert np.abs(a[fin] - b[fin]).max() <= 1e-4 * np.abs(b[fin]).max()
    summary = str(tmp_path / "summary.csv")
    old = optical_PC1.WINDOW_SEC
    optical_PC1.WINDOW_SEC = 3.0
    try:
        optical_PC1.main([j["pc1"], summary], device="cpu")
    finally:
        optical_PC1.WINDOW_SEC = old
    mine, ref = _rows(summary), _rows(j["summary"])
    assert mine[0] == ref[0] and mine[1][:2] == ref[1][:2] and mine[1][7] == ref[1][7]
    # The float32 metric head against the JAX one (tests/test_torch_metrics.py).
    np.testing.assert_allclose([float(v) for v in mine[1][2:7]], [float(v) for v in ref[1][2:7]],
                               rtol=1e-4, atol=1e-7)


def test_compat_helpers_match_reference_semantics(rng):
    kw = {"device": "cpu"}
    assert optical_PC1.ensure_odd(6) == 7 and optical_PC1.ensure_odd(7) == 7
    t = np.arange(120) / 29.97
    assert abs(optical_PC1.estimate_fs_from_time(t, **kw) - 29.97) < 0.05
    assert optical_flow.skel_index_from_time(0.5, np.array([0.0, 0.4, 0.6])) == 1
    assert optical_flow.frame_time_sec(1500.0, 7, 30.0) == 1.5
    assert optical_flow.frame_time_sec(None, 7, 30.0) == pytest.approx(7 / 30)
    np.testing.assert_allclose(optical_PCA.align_axis_to_ref(np.array([0.0, -1.0])), [0.0, 1.0])
    assert optical_PCA.finite_runs(np.array([0, 1, 1, 0, 1], bool)) == [(1, 2), (4, 4)]

    # Each helper against the JAX package's on the same inputs.
    amp = np.abs(np.sin(t * 3)) + 0.1
    amp[5] = np.nan
    assert optical_PC1.safe_auc(amp, t, **kw) == pytest.approx(jPC1.safe_auc(amp, t), rel=1e-5)
    got = optical_PC1.exp_decay_regression(t, np.exp(-0.5 * t), **kw)
    want = jPC1.exp_decay_regression(t, np.exp(-0.5 * t))
    assert got == pytest.approx(want, rel=1e-4)
    x = np.sin(2 * np.pi * 2.0 * t) + 0.2 * rng.normal(size=t.size)
    x[30:34] = np.nan
    np.testing.assert_allclose(optical_PC1.smooth_ma_nan(x, 30.0, 0.2, **kw),
                               jPC1.smooth_ma_nan(x, 30.0, 0.2), rtol=1e-5, atol=1e-6)
    assert np.array_equal(optical_PC1.smooth_ma_nan(x, 30.0, 0.0, **kw), x, equal_nan=True)
    np.testing.assert_allclose(optical_PC1.rolling_p95_positive(x, 30.0, 2.0, **kw),
                               jPC1.rolling_p95_positive(x, 30.0, 2.0), rtol=1e-5)
    for a, b in zip(optical_PC1.detect_cycles_positive_peaks(x, t, 30.0, **kw),
                    jPC1.detect_cycles_positive_peaks(x, t, 30.0)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    sos = optical_PCA.butter_bandpass_sos(0.5, 5.0, 30, 4)
    assert optical_PCA.sos_required_padlen(sos) == jPCA.sos_required_padlen(sos)
    y = np.sin(2 * np.pi * 2.0 * t) + 0.3 * rng.normal(size=t.size)
    np.testing.assert_allclose(optical_PCA.bandpass_nanrobust(y, sos, **kw),
                               jPCA.bandpass_nanrobust(y, sos), rtol=1e-5, atol=1e-5)
    vx, vy = y, 0.5 * y + 0.1 * rng.normal(size=t.size)
    np.testing.assert_allclose(optical_PCA.dynamic_pc1_sliding(t, vx, vy, 2.0, 0.1, **kw),
                               jPCA.dynamic_pc1_sliding(t, vx, vy, 2.0, 0.1), rtol=1e-4, atol=1e-5)
    img = render_clip(n_frames=2)
    mask = optical_flow.build_roi_mask(64, 80, ROI)
    axes = (np.array([1.0, 0.0]), np.array([0.0, 1.0]))
    np.testing.assert_allclose(
        optical_flow.compute_roi_mean_body_flow(img[0], img[1], *axes, mask, **kw),
        jflow.compute_roi_mean_body_flow(img[0], img[1], *axes, mask), rtol=1e-4, atol=1e-6)


def test_readers_raise_the_jax_key_error(tmp_path):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write("t_sec,vx_body\n0.0,1.5\n0.1,\n")
    for reader in ("read_flow_csv", "read_pc1_csv"):
        with pytest.raises(KeyError) as mine:
            getattr(contracts, reader)(path)
        with pytest.raises(KeyError) as theirs:
            getattr(jcontracts, reader)(path)
        assert str(mine.value) == str(theirs.value)
    cols = contracts.read_pc1_csv(path, "vx_body")
    assert cols["t_sec"].dtype == np.float64 and np.isnan(cols["vx_body"][1])


def test_clis_raise_without_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for mod, argv in ((optical_flow, ["v.npy", "s.npz", "o.csv"]), (optical_PCA, []),
                      (optical_PC1, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([str(tmp_path / a) for a in argv])
