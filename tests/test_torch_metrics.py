"""The port's metric head on the CPU against the JAX package and SciPy:
rank statistics and regressions (ops/stats.py), cycle peak detection
(ops/peaks.py) and the PC1 metrics (models/metrics.py), all in float32."""

import numpy as np
import pytest
import scipy.stats
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import MetricParams
from btcs_pnes_optical_flow_tpu.models import metrics as jmetrics
from btcs_pnes_optical_flow_tpu.ops import peaks as jpeaks
from btcs_pnes_optical_flow_tpu.ops import stats as jstats
from btcs_pnes_optical_flow_tpu.ops.filters import smooth_window_len as j_smooth_window_len
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.models import metrics as tmetrics
from btcs_pnes_optical_flow_tpu_torch.ops import peaks as tpeaks
from btcs_pnes_optical_flow_tpu_torch.ops import stats as tstats
from btcs_pnes_optical_flow_tpu_torch.ops.filters import smooth_window_len
from tests import reference_impl as ri

torch.set_num_threads(1)


def _masked(x, cap=40):
    buf = np.zeros(cap, np.float32)
    buf[: len(x)] = x
    m = np.zeros(cap, bool)
    m[: len(x)] = True
    return buf, m


def _pc1_like(n, fs, seed, decay=0.25, f0=3.0, chirp=-0.08):
    """Clonic-like decaying oscillation with slowing frequency (as
    tests/test_peaks.py)."""
    t = np.arange(n) / fs
    x = np.exp(-decay * t) * np.sin(2 * np.pi * (f0 * t + 0.5 * chirp * t * t))
    return t, x + 0.05 * np.random.default_rng(seed).normal(size=n)


def _kendall_case(case):
    rng = np.random.default_rng(0)
    if case.startswith("no_ties_"):
        n = int(case.split("_")[-1])
        x = rng.normal(size=n)
        return x, 0.5 * x + rng.normal(size=n)
    if case == "ties":
        x = np.round(rng.normal(size=15) * 3) / 3
        return x, np.round((0.3 * x + rng.normal(size=15)) * 3) / 3
    if case == "perfect":
        return np.arange(10.0), -np.arange(10.0)
    if case == "large_n":
        x = rng.normal(size=38)
        return x, 0.8 * x + 0.01 * rng.normal(size=38)
    if case == "large_n_near_perfect":  # n > 33, c <= 1: the closed form
        return np.sort(rng.normal(size=36)), np.arange(36.0)
    if case == "all_tied_x":
        return np.ones(8), np.arange(8.0)
    T = np.array([4, 4, 5, 5, 5, 6, 6, 7, 8, 8, 9]) / 30.0  # interval-like ties
    return np.cumsum(T) - T / 2, T


@pytest.mark.parametrize("case", ["no_ties_5", "no_ties_12", "no_ties_33", "ties", "perfect",
                                  "large_n", "large_n_near_perfect", "all_tied_x", "intervals"])
def test_kendalltau_matches_jax_and_scipy(case):
    x, y = _kendall_case(case)
    xb, m = _masked(x)
    yb, _ = _masked(y)
    tau, p = (float(v) for v in tstats.kendalltau_masked(
        torch.as_tensor(xb), torch.as_tensor(yb), torch.as_tensor(m)))
    jtau, jp = (float(v) for v in jstats.kendalltau_masked(
        jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(m)))
    ref = scipy.stats.kendalltau(x, y)
    if case == "all_tied_x":
        assert np.isnan(tau) and np.isnan(p) and np.isnan(jtau) and np.isnan(jp)
        return
    # The same float32 operations; the exact p's DP cumsum and lgamma
    # round in another order than XLA's.
    assert tau == pytest.approx(jtau, abs=1e-6)
    assert p == pytest.approx(jp, rel=1e-4, abs=1e-9)
    # SciPy's bars of tests/test_stats.py.
    assert abs(tau - ref.statistic) < max(1e-5, abs(ref.statistic) * 1e-5)
    assert abs(p - ref.pvalue) < max(1e-5, ref.pvalue * 2e-3)


def test_regressions_match_jax():
    rng = np.random.default_rng(1)
    t = np.arange(60, dtype=np.float32) / 30.0
    amp = (np.exp(-0.4 * t) * (1 + 0.1 * rng.normal(size=60))).astype(np.float32)
    amp[[5, 17]] = np.nan
    amp[9] = -0.1
    m = np.ones(60, bool)
    m[50:] = False
    tt, ta, tm = torch.as_tensor(t), torch.as_tensor(amp), torch.as_tensor(m)
    jt, ja, jm = jnp.asarray(t), jnp.asarray(amp), jnp.asarray(m)
    pairs = [
        (tstats.exp_decay_regression_masked(tt, ta, tm),
         jstats.exp_decay_regression_masked(jt, ja, jm)),
        (tstats.linregress_masked(tt, torch.nan_to_num(ta), tm),
         jstats.linregress_masked(jt, jnp.nan_to_num(ja), jm)),
        ((tstats.safe_auc_masked(ta, tt),), (jstats.safe_auc_masked(ja, jt),)),
        ((tstats.estimate_fs_masked(tt, tm),), (jstats.estimate_fs_masked(jt, jm),)),
        ((tstats.masked_median(ta, tm & torch.isfinite(ta)),),
         (jstats.masked_median(ja, jm & jnp.isfinite(ja)),)),
    ]
    for mine, theirs in pairs:
        for a, b in zip(mine, theirs):
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7)
    # Degenerate inputs: fewer than 2 points, an empty mask.
    none = torch.zeros(60, dtype=torch.bool)
    assert all(np.isnan(float(v)) for v in tstats.linregress_masked(tt, ta, none))
    assert np.isnan(float(tstats.masked_median(ta, none)))
    assert np.isnan(float(tstats.safe_auc_masked(torch.full((5,), float("nan")), tt[:5])))


@pytest.mark.parametrize("case", ["clean", "nangap", "sparse", "padded", "merge"])
def test_detect_cycles_matches_jax(case):
    fs = 30.0
    n, cap = 301, 301
    t, x = _pc1_like(n, fs, seed=2)
    if case == "nangap":
        x[100:130] = np.nan
    elif case == "sparse":
        x[::7] = np.nan
    elif case == "padded":
        cap = 384
    elif case == "merge":  # close double peaks keep the larger
        x = np.zeros(n) - 0.25
        for c, a in [(50, 1.0), (53, 1.4), (100, 1.2), (104, 0.9), (200, 1.0), (260, 1.1)]:
            x += a * np.exp(-0.5 * ((np.arange(n) - c) / 1.5) ** 2)
    buf_p = np.full(cap, np.nan, np.float32)
    buf_t = np.full(cap, np.nan, np.float32)
    buf_p[:n] = x
    buf_t[:n] = t
    k = smooth_window_len(fs, 0.2)
    p95w = max(3, smooth_window_len(fs, 2.0))
    mine = tpeaks.detect_cycles_positive_peaks(torch.as_tensor(buf_p), torch.as_tensor(buf_t),
                                               k, p95w, n)
    ref = jpeaks.detect_cycles_positive_peaks(jnp.asarray(buf_p), jnp.asarray(buf_t), k, p95w, n)
    assert int(mine.n_peaks) == int(ref.n_peaks) > 0
    assert int(mine.n_intervals) == int(ref.n_intervals)
    for name in ("pc1_s", "t_peaks", "tm", "T"):
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], rtol=1e-5, atol=1e-6)
    if case == "clean":  # and the reference's detector
        _, ref_tp, _, ref_T = ri.ref_detect_cycles(x, t, fs)
        np.testing.assert_allclose(mine.t_peaks.numpy()[: int(mine.n_peaks)], ref_tp, atol=1e-5)
        np.testing.assert_allclose(mine.T.numpy()[: int(mine.n_intervals)], ref_T, atol=1e-5)


def test_rolling_p95_and_smoother_match_jax():
    fs = 30.0
    _, x = _pc1_like(301, fs, seed=3)
    x[40:44] = np.nan
    xs = x.astype(np.float32)
    sm = tpeaks.smooth_ma_nan_dyn(torch.as_tensor(xs), 7, 290).numpy()[:290]
    jsm = np.asarray(jpeaks.smooth_ma_nan_dyn(jnp.asarray(xs), 7, 290))[:290]
    np.testing.assert_allclose(sm, jsm, rtol=1e-6, atol=1e-7)
    p95 = tpeaks.rolling_p95_positive(torch.as_tensor(xs), 61, 290).numpy()
    jp95 = np.asarray(jpeaks.rolling_p95_positive(jnp.asarray(xs), 61, 290))
    assert np.array_equal(np.isnan(p95), np.isnan(jp95))
    np.testing.assert_allclose(p95[np.isfinite(jp95)], jp95[np.isfinite(jp95)], rtol=1e-6)


def _waveform(case):
    if case == "fs32":
        t, x = _pc1_like(420, 32.0, seed=4)
    else:
        t, x = _pc1_like(513, 30.0, seed=5)
    if case == "nan_gaps":
        x[60:75] = np.nan
        x[::11] = np.nan
    elif case == "too_few_valid":
        x[5:] = np.nan
    elif case == "too_few_in_window":
        t = t.copy()
        t[6:] += 30.0
    return t, x


@pytest.mark.parametrize("case", ["fs30", "fs32", "nan_gaps", "too_few_valid",
                                  "too_few_in_window"])
def test_pc1_metrics_match_jax(case):
    t, x = _waveform(case)
    params = MetricParams()
    mine = tmetrics.pc1_metrics(t, x, from_fields(params), device="cpu")
    ref = jmetrics.pc1_metrics(t, x, params)
    assert int(mine.status) == int(ref.status)
    assert int(mine.peak_n) == int(ref.peak_n)
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(mine, f)), float(getattr(ref, f))
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, rel=1e-4, abs=1e-7), f
    if case == "fs30":
        assert int(mine.status) == 0 and np.isfinite(float(mine.kendall_tau))
    if case.startswith("too_few"):
        with pytest.raises(RuntimeError):
            tmetrics.pc1_metrics(t, x, from_fields(params), strict=True, device="cpu")


def test_pc1_metrics_batch_matches_jax():
    rows = [_waveform(c) for c in ("fs30", "nan_gaps", "too_few_valid")]
    n = max(len(t) for t, _ in rows)
    t_all = np.full((3, n), np.nan)
    p_all = np.full((3, n), np.nan)
    for i, (t, x) in enumerate(rows):
        t_all[i, : len(t)] = t
        p_all[i, : len(x)] = x
    mine = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    ref = jmetrics.pc1_metrics_batch(t_all, p_all)
    assert np.array_equal(mine.status, ref.status) and np.array_equal(mine.peak_n, ref.peak_n)
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        np.testing.assert_allclose(getattr(mine, f), getattr(ref, f), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("fs,sec", [(30.0, 0.2), (30.0, 2.0), (32.0, 0.2), (25.0, 0.1),
                                    (29.97, 2.0), (12.5, 0.2)])
def test_smooth_window_len_matches_jax(fs, sec):
    assert smooth_window_len(fs, sec) == j_smooth_window_len(fs, sec)
