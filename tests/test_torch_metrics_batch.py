"""The port's batched metric head on the CPU: ``pc1_metrics_batch`` and its
two phases against the JAX package's ``pc1_metrics_batch``,
``_estimate_fs_batch`` and ``_pc1_metrics_core_batch`` and against K calls
of the port's own ``pc1_metrics``; the batched peaks and stats functions
against their 1-D forms row by row; the row blocks of bounded memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.config import MetricParams
from btcs_pnes_optical_flow_tpu.models import metrics as jmetrics
from btcs_pnes_optical_flow_tpu.ops import stats as jstats
from btcs_pnes_optical_flow_tpu_torch.models import metrics as tmetrics
from btcs_pnes_optical_flow_tpu_torch.ops import peaks as tpeaks
from btcs_pnes_optical_flow_tpu_torch.ops import stats as tstats
from tests.test_torch_metrics import _kendall_case, _masked, _pc1_like, _waveform

torch.set_num_threads(1)

_FLOATS = ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p")


def _warped(period, jitter, seed, n=310):
    """A decaying oscillation of ``period`` samples whose time stamps run
    on a quadratic clock (strictly growing steps, median ~1/30 s), so its
    inter-peak intervals never tie: with no jitter every interval is
    longer than the last (τ = 1, c = 0) and there are more than 33; with a
    smooth phase jitter the order is mixed and there are fewer."""
    s = np.arange(n)
    t = s / 30.0 + 1e-5 * (s * s - n * s)
    phase = s / period + jitter * np.sin(2 * np.pi * s / 53.0 + seed)
    return t, np.exp(-0.05 * t) * np.sin(2 * np.pi * phase)


# Row name → waveform; the kendall branch each status-0 row takes.
ROWS = {
    "fs30": _waveform("fs30"),                            # tied intervals: asymptotic p
    "fs32": _waveform("fs32"),                            # the second window shape
    "nan_gaps": _waveform("nan_gaps"),
    "too_few_valid": _waveform("too_few_valid"),          # status 1
    "too_few_in_window": _waveform("too_few_in_window"),  # status 2
    "monotone_35": _warped(8, 0.0, 0),                    # n = 35 > 33, c = 0: closed form
    "mixed_23": _warped(12, 0.25, 1),                     # no ties, n = 23: exact DP
    "fs30_seed7": _pc1_like(513, 30.0, seed=7),
}


def _batch():
    n = max(len(t) for t, _ in ROWS.values())
    t_all = np.full((len(ROWS), n), np.nan)
    p_all = np.full((len(ROWS), n), np.nan)
    for i, (t, x) in enumerate(ROWS.values()):
        t_all[i, : len(t)] = t
        p_all[i, : len(x)] = x
    return t_all, p_all


def _assert_close(mine, ref, rtol, atol=0.0):
    assert np.array_equal(np.asarray(mine.status), np.asarray(ref.status))
    assert np.array_equal(np.asarray(mine.peak_n), np.asarray(ref.peak_n))
    for f in _FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(mine, f), np.float64),
                                   np.asarray(getattr(ref, f), np.float64),
                                   rtol=rtol, atol=atol, err_msg=f)


def test_batch_covers_every_branch():
    """The batch holds both window shapes, both failure statuses and the
    three p branches (asymptotic, exact DP, closed form)."""
    t_all, p_all = _batch()
    mine = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    names = list(ROWS)
    assert list(mine.status) == [0, 0, 0, 1, 2, 0, 0, 0]
    t, p = (torch.as_tensor(a, dtype=torch.float32) for a in (t_all, p_all))
    fs, _ = tmetrics._estimate_fs_batch(t, p)
    shapes = {tmetrics._window_lens(float(fs[i]), MetricParams()) for i in (0, 1)}
    assert len(shapes) == 2
    assert mine.peak_n[names.index("monotone_35")] == 36
    assert mine.kendall_tau[names.index("monotone_35")] == 1.0
    assert mine.peak_n[names.index("mixed_23")] == 24
    assert np.all(np.isfinite(mine.kendall_p[mine.status == 0]))


def test_batch_matches_jax_batch():
    t_all, p_all = _batch()
    mine = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    ref = jmetrics.pc1_metrics_batch(t_all, p_all)
    _assert_close(mine, ref, rtol=1e-4, atol=1e-7)


def test_phases_match_jax_phases():
    t_all, p_all = (a.astype(np.float32) for a in _batch())
    params = MetricParams()
    fs, st = tmetrics._estimate_fs_batch(torch.as_tensor(t_all), torch.as_tensor(p_all))
    jfs, jst = jmetrics._estimate_fs_batch(jnp.asarray(t_all), jnp.asarray(p_all), params)
    assert np.array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=1e-6)
    # Phase 2 over every row at the fs = 30 shape, failed rows included.
    k_smooth, p95_win_n = tmetrics._window_lens(float(fs[0]), params)
    mine = tmetrics._pc1_metrics_core_batch(torch.as_tensor(t_all), torch.as_tensor(p_all),
                                            k_smooth, p95_win_n)
    ref = jmetrics._pc1_metrics_core_batch(jnp.asarray(t_all), jnp.asarray(p_all),
                                           k_smooth, p95_win_n, params)
    _assert_close(mine, jax.tree.map(np.asarray, ref), rtol=1e-4, atol=1e-7)


def test_batch_matches_row_calls():
    t_all, p_all = _batch()
    mine = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    rows = [tmetrics.pc1_metrics(t, p, device="cpu") for t, p in zip(t_all, p_all)]
    ref = tmetrics.PC1Metrics(*(np.array([float(getattr(r, f)) for r in rows])
                                for f in tmetrics.PC1Metrics._fields))
    _assert_close(mine, ref, rtol=1e-6)


@pytest.mark.parametrize("rows_per_block", [1, 3, None])
def test_blocks_do_not_change_results(rows_per_block, monkeypatch):
    """1, 3 and all rows per block give equal results; each block runs
    phase 2 once and reads the device back twice (the peak merge and the
    fields), phase 1 once in all: no count grows with the rows of a
    block, and no scalar is read back."""
    t_all, p_all = _batch()
    whole = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    n = t_all.shape[1]
    budget = 2 ** 40 if rows_per_block is None else rows_per_block * (n - 1) * n
    calls, reads = [], []
    core = tmetrics._pc1_metrics_core_batch
    cpu = torch.Tensor.cpu

    def scalar_read(*_):
        raise AssertionError("a device scalar was read back")

    monkeypatch.setattr(tmetrics, "_pc1_metrics_core_batch",
                        lambda t, *a: calls.append(t.shape[0]) or core(t, *a))
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a: reads.append(1) or cpu(self, *a))
    for name in ("item", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, scalar_read)
    monkeypatch.setattr(tmetrics, "BLOCK_ELEMS", budget)
    blocked = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    monkeypatch.undo()
    for f in tmetrics.PC1Metrics._fields:
        assert np.array_equal(getattr(blocked, f), getattr(whole, f), equal_nan=True), f
    # The fs = 30 group holds 5 rows, the fs = 32 group 1.
    want = {1: [1] * 6, 3: [3, 2, 1], None: [5, 1]}[rows_per_block]
    assert calls == want
    assert len(reads) == 1 + 2 * len(want)


def test_batch_never_calls_row_path(monkeypatch):
    def row(*_, **__):
        raise AssertionError("pc1_metrics_batch called pc1_metrics")

    monkeypatch.setattr(tmetrics, "pc1_metrics", row)
    t_all, p_all = _batch()
    res = tmetrics.pc1_metrics_batch(t_all, p_all, device="cpu")
    assert res.status.shape == (len(ROWS),)


def _rows_vs_1d(batched, one_d, k):
    """Each output of a batched call against the 1-D call on row i."""
    for i in range(k):
        for b, r in zip(batched, one_d(i)):
            np.testing.assert_allclose(b[i].numpy(), r.numpy(), rtol=1e-6, atol=0)


def test_batched_peaks_match_1d_rows():
    rng = np.random.default_rng(3)
    k, n = 5, 301
    counts = torch.tensor([301, 290, 150, 7, 0])
    x = np.stack([_pc1_like(n, 30.0, seed=s)[1] for s in range(k)]).astype(np.float32)
    x[1, 40:44] = np.nan
    x[2, rng.random(n) < 0.1] = np.nan
    xt = torch.as_tensor(x)
    mask = torch.as_tensor(rng.random((k, n)) < 0.4)
    idx, cnt = tpeaks.compact_index(mask)
    for i in range(k):
        ri, rc = tpeaks.compact_index(mask[i])
        assert torch.equal(idx[i], ri) and torch.equal(cnt[i], rc)
    _rows_vs_1d((tpeaks.uniform_filter1d_nearest_dyn(torch.nan_to_num(xt), 7, counts),),
                lambda i: (tpeaks.uniform_filter1d_nearest_dyn(torch.nan_to_num(xt[i]), 7,
                                                              counts[i]),), k)
    _rows_vs_1d((tpeaks.smooth_ma_nan_dyn(xt, 7, counts),
                 tpeaks.rolling_p95_positive(xt, 61, counts)),
                lambda i: (tpeaks.smooth_ma_nan_dyn(xt[i], 7, counts[i]),
                           tpeaks.rolling_p95_positive(xt[i], 61, counts[i])), k)
    t = torch.arange(n, dtype=torch.float32)[None].expand(k, n) / 30.0
    res = tpeaks.detect_cycles_positive_peaks(xt, t, 7, 61, counts)
    for i in range(k):
        ref = tpeaks.detect_cycles_positive_peaks(xt[i], t[i], 7, 61, counts[i])
        for f in ref._fields:
            assert torch.equal(getattr(res, f)[i].nan_to_num(-7.0),
                               getattr(ref, f).nan_to_num(-7.0)), f
    assert res.n_peaks[0] > 0 and res.n_peaks[4] == 0


def test_batched_stats_match_1d_rows_and_jax():
    rng = np.random.default_rng(1)
    k, n = 4, 60
    t = np.tile(np.arange(n, dtype=np.float32) / 30.0, (k, 1))
    amp = (np.exp(-0.4 * t) * (1 + 0.1 * rng.normal(size=(k, n)))).astype(np.float32)
    amp[0, [5, 17]] = np.nan
    amp[1, 9] = -0.1
    m = np.ones((k, n), bool)
    m[1, 50:] = False
    m[2, 1:] = False  # one sample: the degenerate cases
    m[3, :] = False
    tt, ta, tm = torch.as_tensor(t), torch.as_tensor(amp), torch.as_tensor(m)
    clean = torch.nan_to_num(ta)
    _rows_vs_1d(tstats.exp_decay_regression_masked(tt, ta, tm)
                + tstats.linregress_masked(tt, clean, tm)
                + (tstats.safe_auc_masked(ta, tt), tstats.estimate_fs_masked(tt, tm),
                   tstats.masked_median(ta, tm & torch.isfinite(ta))),
                lambda i: tstats.exp_decay_regression_masked(tt[i], ta[i], tm[i])
                + tstats.linregress_masked(tt[i], clean[i], tm[i])
                + (tstats.safe_auc_masked(ta[i], tt[i]), tstats.estimate_fs_masked(tt[i], tm[i]),
                   tstats.masked_median(ta[i], tm[i] & torch.isfinite(ta[i]))), k)

    # Kendall τ over every case of test_torch_metrics.py at once: the
    # exact DP, ties, the closed form past n = 33, a degenerate series.
    cases = ["no_ties_5", "no_ties_12", "no_ties_33", "ties", "perfect", "large_n",
             "large_n_near_perfect", "all_tied_x", "intervals"]
    pairs = [_kendall_case(c) for c in cases]
    xb = np.stack([_masked(x)[0] for x, _ in pairs])
    yb = np.stack([_masked(y)[0] for _, y in pairs])
    mb = np.stack([_masked(x)[1] for x, _ in pairs])
    tau, p = tstats.kendalltau_masked(*(torch.as_tensor(a) for a in (xb, yb, mb)))
    _rows_vs_1d((tau, p), lambda i: tstats.kendalltau_masked(
        torch.as_tensor(xb[i]), torch.as_tensor(yb[i]), torch.as_tensor(mb[i])), len(cases))
    jtau, jp = jax.vmap(jstats.kendalltau_masked)(jnp.asarray(xb), jnp.asarray(yb),
                                                  jnp.asarray(mb))
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-9)
