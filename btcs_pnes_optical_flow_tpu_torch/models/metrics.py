"""PC1 metric head: AUC, amplitude-decay slope, Kendall τ.

Port of ``btcs_pnes_optical_flow_tpu/models/metrics.py`` (reference:
optical_PC1.py:234-299), in float32 as the JAX head computes.  The
arrays keep their capacity N with live masks; the two phases stay: the
sampling rate of the compacted 0–10 s window is estimated first, the host
rounds it into the static smoothing window lengths, then the metrics are
computed.  ``pc1_metrics_batch`` runs the rows in a loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import MetricParams
from btcs_pnes_optical_flow_tpu_torch.ops import peaks, stats
from btcs_pnes_optical_flow_tpu_torch.ops.filters import smooth_window_len

_FIELDS = ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p")


class PC1Metrics(NamedTuple):
    pc1_area: torch.Tensor     # AUC of smoothed |PC1| over 0-10 s
    ads_slope: torch.Tensor    # ln-amplitude decay slope
    ads_r2: torch.Tensor
    kendall_tau: torch.Tensor
    kendall_p: torch.Tensor
    peak_n: torch.Tensor       # int32
    status: torch.Tensor       # 0 ok; 1 too few valid; 2 too few in window


def _compact_window(t_all, pc1_all, window_sec, min_valid):
    """Finite-pair compaction + the 0–window_sec re-zeroed window
    (optical_PC1.py:244-261).  Returns (time, pc1, live, count, status)."""
    n = t_all.shape[0]
    nan = torch.full((), float("nan"), dtype=t_all.dtype, device=t_all.device)
    slot = torch.arange(n, device=t_all.device)
    o1, c1 = peaks.compact_index(torch.isfinite(t_all) & torch.isfinite(pc1_all))
    t_c = torch.where(slot < c1, t_all[o1], nan)
    p_c = torch.where(slot < c1, pc1_all[o1], nan)

    time = t_c - t_c[0]
    in_win = (slot < c1) & (time >= 0.0) & (time <= window_sec)
    o2, c2 = peaks.compact_index(in_win)
    time2 = torch.where(slot < c2, time[o2], nan)
    pc12 = torch.where(slot < c2, p_c[o2], nan)

    status = torch.where(c1 < min_valid, 1, torch.where(c2 < min_valid, 2, 0)).to(torch.int32)
    return time2, pc12, slot < c2, c2, status


def estimate_fs(t_all: torch.Tensor, pc1_all: torch.Tensor,
                params: MetricParams = MetricParams()):
    """Phase 1: (sampling rate of the compacted 0–10 s window, status)."""
    time, _, live, _, status = _compact_window(
        t_all, pc1_all, params.window_sec, params.min_valid_samples)
    return stats.estimate_fs_masked(time, live), status


def pc1_metrics_core(t_all: torch.Tensor, pc1_all: torch.Tensor, k_smooth: int,
                     p95_win_n: int, params: MetricParams = MetricParams()) -> PC1Metrics:
    """Phase 2: the three metrics (optical_PC1.py:263-299) for the
    fs-derived odd window lengths ``k_smooth`` and ``p95_win_n``."""
    time, pc1, live, count, status = _compact_window(
        t_all, pc1_all, params.window_sec, params.min_valid_samples)
    bad = status != 0
    nan = torch.full((), float("nan"), dtype=pc1.dtype, device=pc1.device)

    # Metric 1: AUC of the 0.2-s smoothed |PC1|.
    amp = peaks.smooth_ma_nan_dyn(torch.where(live, pc1.abs(), nan), k_smooth, count)
    amp = torch.where(live, amp, nan)
    area = stats.safe_auc_masked(amp, time)

    # Metric 2: amplitude decay slope (ln amp vs t).
    ads_slope, ads_r = stats.exp_decay_regression_masked(time, amp, live)
    ads_r2 = torch.where(torch.isfinite(ads_r), ads_r * ads_r, nan)

    # Metric 3: Kendall τ of the inter-peak intervals.
    res = peaks.detect_cycles_positive_peaks(
        pc1, time, k_smooth, p95_win_n, count,
        peak_min_frac=params.peak_min_frac,
        peak_min_abs=params.peak_min_abs,
        min_dist_sec=params.min_dist_sec,
    )
    iv_live = torch.arange(res.tm.shape[0], device=pc1.device) < res.n_intervals
    tau, p = stats.kendalltau_masked(res.tm, res.T, iv_live)
    enough = res.n_intervals >= params.min_intervals_for_tau
    tau = torch.where(enough, tau, nan)
    p = torch.where(enough, p, nan)

    return PC1Metrics(
        pc1_area=torch.where(bad, nan, area),
        ads_slope=torch.where(bad, nan, ads_slope),
        ads_r2=torch.where(bad, nan, ads_r2),
        kendall_tau=torch.where(bad, nan, tau),
        kendall_p=torch.where(bad, nan, p),
        peak_n=torch.where(bad, torch.zeros_like(res.n_peaks), res.n_peaks),
        status=status,
    )


def pc1_metrics(t_all, pc1_all, params: MetricParams = MetricParams(), strict: bool = False,
                *, device) -> PC1Metrics:
    """Metrics of one waveform on ``device`` (two-phase fs handling).

    With ``strict=True`` raises RuntimeError on too few samples, as the
    reference does (optical_PC1.py:250,261); otherwise returns NaN fields
    with a nonzero status.
    """
    t = torch.as_tensor(t_all, dtype=torch.float32, device=device)
    p = torch.as_tensor(pc1_all, dtype=torch.float32, device=device)
    fs, status = estimate_fs(t, p, params)
    st = int(status)
    if st != 0:
        if strict:
            raise RuntimeError("Too few valid samples in input CSV." if st == 1
                               else "Too few samples in the 0-10 s window.")
        nan = torch.full((), float("nan"), dtype=torch.float32, device=t.device)
        return PC1Metrics(nan, nan, nan, nan, nan,
                          torch.zeros((), dtype=torch.int32, device=t.device), status)
    fs_f = float(fs)
    k_smooth = smooth_window_len(fs_f, params.smooth_sec)
    p95_win_n = max(3, smooth_window_len(fs_f, params.p95_win_sec))
    return pc1_metrics_core(t, p, k_smooth, p95_win_n, params)


def pc1_metrics_batch(t_all, pc1_all, params: MetricParams = MetricParams(), *,
                      device) -> PC1Metrics:
    """(K, N) waveforms → PC1Metrics of (K,) NumPy arrays: K calls of
    :func:`pc1_metrics`.  Rows may be NaN-padded to a common N; padding is
    ignored like trailing invalid samples."""
    t_all = np.asarray(t_all, np.float32)
    pc1_all = np.asarray(pc1_all, np.float32)
    k = t_all.shape[0]
    out = {f: np.full((k,), np.nan, np.float64) for f in _FIELDS}
    peak_n = np.zeros((k,), np.int64)
    status = np.zeros((k,), np.int64)
    for i in range(k):
        res = pc1_metrics(t_all[i], pc1_all[i], params, device=device)
        for f in _FIELDS:
            out[f][i] = float(getattr(res, f))
        peak_n[i] = int(res.peak_n)
        status[i] = int(res.status)
    return PC1Metrics(**out, peak_n=peak_n, status=status)
