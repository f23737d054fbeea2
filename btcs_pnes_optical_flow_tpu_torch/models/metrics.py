"""PC1 metric head: AUC, amplitude-decay slope, Kendall τ.

Port of ``btcs_pnes_optical_flow_tpu/models/metrics.py`` (reference:
optical_PC1.py:234-299), in float32 as the JAX head computes.  The
arrays keep their capacity N with live masks and carry a leading row axis
K.  The two phases stay: the sampling rate of the compacted 0–10 s window
is estimated first (``_estimate_fs_batch``), the host rounds it into the
static smoothing window lengths, then the metrics are computed
(``_pc1_metrics_core_batch``).  ``estimate_fs`` and ``pc1_metrics_core``
are the two phases of one waveform, a batch of one, and ``pc1_metrics``
runs them; ``pc1_metrics_batch`` runs phase 1 once for all rows and phase
2 once per window shape, in row blocks of bounded memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import MetricParams
from btcs_pnes_optical_flow_tpu_torch.ops import peaks, stats
from btcs_pnes_optical_flow_tpu_torch.ops.filters import smooth_window_len

_FIELDS = ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p")
# Elements of phase 2's largest operand, the per-cycle argmax's
# (rows, N-1, N), per block of rows: 2^26 float32 is 256 MiB.
BLOCK_ELEMS = 2 ** 26


class PC1Metrics(NamedTuple):
    pc1_area: torch.Tensor     # AUC of smoothed |PC1| over 0-10 s
    ads_slope: torch.Tensor    # ln-amplitude decay slope
    ads_r2: torch.Tensor
    kendall_tau: torch.Tensor
    kendall_p: torch.Tensor
    peak_n: torch.Tensor       # int32
    status: torch.Tensor       # 0 ok; 1 too few valid; 2 too few in window


def _compact_window(t_all, pc1_all, window_sec, min_valid):
    """Finite-pair compaction + the 0–window_sec re-zeroed window of each
    row (optical_PC1.py:244-261).  Returns (time, pc1, live, count,
    status), the last two (K,)."""
    n = t_all.shape[1]
    nan = torch.full((), float("nan"), dtype=t_all.dtype, device=t_all.device)
    slot = torch.arange(n, device=t_all.device)
    o1, c1 = peaks.compact_index(torch.isfinite(t_all) & torch.isfinite(pc1_all))
    live1 = slot < c1[:, None]
    t_c = torch.where(live1, t_all.gather(1, o1), nan)
    p_c = torch.where(live1, pc1_all.gather(1, o1), nan)

    time = t_c - t_c[:, :1]
    in_win = live1 & (time >= 0.0) & (time <= window_sec)
    o2, c2 = peaks.compact_index(in_win)
    live = slot < c2[:, None]
    time2 = torch.where(live, time.gather(1, o2), nan)
    pc12 = torch.where(live, p_c.gather(1, o2), nan)

    status = torch.where(c1 < min_valid, 1, torch.where(c2 < min_valid, 2, 0)).to(torch.int32)
    return time2, pc12, live, c2, status


def _estimate_fs_batch(t_all: torch.Tensor, pc1_all: torch.Tensor,
                       params: MetricParams = MetricParams()):
    """Phase 1 over (K, N) rows: (K,) sampling rates of the compacted
    0–10 s windows and (K,) statuses, on the rows' device."""
    time, _, live, _, status = _compact_window(
        t_all, pc1_all, params.window_sec, params.min_valid_samples)
    return stats.estimate_fs_masked(time, live), status


def _pc1_metrics_core_batch(t_all: torch.Tensor, pc1_all: torch.Tensor, k_smooth: int,
                            p95_win_n: int, params: MetricParams = MetricParams()) -> PC1Metrics:
    """Phase 2 over (K, N) rows: the three metrics (optical_PC1.py:263-299)
    for the fs-derived odd window lengths ``k_smooth`` and ``p95_win_n``,
    as a PC1Metrics of (K,) tensors."""
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
    iv_live = torch.arange(res.tm.shape[1], device=pc1.device) < res.n_intervals[:, None]
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


def estimate_fs(t_all: torch.Tensor, pc1_all: torch.Tensor,
                params: MetricParams = MetricParams()):
    """Phase 1 of one (N,) waveform (JAX ``models/metrics.py:69``): the
    sampling rate of its compacted 0–10 s window and its status, 0-d
    tensors on its device; the batched phase on a batch of one."""
    fs, status = _estimate_fs_batch(t_all[None], pc1_all[None], params)
    return fs[0], status[0]


def pc1_metrics_core(t_all: torch.Tensor, pc1_all: torch.Tensor, k_smooth: int, p95_win_n: int,
                     params: MetricParams = MetricParams()) -> PC1Metrics:
    """Phase 2 of one (N,) waveform (JAX ``models/metrics.py:78``) for the
    odd window lengths ``k_smooth`` and ``p95_win_n``; the fields are 0-d
    tensors.  The batched core on a batch of one."""
    res = _pc1_metrics_core_batch(t_all[None], pc1_all[None], k_smooth, p95_win_n, params)
    return PC1Metrics(*(v[0] for v in res))


def _window_lens(fs: float, params: MetricParams):
    """The static (k_smooth, p95_win_n) the reference derives from fs."""
    return (smooth_window_len(fs, params.smooth_sec),
            max(3, smooth_window_len(fs, params.p95_win_sec)))


def pc1_metrics(t_all, pc1_all, params: MetricParams = MetricParams(), strict: bool = False,
                *, device) -> PC1Metrics:
    """Metrics of one waveform on ``device`` (two-phase fs handling), as
    a batch of one; the fields are 0-d tensors.

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
    return pc1_metrics_core(t, p, *_window_lens(float(fs), params), params)


def pc1_metrics_batch(t_all, pc1_all, params: MetricParams = MetricParams(), *,
                      device) -> PC1Metrics:
    """(K, N) waveforms → PC1Metrics of (K,) NumPy arrays, equal to K calls
    of :func:`pc1_metrics`.  Rows may be NaN-padded to a common N; padding
    is ignored like trailing invalid samples.

    Phase 1 runs once for all K rows and is read back once.  The rows of
    status 0 are grouped by their window lengths, and phase 2 runs once
    per group in blocks of ``max(1, BLOCK_ELEMS // ((N-1)·N))`` rows, each
    read back once; the results do not depend on the block size.  Rows of
    another status keep NaN fields, ``peak_n`` 0 and their status.
    """
    t = torch.as_tensor(np.asarray(t_all, np.float32), device=device)
    p = torch.as_tensor(np.asarray(pc1_all, np.float32), device=device)
    k, n = t.shape
    fs_b, status_b = _estimate_fs_batch(t, p, params)
    fs_h, status_h = torch.stack([fs_b, status_b.to(fs_b.dtype)]).cpu().numpy()

    out = {f: np.full((k,), np.nan, np.float64) for f in _FIELDS}
    peak_n = np.zeros((k,), np.int64)
    status = status_h.astype(np.int64)
    groups: dict = {}
    for i in np.flatnonzero(status == 0):
        groups.setdefault(_window_lens(float(fs_h[i]), params), []).append(i)
    rows = max(1, BLOCK_ELEMS // max(1, (n - 1) * n))
    for (k_smooth, p95_win_n), idx in groups.items():
        for b in range(0, len(idx), rows):
            sel = np.asarray(idx[b:b + rows])
            sel_t = torch.as_tensor(sel, device=t.device)
            res = _pc1_metrics_core_batch(t[sel_t], p[sel_t], k_smooth, p95_win_n, params)
            host = torch.stack([getattr(res, f) for f in _FIELDS]
                               + [res.peak_n.to(res.pc1_area.dtype),
                                  res.status.to(res.pc1_area.dtype)]).cpu().numpy()
            for j, f in enumerate(_FIELDS):
                out[f][sel] = host[j]
            peak_n[sel] = host[5]
            status[sel] = host[6]
    return PC1Metrics(**out, peak_n=peak_n, status=status)
