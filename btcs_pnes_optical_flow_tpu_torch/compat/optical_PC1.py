"""Drop-in equivalent of the reference's optical_PC1.py entry point.

Same public surface (ensure_odd, smooth_ma_nan, rolling_p95_positive,
detect_cycles_positive_peaks — optical_PC1.py:47-228) as the JAX
package's ``compat.optical_PC1``, plus working implementations of the
three functions the published script calls but never defines
(estimate_fs_from_time, safe_auc, exp_decay_regression;
optical_PC1.py:263,267,270 — specified in SURVEY.md §2.4), so this entry
point runs, which the reference as published does not.  Backed by the
port's metric ops on ``device``.

Usage:  python -m btcs_pnes_optical_flow_tpu_torch.compat.optical_PC1 \\
            [flow_pc1.csv] [flow_summary_dyn_core.csv]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import MetricParams
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.models.metrics import pc1_metrics
from btcs_pnes_optical_flow_tpu_torch.ops import peaks as _peaks
from btcs_pnes_optical_flow_tpu_torch.ops import stats as _stats
from btcs_pnes_optical_flow_tpu_torch.ops.filters import ensure_odd, smooth_window_len  # noqa: F401
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device

IN_CSV = "flow_pc1.csv"
OUT_CSV = "flow_summary_dyn_core.csv"
PC1_COL = "pc1_dyn"
WINDOW_SEC = 10.0
SMOOTH_SEC = 0.20
PEAK_MIN_FRAC = 0.20
PEAK_MIN_ABS = 0.0
MIN_DIST_SEC = 0.2

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, float), dtype=torch.float32,
                           device=resolve_device(device))


def estimate_fs_from_time(time, *, device="cuda") -> float:
    """Sampling rate from timestamps: 1/median(Δt) (robust to jitter)."""
    t = _f32(time, device)
    return float(_stats.estimate_fs_masked(t, torch.isfinite(t)))


def safe_auc(amp, time, *, device="cuda") -> float:
    """NaN-robust trapezoidal integral of amp(t)."""
    return float(_stats.safe_auc_masked(_f32(amp, device), _f32(time, device)))


def exp_decay_regression(time, amp, *, device="cuda") -> dict:
    """ln(amp)-vs-time regression → {'slope', 'r'} (linregress fields)."""
    t = _f32(time, device)
    slope, r = _stats.exp_decay_regression_masked(t, _f32(amp, device),
                                                  torch.ones(t.shape, dtype=torch.bool,
                                                             device=t.device))
    return {"slope": float(slope), "r": float(r)}


def smooth_ma_nan(x, fs: float, sec: float, *, device="cuda"):
    """NaN-tolerant moving average (optical_PC1.py:55-76)."""
    x = np.asarray(x, float)
    if sec <= 0:
        return x.copy()
    k = smooth_window_len(fs, sec)
    return _peaks.smooth_ma_nan_dyn(_f32(x, device), k, len(x)).cpu().numpy().astype(float)


def rolling_p95_positive(pc1_s, fs: float, win_sec: float, *, device="cuda"):
    """Rolling positive 95th percentile (optical_PC1.py:79-118)."""
    x = np.asarray(pc1_s, float)
    win_n = max(3, ensure_odd(int(round(win_sec * fs))))
    return _peaks.rolling_p95_positive(_f32(x, device), win_n, len(x)).cpu().numpy().astype(float)


def detect_cycles_positive_peaks(
    pc1, time_sec, fs, smooth_sec=0.20, p95_win_sec=2.0,
    peak_min_frac=0.20, peak_min_abs=0.0, min_dist_sec=0.2, *, device="cuda",
):
    """Cycle/peak detection (optical_PC1.py:121-228) on the port's ops."""
    pc1 = np.asarray(pc1, float)
    k = smooth_window_len(fs, smooth_sec)
    p95w = max(3, ensure_odd(int(round(p95_win_sec * fs))))
    res = _peaks.detect_cycles_positive_peaks(
        _f32(pc1, device), _f32(time_sec, device), k, p95w, len(pc1),
        peak_min_frac=peak_min_frac, peak_min_abs=peak_min_abs, min_dist_sec=min_dist_sec,
    )
    n_p = int(res.n_peaks)
    n_i = int(res.n_intervals)
    return (
        res.pc1_s.cpu().numpy().astype(float),
        res.t_peaks.cpu().numpy().astype(float)[:n_p],
        res.tm.cpu().numpy().astype(float)[:n_i],
        res.T.cpu().numpy().astype(float)[:n_i],
    )


def main(argv=None, *, device="cuda") -> None:
    argv = argv if argv is not None else sys.argv[1:]
    device = resolve_device(device)
    in_csv = argv[0] if len(argv) > 0 else IN_CSV
    out_csv = argv[1] if len(argv) > 1 else OUT_CSV

    cols = contracts.read_pc1_csv(in_csv, PC1_COL)
    params = MetricParams(
        window_sec=WINDOW_SEC, smooth_sec=SMOOTH_SEC, peak_min_frac=PEAK_MIN_FRAC,
        peak_min_abs=PEAK_MIN_ABS, min_dist_sec=MIN_DIST_SEC,
    )
    mets = pc1_metrics(cols["t_sec"].astype(float), cols[PC1_COL].astype(float), params,
                       strict=True, device=device)
    contracts.write_summary_csv(out_csv, mets, WINDOW_SEC, PC1_COL)


if __name__ == "__main__":
    main()
