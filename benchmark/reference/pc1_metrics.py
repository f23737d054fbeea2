"""Plain NumPy/SciPy reference of the PC1 head and the metric head.

The reference scripts' behaviour in float64: the NaN-robust zero-phase
Butterworth band-pass of each finite run (optical_PCA.py:96-121), the
sliding-window PCA with its sign stabilisation and nearest-centre axis
choice (optical_PCA.py:136-235), and the metric row of the 0-10 s window
(optical_PC1.py:234-299: AUC of the smoothed |PC1|, the ln-amplitude decay
slope and its R^2, Kendall tau of the inter-peak intervals, the peak
count), with the three helpers the reference script calls but never
defines written as the port's contract states them (1 / median sample
interval, a trapezoid integral over finite runs, ``linregress`` of ln amp).
Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import scipy.signal
import scipy.stats

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def bandpass_sos(low_hz=0.5, high_hz=5.0, fs=30.0, order=4):
    return scipy.signal.butter(order, [low_hz, high_hz], btype="band", fs=fs, output="sos")


def bandpass_nanrobust(x, sos):
    """Zero-phase band-pass of each finite run; runs shorter than the
    filter's pad + 1 stay NaN."""
    x = np.asarray(x, float)
    y = np.full_like(x, np.nan)
    padreq = 3 * (2 * sos.shape[0])
    idx = np.flatnonzero(np.isfinite(x))
    if idx.size == 0:
        return y
    gap = np.where(np.diff(idx) > 1)[0]
    for s, e in zip(np.r_[idx[0], idx[gap + 1]], np.r_[idx[gap], idx[-1]]):
        seg = x[s:e + 1]
        if seg.size < padreq + 1:
            continue
        pad = min(padreq, int(seg.size // 2 - 1))
        y[s:e + 1] = seg if pad <= 0 else scipy.signal.sosfiltfilt(sos, seg, padlen=pad)
    return y


def dynamic_pc1(vx, vy, win_sec=2.0, step_sec=0.1, fs=30.0, ref=(0.0, 1.0)):
    """Sliding-window PCA -> the PC1 waveform."""
    vx, vy = np.asarray(vx, float), np.asarray(vy, float)
    ref = np.asarray(ref, float)
    n = vx.size
    out = np.full(n, np.nan)
    win_n = max(3, int(round(win_sec * fs)))
    step_n = max(1, int(round(step_sec * fs)))
    centers, ws, prev = [], [], None
    for start in range(0, n - win_n + 1, step_n):
        end = start + win_n
        sx, sy = vx[start:end], vy[start:end]
        m = np.isfinite(sx) & np.isfinite(sy)
        if m.sum() < 3:
            continue
        xy = np.column_stack([sx[m], sy[m]])
        vals, vecs = np.linalg.eigh(np.cov(xy - xy.mean(axis=0), rowvar=False))
        w = vecs[:, int(np.argmax(vals))]
        if np.all(np.isfinite(w)) and float(w @ ref) < 0:
            w = -w
        if prev is not None and float(w @ prev) < 0:
            w = -w
        prev = w.copy()
        centers.append((start + end - 1) // 2)
        ws.append(w)
    if not centers:
        return out
    centers, ws = np.asarray(centers), np.vstack(ws)
    i = np.arange(n)
    j = np.clip(np.searchsorted(centers, i, side="left"), 0, len(centers) - 1)
    j2 = np.maximum(j - 1, 0)
    pick = np.where(np.abs(i - centers[j2]) < np.abs(i - centers[j]), j2, j)
    e = ws[pick]
    ok = np.isfinite(vx) & np.isfinite(vy) & np.isfinite(e).all(axis=1)
    out[ok] = vx[ok] * e[ok, 0] + vy[ok] * e[ok, 1]
    return out


def pc1_from_features(vx, vy, pca: dict):
    """PC1 of one ROI's (vx, vy) series under the configuration's ``pca``
    settings (band 0.5-5 Hz, order 4, fs 30, 2-s windows every 0.1 s)."""
    fs = pca.get("fs", 30.0)
    sos = bandpass_sos(pca.get("bpf_low_hz", 0.5), pca.get("bpf_high_hz", 5.0), fs,
                       pca.get("bpf_order", 4))
    return dynamic_pc1(bandpass_nanrobust(vx, sos), bandpass_nanrobust(vy, sos),
                       pca.get("win_sec", 2.0), pca.get("step_sec", 0.1), fs)


def _smooth_ma_nan(x, fs, sec):
    k = int(max(1, round(fs * sec))) | 1
    valid = np.isfinite(x).astype(float)
    num = scipy.ndimage.uniform_filter1d(np.where(np.isfinite(x), x, 0.0), size=k, mode="nearest")
    den = scipy.ndimage.uniform_filter1d(valid, size=k, mode="nearest")
    y = num / np.maximum(den, 1e-12)
    y[den < 1e-12] = np.nan
    return y


def _rolling_p95_positive(x, fs, win_sec):
    half = max(3, int(round(win_sec * fs)) | 1) // 2
    pos = np.where(np.isfinite(x) & (x > 0), x, np.nan)
    out = np.full(pos.shape, np.nan)
    for i in range(pos.size):
        seg = pos[max(0, i - half):min(pos.size, i + half + 1)]
        seg = seg[np.isfinite(seg)]
        if seg.size >= 5:
            out[i] = float(np.percentile(seg, 95))
    return out


def _peaks(pc1, time, fs, mp):
    """Positive peaks, one per up-crossing cycle of the smoothed PC1, above
    max(peak_min_abs, peak_min_frac x the local 95th percentile), merged
    closer than min_dist_sec (the higher wins) -> (peak times, interval
    midpoints, intervals)."""
    s = _smooth_ma_nan(pc1, fs, mp["smooth_sec"])
    p95 = _rolling_p95_positive(s, fs, mp["p95_win_sec"])
    up = np.where((s[:-1] <= 0) & (s[1:] > 0))[0]
    dn = np.where((s[:-1] > 0) & (s[1:] <= 0))[0]
    t_raw, a_raw = [], []
    for iu in up:
        after = dn[dn > iu]
        if after.size == 0:
            continue
        seg = s[iu:int(after[0]) + 1]
        if seg.size == 0 or np.all(~np.isfinite(seg)):
            continue
        im = int(np.nanargmax(seg))
        ipk, a = iu + im, float(seg[im])
        if not np.isfinite(a):
            continue
        thr = float(mp["peak_min_abs"])
        if np.isfinite(p95[ipk]) and p95[ipk] > 0:
            thr = max(thr, mp["peak_min_frac"] * float(p95[ipk]))
        if a < thr:
            continue
        t_raw.append(time[ipk])
        a_raw.append(a)
    t_raw = list(np.asarray(t_raw, time.dtype))
    if len(t_raw) < 2:
        return np.asarray(t_raw), np.array([]), np.array([])
    tk, ak = [t_raw[0]], [a_raw[0]]
    for t, a in zip(t_raw[1:], a_raw[1:]):
        if t - tk[-1] < mp["min_dist_sec"]:
            if a > ak[-1]:
                tk[-1], ak[-1] = t, a
        else:
            tk.append(t)
            ak.append(a)
    tp = np.asarray(tk, time.dtype)
    if tp.size < 2:
        return tp, np.array([]), np.array([])
    iv = np.diff(tp)
    mid = tp.dtype.type(0.5) * (tp[:-1] + tp[1:])
    ok = np.isfinite(iv) & (iv > 0)
    return tp, mid[ok], iv[ok]


def _auc(amp, time):
    m = np.isfinite(amp) & np.isfinite(time)
    if m.sum() < 2:
        return float("nan")
    idx = np.flatnonzero(m)
    gap = np.where(np.diff(idx) > 1)[0]
    return float(sum(_trapezoid(amp[s:e + 1], time[s:e + 1])
                     for s, e in zip(np.r_[idx[0], idx[gap + 1]], np.r_[idx[gap], idx[-1]])
                     if e > s))


METRIC_DEFAULTS = dict(window_sec=10.0, smooth_sec=0.2, p95_win_sec=2.0, peak_min_frac=0.2,
                       peak_min_abs=0.0, min_dist_sec=0.2, min_valid_samples=10,
                       min_intervals_for_tau=5)
COLUMNS = ("PC1_area_0_10", "ADS_slope_0_10", "ADS_R2_0_10", "Kendall_tau_0_10",
           "Kendall_p_0_10", "Peak_n")


def metric_row(t_all, pc1_all, metrics: dict = None, time_dtype=np.float32) -> dict:
    """The metric row of one PC1 waveform; NaN fields and Peak_n 0 when the
    0-10 s window holds too few finite samples.

    Times are held in the configuration's float32: peak times sit on the
    frame grid, so the inter-peak intervals tie or not by their last bits,
    and Kendall's tau-b counts the ties."""
    mp = dict(METRIC_DEFAULTS, **(metrics or {}))
    t_all, pc1_all = np.asarray(t_all, time_dtype), np.asarray(pc1_all, float)
    m = np.isfinite(t_all) & np.isfinite(pc1_all)
    t_all, pc1_all = t_all[m], pc1_all[m]
    nan_row = {c: float("nan") for c in COLUMNS[:-1]}
    nan_row["Peak_n"] = 0
    if t_all.size < mp["min_valid_samples"]:
        return nan_row
    time = t_all - t_all[0]
    mw = (time >= 0.0) & (time <= mp["window_sec"])
    time, pc1 = time[mw], pc1_all[mw]
    if time.size < mp["min_valid_samples"]:
        return nan_row
    fs = float(1.0 / np.median(np.diff(time)))
    amp = _smooth_ma_nan(np.abs(pc1), fs, mp["smooth_sec"])
    fit = np.isfinite(time) & np.isfinite(amp) & (amp > 0)
    slope = r = float("nan")
    if fit.sum() >= 2:
        res = scipy.stats.linregress(time[fit], np.log(amp[fit]))
        slope, r = float(res.slope), float(res.rvalue)
    tp, mid, iv = _peaks(pc1, time, fs, mp)
    tau = p = float("nan")
    if mid.size >= mp["min_intervals_for_tau"]:
        tau, p = (float(v) for v in scipy.stats.kendalltau(mid, iv))
    return {"PC1_area_0_10": _auc(amp, time), "ADS_slope_0_10": slope,
            "ADS_R2_0_10": r * r if np.isfinite(r) else float("nan"),
            "Kendall_tau_0_10": tau, "Kendall_p_0_10": p, "Peak_n": int(tp.size)}
