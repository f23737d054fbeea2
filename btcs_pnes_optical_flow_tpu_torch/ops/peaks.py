"""Cycle-based positive-peak detection in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/peaks.py`` (reference:
optical_PC1.py:79-228) in the same fixed shapes: arrays keep their
capacity N and carry a live-prefix length ``m_count``, and compaction is
a stable sort of the mask (``compact_index``), the counterpart of
``jnp.nonzero(size=N, fill_value=0)``.  The reverse cumulative minimum is
``torch.cummin`` on the flipped vector.  The sequential 0.2-s merge of
peaks (``lax.scan`` in the JAX package) is a loop on the host over the
N-1 candidates, in float32 as the scan computes it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def compact_index(mask: torch.Tensor):
    """(idx, count): the positions of the True entries of a 1-D mask in
    order, then zeros to the mask's length, and how many there are."""
    count = mask.sum()
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    slot = torch.arange(mask.shape[0], device=mask.device)
    return torch.where(slot < count, order, torch.zeros_like(order)), count


def _nan(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=x.dtype, device=x.device)


def uniform_filter1d_nearest_dyn(x: torch.Tensor, k: int, m_count) -> torch.Tensor:
    """Centered box mean with edge replication over a dynamic prefix:
    scipy.ndimage.uniform_filter1d(x[:m_count], size=k, mode="nearest")
    in the first ``m_count`` slots; values past the prefix are garbage."""
    n = x.shape[0]
    half = k // 2
    offs = torch.arange(-half, k - half, device=x.device)
    idx = torch.arange(n, device=x.device)[:, None] + offs[None, :]
    hi = torch.clamp(torch.as_tensor(m_count, device=x.device) - 1, min=0)
    idx = torch.minimum(torch.clamp(idx, min=0), hi)
    taps = x[idx]
    # Summed tap by tap, in order, then divided: XLA's order for the JAX
    # package's mean, so that near-equal neighbours keep their ranking
    # (the peak argmax depends on it).
    acc = taps[:, 0]
    for i in range(1, k):
        acc = acc + taps[:, i]
    return acc / k


def smooth_ma_nan_dyn(x: torch.Tensor, k: int, m_count) -> torch.Tensor:
    """NaN-tolerant moving average over a dynamic prefix."""
    valid = torch.isfinite(x)
    x2 = torch.where(valid, x, torch.zeros_like(x))
    num = uniform_filter1d_nearest_dyn(x2, k, m_count)
    den = uniform_filter1d_nearest_dyn(valid.to(x.dtype), k, m_count)
    y = num / torch.clamp(den, min=1e-12)
    return torch.where(den < 1e-12, _nan(x), y)


def rolling_p95_positive(pc1_s: torch.Tensor, win_n: int, m_count) -> torch.Tensor:
    """Rolling 95th percentile of the positive finite values in a centered
    window of static odd length ``win_n``, truncated at the live prefix's
    edges; NaN where fewer than 5 values qualify.  numpy's linear
    interpolation on the sorted values."""
    n = pc1_s.shape[0]
    dev = pc1_s.device
    half = win_n // 2
    offs = torch.arange(-half, half + 1, device=dev)
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    inb = (idx >= 0) & (idx < torch.as_tensor(m_count, device=dev))
    vals = pc1_s[torch.clamp(idx, 0, n - 1)]
    ok = inb & torch.isfinite(vals) & (vals > 0)
    big = torch.full((), float("inf"), dtype=pc1_s.dtype, device=dev)
    sorted_vals = torch.sort(torch.where(ok, vals, big), dim=1).values
    v = ok.sum(1)
    pos = 0.95 * (v - 1).to(pc1_s.dtype)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(v - 1, min=0))
    frac = pos - lo.to(pc1_s.dtype)
    lo = torch.clamp(lo, 0, win_n - 1)
    hi = torch.clamp(hi, 0, win_n - 1)
    s_lo = sorted_vals.gather(1, lo[:, None])[:, 0]
    s_hi = sorted_vals.gather(1, hi[:, None])[:, 0]
    p95 = s_lo + frac * (s_hi - s_lo)
    return torch.where(v >= 5, p95, _nan(pc1_s))


class PeakResult(NamedTuple):
    pc1_s: torch.Tensor        # (N,) smoothed PC1
    t_peaks: torch.Tensor      # (N,) peak times, live prefix
    n_peaks: torch.Tensor      # () int32
    tm: torch.Tensor           # (N,) interval midpoints, live prefix
    T: torch.Tensor            # (N,) inter-peak intervals, live prefix
    n_intervals: torch.Tensor  # () int32


def _merge_close_peaks(cand_valid, t_cand, a_peak, min_dist_sec: float):
    """The reference's greedy merge of peaks closer than ``min_dist_sec``
    (optical_PC1.py:207-218), in candidate order on the host.  Returns
    is_new (a group starts here) and rep_t (the current group's peak time
    after this slot), both (N-1,)."""
    valid = cand_valid.cpu().numpy()
    t_all = t_cand.cpu().numpy()
    a_all = a_peak.cpu().numpy()
    dist = np.float32(min_dist_sec)
    last_t = last_a = np.float32(0.0)
    started = False
    is_new = np.zeros(valid.shape, bool)
    rep_t = np.empty(valid.shape, np.float32)
    for s in range(valid.shape[0]):
        if valid[s]:
            t, a = t_all[s], a_all[s]
            gap = t - last_t
            if not started or gap >= dist:
                is_new[s] = True
                last_t, last_a = t, a
            elif gap < dist and a > last_a:
                last_t, last_a = t, a
            started = True
        rep_t[s] = last_t
    dev = cand_valid.device
    return torch.as_tensor(is_new, device=dev), torch.as_tensor(rep_t, device=dev)


def detect_cycles_positive_peaks(
    pc1: torch.Tensor,
    time_sec: torch.Tensor,
    k_smooth: int,
    p95_win_n: int,
    m_count,
    peak_min_frac: float = 0.20,
    peak_min_abs: float = 0.0,
    min_dist_sec: float = 0.2,
) -> PeakResult:
    """Positive-peak detection over zero-crossing cycles
    (optical_PC1.py:121-228).  ``k_smooth`` / ``p95_win_n`` are the static
    window lengths derived from fs; ``m_count`` is the live prefix length."""
    n = pc1.shape[0]
    dt = pc1.dtype
    dev = pc1.device
    nan = _nan(pc1)
    i_all = torch.arange(n, device=dev)
    live = i_all < torch.as_tensor(m_count, device=dev)

    pc1_s = smooth_ma_nan_dyn(torch.where(live, pc1, nan), k_smooth, m_count)
    pc1_s = torch.where(live, pc1_s, nan)
    local_p95 = rolling_p95_positive(pc1_s, p95_win_n, m_count)

    # Zero crossings (NaN comparisons are False, so gaps yield none).
    y0 = pc1_s[:-1]
    y1 = pc1_s[1:]
    up = (y0 <= 0) & (y1 > 0)  # index i: crossing between i and i+1
    dn = (y0 > 0) & (y1 <= 0)

    # Next down-crossing strictly after i: reverse cumulative min.
    big_i = n + 1
    dn_idx = torch.where(dn, i_all[:-1], torch.full_like(i_all[:-1], big_i))
    nd_incl = torch.cummin(dn_idx.flip(0), 0).values.flip(0)
    nd_after = torch.cat([nd_incl[1:], torch.full((1,), big_i, device=dev)])
    has_dn = nd_after < big_i

    # Per-cycle masked argmax over j in [i, end_i].
    end = torch.where(has_dn, nd_after + 1, torch.zeros_like(nd_after))
    j_col = i_all[None, :]
    i_row = i_all[:-1, None]
    in_seg = (j_col >= i_row) & (j_col <= end[:, None]) & up[:, None] & has_dn[:, None]
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    vals = torch.where(in_seg & torch.isfinite(pc1_s)[None, :], pc1_s[None, :], ninf)
    seg_max = vals.max(1).values
    # First index achieving the max (nanargmax's tie rule).
    peak_idx = torch.argmax((vals == seg_max[:, None]).to(torch.int32), 1)
    a_peak = seg_max
    cand_valid = up & has_dn & torch.isfinite(a_peak) & (a_peak > ninf)

    # Local threshold at the peak index (optical_PC1.py:188-195).
    ref_v = local_p95[torch.clamp(peak_idx, 0, n - 1)]
    thr = torch.full((n - 1,), peak_min_abs, dtype=dt, device=dev)
    thr = torch.where(torch.isfinite(ref_v) & (ref_v > 0),
                      torch.maximum(thr, peak_min_frac * ref_v), thr)
    cand_valid = cand_valid & (a_peak >= thr)
    t_cand = time_sec[torch.clamp(peak_idx, 0, n - 1)].to(dt)

    is_new, rep_t = _merge_close_peaks(cand_valid, t_cand, a_peak, min_dist_sec)

    # A slot ends a group iff a group has started by then and the next
    # slot begins a new one (or it is the last slot).
    nxt_new = torch.cat([is_new[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
    started_by = torch.cummax(is_new.to(torch.int32), 0).values > 0
    group_end = started_by & (nxt_new | (torch.arange(n - 1, device=dev) == n - 2))

    n_peaks = is_new.sum().to(torch.int32)
    order, _ = compact_index(group_end)
    t_peaks = torch.where(torch.arange(n - 1, device=dev) < n_peaks, rep_t[order], nan)

    # Intervals between consecutive kept peaks (optical_PC1.py:224-228).
    T = t_peaks[1:] - t_peaks[:-1]
    tm = 0.5 * (t_peaks[1:] + t_peaks[:-1])
    slot = torch.arange(n - 2, device=dev)
    iv_valid = (slot + 1 < n_peaks) & (n_peaks >= 2) & torch.isfinite(T) & (T > 0)
    comp, n_iv = compact_index(iv_valid)
    T_c = torch.where(slot < n_iv, T[comp], nan)
    tm_c = torch.where(slot < n_iv, tm[comp], nan)

    pad1 = torch.full((1,), float("nan"), dtype=dt, device=dev)
    pad2 = torch.full((2,), float("nan"), dtype=dt, device=dev)
    return PeakResult(
        pc1_s=pc1_s,
        t_peaks=torch.cat([t_peaks, pad1]),
        n_peaks=n_peaks,
        tm=torch.cat([tm_c, pad2]),
        T=torch.cat([T_c, pad2]),
        n_intervals=n_iv.to(torch.int32),
    )
