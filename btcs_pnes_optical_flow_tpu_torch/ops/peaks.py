"""Cycle-based positive-peak detection in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/peaks.py`` (reference:
optical_PC1.py:79-228) in the same fixed shapes: arrays keep their
capacity N and carry a live-prefix length ``m_count``, and compaction is
a stable sort of the mask (``compact_index``), the counterpart of
``jnp.nonzero(size=N, fill_value=0)``.  The reverse cumulative minimum is
``torch.cummin`` on the flipped vector.  The sequential 0.2-s merge of
peaks (``lax.scan`` in the JAX package) is a loop on the host over the
N-1 candidates, in float32 as the scan computes it.

Every function takes one waveform ``(N,)`` with a scalar count, or K of
them ``(K, N)`` with a ``(K,)`` count (the JAX package's ``vmap``); the
rows are independent and each computes in the 1-D form's order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _rows(x: torch.Tensor, m_count):
    """(x as (K, N), m_count as (K,) on x's device, whether x was 1-D)."""
    one = x.dim() == 1
    x2 = x[None] if one else x
    mc = torch.as_tensor(m_count, device=x.device).reshape(-1).expand(x2.shape[0])
    return x2, mc, one


def compact_index(mask: torch.Tensor):
    """(idx, count): the positions of the True entries of a mask along its
    last axis in order, then zeros to the mask's length, and how many
    there are (per row for a (K, N) mask)."""
    count = mask.sum(-1)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    slot = torch.arange(mask.shape[-1], device=mask.device)
    return torch.where(slot < count.unsqueeze(-1), order, torch.zeros_like(order)), count


def _nan(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=x.dtype, device=x.device)


def uniform_filter1d_nearest_dyn(x: torch.Tensor, k: int, m_count) -> torch.Tensor:
    """Centered box mean with edge replication over a dynamic prefix:
    scipy.ndimage.uniform_filter1d(x[:m_count], size=k, mode="nearest")
    in the first ``m_count`` slots; values past the prefix are garbage."""
    x2, mc, one = _rows(x, m_count)
    n = x2.shape[1]
    half = k // 2
    offs = torch.arange(-half, k - half, device=x.device)
    idx = torch.arange(n, device=x.device)[:, None] + offs[None, :]
    hi = torch.clamp(mc - 1, min=0)[:, None, None]
    idx = torch.minimum(torch.clamp(idx, min=0)[None], hi)
    taps = x2.gather(1, idx.reshape(x2.shape[0], -1)).reshape(x2.shape[0], n, k)
    # Summed tap by tap, in order, then divided: XLA's order for the JAX
    # package's mean, so that near-equal neighbours keep their ranking
    # (the peak argmax depends on it).
    acc = taps[..., 0]
    for i in range(1, k):
        acc = acc + taps[..., i]
    out = acc / k
    return out[0] if one else out


def smooth_ma_nan_dyn(x: torch.Tensor, k: int, m_count) -> torch.Tensor:
    """NaN-tolerant moving average over a dynamic prefix; the numerator
    and the denominator are filtered in one call."""
    xr, mc, one = _rows(x, m_count)
    valid = torch.isfinite(xr)
    both = uniform_filter1d_nearest_dyn(
        torch.cat([torch.where(valid, xr, torch.zeros_like(xr)), valid.to(x.dtype)]),
        k, mc.repeat(2))
    num, den = both.chunk(2)
    y = torch.where(den < 1e-12, _nan(x), num / torch.clamp(den, min=1e-12))
    return y[0] if one else y


def rolling_p95_positive(pc1_s: torch.Tensor, win_n: int, m_count) -> torch.Tensor:
    """Rolling 95th percentile of the positive finite values in a centered
    window of static odd length ``win_n``, truncated at the live prefix's
    edges; NaN where fewer than 5 values qualify.  numpy's linear
    interpolation on the sorted values."""
    x2, mc, one = _rows(pc1_s, m_count)
    kk, n = x2.shape
    dev = pc1_s.device
    half = win_n // 2
    offs = torch.arange(-half, half + 1, device=dev)
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    inb = (idx >= 0)[None] & (idx[None] < mc[:, None, None])
    vals = x2.gather(1, torch.clamp(idx, 0, n - 1).reshape(1, -1).expand(kk, -1))
    vals = vals.reshape(kk, n, win_n)
    ok = inb & torch.isfinite(vals) & (vals > 0)
    big = torch.full((), float("inf"), dtype=pc1_s.dtype, device=dev)
    sorted_vals = torch.sort(torch.where(ok, vals, big), dim=-1).values
    v = ok.sum(-1)
    pos = 0.95 * (v - 1).to(pc1_s.dtype)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(v - 1, min=0))
    frac = pos - lo.to(pc1_s.dtype)
    lo = torch.clamp(lo, 0, win_n - 1)
    hi = torch.clamp(hi, 0, win_n - 1)
    s_lo = sorted_vals.gather(-1, lo[..., None])[..., 0]
    s_hi = sorted_vals.gather(-1, hi[..., None])[..., 0]
    p95 = s_lo + frac * (s_hi - s_lo)
    out = torch.where(v >= 5, p95, _nan(pc1_s))
    return out[0] if one else out


class PeakResult(NamedTuple):
    pc1_s: torch.Tensor        # (..., N) smoothed PC1
    t_peaks: torch.Tensor      # (..., N) peak times, live prefix
    n_peaks: torch.Tensor      # (...) int32
    tm: torch.Tensor           # (..., N) interval midpoints, live prefix
    T: torch.Tensor            # (..., N) inter-peak intervals, live prefix
    n_intervals: torch.Tensor  # (...) int32


def _merge_close_peaks(cand_valid, t_cand, a_peak, min_dist_sec: float):
    """The reference's greedy merge of peaks closer than ``min_dist_sec``
    (optical_PC1.py:207-218), in candidate order on the host, every row at
    once: one copy to the host and one back.  Returns is_new (a group
    starts here) and rep_t (the current group's peak time after this
    slot), both (K, N-1).  Only the slots where some row has a candidate
    can change the state, so the loop visits those and rep_t carries the
    last visited slot's value forward."""
    host = torch.stack([cand_valid.to(a_peak.dtype), t_cand, a_peak]).cpu().numpy()
    valid = host[0] != 0
    t_all, a_all = host[1], host[2]
    dist = np.float32(min_dist_sec)
    kk, slots = valid.shape
    last_t = np.zeros(kk, np.float32)
    last_a = np.zeros(kk, np.float32)
    started = np.zeros(kk, bool)
    is_new = np.zeros(valid.shape, bool)
    rep_at = np.zeros(valid.shape, np.float32)
    any_valid = valid.any(0)
    for s in np.flatnonzero(any_valid):
        v, t, a = valid[:, s], t_all[:, s], a_all[:, s]
        gap = t - last_t
        new = v & (~started | (gap >= dist))
        take = new | (v & started & (gap < dist) & (a > last_a))
        last_t = np.where(take, t, last_t)
        last_a = np.where(take, a, last_a)
        started |= v
        is_new[:, s] = new
        rep_at[:, s] = last_t
    visited = np.maximum.accumulate(np.where(any_valid, np.arange(slots), -1))
    rep_t = np.where(visited >= 0, rep_at[:, np.maximum(visited, 0)], np.float32(0.0))
    back = torch.as_tensor(np.stack([is_new.astype(np.float32), rep_t]), device=a_peak.device)
    return back[0] != 0, back[1]


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
    window lengths derived from fs; ``m_count`` is the live prefix length.
    The per-cycle argmax holds (K, N-1, N) elements."""
    pc1_2, mc, one = _rows(pc1, m_count)
    time2 = time_sec[None] if one else time_sec
    kk, n = pc1_2.shape
    dt = pc1.dtype
    dev = pc1.device
    nan = _nan(pc1)
    i_all = torch.arange(n, device=dev)
    live = i_all[None] < mc[:, None]

    pc1_s = smooth_ma_nan_dyn(torch.where(live, pc1_2, nan), k_smooth, mc)
    pc1_s = torch.where(live, pc1_s, nan)
    local_p95 = rolling_p95_positive(pc1_s, p95_win_n, mc)

    # Zero crossings (NaN comparisons are False, so gaps yield none).
    y0 = pc1_s[:, :-1]
    y1 = pc1_s[:, 1:]
    up = (y0 <= 0) & (y1 > 0)  # index i: crossing between i and i+1
    dn = (y0 > 0) & (y1 <= 0)

    # Next down-crossing strictly after i: reverse cumulative min.
    big_i = n + 1
    dn_idx = torch.where(dn, i_all[:-1], torch.full_like(i_all[:-1], big_i))
    nd_incl = torch.cummin(dn_idx.flip(-1), -1).values.flip(-1)
    nd_after = torch.cat([nd_incl[:, 1:], torch.full((kk, 1), big_i, device=dev)], 1)
    has_dn = nd_after < big_i

    # Per-cycle masked argmax over j in [i, end_i].
    end = torch.where(has_dn, nd_after + 1, torch.zeros_like(nd_after))
    j_col = i_all[None, None, :]
    i_row = i_all[None, :-1, None]
    in_seg = ((j_col >= i_row) & (j_col <= end[..., None])
              & up[..., None] & has_dn[..., None])
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    vals = torch.where(in_seg & torch.isfinite(pc1_s)[:, None, :], pc1_s[:, None, :], ninf)
    seg_max = vals.max(-1).values
    # First index achieving the max (nanargmax's tie rule).
    peak_idx = torch.argmax((vals == seg_max[..., None]).to(torch.int32), -1)
    del in_seg, vals
    a_peak = seg_max
    cand_valid = up & has_dn & torch.isfinite(a_peak) & (a_peak > ninf)

    # Local threshold at the peak index (optical_PC1.py:188-195).
    at_peak = torch.clamp(peak_idx, 0, n - 1)
    ref_v = local_p95.gather(1, at_peak)
    thr = torch.full((kk, n - 1), peak_min_abs, dtype=dt, device=dev)
    thr = torch.where(torch.isfinite(ref_v) & (ref_v > 0),
                      torch.maximum(thr, peak_min_frac * ref_v), thr)
    cand_valid = cand_valid & (a_peak >= thr)
    t_cand = time2.gather(1, at_peak).to(dt)

    is_new, rep_t = _merge_close_peaks(cand_valid, t_cand, a_peak, min_dist_sec)

    # A slot ends a group iff a group has started by then and the next
    # slot begins a new one (or it is the last slot).
    nxt_new = torch.cat([is_new[:, 1:], torch.zeros((kk, 1), dtype=torch.bool, device=dev)], 1)
    started_by = torch.cummax(is_new.to(torch.int32), -1).values > 0
    group_end = started_by & (nxt_new | (torch.arange(n - 1, device=dev) == n - 2))

    n_peaks = is_new.sum(-1).to(torch.int32)
    order, _ = compact_index(group_end)
    slot_p = torch.arange(n - 1, device=dev)
    t_peaks = torch.where(slot_p < n_peaks[:, None], rep_t.gather(1, order), nan)

    # Intervals between consecutive kept peaks (optical_PC1.py:224-228).
    T = t_peaks[:, 1:] - t_peaks[:, :-1]
    tm = 0.5 * (t_peaks[:, 1:] + t_peaks[:, :-1])
    slot = torch.arange(n - 2, device=dev)
    n_pk = n_peaks[:, None]
    iv_valid = (slot + 1 < n_pk) & (n_pk >= 2) & torch.isfinite(T) & (T > 0)
    comp, n_iv = compact_index(iv_valid)
    T_c = torch.where(slot < n_iv[:, None], T.gather(1, comp), nan)
    tm_c = torch.where(slot < n_iv[:, None], tm.gather(1, comp), nan)

    pad1 = torch.full((kk, 1), float("nan"), dtype=dt, device=dev)
    pad2 = torch.full((kk, 2), float("nan"), dtype=dt, device=dev)
    res = PeakResult(
        pc1_s=pc1_s,
        t_peaks=torch.cat([t_peaks, pad1], 1),
        n_peaks=n_peaks,
        tm=torch.cat([tm_c, pad2], 1),
        T=torch.cat([T_c, pad2], 1),
        n_intervals=n_iv.to(torch.int32),
    )
    return PeakResult(*(v[0] for v in res)) if one else res
