"""IIR band-pass filtering and moving averages in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/filters.py``:

- ``sosfilt`` / ``sosfiltfilt`` ↔ scipy.signal.sosfilt / sosfiltfilt over
  the last axis, batched over every leading axis, with two engines:
  ``"scan"``, the sequential biquad recurrence (transposed direct form II:
  on the CPU a Python loop of one small tensor step per sample, on the card
  one launch of ``sos_cascade_kernel`` per call, ``ops/filters_cuda.py``,
  bit for bit the same loop), and ``"assoc"``, a
  log-depth doubling scan of each section's complex pole-coordinate
  recurrence (the JAX package's ``lax.associative_scan`` engine);
- ``bandpass_nanrobust`` ↔ the reference's per-finite-run zero-phase
  filtering (optical_PCA.py:96-121) in fixed shapes: up to ``max_runs``
  runs per signal are gathered into staging rows and filtered together;
- ``uniform_filter1d_nearest`` / ``smooth_ma_nan`` ↔
  scipy.ndimage.uniform_filter1d(mode="nearest") and the NaN-tolerant
  moving average built on it (optical_PC1.py:55-76).

``"assoc"`` is the default of the filters here, as in the JAX package;
the PC1 head (``models/pc1.py``) passes ``"scan"``, as the JAX one does.
``smooth_window_len`` is the metric head's window rule.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.ops import design, filters_cuda


def _section_scan(b0, b1, b2, a1, a2, x: torch.Tensor, zi: torch.Tensor):
    """One biquad section over the last axis of x; zi (..., 2)."""
    z1 = zi[..., 0]
    z2 = zi[..., 1]
    ys = []
    for i in range(x.shape[-1]):
        xn = x[..., i]
        y = b0 * xn + z1
        z1, z2 = b1 * xn - a1 * y + z2, b2 * xn - a2 * y
        ys.append(y)
    return torch.stack(ys, dim=-1), torch.stack([z1, z2], dim=-1)


def _section_assoc(b0, b1, b2, a1, a2, x: torch.Tensor, zi: torch.Tensor):
    """One biquad section over the last axis of x in pole coordinates.

    The state s_n = [z1, z2] obeys s_{n+1} = M s_n + c_n with
    M = [[-a1, 1], [-a2, 0]], whose eigenvalues are the section's poles p,
    p̄.  Products of the non-normal M grow transiently for poles near the
    unit circle, so scanning the 2×2 affine maps is unstable in float32.
    With the left eigenvector w = [p, 1], the scalar mode d_n = p·z1_n + z2_n
    obeys d_{n+1} = p·d_n + γ·x_n, a well-conditioned complex scalar
    recurrence; its prefix maps (g, t) ↦ d = g·d_0 + t are composed by a
    doubling scan in log2(N) steps, as real and imaginary float32 planes.
    The state comes back as z1 = 2·Re(d/κ), z2 = 2·Re(d·v2/κ) with
    κ = (p² − a2)/p and v2 = −a2/p.  Real poles (a1² ≥ 4·a2) take the
    sequential scan.
    """
    disc = a1 * a1 - 4.0 * a2
    if disc >= 0.0:
        return _section_scan(b0, b1, b2, a1, a2, x, zi)
    p = complex(-a1 / 2.0, math.sqrt(-disc) / 2.0)
    gamma = (b1 - a1 * b0) * p + (b2 - a2 * b0)
    inv_kappa = 1.0 / ((p * p - a2) / p)
    v2_over_kappa = (-a2 / p) * inv_kappa

    d0_re = (p.real * zi[..., 0] + zi[..., 1])[..., None]
    d0_im = (p.imag * zi[..., 0])[..., None]
    g_re = torch.full_like(x, p.real)
    g_im = torch.full_like(x, p.imag)
    t_re = gamma.real * x
    t_im = gamma.imag * x
    n = x.shape[-1]
    k = 1
    while k < n:
        # Element i takes the composition of element i - k (earlier) then i.
        g1r, g1i, t1r, t1i = (v[..., :-k] for v in (g_re, g_im, t_re, t_im))
        g2r, g2i, t2r, t2i = (v[..., k:] for v in (g_re, g_im, t_re, t_im))
        g_re, g_im, t_re, t_im = (
            torch.cat([v[..., :k], c], dim=-1) for v, c in (
                (g_re, g2r * g1r - g2i * g1i),
                (g_im, g2r * g1i + g2i * g1r),
                (t_re, g2r * t1r - g2i * t1i + t2r),
                (t_im, g2r * t1i + g2i * t1r + t2i)))
        k *= 2
    # d_{n+1} = g_cum[n]·d_0 + t_cum[n]
    dn_re = g_re * d0_re - g_im * d0_im + t_re
    dn_im = g_re * d0_im + g_im * d0_re + t_im
    d_re = torch.cat([d0_re, dn_re[..., :-1]], dim=-1)
    d_im = torch.cat([d0_im, dn_im[..., :-1]], dim=-1)
    y = b0 * x + 2.0 * (d_re * inv_kappa.real - d_im * inv_kappa.imag)
    last_re, last_im = dn_re[..., -1], dn_im[..., -1]
    z1f = 2.0 * (last_re * inv_kappa.real - last_im * inv_kappa.imag)
    z2f = 2.0 * (last_re * v2_over_kappa.real - last_im * v2_over_kappa.imag)
    return y, torch.stack([z1f, z2f], dim=-1)


_SECTIONS = {"scan": _section_scan, "assoc": _section_assoc}


def sosfilt(sos, x: torch.Tensor, zi: torch.Tensor,
            engine: str = "assoc") -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade of second-order sections over the last axis of x.

    sos: (S, 6) host coefficients (a0 == 1).  zi: (..., S, 2) initial
    conditions, broadcast against x's leading axes.  engine: "scan"
    (sequential) or "assoc" (log-depth, pole coordinates).  Returns (y, zf).
    """
    if engine not in _SECTIONS:
        raise ValueError(f"sosfilt engine must be one of {sorted(_SECTIONS)}, got {engine!r}")
    sos = np.asarray(sos, dtype=np.float64)
    zi = zi.expand(x.shape[:-1] + zi.shape[-2:])
    if engine == "scan":  # the plain loop on the CPU, one kernel launch on the card
        return filters_cuda.sos_cascade(sos, x.contiguous(), zi)
    return _cascade(_SECTIONS[engine], sos, x, zi)


def _cascade(section, sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor):
    """The sections of sos one after another over the whole of x, each by
    ``section``; zi (..., S, 2) expanded to x's leading axes."""
    v = x
    zf = []
    for s in range(sos.shape[0]):
        b0, b1, b2 = float(sos[s, 0]), float(sos[s, 1]), float(sos[s, 2])
        a1, a2 = float(sos[s, 4]), float(sos[s, 5])
        v, z = section(b0, b1, b2, a1, a2, v, zi[..., s, :])
        zf.append(z)
    return v, torch.stack(zf, dim=-2)


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension at both ends of the last axis (scipy odd_ext)."""
    left = 2 * x[..., :1] - x[..., 1 : n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -(n + 1) : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def sosfiltfilt(sos, x: torch.Tensor, zi: torch.Tensor, padlen: int,
                engine: str = "assoc") -> torch.Tensor:
    """Zero-phase forward-backward SOS filtering with odd padding
    (scipy.signal.sosfiltfilt(sos, x, padlen=padlen)) over the last axis."""
    ext = odd_ext(x, padlen) if padlen > 0 else x
    y, _ = sosfilt(sos, ext, zi * ext[..., :1, None], engine=engine)
    y_rev = y.flip(-1)
    y2, _ = sosfilt(sos, y_rev, zi * y_rev[..., :1, None], engine=engine)
    y2 = y2.flip(-1)
    if padlen > 0:
        y2 = y2[..., padlen:-padlen]
    return y2


def finite_runs_bounded(mask: torch.Tensor, max_runs: int):
    """Contiguous True runs along the last axis as (starts, ends, n_runs).

    Fixed shapes: ``max_runs`` slots per signal, filled in order; unused
    slots hold start = n (past the end) and end = -1.  Runs beyond
    ``max_runs`` are dropped; ``n_runs`` counts them all.
    """
    n = mask.shape[-1]
    lead = mask.shape[:-1]
    false = torch.zeros(lead + (1,), dtype=torch.bool, device=mask.device)
    prev = torch.cat([false, mask[..., :-1]], dim=-1)
    nxt = torch.cat([mask[..., 1:], false], dim=-1)
    pos = torch.arange(n, device=mask.device).expand(mask.shape)

    def slots(flags, fill):
        rank = torch.cumsum(flags.long(), dim=-1) - 1
        idx = torch.where(flags & (rank < max_runs), rank, torch.full_like(rank, max_runs))
        out = torch.full(lead + (max_runs + 1,), fill, dtype=torch.long, device=mask.device)
        return out.scatter(-1, idx, pos)[..., :max_runs]

    run_start = mask & ~prev
    run_end = mask & ~nxt
    n_runs = run_start.long().sum(-1)
    return slots(run_start, n), slots(run_end, -1), n_runs


def _filtfilt_runs(sos, zi: torch.Tensor, x: torch.Tensor, start: torch.Tensor,
                   end: torch.Tensor, padreq: int, engine: str) -> torch.Tensor:
    """filtfilt the runs [start, end] of x (..., N); start/end (..., R).

    Each run is gathered into a staging row of length N + 2·padreq laid
    out as [left odd ext (pad) | segment | right odd ext (pad) | fill],
    filtered forward and (window-reversed) backward.  Returns (..., R, N)
    aligned to x's positions (garbage outside each run — caller masks).
    """
    n = x.shape[-1]
    ell = n + 2 * padreq
    dev = x.device
    start = start[..., None]
    end = end[..., None]
    size = end - start + 1
    pad = torch.clamp(torch.minimum(torch.full_like(size, padreq), size // 2 - 1), min=0)
    xr = x[..., None, :].expand(start.shape[:-1] + (n,))

    def seg(i):
        # x[start + clip(i)] with i clipped into the run; always finite.
        i = torch.minimum(torch.clamp(i, min=0), size - 1)
        return torch.gather(xr, -1, torch.clamp(start + i, 0, n - 1))

    j = torch.arange(ell, device=dev).expand(start.shape[:-1] + (ell,))
    first = seg(torch.zeros_like(j))
    last = seg((size - 1).expand_as(j))
    left_val = 2.0 * first - seg(pad - j)
    mid_val = seg(j - pad)
    right_val = 2.0 * last - seg(2 * size + pad - 2 - j)
    ext = torch.where(j < pad, left_val, torch.where(j < pad + size, mid_val, right_val))
    wlen = 2 * pad + size
    ext = torch.where(j < wlen, ext, last)

    yf, _ = sosfilt(sos, ext, zi * ext[..., :1, None], engine=engine)
    rev_idx = torch.clamp(wlen - 1 - j, 0, ell - 1)
    yr = torch.gather(yf, -1, rev_idx)
    yr = torch.where(j < wlen, yr, yr[..., :1])
    yb, _ = sosfilt(sos, yr, zi * yr[..., :1, None], engine=engine)
    i_local = torch.arange(n, device=dev) - start
    out_idx = torch.clamp(pad + size - 1 - i_local, 0, ell - 1)
    y_run = torch.gather(yb, -1, out_idx)
    # pad <= 0 (reference keeps the raw segment).
    keep = torch.minimum(torch.maximum(torch.arange(n, device=dev), start), end)
    passthrough = torch.gather(xr, -1, torch.clamp(keep, 0, n - 1))
    return torch.where(pad > 0, y_run, passthrough)


def bandpass_nanrobust(x: torch.Tensor, sos, zi: torch.Tensor, padreq: int,
                       max_runs: int = 64, engine: str = "assoc") -> torch.Tensor:
    """Zero-phase band-pass per contiguous finite run, over the last axis.

    Behavioral contract (optical_PCA.py:96-121): runs shorter than
    ``padreq + 1`` stay NaN; pad is clamped to ``size//2 - 1``; output is
    NaN outside finite runs.  Leading axes are independent signals.
    """
    n = x.shape[-1]
    mask = torch.isfinite(x)
    xf = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    starts, ends, n_runs = finite_runs_bounded(mask, max_runs)
    ys = _filtfilt_runs(sos, zi, xf, starts, ends, padreq, engine)  # (..., R, N)

    idx = torch.arange(n, device=x.device)
    sizes = (ends - starts + 1)[..., None]
    slot = torch.arange(max_runs, device=x.device)[:, None]
    run_ok = (slot < n_runs[..., None, None]) & (sizes >= padreq + 1)
    in_run = (idx >= starts[..., None]) & (idx <= ends[..., None]) & run_ok
    # Runs are disjoint, so a masked sum-select is exact.
    total = torch.where(in_run, ys, torch.zeros((), dtype=x.dtype, device=x.device)).sum(-2)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(in_run.any(-2), total, nan)


def make_bandpass(low_hz: float, high_hz: float, fs: float, order: int = 4,
                  dtype=np.float32):
    """Design a band-pass; returns host-side (sos, zi, padreq) constants."""
    sos_np = design.butter_bandpass_sos(low_hz, high_hz, fs, order)
    zi_np = design.sosfilt_zi(sos_np).astype(dtype)
    padreq = design.sos_required_padlen(sos_np)
    return sos_np, zi_np, padreq


def uniform_filter1d_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centered box mean over the last axis, edge-replicated
    (mode="nearest"), origin 0: the window of index i covers the offsets
    [-(size//2), size - size//2 - 1]."""
    left = size // 2
    right = size - left - 1
    xp = torch.cat([x[..., :1].expand(x.shape[:-1] + (left,)), x,
                    x[..., -1:].expand(x.shape[:-1] + (right,))], dim=-1)
    return xp.unfold(-1, size, 1).sum(-1) / size


def smooth_ma_nan(x: torch.Tensor, k: int) -> torch.Tensor:
    """NaN-tolerant moving average of odd window length ``k`` over the last
    axis (optical_PC1.py:55-76; the reference computes k as
    ``ensure_odd(max(1, round(fs * sec)))``)."""
    valid = torch.isfinite(x)
    num = uniform_filter1d_nearest(torch.where(valid, x, torch.zeros_like(x)), k)
    den = uniform_filter1d_nearest(valid.to(x.dtype), k)
    y = num / torch.clamp(den, min=1e-12)
    return torch.where(den < 1e-12, torch.full_like(y, float("nan")), y)


def ensure_odd(n: int) -> int:
    """int(n) | 1 (optical_PC1.py:47-52)."""
    return int(n) | 1


def smooth_window_len(fs: float, sec: float) -> int:
    """Window length of the reference's smoother: odd(max(1, round(fs·sec))),
    rounding half to even as Python's round does."""
    r = fs * sec
    f = math.floor(r)
    d = r - f
    if d > 0.5:
        ri = f + 1
    elif d < 0.5:
        ri = f
    else:
        ri = f + 1 if f % 2 else f
    return ensure_odd(max(1, ri))
