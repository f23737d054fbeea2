"""IIR band-pass filtering in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/filters.py``'s band-pass path:

- ``sosfilt`` / ``sosfiltfilt`` ↔ scipy.signal.sosfilt / sosfiltfilt,
  as a sequential biquad recurrence (transposed direct form II) over the
  last axis, batched over every leading axis;
- ``bandpass_nanrobust`` ↔ the reference's per-finite-run zero-phase
  filtering (optical_PCA.py:96-121) in fixed shapes: up to ``max_runs``
  runs per signal are gathered into staging rows and filtered together.

The recurrence is a Python loop over samples, one small tensor step per
sample for all runs and signals at once.  The JAX package's
log-depth associative-scan engine (``engine="assoc"``) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu.ops import design


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


def sosfilt(sos, x: torch.Tensor, zi: torch.Tensor,
            engine: str = "scan") -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade of second-order sections over the last axis of x.

    sos: (S, 6) host coefficients (a0 == 1).  zi: (..., S, 2) initial
    conditions, broadcast against x's leading axes.  Returns (y, zf).
    """
    if engine != "scan":
        raise NotImplementedError(f"sosfilt engine {engine!r} is not ported; use 'scan'")
    sos = np.asarray(sos, dtype=np.float64)
    zi = zi.expand(x.shape[:-1] + zi.shape[-2:])
    v = x
    zf = []
    for s in range(sos.shape[0]):
        b0, b1, b2 = float(sos[s, 0]), float(sos[s, 1]), float(sos[s, 2])
        a1, a2 = float(sos[s, 4]), float(sos[s, 5])
        v, z = _section_scan(b0, b1, b2, a1, a2, v, zi[..., s, :])
        zf.append(z)
    return v, torch.stack(zf, dim=-2)


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension at both ends of the last axis (scipy odd_ext)."""
    left = 2 * x[..., :1] - x[..., 1 : n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -(n + 1) : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def sosfiltfilt(sos, x: torch.Tensor, zi: torch.Tensor, padlen: int,
                engine: str = "scan") -> torch.Tensor:
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
                       max_runs: int = 64, engine: str = "scan") -> torch.Tensor:
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
