"""Sliding-window dynamic PC1 in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/pca.py``: every window is one
gather into a (K, win_n) batch, the 2×2 symmetric eigenproblem is solved
in closed form, the reference's sequential sign stabilization is a
prefix product of ±1 factors over the accepted-window chain, and each
sample takes the axis of its nearest accepted window center (ties go to
the later center, optical_PCA.py:218-225).
"""

from __future__ import annotations

import numpy as np
import torch

_INT32_MAX = 2**31 - 1


def eigvec2x2_major(cxx: torch.Tensor, cxy: torch.Tensor, cyy: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector (..., 2) of the largest eigenvalue of
    [[cxx, cxy], [cxy, cyy]]; an axis vector for the zero / isotropic
    matrix ([1, 0] if cxx >= cyy).  The sign is arbitrary."""
    half_diff = 0.5 * (cxx - cyy)
    root = torch.sqrt(half_diff * half_diff + cxy * cxy)
    lam = 0.5 * (cxx + cyy) + root
    # Two algebraically equivalent candidates; pick the better-conditioned.
    v1 = torch.stack([cxy, lam - cxx], dim=-1)
    v2 = torch.stack([lam - cyy, cxy], dim=-1)
    n1 = torch.sum(v1 * v1, dim=-1)
    n2 = torch.sum(v2 * v2, dim=-1)
    v = torch.where((n1 >= n2)[..., None], v1, v2)
    nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    ex = torch.tensor([1.0, 0.0], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0.0, 1.0], dtype=v.dtype, device=v.device)
    axis = torch.where((cxx >= cyy)[..., None], ex, ey)
    tiny = 1e-30
    return torch.where(nrm > tiny, v / torch.clamp(nrm, min=tiny), axis)


def window_axes(vx: torch.Tensor, vy: torch.Tensor, win_n: int, step_n: int,
                min_samples: int = 3, ref=(0.0, 1.0)):
    """Per-window principal axes with reference-exact sign stabilization.

    Returns (centers, acc_idx, a_count, w_acc, valid) over the K static
    windows: centers (K,) window-center indices, acc_idx (K,) the
    accepted windows compacted to the front (fill 0), a_count their
    number, w_acc (K, 2) their sign-stabilized axes (slots >= a_count
    are garbage) and valid (K,).
    """
    dev = vx.device
    n = vx.shape[0]
    starts = np.arange(0, n - win_n + 1, step_n, dtype=np.int64)
    k = starts.shape[0]
    centers = torch.as_tensor((2 * starts + win_n - 1) // 2, device=dev)

    idx = torch.as_tensor(starts, device=dev)[:, None] + torch.arange(win_n, device=dev)[None, :]
    wx = vx[idx]
    wy = vy[idx]
    m = torch.isfinite(wx) & torch.isfinite(wy)
    cnt = m.sum(1)
    valid = cnt >= min_samples
    cntf = torch.clamp(cnt, min=1).to(vx.dtype)
    zero = torch.zeros((), dtype=vx.dtype, device=dev)

    mx = torch.where(m, wx, zero).sum(1) / cntf
    my = torch.where(m, wy, zero).sum(1) / cntf
    dx = torch.where(m, wx - mx[:, None], zero)
    dy = torch.where(m, wy - my[:, None], zero)
    # np.cov with default ddof → N-1 normalization (optical_PCA.py:197).
    denom = torch.clamp(cnt - 1, min=1).to(vx.dtype)
    cxx = (dx * dx).sum(1) / denom
    cxy = (dx * dy).sum(1) / denom
    cyy = (dy * dy).sum(1) / denom

    w = eigvec2x2_major(cxx, cxy, cyy)

    # Stage (a): align to the reference axis — flip iff dot(w, ref) < 0.
    d_ref = w[:, 0] * ref[0] + w[:, 1] * ref[1]
    w = torch.where((d_ref < 0)[:, None], -w, w)

    # Stage (b): temporal continuity along the accepted chain — the
    # sequential "flip if dot with previous accepted < 0" is the prefix
    # product of per-link sign factors.
    a_count = int(valid.sum())
    slot = torch.arange(k, device=dev)
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # accepted first, in order
    acc_idx = torch.where(slot < a_count, order, torch.zeros_like(order))
    w_acc = w[acc_idx]
    link = (w_acc[1:] * w_acc[:-1]).sum(1)
    factors = torch.where(link < 0, -1.0, 1.0).to(w.dtype)
    sigma = torch.cat([torch.ones(1, dtype=w.dtype, device=dev), torch.cumprod(factors, 0)])
    return centers, acc_idx, a_count, sigma[:, None] * w_acc, valid


def dynamic_pc1_sliding(vx: torch.Tensor, vy: torch.Tensor, win_n: int, step_n: int,
                        min_samples: int = 3, ref=(0.0, 1.0)) -> torch.Tensor:
    """Dynamic PC1 waveform — behavioral clone of optical_PCA.py:136-235."""
    n = vx.shape[0]
    if n < min_samples or n < win_n:
        return torch.full((n,), float("nan"), dtype=vx.dtype, device=vx.device)

    centers, acc_idx, a_count, w_acc, _ = window_axes(vx, vy, win_n, step_n, min_samples, ref)
    k = centers.shape[0]
    dev = vx.device

    # Compact accepted centers, padded with a sentinel beyond the end so
    # searchsorted never selects a padding slot.
    slot = torch.arange(k, device=dev)
    c_acc = torch.where(slot < a_count, centers[acc_idx], torch.full_like(centers, _INT32_MAX))

    i = torch.arange(n, device=dev)
    j = torch.searchsorted(c_acc, i, side="left")
    j = torch.clamp(j, 0, max(a_count - 1, 0))
    j2 = torch.clamp(j - 1, min=0)
    # Strictly-closer → earlier center; ties → later.
    d2 = (i - c_acc[j2]).abs()
    d1 = (i - c_acc[j]).abs()
    pick = torch.where(d2 < d1, j2, j)

    e1 = w_acc[pick]
    pc1 = vx * e1[:, 0] + vy * e1[:, 1]
    ok = (torch.isfinite(vx) & torch.isfinite(vy) & torch.isfinite(e1[:, 0])
          & torch.isfinite(e1[:, 1]) & (a_count > 0))
    return torch.where(ok, pc1, torch.full_like(pc1, float("nan")))
