"""Rank statistics and regressions in PyTorch, over masked fixed shapes.

Port of ``btcs_pnes_optical_flow_tpu/ops/stats.py``, in float32 as the
JAX package computes them, so that the two agree (Kendall τ-b's tie
structure included):

- ``kendalltau_masked``  ↔ scipy.stats.kendalltau (τ-b, method='auto':
  the exact two-sided p from Kendall's inversion-count DP, or the
  tie-corrected normal approximation);
- ``linregress_masked``  ↔ scipy.stats.linregress (slope, intercept, r);
- ``safe_auc_masked``, ``estimate_fs_masked``,
  ``exp_decay_regression_masked``: the three helpers the reference calls
  but never defines (optical_PC1.py:263-270).

Every function takes a validity mask; invalid slots are ignored as if
the arrays had been compacted.  The samples lie along the last axis: one
series ``(N,)`` gives scalars, K of them ``(K, N)`` give ``(K,)`` (the JAX
package's ``vmap``), and no function reads a value back to the host.
"""

from __future__ import annotations

import math

import torch

# scipy's 'auto' rule takes the exact distribution when there are no ties
# and (n <= 33 or min(dis, tot-dis) <= 1).
_EXACT_N_MAX = 33
_EXACT_C_MAX = (_EXACT_N_MAX * (_EXACT_N_MAX - 1)) // 4 + 1  # 265


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over valid entries (numpy: mean of the two middles)."""
    xs = torch.sort(torch.where(valid, x, _full(x, float("inf"))), dim=-1).values
    c = valid.sum(-1, keepdim=True)
    lo = xs.gather(-1, torch.clamp((c - 1) // 2, min=0))[..., 0]
    hi = xs.gather(-1, torch.clamp(c // 2, min=0))[..., 0]
    return torch.where(c[..., 0] > 0, 0.5 * (lo + hi), _full(x, float("nan")))


def estimate_fs_masked(time: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Sampling rate of a compacted time vector, 1 / median(diff), over
    consecutive live samples (``m`` marks the live prefix)."""
    d = time[..., 1:] - time[..., :-1]
    return 1.0 / masked_median(d, m[..., 1:] & m[..., :-1])


def safe_auc_masked(amp: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """NaN-robust trapezoid of amp(t) over consecutive finite pairs; NaN
    when fewer than 2 finite samples exist."""
    zero = _full(amp, 0.0)
    fin = torch.isfinite(amp) & torch.isfinite(time)
    pair = fin[..., 1:] & fin[..., :-1]
    a0 = torch.where(fin[..., :-1], amp[..., :-1], zero)
    a1 = torch.where(fin[..., 1:], amp[..., 1:], zero)
    dt = torch.where(pair, time[..., 1:] - time[..., :-1], zero)
    total = torch.where(pair, 0.5 * (a0 + a1) * dt, zero).sum(-1)
    return torch.where(fin.sum(-1) >= 2, total, _full(amp, float("nan")))


def linregress_masked(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor):
    """OLS (slope, intercept, r) over masked samples, scipy's degenerate
    cases: r = 0 when either variance vanishes, NaN slope when the
    x-variance is 0, all NaN with fewer than 2 samples."""
    zero = _full(x, 0.0)
    nan = _full(x, float("nan"))
    n = m.to(x.dtype).sum(-1)
    nsafe = torch.clamp(n, min=1.0)
    xm = torch.where(m, x, zero).sum(-1) / nsafe
    ym = torch.where(m, y, zero).sum(-1) / nsafe
    dx = torch.where(m, x - xm.unsqueeze(-1), zero)
    dy = torch.where(m, y - ym.unsqueeze(-1), zero)
    ssxm = (dx * dx).sum(-1)
    ssym = (dy * dy).sum(-1)
    ssxym = (dx * dy).sum(-1)
    slope = torch.where(ssxm > 0, ssxym / torch.clamp(ssxm, min=1e-30), nan)
    intercept = ym - slope * xm
    denom = torch.sqrt(torch.clamp(ssxm * ssym, min=1e-30))
    r = torch.where((ssxm > 0) & (ssym > 0), ssxym / denom, zero)
    r = torch.clamp(r, -1.0, 1.0)
    bad = n < 2
    return torch.where(bad, nan, slope), torch.where(bad, nan, intercept), torch.where(bad, nan, r)


def exp_decay_regression_masked(time: torch.Tensor, amp: torch.Tensor, m: torch.Tensor):
    """Amplitude-decay slope: ln(amp) regressed on time over finite amp > 0;
    returns (slope, r), NaN with fewer than 2 such points."""
    ok = m & torch.isfinite(amp) & (amp > 0) & torch.isfinite(time)
    la = torch.log(torch.where(ok, amp, _full(amp, 1.0)))
    slope, _, r = linregress_masked(time, la, ok)
    bad = ok.sum(-1) < 2
    nan = _full(amp, float("nan"))
    return torch.where(bad, nan, slope), torch.where(bad, nan, r)


def _kendall_p_exact_two_sided(n: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact two-sided p of Kendall's statistic for n samples and the
    folded discordant count c = min(dis, tot-dis) (int64 tensors of one
    shape), in float32.

    The null distribution of the discordant count is the inversion-number
    distribution of random permutations, built by the recurrence
    f_j = windowed-cumsum(f_{j-1}) (scipy's ``_kendall_p_exact``) for
    j = 3…33, each step kept only where j <= n (the JAX package's
    ``fori_loop``); past n = 33 scipy's 'auto' rule takes the exact method
    only for c <= 1, which has a closed form (count(k<=0) = 1,
    count(k<=1) = n).
    """
    kmax = _EXACT_C_MAX
    idx = torch.arange(kmax, device=n.device)
    js = torch.arange(3, _EXACT_N_MAX + 1, device=n.device)[:, None]
    cm = torch.clamp(c, max=kmax - 1).unsqueeze(-1)
    # Step j subtracts the cumsum shifted by j where j <= idx and j <= c
    # (g - 0 elsewhere, which is g), and is kept where j <= n.  The masks
    # and gather indices of all steps are formed before the loop.
    shifts = torch.clamp(idx - js, min=0).unbind(0)
    subs = ((idx >= js) & (js <= cm.unsqueeze(-1))).unbind(-2)
    keeps = (js[:, 0] <= n.unsqueeze(-1)).unsqueeze(-1).unbind(-2)
    new = (idx < 2).to(torch.float32).expand(*n.shape, kmax)
    for shift, sub, keep in zip(shifts, subs, keeps):
        g = torch.cumsum(new, -1)
        new = torch.where(keep, torch.where(sub, g - g[..., shift], g), new)
    total = torch.where(idx <= cm, new, torch.zeros((), device=n.device)).sum(-1)
    nf = n.to(torch.float32)
    log_nfact = torch.lgamma(nf + 1.0)
    prob = 2.0 * total * torch.exp(-log_nfact)
    prob_big = torch.where(c <= 0, 2.0 * torch.exp(-log_nfact), 2.0 * torch.exp(-torch.lgamma(nf)))
    prob = torch.where(n > _EXACT_N_MAX, prob_big, prob)
    # c at the distribution's midpoint: the two-sided p is 1.
    prob = torch.where(4 * c == n * (n - 1), torch.ones_like(prob), prob)
    return torch.clamp(prob, 0.0, 1.0)


def kendalltau_masked(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor):
    """Kendall τ-b and its two-sided p over masked samples (scipy
    kendalltau, method='auto'); (nan, nan) when degenerate.

    Pairwise O(n²) form (n is the number of inter-peak intervals):
    concordant minus discordant is Σ_{i<j} sgn(Δx)·sgn(Δy); the tie
    corrections come from each element's tied-group size.  The exact and
    the asymptotic p are both computed and chosen per series, as
    ``lax.cond`` under ``vmap`` does in the JAX package.
    """
    dt = x.dtype
    zero = _full(x, 0.0)
    one = _full(x, 1.0)
    n = m.sum(-1)
    mm = m[..., :, None] & m[..., None, :]
    pair = mm & torch.triu(torch.ones(mm.shape[-2:], dtype=torch.bool, device=x.device),
                           diagonal=1)
    dxs = torch.sign(x[..., None, :] - x[..., :, None])
    dys = torch.sign(y[..., None, :] - y[..., :, None])
    cmd = torch.where(pair, dxs * dys, zero).sum((-2, -1))

    ex = x[..., None, :] == x[..., :, None]
    ey = y[..., None, :] == y[..., :, None]
    xtie = torch.where(pair & ex, one, zero).sum((-2, -1))
    ytie = torch.where(pair & ey, one, zero).sum((-2, -1))
    ntie = torch.where(pair & ex & ey, one, zero).sum((-2, -1))

    cx = torch.where(mm & ex, one, zero).sum(-1)  # tied-group size per i
    cy = torch.where(mm & ey, one, zero).sum(-1)
    mv = m.to(dt)
    x0 = (mv * (cx - 1.0) * (cx - 2.0)).sum(-1)  # Σ t(t-1)(t-2)
    y0 = (mv * (cy - 1.0) * (cy - 2.0)).sum(-1)
    x1 = (mv * (cx - 1.0) * (2.0 * cx + 5.0)).sum(-1)  # Σ t(t-1)(2t+5)
    y1 = (mv * (cy - 1.0) * (2.0 * cy + 5.0)).sum(-1)

    nf = n.to(dt)
    tot = nf * (nf - 1.0) / 2.0
    dis = (tot - xtie - ytie + ntie - cmd) / 2.0
    denom = (torch.sqrt(torch.clamp(tot - xtie, min=1e-30))
             * torch.sqrt(torch.clamp(tot - ytie, min=1e-30)))
    tau = torch.clamp(cmd / denom, -1.0, 1.0)

    cfold = torch.minimum(dis, tot - dis)
    use_exact = (xtie == 0) & (ytie == 0) & ((n <= _EXACT_N_MAX) | (cfold <= 1.0))
    p_exact = _kendall_p_exact_two_sided(n, cfold.to(torch.int64)).to(dt)
    mfac = nf * (nf - 1.0)
    var = ((mfac * (2.0 * nf + 5.0) - x1 - y1) / 18.0
           + (2.0 * xtie * ytie) / torch.clamp(mfac, min=1.0)
           + x0 * y0 / torch.clamp(9.0 * mfac * (nf - 2.0), min=1.0))
    z = cmd / torch.sqrt(torch.clamp(var, min=1e-30))
    p_asym = torch.special.erfc(torch.abs(z) / math.sqrt(2.0))
    p = torch.where(use_exact, p_exact, p_asym)

    nan = _full(x, float("nan"))
    degenerate = (n < 2) | (xtie >= tot) | (ytie >= tot)
    return torch.where(degenerate, nan, tau), torch.where(degenerate, nan, p)
