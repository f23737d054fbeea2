"""TV-L1 variational optical flow in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/tvl1.py``: the Zach–Pock–Bischof
duality-based TV-L1 with OpenCV DualTVL1 semantics.  Coarse to fine over
a pyramid; at each level ``n_warps`` re-linearisations of the data term
around the current flow, each followed by a Chambolle primal–dual chain
of ``n_iterations`` steps whose duals start at zero.

Two steps carry the work and each has a plain PyTorch version here and a
hand-written CUDA kernel behind ``ops/tvl1_cuda.py``:

- ``warp_sample_cf_plain`` (K5): bilinear sample of (I1, I1x, I1y) at
  (x+u, y+v) with cv2.remap's clamp;
- ``pd_chain_plain`` (K6): the primal–dual chain, in the factored form
  of the JAX package's resident kernel (hoisted -1/|∇I|², reciprocal
  dual scaling), with an optional ε early exit; on a CUDA tensor the
  fixed-length chain is K6 and the ε loop one launch of K6's ε step an
  iteration (``tvl1_cuda.pd_eps_chain``).

The ε exit is per pair: each pair of the batch keeps the flow of the
iteration at which its own mean squared update fell below ε², so a pair's
flow does not depend on the pairs it is batched with (a recording's answer
does not depend on ``run_full``'s chunk, nor on the tail chunk's padding).
This departs on purpose from the JAX package, whose loop runs until the
largest update over the batch falls below ε²; at B = 1 the two are one
loop.

Engines, resolved as the JAX package resolves them with the CUDA card in
the TPU's place: every ``warp_engine`` samples directly (K5 on a CUDA
tensor; the banded-warp knobs are accepted and ignored, since a direct
sample has no reach limit and never clips).  ``pd_engine`` "resident",
or "auto" on a CUDA tensor, asks for the fixed-length chain (K6 on a
CUDA tensor), which runs the full static ``n_iterations`` and ignores ε;
"xla", or "auto" on a CPU tensor, runs the ε early-exit loop (K6's ε
step on a CUDA tensor, plain PyTorch on the CPU).  As in the JAX
package (``ops/tvl1.py _tvl1_level``), the fixed-length chain is then
narrowed per pyramid level by ``_resident_ok``, a pure function of the
level's shape and ``n_iterations``: a level whose resident row blocks
would recompute a halo taller than themselves (padded width ≥ 896 px at
the default 30 iterations, e.g. level 0 of 720×1280 and levels 0–1 of
1080×1920) runs the ε loop instead, on whatever device it is on.  That is the
reference's engine choice, made the same way on every device; it never
depends on an error.

Host ranges (``utils/timing._range``, no fence) label a call's parts in a
profiled run: "tvl1.pyramid" (the blur and each level's resizes),
"tvl1.warp" (K5 and the linearisation), "tvl1.chain" (the fixed-length
chain, K6 on the card) and "tvl1.eps_loop" (one call of the ε loop, whose
host read each iteration waits for everything enqueued before it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from btcs_pnes_optical_flow_tpu_torch.ops import cvx, tvl1_cuda
from btcs_pnes_optical_flow_tpu_torch.utils.timing import _range


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    """The JAX package's ``ops/tvl1.py TVL1Params``: same fields, same
    defaults (that module imports JAX, so the class is copied here)."""

    tau: float = 0.25          # dual step size
    lambda_: float = 0.3       # data-term weight
    theta: float = 0.3         # coupling parameter
    n_scales: int = 3          # pyramid levels (0.5 scale factor)
    n_warps: int = 5           # warps per level
    n_iterations: int = 30     # max primal-dual iterations per warp
    # Early stop on the mean squared flow update per iteration (OpenCV
    # DualTVL1 semantics), per pair; 0 always runs the full n_iterations.
    # Only the ε loop reads it.
    epsilon: float = 0.001
    scale_step: float = 0.5
    warp_engine: str = "auto"  # "auto" | "exact" | "banded": all sample directly
    warp_d_max_y: int = 8      # banded-warp knobs of the TPU kernel: ignored
    warp_d_max_x: int = 16
    warp_base_max: int = 56
    warp_s_cap: int = 14
    pd_engine: str = "auto"    # "auto" | "xla" | "resident"


def _grad(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with zero at the far edge."""
    gx = torch.cat([img[..., :, 1:] - img[..., :, :-1], torch.zeros_like(img[..., :, :1])], -1)
    gy = torch.cat([img[..., 1:, :] - img[..., :-1, :], torch.zeros_like(img[..., :1, :])], -2)
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence (adjoint of _grad)."""
    dx = torch.cat([px[..., :, :1], px[..., :, 1:-1] - px[..., :, :-2], -px[..., :, -2:-1]], -1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :], -py[..., -2:-1, :]], -2)
    return dx + dy


def _sample(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample of src (B, C, H, W) at (x+u, y+v), u and v
    (B, H, W): the coordinates once, then four taps per channel."""
    b, c, h, w = src.shape
    dt, dev = src.dtype, src.device
    gx = (torch.arange(w, dtype=dt, device=dev) + u).clamp(0.0, w - 1.0)
    gy = (torch.arange(h, dtype=dt, device=dev)[:, None] + v).clamp(0.0, h - 1.0)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = src.reshape(b, c, h * w)

    def take(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = take(y0i, x0i) * (1 - fx) + take(y0i, x1i) * fx
    bot = take(y1i, x0i) * (1 - fx) + take(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def _warp_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample img (B, H, W) at (x+u, y+v), clamped bilinear."""
    return _sample(img[:, None], u, v)[:, 0]


def warp_sample_cf_plain(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K5 plain: src (B, C, H, W) at (x+u, y+v) with flow (B, 2, H, W) →
    (B, C, H, W); ``_warp_bilinear`` of each channel."""
    return _sample(src, flow[:, 0], flow[:, 1])


def pd_chain_plain(u, v, rho_c, i1wx, i1wy, grad_sq, n_iterations: int, tau: float,
                   lambda_: float, theta: float, epsilon: float = 0.0):
    """K6 plain: one warp's primal–dual chain, all planes (B, H, W).

    Returns (u, v) after ``n_iterations`` steps from zero duals.  With
    ``epsilon > 0`` each pair stops after the first step whose mean
    squared update over its own plane is below epsilon², and keeps that
    step's (u, v); the loop ends when every pair has stopped (one host
    read a step).  The JAX package's "xla" engine stops the whole batch
    on its largest update instead; at B = 1 the two are the same loop.
    """
    l_t = lambda_ * theta
    tau_theta = tau / theta
    neg_inv_gs = -1.0 / torch.clamp_min(grad_sq, 1e-9)
    wx_igs = i1wx * neg_inv_gs
    wy_igs = i1wy * neg_inv_gs
    p11 = p12 = p21 = p22 = torch.zeros_like(u)
    active = torch.ones(u.shape[:-2], dtype=torch.bool, device=u.device) if epsilon > 0 else None
    for _ in range(n_iterations):
        rho = rho_c + i1wx * u + i1wy * v
        lo = rho < -l_t * grad_sq
        hi = rho > l_t * grad_sq
        d1 = torch.where(lo, l_t * i1wx, torch.where(hi, -l_t * i1wx, rho * wx_igs))
        d2 = torch.where(lo, l_t * i1wy, torch.where(hi, -l_t * i1wy, rho * wy_igs))
        u_new = u + d1 + theta * _div(p11, p12)
        v_new = v + d2 + theta * _div(p21, p22)
        ux, uy = _grad(u_new)
        vx, vy = _grad(v_new)
        r_u = 1.0 / (1.0 + tau_theta * torch.sqrt(ux * ux + uy * uy))
        r_v = 1.0 / (1.0 + tau_theta * torch.sqrt(vx * vx + vy * vy))
        p11 = (p11 + tau_theta * ux) * r_u
        p12 = (p12 + tau_theta * uy) * r_u
        p21 = (p21 + tau_theta * vx) * r_v
        p22 = (p22 + tau_theta * vy) * r_v
        if active is None:
            u, v = u_new, v_new
            continue
        err = ((u_new - u) ** 2 + (v_new - v) ** 2).mean(dim=(-2, -1))
        keep = active[..., None, None]
        u, v = torch.where(keep, u_new, u), torch.where(keep, v_new, v)
        active = active & ~(err < epsilon * epsilon)
        if not bool(active.any()):
            break
    return u, v


def _check_warp_engine(engine: str) -> None:
    if engine not in ("auto", "exact", "banded"):
        raise ValueError(f"unknown TV-L1 warp_engine {engine!r}")


def _resolve_pd_engine(engine: str, device: torch.device) -> bool:
    """True for the fixed-length chain (K6), False for the ε loop."""
    if engine == "auto":
        return device.type == "cuda"
    if engine not in ("xla", "resident"):
        raise ValueError(f"unknown TV-L1 pd_engine {engine!r}")
    return engine == "resident"


def _resident_geometry(h: int, w: int, n_iterations: int) -> Tuple[int, int]:
    """(rows per block, halo rows) of the JAX package's resident chain:
    the integer geometry of its ``ops/tvl1_pallas.py _block_geometry``,
    copied.  A level whose slab fits 6 MB runs as one block, no halo."""
    wp = -(-w // 128) * 128
    hp = -(-h // 8) * 8
    halo = -(-2 * n_iterations // 8) * 8
    if 16 * hp * wp * 4 <= 6 << 20:
        return hp, 0
    bh = max(8, (((10 << 20) // (16 * 4 * wp)) - 2 * halo) // 8 * 8)
    return min(bh, hp), halo


def _resident_ok(h: int, w: int, p: TVL1Params) -> bool:
    """The JAX package's per-level check (``ops/tvl1.py _resident_ok``):
    the fixed-length chain runs at an (h, w) level only when its row
    blocks are at least as tall as their halo."""
    bh, halo = _resident_geometry(h, w, p.n_iterations)
    return halo == 0 or bh >= halo


def _unit(frames: torch.Tensor) -> torch.Tensor:
    """frames / 255 in float32, divided on either device.  A CUDA tensor
    divided by a Python scalar is multiplied by the scalar's float32
    reciprocal instead, which rounds apart from the division for 126 of
    the 256 pixel values; through the data term's thresholds that moved
    TV-L1's flow at 112×896 by 1.1e-3 px between the card and the CPU."""
    return frames.float() / torch.full((), 255.0, device=frames.device)


def _pyramid_sizes(h: int, w: int, params: TVL1Params):
    sizes = [(h, w)]
    for _ in range(params.n_scales - 1):
        hh, ww = sizes[-1]
        nh, nw = max(round(hh * params.scale_step), 16), max(round(ww * params.scale_step), 16)
        if (nh, nw) == sizes[-1]:
            break
        sizes.append((nh, nw))
    return sizes


def _linearise(i0, src, u, v, warp):
    """Warp src = (I1, I1x, I1y) (B, 3, H, W) to the flow (u, v) with
    ``warp`` and linearise the data term there: the chain's inputs
    (rho_c, I1wx, I1wy, |∇I1w|²), each contiguous (B, H, W)."""
    s = warp(src, torch.stack([u, v], dim=1))
    i1wx, i1wy = s[:, 1].contiguous(), s[:, 2].contiguous()
    grad_sq = i1wx * i1wx + i1wy * i1wy
    rho_c = s[:, 0] - i1wx * u - i1wy * v - i0
    return rho_c, i1wx, i1wy, grad_sq


def _tvl1_level(i0, i1, u, v, p: TVL1Params, resident: bool, kernels: bool):
    """One pyramid level: n_warps × (linearise + primal–dual)."""
    warp = tvl1_cuda.warp_sample_cf if kernels else warp_sample_cf_plain
    chain = tvl1_cuda.pd_chain if kernels else pd_chain_plain
    eps_chain = tvl1_cuda.pd_eps_chain if kernels else pd_chain_plain
    resident = resident and _resident_ok(*u.shape[-2:], p)
    # I1 and its gradient do not change across the level's warps.
    with _range("tvl1.warp"):
        src = torch.stack([i1, *_grad(i1)], dim=1)
    for _ in range(p.n_warps):
        with _range("tvl1.warp"):
            planes = _linearise(i0, src, u, v, warp)
        if resident:
            with _range("tvl1.chain"):
                u, v = chain(u, v, *planes, p.n_iterations, p.tau, p.lambda_, p.theta)
        else:
            with _range("tvl1.eps_loop"):
                u, v = eps_chain(u, v, *planes, p.n_iterations, p.tau, p.lambda_, p.theta,
                                 epsilon=p.epsilon)
    return u, v


def tvl1_flow(prev: torch.Tensor, curr: torch.Tensor, params: TVL1Params = TVL1Params(),
              return_clip: bool = False, *, kernels: bool = True):
    """Dense TV-L1 flow.  prev, curr: (B, H, W) or (H, W), uint8 or float;
    returns flow (B, H, W, 2) (or (H, W, 2)) with channels (u, v) in pixels.

    With ``return_clip=True`` also returns the per-pair count of clamped
    warp candidates, int32 zeros: the direct sample never clips.
    ``kernels=False`` runs the plain versions of K5 and K6 with the kernel
    path's engine choice (the on-card reference).  The pyramid is the JAX
    package's: blur the full-size frame (5 taps, σ 0.8, reflect-101), then
    ``resize_bilinear_mm`` to each level; flows go up by 1/scale_step.
    """
    squeeze = prev.ndim == 2
    if squeeze:
        prev, curr = prev[None], curr[None]
    _check_warp_engine(params.warp_engine)
    resident = _resolve_pd_engine(params.pd_engine, prev.device)
    b, h, w = prev.shape
    with _range("tvl1.pyramid"):
        i0b = cvx.gaussian_blur_reflect101(_unit(prev), 5, 0.8)
        i1b = cvx.gaussian_blur_reflect101(_unit(curr), 5, 0.8)

    u = v = None
    for hh, ww in reversed(_pyramid_sizes(h, w, params)):
        with _range("tvl1.pyramid"):
            i0s = cvx.resize_bilinear_mm(i0b, hh, ww)
            i1s = cvx.resize_bilinear_mm(i1b, hh, ww)
            if u is None:
                u = torch.zeros((b, hh, ww), dtype=torch.float32, device=prev.device)
                v = torch.zeros_like(u)
            else:
                inv = 1.0 / params.scale_step
                u = cvx.resize_bilinear_mm(u, hh, ww) * inv
                v = cvx.resize_bilinear_mm(v, hh, ww) * inv
        u, v = _tvl1_level(i0s, i1s, u, v, params, resident, kernels)

    flow = torch.stack([u, v], dim=-1)
    clips = torch.zeros((b,), dtype=torch.int32, device=prev.device)
    if squeeze:
        flow, clips = flow[0], clips[0]
    return (flow, clips) if return_clip else flow
