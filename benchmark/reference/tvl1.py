"""Plain TV-L1 optical flow of frame pairs: the benchmark's reference of
the ``tvl1`` configuration's flow stage.

TV-L1 as Zach, Pock and Bischof give it ("A Duality Based Approach for
Realtime TV-L1 Optical Flow", DAGM 2007), in the discretisation of
OpenCV's ``DualTVL1OpticalFlow``.  Coarse to fine over a pyramid; at each
level ``n_warps`` times: sample I1 and its gradient at (x + u0, y + v0)
and linearise the data term there,

    rho(u, v) = I1w + I1wx (u - u0) + I1wy (v - v0) - I0,

then run the primal-dual chain from zero duals p = (p11, p12, p21, p22):

    v' = u - lambda theta I1wx        where rho < -lambda theta |grad I1w|^2
         u + lambda theta I1wx        where rho >  lambda theta |grad I1w|^2
         u - rho I1wx / |grad I1w|^2  elsewhere              (and so for v)
    u  = v' + theta div(p11, p12)
    p  = (p + tau/theta grad u) / (1 + tau/theta |grad u|)

with the forward-difference gradient (zero at the far edge), the
backward-difference divergence (its adjoint) and clamped bilinear
sampling.  A pair stops iterating once its mean squared update
mean((u - u_prev)^2 + (v - v_prev)^2) falls below epsilon^2 and keeps
that iteration's flow (OpenCV computes one pair at a time); a batch of
pairs here is each pair alone.  The flow goes up a level by a bilinear
resize and 1 / scale_step.

Written in plain PyTorch, nothing of the program under test: every
division divides where it stands (the program multiplies by reciprocals
hoisted out of its loops), each step is written out over whole planes,
and there is no kernel, no chunk and no padding.  ``dtype`` is the
precision of every plane: float32 is the reference; bfloat16 is the
control that the comparison must refuse (sample coordinates stay in
float32, as a bfloat16 coordinate could not address a column past 256).
The caller turns TF32 off.

Departures from OpenCV's ``DualTVL1`` defaults, each the program's
``TVL1Params()`` (the JAX package's defaults):

- lambda 0.3 (OpenCV 0.15), on intensities in [0, 1] (frames / 255;
  OpenCV keeps 0-255), tau 0.25 and theta 0.3 as OpenCV's;
- 3 scales at ratio 0.5 (OpenCV 5 at 0.8); every level is the full
  frame blurred once (5 taps, sigma 0.8, reflect-101) and resized
  bilinearly (cv2 INTER_LINEAR taps, ``reference/farneback.py``'s);
- epsilon 0.001 (OpenCV 0.01) checked after every iteration, and at most
  30 iterations a warp (OpenCV 300);
- the fixed-length levels (``fixed_length``): where the program's rule
  says so, a level runs all ``n_iterations`` with no epsilon stop;
- no median filtering of the flow (OpenCV filters it between warps);
- I1's gradient by forward differences (OpenCV: centred differences) and
  the warp by clamped bilinear sampling (OpenCV: a bicubic remap);
- the data term divides by max(|grad I1w|^2, 1e-9) (OpenCV skips the
  division below FLT_EPSILON).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import farneback as rf


@dataclasses.dataclass(frozen=True)
class Params:
    """The TV-L1 settings a configuration file states (its ``tvl1`` group)
    over the program's defaults; the TPU warp knobs are ignored."""

    tau: float = 0.25
    lambda_: float = 0.3
    theta: float = 0.3
    n_scales: int = 3
    n_warps: int = 5
    n_iterations: int = 30
    epsilon: float = 0.001
    scale_step: float = 0.5
    pd_engine: str = "auto"

    @classmethod
    def of(cls, group: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in group.items() if k in names})


def pyramid_sizes(h: int, w: int, p: Params):
    """Level sizes, finest first: each the one above times scale_step,
    rounded half to even, at least 16 px a side."""
    sizes = [(h, w)]
    for _ in range(p.n_scales - 1):
        hh, ww = sizes[-1]
        nh, nw = max(round(hh * p.scale_step), 16), max(round(ww * p.scale_step), 16)
        if (nh, nw) == sizes[-1]:
            break
        sizes.append((nh, nw))
    return sizes


def fixed_length(h: int, w: int, p: Params, device) -> bool:
    """Whether an (h, w) level runs all ``n_iterations`` with no epsilon
    stop.  The program's rule: with ``pd_engine`` "resident", or "auto" on
    a CUDA device, a level takes its fixed-length chain where the JAX
    package's TPU geometry accepts it (``ops/tvl1.py _resident_ok`` over
    ``ops/tvl1_pallas.py _block_geometry`` of that package, integer rule
    copied): the slab fits 6 MB, or its row blocks are at least as tall as
    their halo of 2 n_iterations rows.  At 1080x1920 only 270x480 does."""
    if not (p.pd_engine == "resident"
            or (p.pd_engine == "auto" and torch.device(device).type == "cuda")):
        return False
    wp = -(-w // 128) * 128
    hp = -(-h // 8) * 8
    halo = -(-2 * p.n_iterations // 8) * 8
    if 16 * hp * wp * 4 <= 6 << 20:
        return True
    bh = max(8, (((10 << 20) // (16 * 4 * wp)) - 2 * halo) // 8 * 8)
    return min(bh, hp) >= halo


def blur(img):
    """cv2.GaussianBlur(img, (5, 5), 0.8), BORDER_REFLECT_101."""
    g = rf.gaussian_kernel(5, 0.8)
    return rf._corr(rf._corr(rf._pad(img, 2, "reflect101"), g, -2), g, -1)


def grad(z):
    """Forward differences (d/dx, d/dy), zero at the far edge."""
    zx = torch.zeros_like(z)
    zy = torch.zeros_like(z)
    zx[..., :, :-1] = z[..., :, 1:] - z[..., :, :-1]
    zy[..., :-1, :] = z[..., 1:, :] - z[..., :-1, :]
    return zx, zy


def div(px, py):
    """Backward-difference divergence, the negative adjoint of ``grad``:
    px[x] - px[x-1] inside, px[0] at the first column, -px[w-2] at the
    last (and so for py along the rows)."""
    dx = torch.empty_like(px)
    dx[..., :, 0] = px[..., :, 0]
    dx[..., :, 1:-1] = px[..., :, 1:-1] - px[..., :, :-2]
    dx[..., :, -1] = -px[..., :, -2]
    dy = torch.empty_like(py)
    dy[..., 0, :] = py[..., 0, :]
    dy[..., 1:-1, :] = py[..., 1:-1, :] - py[..., :-2, :]
    dy[..., -1, :] = -py[..., -2, :]
    return dx + dy


def sample(img, u, v):
    """img (B, H, W) at (x + u, y + v), the coordinates clamped to the
    frame, bilinear between the four neighbours."""
    b, h, w = img.shape
    dev = img.device
    x = (torch.arange(w, device=dev, dtype=torch.float32) + u.float()).clamp(0.0, w - 1.0)
    y = (torch.arange(h, device=dev, dtype=torch.float32)[:, None] + v.float()).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = (x - x0).to(img.dtype), (y - y0).to(img.dtype)
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    flat = img.reshape(b, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(b, h * w)).reshape(b, h, w)

    top = at(y0, x0) * (1 - ax) + at(y0, x1) * ax
    bottom = at(y1, x0) * (1 - ax) + at(y1, x1) * ax
    return top * (1 - ay) + bottom * ay


def primal_dual(u0, v0, i0, i1w, i1wx, i1wy, p: Params, epsilon: float):
    """One warp's chain from (u0, v0) and zero duals; each pair stops at
    the first iteration whose mean squared update is below epsilon^2
    (none where epsilon is 0)."""
    lt = p.lambda_ * p.theta
    taut = p.tau / p.theta
    gsq = i1wx * i1wx + i1wy * i1wy
    u, v = u0, v0
    p11, p12, p21, p22 = (torch.zeros_like(u0) for _ in range(4))
    going = torch.ones(u0.shape[0], dtype=torch.bool, device=u0.device)
    for _ in range(p.n_iterations):
        rho = i1w + i1wx * (u - u0) + i1wy * (v - v0) - i0
        low = rho < -lt * gsq
        high = rho > lt * gsq
        den = torch.clamp_min(gsq, 1e-9)
        vu = torch.where(low, u + lt * i1wx,
                         torch.where(high, u - lt * i1wx, u - rho * i1wx / den))
        vv = torch.where(low, v + lt * i1wy,
                         torch.where(high, v - lt * i1wy, v - rho * i1wy / den))
        un = vu + p.theta * div(p11, p12)
        vn = vv + p.theta * div(p21, p22)
        ux, uy = grad(un)
        vx, vy = grad(vn)
        nu = 1 + taut * torch.sqrt(ux * ux + uy * uy)
        nv = 1 + taut * torch.sqrt(vx * vx + vy * vy)
        p11 = (p11 + taut * ux) / nu
        p12 = (p12 + taut * uy) / nu
        p21 = (p21 + taut * vx) / nv
        p22 = (p22 + taut * vy) / nv
        step = ((un - u) ** 2 + (vn - v) ** 2).mean(dim=(-2, -1))
        keep = going[:, None, None]
        u = torch.where(keep, un, u)
        v = torch.where(keep, vn, v)
        if epsilon > 0:
            going = going & (step >= epsilon * epsilon)
            if not bool(going.any()):
                break
    return u, v


def flow_pairs(prev, curr, p: Params, dtype=torch.float32):
    """TV-L1 flow (B, 2, H, W), channels (u, v) in pixels, of the frame
    pairs prev -> curr (B, H, W) uint8, on their device."""
    b, h, w = prev.shape
    dev = prev.device
    scale = torch.full((), 255.0, dtype=dtype, device=dev)
    i0b, i1b = (blur(f.to(dtype) / scale) for f in (prev, curr))
    u = v = None
    for hh, ww in reversed(pyramid_sizes(h, w, p)):
        i0 = rf.resize_bilinear(i0b, hh, ww)
        i1 = rf.resize_bilinear(i1b, hh, ww)
        if u is None:
            u = torch.zeros((b, hh, ww), dtype=dtype, device=dev)
            v = torch.zeros_like(u)
        else:
            u = rf.resize_bilinear(u, hh, ww) / p.scale_step
            v = rf.resize_bilinear(v, hh, ww) / p.scale_step
        epsilon = 0.0 if fixed_length(hh, ww, p, dev) else p.epsilon
        i1x, i1y = grad(i1)
        for _ in range(p.n_warps):
            i1w, i1wx, i1wy = (sample(z, u, v) for z in (i1, i1x, i1y))
            u, v = primal_dual(u, v, i0, i1w, i1wx, i1wy, p, epsilon)
    return torch.stack([u, v], dim=1)
