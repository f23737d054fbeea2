"""Plain dense Farnebäck flow and the ROI features of a frame sequence.

The benchmark's own reference of the flow stage: OpenCV's
calcOpticalFlowFarneback (per-level images by Gaussian blur of the
full-resolution frame and a bilinear resize, a quadratic polynomial
expansion per frame, then per iteration a bilinear warp of the second
expansion with the normal-equation assembly, a box-window average and a
regularised 2x2 solve), written in plain PyTorch over whole frames: no
kernels, no ROI boxes, no chunk padding.  The warp's horizontal lerp
runs in bfloat16 where the configuration states ``warp_precision:
"bf16"`` (each tap and weight, each product and the sum rounded to
bfloat16, the ``(1 - ax) v0`` term first), else in float32.

``dtype`` is the precision of every plane: float32 is the reference;
bfloat16 is the control that the comparison must refuse.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# Rim damping of the normal equations near the image border (5-pixel ramp).
BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def round_half_even(x: float) -> int:
    f = math.floor(x)
    d = x - f
    if d > 0.5:
        return f + 1
    if d < 0.5:
        return f
    return f + 1 if f % 2 else f


class Params:
    """The Farnebäck settings a configuration file states (``flow`` key),
    over OpenCV's defaults of the reference script: pyr_scale 0.5, 3
    levels, winsize 15, 3 iterations, poly_n 5, poly_sigma 1.2, no flags."""

    def __init__(self, pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
                 poly_sigma=1.2, iter_schedule=None, warp_precision="fp32", **_ignored):
        self.pyr_scale = float(pyr_scale)
        self.levels = int(levels)
        self.winsize = int(winsize)
        self.iterations = int(iterations)
        self.poly_n = int(poly_n)
        self.poly_sigma = float(poly_sigma)
        self.iter_schedule = tuple(iter_schedule) if iter_schedule else None
        self.warp_precision = warp_precision

    def iters_at(self, k: int) -> int:
        if not self.iter_schedule:
            return self.iterations
        return self.iter_schedule[min(k, len(self.iter_schedule) - 1)]

    def num_levels(self, h: int, w: int, min_size: int = 32) -> int:
        """Extra pyramid levels OpenCV keeps: each at least 32 px a side."""
        k, scale = 0, 1.0
        while k < self.levels:
            scale *= self.pyr_scale
            if w * scale < min_size or h * scale < min_size:
                break
            k += 1
        return k

    def level_size(self, h: int, w: int, k: int):
        s = self.pyr_scale ** k
        return round_half_even(h * s), round_half_even(w * s)


# ---------------------------------------------------------------------------
# Image primitives (OpenCV semantics), over the last two axes
# ---------------------------------------------------------------------------

def _pad_index(n, p, mode, device):
    i = np.arange(-p, n + p)
    if mode == "replicate":
        i = np.clip(i, 0, n - 1)
    else:  # reflect101
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        i = np.where(i > n - 1, period - i, i)
    return torch.as_tensor(i, dtype=torch.long, device=device)


def _pad(img, p, mode):
    h, w = img.shape[-2:]
    img = img.index_select(-2, _pad_index(h, p, mode, img.device))
    return img.index_select(-1, _pad_index(w, p, mode, img.device))


def _taps(kernel):
    """Host taps in float64, rounded to float32 where they meet the data."""
    return [float(v) for v in np.asarray(kernel, np.float64).astype(np.float32)]


def _corr(img, kernel, axis, stride=1, start=0, n_out=None):
    """'VALID' 1-D correlation of a padded image, tap by tap in order:
    out[d] = sum_i k[i] x[start + d stride + i]."""
    taps = _taps(kernel)
    if n_out is None:
        n_out = (img.shape[axis] - len(taps)) // stride + 1
    span = (n_out - 1) * stride + 1

    def tap(i):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(start + i, start + i + span, stride)
        return img[tuple(sl)]

    acc = tap(0) * taps[0]
    for i in range(1, len(taps)):
        acc = acc + tap(i) * taps[i]
    return acc


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: for sigma <= 0 OpenCV's fixed 3- and 5-tap
    kernels, else sampled and normalised (level 0 has sigma 0, so the
    full-resolution frame is blurred by [1/4, 1/2, 1/4])."""
    fixed = {3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625]}
    if sigma <= 0 and ksize in fixed:
        return np.asarray(fixed[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _axis_taps(n_in, n_out):
    """cv2 INTER_LINEAR taps along one axis."""
    d = np.arange(n_out, dtype=np.float64)
    s = (d + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s).astype(np.int64)
    frac = np.where(i0 < 0, 0.0, s - i0)
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.clip(i0 + 1, 0, n_in - 1), frac.astype(np.float32)


def resize_bilinear(img, out_h, out_w):
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    dev = img.device
    y0, y1, fy = _axis_taps(in_h, out_h)
    x0, x1, fx = _axis_taps(in_w, out_w)
    fy = torch.as_tensor(fy, device=dev).to(img.dtype)[:, None]
    fx = torch.as_tensor(fx, device=dev).to(img.dtype)
    rows = (img.index_select(-2, torch.as_tensor(y0, device=dev)) * (1.0 - fy)
            + img.index_select(-2, torch.as_tensor(y1, device=dev)) * fy)
    return (rows.index_select(-1, torch.as_tensor(x0, device=dev)) * (1.0 - fx)
            + rows.index_select(-1, torch.as_tensor(x1, device=dev)) * fx)


def level_image(img, k, p: Params, h, w):
    """Level k of a full-resolution frame: Gaussian blur (reflect101) with
    sigma = (1/scale - 1)/2, then the bilinear resize.  At pyr_scale 0.5
    with a frame of 2^k times the level's size both collapse into one
    strided correlation with the blur convolved with [0.5, 0.5]."""
    scale = p.pyr_scale ** k
    sigma = (1.0 / scale - 1.0) * 0.5
    ksize = max(round_half_even(sigma * 5) | 1, 3)
    hk, wk = p.level_size(h, w, k)
    g = gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    if k > 0 and p.pyr_scale == 0.5 and (h, w) == (hk * 2 ** k, wk * 2 ** k):
        m = 2 ** k
        comb = np.convolve(g, [0.5, 0.5])
        xp = _pad(img, pad, "reflect101")
        v = _corr(xp, comb, -2, m, (m - 2) // 2, hk)
        return _corr(v, comb, -1, m, (m - 2) // 2, wk)
    xp = _pad(img, pad, "reflect101")
    return resize_bilinear(_corr(_corr(xp, g, -2), g, -1), hk, wk)


# ---------------------------------------------------------------------------
# The three steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _poly_tables(n: int, sigma: float):
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    basis, wts = [], []
    for yy in x:
        for xx in x:
            wts.append(g[int(yy) + n] * g[int(xx) + n])
            basis.append([1.0, xx, yy, xx * xx, yy * yy, xx * yy])
    b = np.asarray(basis)
    ginv = np.linalg.inv(b.T @ (b * np.asarray(wts)[:, None]))
    igs = tuple(float(np.float32(ginv[i, j])) for i, j in ((1, 1), (0, 3), (3, 3), (5, 5)))
    return g, x * g, x * x * g, igs


def poly_exp(img, n, sigma):
    """(B, H, W) -> (B, 5, H, W): [b_y, b_x, A_yy, A_xx, 2 A_xy], replicate
    borders, separable correlations in order."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_tables(n, sigma)
    xp = _pad(img, n, "replicate")
    t0, t1, t2 = (_corr(xp, k, -2) for k in (g, xg, xxg))
    b1, b2, b4 = (_corr(t0, k, -1) for k in (g, xg, xxg))
    b3, b6 = _corr(t1, g, -1), _corr(t1, xg, -1)
    b5 = _corr(t2, g, -1)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def _lerp_x(v0, v1, ax, precision):
    if precision == "bf16":
        bf = torch.bfloat16
        return (v0.to(bf) * (1.0 - ax).to(bf) + v1.to(bf) * ax.to(bf)).to(v0.dtype)
    return v0 * (1.0 - ax) + v1 * ax


@functools.lru_cache(maxsize=None)
def _rim(h, w):
    def ramp(n):
        s = np.ones(n, np.float32)
        for i, v in enumerate(BORDER_SCALE):
            if i < n:
                s[i] *= v
            if n - 1 - i >= 0:
                s[n - 1 - i] *= v
        return s
    return ramp(h)[:, None] * ramp(w)[None, :]


def update_matrices(r0, r1, flow, precision):
    """Normal equations of one iteration: r1 warped bilinearly to (x + dx,
    y + dy) under OpenCV's guard (the floor inside [0, W-2] x [0, H-2]),
    averaged with r0, damped at the rim -> M (B, 5, H, W)."""
    b, _, h, w = r0.shape
    dev, dt = r0.device, r0.dtype
    dx, dy = flow[:, 0], flow[:, 1]
    # Sample coordinates in float32 whatever the planes' precision: a
    # bfloat16 coordinate could not address a column past 256.
    fx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + dx.float()
    fy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + dy.float()
    x1, y1 = torch.floor(fx), torch.floor(fy)
    ax, ay = (fx - x1)[..., None].to(dt), (fy - y1)[..., None].to(dt)
    xi, yi = x1.clamp(-2, w).long(), y1.clamp(-2, h).long()
    inside = (xi >= 0) & (xi < w - 1) & (yi >= 0) & (yi < h - 1)
    x0c, x1c = xi.clamp(0, w - 1), (xi + 1).clamp(0, w - 1)
    y0c, y1c = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    flat = r1.movedim(1, -1).reshape(b, h * w, 5)

    def take(yy, xx):
        lin = (yy * w + xx).reshape(b, h * w, 1).expand(b, h * w, 5)
        return torch.gather(flat, 1, lin).reshape(b, h, w, 5)

    top = _lerp_x(take(y0c, x0c), take(y0c, x1c), ax, precision)
    bot = _lerp_x(take(y1c, x0c), take(y1c, x1c), ax, precision)
    s = (top * (1.0 - ay) + bot * ay).movedim(-1, 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    r4 = torch.where(inside, (r0[:, 2] + s[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(inside, (r0[:, 3] + s[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(inside, (r0[:, 4] + s[:, 4]) * 0.25, r0[:, 4] * 0.5)
    r2 = (r0[:, 0] - torch.where(inside, s[:, 0], zero)) * 0.5
    r3 = (r0[:, 1] - torch.where(inside, s[:, 1], zero)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    rim = torch.as_tensor(_rim(h, w), device=dev).to(dt)
    r2, r3, r4, r5, r6 = (v * rim for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1)


def update_flow(m, winsize):
    """Box-window mean of M (replicate borders) and the regularised 2x2
    solve -> flow (B, 2, H, W) as (dx, dy)."""
    ones = np.ones(winsize)
    xp = _pad(m, winsize // 2, "replicate")
    s = _corr(_corr(xp, ones, -2), ones, -1) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=1)


def flow_seq(frames: torch.Tensor, p: Params, dtype=torch.float32) -> torch.Tensor:
    """Flow (N, 2, H, W) of the N consecutive pairs of (N+1, H, W) frames,
    coarse to fine from zero flow; each frame's levels and expansion are
    computed once."""
    n1, h, w = frames.shape
    img = frames.to(dtype)
    flow = None
    for k in range(p.num_levels(h, w), -1, -1):
        hk, wk = p.level_size(h, w, k)
        e = poly_exp(level_image(img, k, p, h, w), p.poly_n, p.poly_sigma)
        r0, r1 = e[:-1], e[1:]
        if flow is None:
            flow = torch.zeros((n1 - 1, 2, hk, wk), dtype=dtype, device=frames.device)
        else:
            flow = resize_bilinear(flow, hk, wk) * (1.0 / p.pyr_scale)
        for _ in range(p.iters_at(k)):
            flow = update_flow(update_matrices(r0, r1, flow, p.warp_precision), p.winsize)
    return flow


def roi_features(flow: torch.Tensor, theta, masks: np.ndarray) -> np.ndarray:
    """(N, 3, R) float64: the mean over each ROI mask of the flow projected
    on the body axes ex = (cos t, -sin t), ey = (sin t, cos t) -- vx, vy
    and the magnitude of (vx, vy) per pixel."""
    c, s = math.cos(theta), math.sin(theta)
    fx, fy = flow[:, 0], flow[:, 1]
    ex = torch.tensor([c, -s], dtype=torch.float32).to(fx.dtype)
    ey = torch.tensor([s, c], dtype=torch.float32).to(fx.dtype)
    bx = fx * float(ex[0]) + fy * float(ex[1])
    by = fx * float(ey[0]) + fy * float(ey[1])
    mg = torch.sqrt(bx * bx + by * by)
    out = np.empty((flow.shape[0], 3, len(masks)))
    for r, mask in enumerate(masks):
        m = torch.as_tensor(mask, device=flow.device)
        cnt = max(int(mask.sum()), 1)
        for j, z in enumerate((bx, by, mg)):
            out[:, j, r] = (z[:, m].double().sum(1) / cnt).cpu().numpy()
    return out
