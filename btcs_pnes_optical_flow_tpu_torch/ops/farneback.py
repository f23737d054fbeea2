"""Dense Farnebäck optical flow in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/farneback.py`` (the exact
engine) and of the frame sharing of ``ops/farneback_fused.py``
(``_seq_impl``).  The algorithm is OpenCV's calcOpticalFlowFarneback:
per-level images by Gaussian blur of the full-res frame + bilinear
resize, a quadratic polynomial expansion per frame, then per iteration
a bilinear warp of the second expansion with the normal-equation
assembly, a window average and a regularized 2×2 solve.

Each of the three steps has a plain PyTorch version here
(``poly_exp_cf_plain``, ``update_matrices_cf_plain``,
``update_flow_cf_plain``, channel-first) and a hand-written CUDA kernel
behind ``ops/farneback_cuda.py``; the level loop calls the wrappers
there, which take the plain version for a CPU tensor and launch the
kernel for a CUDA tensor.  The public channel-last functions
(``poly_exp``, ``update_matrices``, ``update_flow``) keep the JAX exact
engine's layout so the two packages compare like with like.

ROI dispatch (``roi_dispatch_params``, ``FarnebackParams.roi_active_px``)
is the port of ``ops/farneback_fused.py``'s: a level whose ROI box,
quantized to the ``TILE`` lattice, covers fewer tiles than the level
assembles M over the box only (``update_matrices_cf`` in box mode, the
port of K2's ``active`` tile range) and solves the box only
(``update_flow_cf`` in box mode); the flow outside the box keeps the
level's initial flow.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import (
    FarnebackParams,
    _round_half_even,
    check_supported,
)
from btcs_pnes_optical_flow_tpu_torch.ops import cvx, farneback_cuda

# Rim damping applied to the normal equations near the image border
# (5-pixel ramp; suppresses the unreliable constraints there).
_BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# The port's tile lattice (rows, columns): the grain to which ROI boxes are
# quantized, and the tiles of K4's lists (one block of one thread per pixel
# each).
TILE = (8, 32)


@functools.lru_cache(maxsize=None)
def _poly_exp_tables(n: int, sigma: float):
    """Gaussian applicability kernels + inverse-Gram factors (host, f64).

    The LS fit of f over basis (1, x, y, x², y², xy) with separable
    weight w(x,y)=g(x)g(y) has Gram matrix G whose inverse supplies the
    four factors needed to turn raw correlations into coefficients.
    """
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    basis = []
    w = []
    for yy in x:
        for xx in x:
            w.append(g[int(yy) + n] * g[int(xx) + n])
            basis.append([1.0, xx, yy, xx * xx, yy * yy, xx * yy])
    bmat = np.asarray(basis)
    wv = np.asarray(w)
    gram = bmat.T @ (bmat * wv[:, None])
    ginv = np.linalg.inv(gram)
    ig11 = ginv[1, 1]
    ig03 = ginv[0, 3]
    ig33 = ginv[3, 3]
    ig55 = ginv[5, 5]
    return g, xg, xxg, (ig11, ig03, ig33, ig55)


def poly_exp_cf_plain(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic polynomial expansion, (B, H, W) f32 → (B, 5, H, W).

    Channels: [b_y, b_x, A_yy, A_xx, 2·A_xy]; replicate borders.
    """
    g, xg, xxg, igs = _poly_exp_tables(n, sigma)
    ig11, ig03, ig33, ig55 = (float(np.float32(v)) for v in igs)
    xpad = cvx.pad_replicate(img, n, n)
    # Vertical pass (offsets along y; xg is odd → signed kernel).
    t0 = cvx.corr1d(xpad, g, axis=-2)
    t1 = cvx.corr1d(xpad, xg, axis=-2)
    t2 = cvx.corr1d(xpad, xxg, axis=-2)
    # Horizontal pass.
    b1 = cvx.corr1d(t0, g, axis=-1)
    b2 = cvx.corr1d(t0, xg, axis=-1)
    b4 = cvx.corr1d(t0, xxg, axis=-1)
    b3 = cvx.corr1d(t1, g, axis=-1)
    b6 = cvx.corr1d(t1, xg, axis=-1)
    b5 = cvx.corr1d(t2, g, axis=-1)
    return torch.stack(
        [b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33, b6 * ig55],
        dim=1,
    )


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Polynomial expansion → (B, H, W, 5) coefficients (channel-last).

    Runs the CUDA kernel for a CUDA tensor, the plain version on the CPU.
    """
    return farneback_cuda.poly_exp_cf(img.float().contiguous(), n, sigma).movedim(1, -1)


def _lerp_x(v0: torch.Tensor, v1: torch.Tensor, ax: torch.Tensor, precision: str):
    """One row's horizontal lerp (1 − ax)·v0 + ax·v1.

    ``"bf16"`` is the TPU kernel's bf16 candidate MAC
    (``ops/farneback_pallas.py`` ``_make_kernel``: the taps and the weights
    ``ax`` and ``1 − ax``, the latter taken in fp32 first, rounded to
    bfloat16; each product and the sum rounded to bfloat16, the
    ``(1 − ax)·v0`` term first), upcast to fp32.
    """
    if precision == "bf16":
        bf = torch.bfloat16
        return (v0.to(bf) * (1.0 - ax).to(bf) + v1.to(bf) * ax.to(bf)).float()
    return v0 * (1.0 - ax) + v1 * ax


def _bilinear_gather(r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                     precision: str = "fp32", row_off: int = 0, h_glob: Optional[int] = None):
    """Bilinear sample of (B, H, W, C) at absolute coords (fx, fy).

    Returns (sampled (B,h,w,C), inside (B,h,w)) where `inside` mirrors
    OpenCV's guard: floor coords within [0, W-2] × [0, H-2].  The floor
    is clamped to [-2, size] before the integer cast, which leaves the
    guard and the clamped taps unchanged and keeps huge flows finite.
    The horizontal lerp runs in ``precision`` (``_lerp_x``), the vertical
    blend in fp32.

    Row-offset form (a height shard): r1 holds the rows [row_off − K,
    row_off − K + H) of an image of ``h_glob`` rows and fy is a global
    row; the guard also asks the floor row to lie inside r1.  The
    defaults (row_off = K = 0, h_glob = H) are the whole image.
    """
    b, h_ext, w, c = r1.shape
    h, wo = fx.shape[-2:]
    h_glob = h_ext if h_glob is None else h_glob
    top_row = row_off - (h_ext - h) // 2  # global row of r1's row 0
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    ax = (fx - x1)[..., None]
    ay = (fy - y1)[..., None]
    x1i = x1.clamp(-2, w).to(torch.long)
    y1i = y1.clamp(-2, h_glob).to(torch.long)
    y_ext = y1i - top_row
    inside = ((x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < h_glob - 1)
              & (y_ext >= 0) & (y_ext < h_ext - 1))
    x0c = x1i.clamp(0, w - 1)
    y0c = y_ext.clamp(0, h_ext - 1)
    x1c = (x1i + 1).clamp(0, w - 1)
    y1c = (y_ext + 1).clamp(0, h_ext - 1)

    flat = r1.reshape(b, h_ext * w, c)

    def take(yi, xi):
        lin = (yi * w + xi).reshape(b, h * wo, 1).expand(b, h * wo, c)
        return torch.gather(flat, 1, lin).reshape(b, h, wo, c)

    v00 = take(y0c, x0c)
    v01 = take(y0c, x1c)
    v10 = take(y1c, x0c)
    v11 = take(y1c, x1c)
    top = _lerp_x(v00, v01, ax, precision)
    bot = _lerp_x(v10, v11, ax, precision)
    return top * (1.0 - ay) + bot * ay, inside


def _border_scale_1d(n: int) -> np.ndarray:
    s = np.ones(n, dtype=np.float32)
    for i, v in enumerate(_BORDER_SCALE):
        if i < n:
            s[i] *= v
        if n - 1 - i >= 0:
            s[n - 1 - i] *= v
    return s


@functools.lru_cache(maxsize=None)
def _border_scale_np(h: int, w: int) -> np.ndarray:
    """(h, w) float32 rim damping: the 5-pixel ramp on every edge (both
    rims multiply into the same rows when h or w < 10)."""
    return _border_scale_1d(h)[:, None] * _border_scale_1d(w)[None, :]


def update_matrices_core(r0, sampled, inside, dx, dy, scale) -> torch.Tensor:
    """M-plane math, channel-first: r0 and sampled (B, 5, H, W), inside,
    dx, dy (B, H, W), scale (H, W) → M (B, 5, H, W) =
    [G_yy, G_xy, G_xx, h_y, h_x].

    `sampled` is r1 bilinearly warped to (x+dx, y+dy); `inside` marks
    warp targets whose 2×2 support lies fully inside the image.
    """
    zero = torch.zeros((), dtype=r0.dtype, device=r0.device)
    r4 = torch.where(inside, (r0[:, 2] + sampled[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(inside, (r0[:, 3] + sampled[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(inside, (r0[:, 4] + sampled[:, 4]) * 0.25, r0[:, 4] * 0.5)

    r2 = (r0[:, 0] - torch.where(inside, sampled[:, 0], zero)) * 0.5
    r3 = (r0[:, 1] - torch.where(inside, sampled[:, 1], zero)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    m0 = r4 * r4 + r6 * r6
    m1 = (r4 + r5) * r6
    m2 = r5 * r5 + r6 * r6
    m3 = r4 * r2 + r6 * r3
    m4 = r6 * r2 + r5 * r3
    return torch.stack([m0, m1, m2, m3, m4], dim=1)


def update_matrices_rows_cf_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                                  row_off: int, h_glob: int,
                                  precision: str = "fp32") -> torch.Tensor:
    """``update_matrices_cf_plain`` on a height shard: r0 and flow (B, ·, h,
    W) are the rows [row_off, row_off + h) of an image of ``h_glob`` rows,
    r1 (B, 5, h + 2K, W) the same rows with K rows of halo on each side.
    Warp targets use global rows, and a target whose floor row lies
    outside r1 counts as outside the image (r0-only constraint); the rim
    damping uses global rows.  With row_off = K = 0 and h_glob = h this
    is ``update_matrices_cf_plain``."""
    b, _, h, w = r0.shape
    dt, dev = r0.dtype, r0.device
    dx = flow[:, 0]
    dy = flow[:, 1]
    gx = torch.arange(w, dtype=dt, device=dev)[None, None, :]
    gy = torch.arange(row_off, row_off + h, dtype=dt, device=dev)[None, :, None]
    sampled, inside = _bilinear_gather(r1.movedim(1, -1), gx + dx, gy + dy, precision,
                                       row_off, h_glob)
    scale = torch.as_tensor(_border_scale_np(h_glob, w)[row_off:row_off + h], device=dev)
    return update_matrices_core(r0, sampled.movedim(-1, 1), inside, dx, dy, scale)


def update_matrices_cf_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                             precision: str = "fp32", box=None, out=None) -> torch.Tensor:
    """Normal equations from r0, r1 (B, 5, H, W) and flow (B, 2, H, W)
    with channels (dx, dy) → M (B, 5, H, W); the warp's horizontal lerp
    in ``precision`` ("fp32" or "bf16", ``_lerp_x``).

    With ``box=(y0, y1, x0, x1)`` (half-open) and ``out``: the same M
    pasted into ``out`` at the box's pixels, in place; returns ``out``.
    """
    m = update_matrices_rows_cf_plain(r0, r1, flow, 0, r0.shape[2], precision)
    if box is None:
        return m
    y0, y1, x0, x1 = box
    out[:, :, y0:y1, x0:x1] = m[:, :, y0:y1, x0:x1]
    return out


def tile_mask(sel: torch.Tensor, b: int, h: int, w: int, tile) -> torch.Tensor:
    """(b, h, w) bool: the pixels of the tiles listed in ``sel`` (flat ids
    ``(b·n_i + i)·n_j + j`` on the ``tile`` lattice)."""
    th, tw = tile
    n_i, n_j = -(-h // th), -(-w // tw)
    listed = torch.zeros(b * n_i * n_j, dtype=torch.bool, device=sel.device)
    listed[sel.long()] = True
    listed = listed.view(b, n_i, n_j)
    return listed.repeat_interleave(th, 1).repeat_interleave(tw, 2)[:, :h, :w]


def update_matrices_tiles_cf_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                                   sel: torch.Tensor, m: torch.Tensor, tile,
                                   precision: str = "fp32") -> torch.Tensor:
    """``update_matrices_cf_plain`` with the tiles listed in ``sel`` copied
    into ``m`` (B, 5, H, W) in place; the other tiles of ``m`` are left as
    they were.  Returns ``m``."""
    b, _, h, w = r0.shape
    listed = tile_mask(sel, b, h, w, tile)[:, None]
    m.copy_(torch.where(listed, update_matrices_cf_plain(r0, r1, flow, precision), m))
    return m


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    precision: str = "fp32") -> torch.Tensor:
    """Channel-last form: r0, r1 (B, H, W, 5), flow (B, H, W, 2) → M
    (B, H, W, 5).  Runs the CUDA kernel for CUDA tensors."""
    m = farneback_cuda.update_matrices_cf(
        r0.movedim(-1, 1).contiguous(),
        r1.movedim(-1, 1).contiguous(),
        flow.movedim(-1, 1).contiguous(),
        precision,
    )
    return m.movedim(1, -1)


@functools.lru_cache(maxsize=None)
def _gaussian_win_kernel(winsize: int) -> np.ndarray:
    m = winsize // 2
    sigma = m * 0.3
    x = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def solve_flow(msum: torch.Tensor) -> torch.Tensor:
    """Regularized per-pixel 2×2 solve of the window-averaged normal
    equations (B, 5, H, W) → flow (B, 2, H, W) with channels (dx, dy)."""
    g11 = msum[:, 0]
    g12 = msum[:, 1]
    g22 = msum[:, 2]
    h1 = msum[:, 3]
    h2 = msum[:, 4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return torch.stack([fx, fy], dim=1)


def update_flow_cf_plain(m: torch.Tensor, winsize: int, gaussian_win: bool,
                         box=None, out=None) -> torch.Tensor:
    """Window-average M (B, 5, H, W) with replicate borders and solve →
    flow (B, 2, H, W).

    With ``box=(y0, y1, x0, x1)`` (half-open) and ``out``: the same on the
    box cut out of M (its edges replicate), pasted into ``out`` in place.
    """
    if box is not None:
        y0, y1, x0, x1 = box
        out[:, :, y0:y1, x0:x1] = update_flow_cf_plain(m[:, :, y0:y1, x0:x1], winsize,
                                                       gaussian_win)
        return out
    if gaussian_win:
        k = _gaussian_win_kernel(winsize)
        msum = cvx.sep_corr_replicate(m, k, k)
    else:
        msum = cvx.box_sum_replicate(m, winsize) * (1.0 / (winsize * winsize))
    return solve_flow(msum)


def update_flow(m: torch.Tensor, winsize: int, gaussian_win: bool) -> torch.Tensor:
    """Channel-last form: M (B, H, W, 5) → flow (B, H, W, 2)."""
    out = farneback_cuda.update_flow_cf(m.movedim(-1, 1).contiguous(), winsize, gaussian_win)
    return out.movedim(1, -1)


def _strided_corr1d(img: torch.Tensor, kernel, stride: int, start: int, n_out: int,
                    axis: int) -> torch.Tensor:
    """Strided 1-D correlation of a pre-padded image:
    out[d] = Σ_i k[i]·x[start + d·stride + i], a loop over taps."""
    taps = cvx.taps_f32(kernel)
    axis = axis % img.ndim
    span = (n_out - 1) * stride + 1

    def tap(i):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(start + i, start + i + span, stride)
        return img[tuple(sl)]

    acc = tap(0) * taps[0]
    for i in range(1, len(taps)):
        acc = acc + tap(i) * taps[i]
    return acc


def _level_image(img_f: torch.Tensor, k: int, params: FarnebackParams, h: int, w: int):
    """Full-res float image → smoothed + resized level-k image.

    OpenCV semantics: GaussianBlur the *full-res* frame with
    sigma = (1/scale - 1)/2 (reflect101 borders), then bilinear-resize
    to the level size.  When the level size times 2^k is the frame size
    (pyr_scale 0.5), blur + resize collapse into one strided
    correlation with kernel gauss ⊛ [0.5, 0.5]: the bilinear sample
    positions (d+0.5)·2^k − 0.5 fall exactly halfway between two pixels.
    Other sizes take the generic blur + resize.
    """
    scale = params.pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(_round_half_even(sigma * 5) | 1, 3)
    hk, wk = params.level_size(h, w, k)

    if k > 0 and params.pyr_scale == 0.5 and (h, w) == (hk * 2**k, wk * 2**k):
        m = 2**k
        g = cvx.gaussian_kernel(smooth_sz, sigma)
        comb = np.convolve(g, [0.5, 0.5])  # blur ⊛ bilinear half-taps
        p = smooth_sz // 2
        xp = cvx.pad_reflect101(img_f, p, p)
        # out[d] reads padded positions (m·d + (m-2)/2 - p) + [0, 2p+1].
        start = (m - 2) // 2
        v = _strided_corr1d(xp, comb, m, start, hk, axis=-2)
        return _strided_corr1d(v, comb, m, start, wk, axis=-1), hk, wk

    sm = cvx.gaussian_blur_reflect101(img_f, smooth_sz, sigma)
    return cvx.resize_bilinear(sm, hk, wk), hk, wk


def roi_dispatch_params(params: FarnebackParams, h: int, w: int, roi_masks) -> FarnebackParams:
    """FarnebackParams with per-level ROI-active boxes (``roi_active_px``).

    NumPy copy of ``ops/farneback_fused.py:roi_dispatch_params``, which
    returns the same boxes.  Flow is consumed only through the ROI means,
    and flow at a pixel depends on a bounded neighbourhood: each solve
    iteration widens it by winsize//2, each coarser level feeds the finer
    one's initial flow through a 2-px bilinear support.  Fine to coarse:

        need(0)   = ROI bounding box
        box(k)    = need(k) ⊕ (iters_at(k)·(winsize//2) + 10)
        need(k+1) = box(k)/2 ⊕ 2

    roi_masks: (R, H, W) or (H, W) bool.  No ROI pixel → params unchanged.
    """
    m = np.asarray(roi_masks)
    if m.ndim == 2:
        m = m[None]
    ys, xs = np.nonzero(m.any(axis=0))
    if ys.size == 0:
        return params
    need = (int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1)
    boxes = []
    for k in range(params.num_levels(h, w) + 1):
        halo = params.iters_at(k) * (params.winsize // 2) + 10
        box = (need[0] - halo, need[1] + halo, need[2] - halo, need[3] + halo)
        boxes.append(box)
        need = (box[0] // 2 - 2, -(-box[1] // 2) + 2, box[2] // 2 - 2, -(-box[3] // 2) + 2)
    return dataclasses.replace(params, roi_active_px=tuple(boxes))


def box_tiles(box, hk: int, wk: int, tile=TILE):
    """A level's ROI box (y_lo, y_hi, x_lo, x_hi) quantized outward to the
    tile lattice of the (hk, wk) level → tile range (i0, i1, j0, j1), or None
    when it covers every tile (the level then runs whole), following
    ``ops/farneback_fused.py:137-142``."""
    th, tw = tile
    n_i, n_j = -(-hk // th), -(-wk // tw)
    y_lo, y_hi, x_lo, x_hi = box
    i0 = min(max(0, y_lo // th), n_i - 1)
    i1 = max(i0 + 1, min(n_i, -(-y_hi // th)))
    j0 = min(max(0, x_lo // tw), n_j - 1)
    j1 = max(j0 + 1, min(n_j, -(-x_hi // tw)))
    if (i1 - i0) * (j1 - j0) < n_i * n_j:
        return i0, i1, j0, j1
    return None


def tile_box(tiles, hk: int, wk: int, tile=TILE):
    """The pixels (y0, y1, x0, x1), half-open, that the tile range (i0, i1,
    j0, j1) covers in the (hk, wk) level."""
    th, tw = tile
    i0, i1, j0, j1 = tiles
    return i0 * th, min(i1 * th, hk), j0 * tw, min(j1 * tw, wk)


def tile_list(n: int, tiles, hk: int, wk: int, device, tile=TILE) -> torch.Tensor:
    """(n·tiles,) int32 flat ids of the tile range (i0, i1, j0, j1) in each
    of n pairs, pair-major."""
    th, tw = tile
    n_i, n_j = -(-hk // th), -(-wk // tw)
    i0, i1, j0, j1 = tiles
    b = torch.arange(n, device=device)[:, None, None]
    i = torch.arange(i0, i1, device=device)[None, :, None]
    j = torch.arange(j0, j1, device=device)[None, None, :]
    return ((b * n_i + i) * n_j + j).reshape(-1).to(torch.int32)


def _kernel_steps(kernels: bool):
    if kernels:
        return (farneback_cuda.poly_exp_cf, farneback_cuda.update_matrices_cf,
                farneback_cuda.update_flow_cf)
    return poly_exp_cf_plain, update_matrices_cf_plain, update_flow_cf_plain


def _level_loop(polys_of_level, n: int, h: int, w: int, params: FarnebackParams,
                flow0, kernels: bool, device) -> torch.Tensor:
    """Coarse-to-fine pyramid loop, channel-first.

    polys_of_level(k, poly) -> (r0, r1): the (n, 5, hk, wk) expansions
    that level k's pairs warp from and to.  flow0: (n, H, W, 2) or None.
    Returns flow (n, H, W, 2).  A level that ``params.roi_active_px``
    boxes runs K2 and K3 over its box only, as the JAX level loop runs
    them over an ``active`` tile range; outside the box the flow keeps the
    level's initial flow.
    """
    check_supported(params)
    poly, um, uf = _kernel_steps(kernels)
    prec = params.warp_precision
    flow = None
    for k in range(params.num_levels(h, w), -1, -1):
        hk, wk = params.level_size(h, w, k)
        r0, r1 = polys_of_level(k, poly)
        if flow is None:
            if params.use_initial_flow and flow0 is not None:
                # OPTFLOW_USE_INITIAL_FLOW: the given flow, resized to the
                # coarsest level and scaled to its pixels.
                f0 = flow0.to(device=device, dtype=torch.float32).movedim(-1, 1)
                flow = (cvx.resize_bilinear(f0, hk, wk) * params.pyr_scale**k).contiguous()
            else:
                flow = torch.zeros((n, 2, hk, wk), dtype=torch.float32, device=device)
        else:
            flow = cvx.resize_bilinear(flow, hk, wk) * (1.0 / params.pyr_scale)
        tiles = None
        if params.roi_active_px is not None and k < len(params.roi_active_px):
            tiles = box_tiles(params.roi_active_px[k], hk, wk)
        if tiles is None:
            for _ in range(params.iters_at(k)):
                m = um(r0, r1, flow, prec)
                flow = uf(m, params.winsize, params.gaussian_win)
            continue
        box = tile_box(tiles, hk, wk)
        # One M per level: K2 in box mode rewrites the box each iteration;
        # K3 in box mode reads only the box and writes the box of flow in
        # place.
        m = torch.empty((n, 5, hk, wk), dtype=torch.float32, device=device)
        flow = flow.contiguous()
        for _ in range(params.iters_at(k)):
            um(r0, r1, flow, prec, box, m)
            uf(m, params.winsize, params.gaussian_win, box, flow)
    return flow.movedim(1, -1)


def farneback_flow(prev: torch.Tensor, curr: torch.Tensor,
                   params: FarnebackParams = FarnebackParams(),
                   flow0: Optional[torch.Tensor] = None, *,
                   kernels: bool = True) -> torch.Tensor:
    """Dense flow between two (batches of) grayscale frames.

    prev, curr: (B, H, W) or (H, W), uint8 or float; returns flow
    (B, H, W, 2) (or (H, W, 2)) with channels (dx, dy) in pixels, the
    layout of cv2.calcOpticalFlowFarneback.  With
    ``params.use_initial_flow`` and a ``flow0`` of the output's shape the
    pyramid starts from flow0 (cv2's OPTFLOW_USE_INITIAL_FLOW); otherwise
    from zero flow.  ``kernels=False`` runs the plain PyTorch versions on
    any device (the on-card reference).
    """
    squeeze = prev.ndim == 2
    if squeeze:
        prev, curr = prev[None], curr[None]
        if flow0 is not None and flow0.ndim == 3:
            flow0 = flow0[None]
    n, h, w = prev.shape
    p_f = prev.float()
    c_f = curr.float()

    def polys_of_level(k, poly):
        i0, _, _ = _level_image(p_f, k, params, h, w)
        i1, _, _ = _level_image(c_f, k, params, h, w)
        return (poly(i0, params.poly_n, params.poly_sigma),
                poly(i1, params.poly_n, params.poly_sigma))

    out = _level_loop(polys_of_level, n, h, w, params, flow0, kernels, prev.device)
    return out[0] if squeeze else out


def farneback_flow_seq(frames: torch.Tensor,
                       params: FarnebackParams = FarnebackParams(),
                       flow0: Optional[torch.Tensor] = None, *,
                       kernels: bool = True) -> torch.Tensor:
    """Flow for the N consecutive pairs of an (N+1, H, W) sequence.

    Equal to farneback_flow(frames[:-1], frames[1:], params, flow0) with
    flow0 (N, H, W, 2), but each frame's
    level images and polynomial expansion are computed once: pair b
    reads r0 from frame b and warps r1 from frame b+1 (a batch slice of
    the one expansion, still contiguous).
    """
    n1, h, w = frames.shape
    f_all = frames.float()

    def polys_of_level(k, poly):
        lv, _, _ = _level_image(f_all, k, params, h, w)
        p = poly(lv, params.poly_n, params.poly_sigma)
        return p[:-1], p[1:]

    return _level_loop(polys_of_level, n1 - 1, h, w, params, flow0, kernels, frames.device)
