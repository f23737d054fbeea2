"""OpenCV-exact image primitives in PyTorch.

Port of ``btcs_pnes_optical_flow_tpu/ops/cvx.py``.  Every stencil is a
loop over taps on shifted slices and ``resize_bilinear`` is index/weight
arithmetic, so no convolution is involved; the one matrix product is
``resize_bilinear_mm``, which refuses TF32.  Taps and coefficient
tables are computed on the host in float64 and rounded to float32 where
they meet the data, as the JAX package does.  All functions batch over
leading dimensions.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def bgr2gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (..., 3) → gray uint8, OpenCV fixed-point arithmetic:
    y = (R·9798 + G·19235 + B·3735 + 2^14) >> 15 (cv2.cvtColor
    COLOR_BGR2GRAY, BT.601 weights in 15-bit fixed point)."""
    b = bgr[..., 0].to(torch.int32)
    g = bgr[..., 1].to(torch.int32)
    r = bgr[..., 2].to(torch.int32)
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)


def bgr2gray_u8_np(bgr: np.ndarray) -> np.ndarray:
    """Host NumPy twin of ``bgr2gray_u8`` (identical integer math), for the
    decode path."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.astype(np.uint8)


def magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise sqrt(x² + y²) (cv2.magnitude)."""
    return torch.sqrt(x * x + y * y)


def _pad_index(n: int, p: int, mode: str, device) -> torch.Tensor:
    i = np.arange(-p, n + p)
    if mode == "replicate":
        i = np.clip(i, 0, n - 1)
    else:  # reflect101: edge pixel not duplicated
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        i = np.where(i > n - 1, period - i, i)
    return torch.as_tensor(i, dtype=torch.long, device=device)


def _pad(img: torch.Tensor, py: int, px: int, mode: str) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    if py:
        img = img.index_select(-2, _pad_index(h, py, mode, img.device))
    if px:
        img = img.index_select(-1, _pad_index(w, px, mode, img.device))
    return img


def pad_replicate(img: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Edge-replicate (BORDER_REPLICATE / clamp) padding, last two dims."""
    return _pad(img, py, px, "replicate")


def pad_reflect101(img: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding (edge pixel not duplicated)."""
    return _pad(img, py, px, "reflect101")


def taps_f32(kernel) -> list:
    """Host taps rounded to float32, as the JAX package's conv casts them."""
    return [float(v) for v in np.asarray(kernel, dtype=np.float64).astype(np.float32)]


def corr1d(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """'VALID' 1-D correlation along `axis` (-1 or -2) of a pre-padded image.

    out[d] = Σ_i k[i]·x[d + i], summed over taps in order on shifted
    slices (taps rounded to the image dtype, as the JAX package's conv).
    """
    taps = taps_f32(kernel)
    klen = len(taps)
    if klen == 1:
        return img * taps[0]
    n_out = img.shape[axis] - klen + 1
    acc = img.narrow(axis, 0, n_out) * taps[0]
    for i in range(1, klen):
        acc = acc + img.narrow(axis, i, n_out) * taps[i]
    return acc


def sep_corr_replicate(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """Separable correlation with replicate border (same-size output)."""
    py, px = len(kv) // 2, len(kh) // 2
    x = pad_replicate(img, py, px)
    x = corr1d(x, kv, axis=-2)
    return corr1d(x, kh, axis=-1)


def box_sum_replicate(img: torch.Tensor, size: int) -> torch.Tensor:
    """size×size box *sum* with clamp-to-edge border."""
    ones = np.ones(size, dtype=np.float64)
    return sep_corr_replicate(img, ones, ones)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel semantics (float64).

    sigma <= 0 → fixed small kernels for ksize ∈ {1,3,5,7}, else
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        9: [v / 256.0 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)],
    }
    if sigma <= 0 and ksize in small:
        return np.asarray(small[ksize], dtype=np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64)
    x = i - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur_reflect101(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur with default BORDER_REFLECT_101 (separable)."""
    k = gaussian_kernel(ksize, sigma)
    p = ksize // 2
    x = pad_reflect101(img, p, p)
    x = corr1d(x, k, axis=-2)
    return corr1d(x, k, axis=-1)


def _axis_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR taps along one axis: (i0, i1, frac float64).

    Source coordinate s = (d + 0.5)*scale - 0.5 with scale = in/out;
    coordinates below 0 take pixel 0 with weight 0, taps past the end
    clamp to the last pixel.
    """
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    s = (d + 0.5) * scale - 0.5
    i0 = np.floor(s).astype(np.int64)
    frac = s - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, frac


@functools.lru_cache(maxsize=None)
def resize_axis_coeffs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, frac float32) of ``_axis_taps``, as resize_bilinear applies them."""
    i0, i1, frac = _axis_taps(n_in, n_out)
    return i0, i1, frac.astype(np.float32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) for float images (identity when
    sizes match), as index/weight arithmetic over the last two dims."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    dev = img.device
    y0, y1, fy = resize_axis_coeffs(in_h, out_h)
    x0, x1, fx = resize_axis_coeffs(in_w, out_w)
    fy_t = torch.as_tensor(fy, device=dev)[:, None]
    fx_t = torch.as_tensor(fx, device=dev)
    top = img.index_select(-2, torch.as_tensor(y0, device=dev))
    bot = img.index_select(-2, torch.as_tensor(y1, device=dev))
    rows = top * (1.0 - fy_t) + bot * fy_t
    left = rows.index_select(-1, torch.as_tensor(x0, device=dev))
    right = rows.index_select(-1, torch.as_tensor(x1, device=dev))
    return left * (1.0 - fx_t) + right * fx_t


@functools.lru_cache(maxsize=None)
def _resize_axis_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) float32 interpolation matrix of ``_axis_taps``;
    1 - frac is taken in float64 before the rounding, as the JAX package
    does."""
    i0, i1, frac = _axis_taps(n_in, n_out)
    d = np.arange(n_out)
    w = np.zeros((n_out, n_in), np.float32)
    np.add.at(w, (d, i0), (1.0 - frac).astype(np.float32))
    np.add.at(w, (d, i1), frac.astype(np.float32))
    return w


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_resize_axis_matrix(n_in, n_out), device=device)


def resize_bilinear_mm(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """resize_bilinear as two dense float32 matrix products,
    out = Wy @ img @ Wxᵀ over the last two dims (identity when sizes match).

    Port of the JAX package's ``cvx.resize_bilinear_mm``, which the TV-L1
    pyramid uses.  Each output reduces to w0·a + w1·b plus exact zeros.
    The JAX package pins full float32 precision, so this raises on a CUDA
    tensor while TF32 matmuls are allowed.  A NaN pixel poisons its whole
    output row or column (0·NaN): use it on finite planes only.
    """
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("resize_bilinear_mm needs full float32 matmuls; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    out = img
    if in_h != out_h:
        out = torch.matmul(_resize_matrix(in_h, out_h, img.device), out)
    if in_w != out_w:
        out = torch.matmul(out, _resize_matrix(in_w, out_w, img.device).T)
    return out


# ---------------------------------------------------------------------------
# cv2.fillPoly (host NumPy, copied from the JAX package)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _line8_pixels(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """8-connected Bresenham matching cv2.line(..., LINE_8, thickness=1).

    Integer Bresenham with OpenCV's LineIterator semantics
    (leftToRight=True): the walk is canonicalized to ascending x, the
    longer axis is major, err starts at dmaj - 2*dmin, and the minor
    axis advances on strictly-negative err.
    """
    h, w = mask.shape
    dx = x1 - x0
    dy = y1 - y0
    if dx < 0:  # leftToRight canonicalization
        x0, y0 = x1, y1
        dx, dy = -dx, -dy
    sy = 1 if dy >= 0 else -1
    ady = abs(dy)

    if ady > dx:
        dmaj, dmin = ady, dx
        xmaj = False
    else:
        dmaj, dmin = dx, ady
        xmaj = True

    err = dmaj - 2 * dmin
    x, y = x0, y0
    for _ in range(dmaj + 1):
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = True
        if err < 0:
            err += 2 * dmaj - 2 * dmin
            x += 1
            y += sy
        else:
            err -= 2 * dmin
            if xmaj:
                x += 1
            else:
                y += sy


def fill_poly_mask(height: int, width: int, polygon_xy: np.ndarray) -> np.ndarray:
    """Boolean ROI mask from a polygon (host-side NumPy, cv2.fillPoly).

    Even-odd scanline fill between paired edge crossings in 16.16 fixed
    point (a row's span is [ceil(x_left), floor(x_right)]), plus the
    polygon outline drawn with the 8-connected Bresenham of cv2.line.
    """
    poly = np.asarray(polygon_xy).astype(np.int32)  # truncation, as reference
    n = len(poly)
    mask = np.zeros((height, width), dtype=bool)
    if n == 0:
        return mask
    if n == 1:
        _line8_pixels(mask, poly[0, 0], poly[0, 1], poly[0, 0], poly[0, 1])
        return mask

    edges = []  # (y_top, y_bot, x_top_fp, dx_fp)
    for i in range(n):
        x0, y0 = int(poly[i, 0]), int(poly[i, 1])
        x1, y1 = int(poly[(i + 1) % n, 0]), int(poly[(i + 1) % n, 1])
        _line8_pixels(mask, x0, y0, x1, y1)
        if y0 == y1:
            continue
        if y0 < y1:
            yt, yb, xt = y0, y1, x0
            num = (x1 - x0) << _XY_SHIFT
        else:
            yt, yb, xt = y1, y0, x1
            num = (x0 - x1) << _XY_SHIFT
        dx_fp = int(num / (yb - yt))  # C-style truncation toward zero
        edges.append((yt, yb, xt << _XY_SHIFT, dx_fp))

    ymin = max(min(e[0] for e in edges), 0) if edges else 0
    ymax = min(max(e[1] for e in edges), height) if edges else 0
    for y in range(ymin, ymax):
        xs = []
        for yt, yb, x_fp, dx_fp in edges:
            if yt <= y < yb:
                xs.append(x_fp + (y - yt) * dx_fp)
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            lo = (xs[j] + _XY_ONE - 1) >> _XY_SHIFT
            hi = xs[j + 1] >> _XY_SHIFT
            lo = max(lo, 0)
            hi = min(hi, width - 1)
            if lo <= hi and 0 <= y < height:
                mask[y, lo : hi + 1] = True
    return mask
