"""Height-sharded Farnebäck flow with halo exchange.

Port of ``btcs_pnes_optical_flow_tpu/parallel/spatial.py``.  A frame's
height is split into row blocks over the devices of a mesh axis; one
process drives every block (the JAX package's single-controller
``shard_map``).  Each stencil stage exchanges only its halo rows with the
neighbouring blocks (``parallel/halo.py``):

- the level image (blur + resize, plain torch as in the unsharded path):
  the blur's reflect101 rows;
- K1, the polynomial expansion: poly_n replicate rows; the kernel runs on
  the halo-extended block, which is cropped afterwards;
- K2, the warp and assembly: a ``K = min(warp_halo, h_loc)``-row band of
  the second frame's expansion, through K2's row-offset instance
  (``ops/farneback_cuda.py update_matrices_rows_cf``: global rows, the
  inside guard against the global height and the extended block, the rim
  damping of global rows);
- K3, the window average and solve: winsize // 2 replicate rows, the
  kernel on the extended block, cropped afterwards.

Coarse levels whose blocks would be thinner than max(poly_n, winsize // 2)
rows are gathered onto the axis' first device and computed whole with the
same kernels; across block seams the flow is upsampled by
``_upsample2x_rows``.

Semantics against the unsharded ``ops/farneback.py farneback_flow``: equal
wherever every pixel's vertical displacement stays within warp_halo − 1
rows; a target beyond the band counts as outside the image (cv2's r0-only
constraint) instead of reading wrong rows.  The two differ by rounding
where the upsample meets the top border (0.25·x + 0.75·x against x).
Unlike the JAX package's sharded path, which runs ``params.iterations`` at
every level, this one follows ``params.iters_at`` as the unsharded path
does; it runs every level whole (``roi_active_px`` is not used), and the
warp runs in ``params.warp_precision``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import (
    FarnebackParams,
    _round_half_even,
    check_supported,
)
from btcs_pnes_optical_flow_tpu_torch.ops import cvx, farneback_cuda
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
from btcs_pnes_optical_flow_tpu_torch.parallel.halo import exchange_rows, gather_rows, split_rows
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import axis_devices


def _level_image_sharded(blocks: List[torch.Tensor], k: int,
                         params: FarnebackParams) -> List[torch.Tensor]:
    """Each block's rows of the level-k image from the full-res blocks:
    ``fb._level_image``'s blur (k = 0) or strided blur + resize (k > 0,
    pyr_scale 0.5), with the vertical reflect101 pad from the exchange."""
    scale = params.pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(_round_half_even(sigma * 5) | 1, 3)
    p = smooth_sz // 2
    exts = [cvx.pad_reflect101(e, 0, p) for e in exchange_rows(blocks, p, "reflect101")]
    g = cvx.gaussian_kernel(smooth_sz, sigma)
    if k == 0:
        return [cvx.corr1d(cvx.corr1d(e, g, axis=-2), g, axis=-1) for e in exts]
    m = 2**k
    comb = np.convolve(g, [0.5, 0.5])
    start = (m - 2) // 2
    h_out, w_out = blocks[0].shape[-2] // m, blocks[0].shape[-1] // m
    return [fb._strided_corr1d(fb._strided_corr1d(e, comb, m, start, h_out, axis=-2), comb, m,
                               start, w_out, axis=-1) for e in exts]


def _crop_rows(x: torch.Tensor, halo: int, rows: int) -> torch.Tensor:
    return x[:, :, halo:halo + rows].contiguous()


def _poly_exp_sharded(blocks, n: int, sigma: float) -> List[torch.Tensor]:
    """K1 on each block extended by n replicate rows, cropped."""
    rows = blocks[0].shape[-2]
    return [_crop_rows(farneback_cuda.poly_exp_cf(e.contiguous(), n, sigma), n, rows)
            for e in exchange_rows(blocks, n, "replicate")]


def _upsample2x_rows(blocks) -> List[torch.Tensor]:
    """Vertical ×2 bilinear upsample of the blocks (..., h, w), matching
    cvx.resize_bilinear's (d + 0.5)/2 − 0.5 sampling across the seams."""
    out = []
    for x, ext in zip(blocks, exchange_rows(blocks, 1, "replicate")):
        a, b, c = ext[..., :-2, :], ext[..., 1:-1, :], ext[..., 2:, :]
        even = 0.25 * a + 0.75 * b
        odd = 0.75 * b + 0.25 * c
        out.append(torch.stack([even, odd], dim=-2).reshape(
            *x.shape[:-2], 2 * x.shape[-2], x.shape[-1]))
    return out


def _update_matrices_sharded(r0s, r1s, flows, h_glob: int, warp_halo: int,
                             precision: str) -> List[torch.Tensor]:
    """K2's row-offset instance on each block, r1 extended by a
    K = min(warp_halo, h_loc)-row band from the neighbours."""
    h_loc = r0s[0].shape[-2]
    k = min(warp_halo, h_loc)
    return [farneback_cuda.update_matrices_rows_cf(r0, ext.contiguous(), f, i * h_loc, h_glob,
                                                   precision)
            for i, (r0, ext, f) in enumerate(zip(r0s, exchange_rows(r1s, k, "replicate"),
                                                 flows))]


def _update_flow_sharded(ms, winsize: int, gaussian_win: bool) -> List[torch.Tensor]:
    """K3 on each block of M extended by winsize // 2 replicate rows,
    cropped."""
    p = winsize // 2
    rows = ms[0].shape[-2]
    return [_crop_rows(farneback_cuda.update_flow_cf(e.contiguous(), winsize, gaussian_win), p,
                       rows) for e in exchange_rows(ms, p, "replicate")]


def farneback_flow_sharded(prev, curr, params: FarnebackParams = FarnebackParams(),
                           mesh=None, axis_name: str = "spatial",
                           warp_halo: int = 16) -> torch.Tensor:
    """Dense Farnebäck flow with the frame height split over ``mesh``.

    prev, curr: (B, H, W) or (H, W), uint8 or float, arrays or tensors;
    the row blocks go to the devices of the mesh's ``axis_name`` axis (a
    ``Mesh`` or a sequence of devices, read as that axis).  Returns the
    flow (B, H, W, 2) (or (H, W, 2)), channels (dx, dy), its row blocks
    gathered on the axis' first device.  Requires H divisible by
    n_shards·2^levels, W by 2^levels, pyr_scale 0.5 and no initial flow
    (the production configuration), as the JAX package does.
    """
    if mesh is None:
        raise ValueError("farneback_flow_sharded requires a mesh")
    devs = axis_devices(mesh, axis_name)
    prev, curr = torch.as_tensor(prev), torch.as_tensor(curr)
    squeeze = prev.ndim == 2
    if squeeze:
        prev, curr = prev[None], curr[None]
    b, h, w = prev.shape
    n = len(devs)
    klev = params.num_levels(h, w)
    if params.pyr_scale != 0.5:
        raise ValueError("sharded path requires pyr_scale=0.5")
    if params.use_initial_flow:
        raise ValueError("sharded path does not take an initial flow")
    if h % (n * (1 << klev)):
        raise ValueError(f"H={h} must be divisible by n_shards*2^levels={n * (1 << klev)}")
    if w % (1 << klev):
        raise ValueError(f"W={w} must be divisible by 2^levels={1 << klev}")
    check_supported(params)
    prec = params.warp_precision
    p_f = [x.float() for x in split_rows(prev, devs)]
    c_f = [x.float() for x in split_rows(curr, devs)]
    min_rows = max(params.poly_n, params.winsize // 2)
    home = devs[0]

    flow: Optional[list] = None  # per-block flows, or [whole] on `home`
    flow_whole = False
    for k in range(klev, -1, -1):
        hk, wk = h >> k, w >> k
        h_loc = hk // n
        i0 = _level_image_sharded(p_f, k, params)
        i1 = _level_image_sharded(c_f, k, params)
        sharded = h_loc >= min_rows
        if sharded:
            r0 = _poly_exp_sharded(i0, params.poly_n, params.poly_sigma)
            r1 = _poly_exp_sharded(i1, params.poly_n, params.poly_sigma)
        else:  # a thin coarse level: gathered and computed whole
            r0 = [farneback_cuda.poly_exp_cf(gather_rows(i0, home).contiguous(), params.poly_n,
                                             params.poly_sigma)]
            r1 = [farneback_cuda.poly_exp_cf(gather_rows(i1, home).contiguous(), params.poly_n,
                                             params.poly_sigma)]

        # ---- the flow handed down from the coarser level ----------------
        if flow is None:
            flow = [torch.zeros((b, 2, x.shape[-2], wk), dtype=torch.float32, device=x.device)
                    for x in r0]
        elif flow_whole:
            up = cvx.resize_bilinear(flow[0], 2 * flow[0].shape[-2], wk) * (1.0 / params.pyr_scale)
            flow = split_rows(up, devs) if sharded else [up]
        else:
            # Sharded levels only grow finer, so a sharded level never hands
            # its flow to a whole one.
            flow = [cvx.resize_bilinear(f, f.shape[-2], wk) * (1.0 / params.pyr_scale)
                    for f in _upsample2x_rows(flow)]
        flow = [f.contiguous() for f in flow]
        flow_whole = not sharded

        # ---- refinement iterations ---------------------------------------
        n_it = params.iters_at(k)
        for it in range(n_it):
            if sharded:
                m = _update_matrices_sharded(r0, r1, flow, hk, warp_halo, prec)
                flow = _update_flow_sharded(m, params.winsize, params.gaussian_win)
            else:
                m = farneback_cuda.update_matrices_cf(r0[0], r1[0], flow[0], prec)
                flow = [farneback_cuda.update_flow_cf(m, params.winsize, params.gaussian_win)]

    out = (flow[0] if flow_whole else gather_rows(flow, home)).movedim(1, -1)
    return out[0] if squeeze else out
