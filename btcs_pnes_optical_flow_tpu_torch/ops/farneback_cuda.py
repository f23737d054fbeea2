"""Wrappers of the Farnebäck CUDA kernels (``csrc/farneback.cu``).

Port of ``btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py``'s four
Farnebäck kernels:

- ``poly_exp_cf``              ← ``poly_exp_fused_cf`` (K1);
- ``update_matrices_cf``       ← ``update_matrices_banded_cf`` (K2), with
  its ``active`` tile range as a box mode for ROI dispatch;
- ``update_flow_cf``           ← ``update_flow_fused_cf`` (K3), with a box
  mode for ROI dispatch;
- ``update_matrices_tiles_cf`` ← ``update_matrices_banded_tiles_cf`` (K4),
  which no path of the port runs (JAX runs it for follow-up passes only);
- ``update_matrices_rows_cf``  ← K2 on a height shard, the kernel of
  ``parallel/spatial.py`` (JAX ``spatial.py _update_matrices_sharded``).

K2 and K4 take ``precision`` ("fp32" or the TPU kernel's "bf16"
horizontal lerp); the bf16 instances count their launches apart
(``update_matrices_bf16``, ``update_matrices_tiles_bf16``), and K2's box
launches count a second time under ``update_matrices_box`` /
``update_matrices_box_bf16``.

Each wrapper takes the plain PyTorch version of ``ops/farneback.py`` for
a tensor on the CPU.  For a CUDA tensor it checks device, dtype, shape
and contiguity, allocates the output with ``torch.empty``, launches the
kernel on the current stream and raises if the launch fails; there is
no fallback.  ``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import WARP_PRECISIONS
from btcs_pnes_optical_flow_tpu_torch.ops import _build
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as _plain

LAUNCHES = {"poly_exp": 0, "update_matrices": 0, "update_flow": 0, "update_matrices_tiles": 0,
            "update_matrices_bf16": 0, "update_matrices_tiles_bf16": 0,
            "update_matrices_rows": 0, "update_matrices_box": 0, "update_matrices_box_bf16": 0}
# Shared memory one block may use on sm_90 (232,448 bytes).
_MAX_SMEM = 232448
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# K2's walk (csrc/farneback.cu update_matrices_kernel): one block per tile
# of this many (rows, columns), walking a run of consecutive pairs.
WALK_TILE = (8, 32)
# The walk's grid aims at this many times the blocks that the card holds at
# once: the last wave is then a small share of the launch, and the runs stay
# as long as that allows (a run's first pair reads its r0 frame once more).
# On an H100 (scripts/k2_walk_variants.py), 16 ran the 1080p level-0 box
# and 480p's whole level in 1.9-3.3% less time than 8 and within 1% of 32;
# 8 ran the 1080p level-2 box 5% faster.
WALK_WAVES = 16


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.lru_cache(maxsize=None)
def library():
    """The built kernel library with its C signatures declared."""
    lib = _build.load("farneback.cu").lib
    sigs = {
        "fb_poly_exp": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
        "fb_update_matrices": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "fb_update_matrices_rows": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P],
        "fb_update_matrices_resident": [_I, ctypes.POINTER(_I)],
        "fb_update_flow": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "fb_update_matrices_tiles": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
        "fb_poly_exp_smem_bytes": [_I],
        "fb_update_flow_smem_bytes": [_I],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fb_error_string.argtypes = [_I]
    lib.fb_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(device: torch.device, fn, *args) -> None:
    """Launch on ``device`` (the tensors' card, made current for the call)
    and its current stream."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        msg = library().fb_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _poly_consts(n: int, sigma: float, device: torch.device):
    """[g, xg, xxg, ig11, ig03, ig33, ig55] as float32 on the host (the
    kernel's parameters) and on the device (the run-time-radius instance)."""
    g, xg, xxg, igs = _plain._poly_exp_tables(n, sigma)
    host = np.concatenate([g, xg, xxg, np.asarray(igs)]).astype(np.float32)
    return host, torch.as_tensor(host, device=device)


@functools.lru_cache(maxsize=None)
def _window_weights(winsize: int, gaussian_win: bool, device: torch.device):
    """[separable taps (winsize), final scale] as the plain version applies
    them: ones and 1/winsize² for the box, the Gaussian taps and 1; on the
    host (the kernel's parameters) and on the device."""
    if gaussian_win:
        w = np.append(_plain._gaussian_win_kernel(winsize), 1.0)
    else:
        w = np.append(np.ones(winsize), 1.0 / (winsize * winsize))
    host = w.astype(np.float32)
    return host, torch.as_tensor(host, device=device)


def poly_exp_cf(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """K1: (B, H, W) float32 → (B, 5, H, W) polynomial expansion."""
    if img.device.type == "cpu":
        return _plain.poly_exp_cf_plain(img, n, sigma)
    b, h, w = img.shape
    _check(img, "img", (b, h, w))
    lib = library()
    smem = lib.fb_poly_exp_smem_bytes(n)
    if smem > _MAX_SMEM:
        raise ValueError(f"poly_n={n} needs {smem} bytes of shared memory per block")
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=img.device)
    if b:
        host, consts = _poly_consts(n, float(sigma), img.device)
        LAUNCHES["poly_exp"] += 1
        _launch(img.device, lib.fb_poly_exp, img.data_ptr(), host.ctypes.data, consts.data_ptr(),
                out.data_ptr(), b, h, w, n)
    return out


@functools.lru_cache(maxsize=None)
def _rim_rows(h: int, w: int, row_off: int, h_glob: int, device: torch.device) -> torch.Tensor:
    """[sy of the global rows [row_off, row_off + h), sx (w)]: the rim
    damping of a height shard (row_off = 0, h = h_glob: the whole image);
    sy[y]·sx[x] in float32 is bit-equal to the plain version's scale."""
    sy = _plain._border_scale_1d(h_glob)[row_off:row_off + h]
    return torch.as_tensor(np.concatenate([sy, _plain._border_scale_1d(w)]), device=device)


def _bf16(precision: str) -> int:
    if precision not in WARP_PRECISIONS:
        raise ValueError(f"precision must be one of {WARP_PRECISIONS}, got {precision!r}")
    return int(precision == "bf16")


def _level_box(box, h: int, w: int):
    """A box (y0, y1, x0, x1), half-open, as host ints; raises when it is
    empty or leaves the (h, w) level."""
    y0, y1, x0, x1 = (int(v) for v in box)
    if not (0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w):
        raise ValueError(f"box {tuple(box)} is empty or outside the {h}x{w} level")
    return y0, y1, x0, x1


def _check_planes(r0, r1, flow, h_ext: int) -> None:
    b, _, h, w = r0.shape
    _check(r0, "r0", (b, 5, h, w))
    _check(r1, "r1", (b, 5, h_ext, w))
    _check(flow, "flow", (b, 2, h, w))
    if r1.device != r0.device or flow.device != r0.device:
        raise ValueError("r0, r1 and flow must be on one device")


def pairs_per_run(n_tiles: int, batch: int, resident: int) -> int:
    """Pairs that each block of K2's walk takes in turn: runs of equal
    length (the last one shorter), as long as they can be while the grid
    (n_tiles × runs blocks) still reaches WALK_WAVES times the
    ``resident`` blocks that the card holds at once."""
    runs = min(batch, max(1, -(-WALK_WAVES * resident // n_tiles)))
    return max(1, batch // runs)


@functools.lru_cache(maxsize=None)
def _resident(device: torch.device, bf16: int) -> int:
    """Blocks of K2's walk that the card holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = library().fb_update_matrices_resident(bf16, ctypes.byref(out))
    if err:
        raise RuntimeError(f"fb_update_matrices_resident failed: CUDA error {err} "
                           f"({library().fb_error_string(err).decode()})")
    return out.value


def _walk(r0, r1, flow, precision: str, box, out, boxed: bool, pairs=None) -> None:
    """Launch K2's walk on CUDA tensors over ``box`` (half-open host ints)
    into ``out`` in runs of ``pairs`` pairs (default: ``pairs_per_run`` of
    the launch); ``boxed`` counts the launch as a box launch too."""
    bf16 = _bf16(precision)
    b, _, h, w = r0.shape
    y0, y1, x0, x1 = box
    if pairs is None:
        th, tw = WALK_TILE
        n_tiles = -(-(y1 - y0) // th) * -(-(x1 - x0) // tw)
        pairs = pairs_per_run(n_tiles, b, _resident(r0.device, bf16))
    rim = _rim_rows(h, w, 0, h, r0.device)
    LAUNCHES["update_matrices_bf16" if bf16 else "update_matrices"] += 1
    if boxed:
        LAUNCHES["update_matrices_box_bf16" if bf16 else "update_matrices_box"] += 1
    _launch(r0.device, library().fb_update_matrices, r0.data_ptr(), r1.data_ptr(),
            flow.data_ptr(), rim.data_ptr(), out.data_ptr(), b, h, w, y0, y1, x0, x1,
            int(pairs), bf16)


def update_matrices_cf(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                       precision: str = "fp32", box=None, out=None) -> torch.Tensor:
    """K2: r0, r1 (B, 5, H, W), flow (B, 2, H, W) → M (B, 5, H, W); the
    warp's horizontal lerp in ``precision``.

    Box mode (``box=(y0, y1, x0, x1)``, half-open, with ``out`` the level's
    M (B, 5, H, W)), the port of the TPU kernel's ``active`` tile range:
    M at the box's pixels is written into ``out`` in place and returned;
    the rest of ``out`` is left as it was.  r0, r1 and flow stay whole:
    the warp samples r1 anywhere in the level.
    """
    _bf16(precision)
    if (box is None) != (out is None):
        raise ValueError("box and out go together")
    b, _, h, w = r0.shape
    if box is not None:
        box = _level_box(box, h, w)
    if r0.device.type == "cpu":
        return _plain.update_matrices_cf_plain(r0, r1, flow, precision, box, out)
    _check_planes(r0, r1, flow, h)
    boxed = out is not None
    if boxed:
        _check(out, "out", (b, 5, h, w))
        if out.device != r0.device:
            raise ValueError("r0 and out must be on one device")
    else:
        box = (0, h, 0, w)
        out = torch.empty((b, 5, h, w), dtype=torch.float32, device=r0.device)
    if b and h and w:
        _walk(r0, r1, flow, precision, box, out, boxed)
    return out


def update_matrices_rows_cf(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                            row_off: int, h_glob: int, precision: str = "fp32") -> torch.Tensor:
    """K2's row-offset instance: M of the rows [row_off, row_off + h) of an
    image of ``h_glob`` rows from r0, flow (B, ·, h, W) and r1 (B, 5, h +
    2K, W), the shard's rows with K rows of halo on each side
    (``update_matrices_rows_cf_plain``).  At row_off = K = 0, h_glob = h it
    is K2's pre-walk design over the whole image."""
    bf16 = _bf16(precision)
    h = r0.shape[2]
    h_ext = r1.shape[2]
    if (h_ext - h) % 2 or h_ext < h:
        raise ValueError(f"r1 has {h_ext} rows; expected the shard's {h} plus 2K")
    if not (0 <= row_off and row_off + h <= h_glob):
        raise ValueError(f"rows [{row_off}, {row_off + h}) lie outside the image's {h_glob}")
    if r0.device.type == "cpu":
        return _plain.update_matrices_rows_cf_plain(r0, r1, flow, row_off, h_glob, precision)
    _check_planes(r0, r1, flow, h_ext)
    b, _, h, w = r0.shape
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=r0.device)
    if b and h:
        rim = _rim_rows(h, w, int(row_off), int(h_glob), r0.device)
        LAUNCHES["update_matrices_rows"] += 1
        _launch(r0.device, library().fb_update_matrices_rows, r0.data_ptr(), r1.data_ptr(),
                flow.data_ptr(), rim.data_ptr(), out.data_ptr(), b, h, w, int(row_off),
                (h_ext - h) // 2, int(h_glob), bf16)
    return out


def update_flow_cf(m: torch.Tensor, winsize: int, gaussian_win: bool,
                   box=None, out=None) -> torch.Tensor:
    """K3: M (B, 5, H, W) → flow (B, 2, H, W).

    Box mode (``box=(y0, y1, x0, x1)``, half-open, with ``out`` the level's
    flow (B, 2, H, W)): solves the box only, reading M clamped to it, and
    writes the box of ``out`` in place; the rest of ``out`` is untouched.
    """
    if (box is None) != (out is None):
        raise ValueError("box and out go together")
    b, _, h, w = m.shape
    if box is not None:
        y0, y1, x0, x1 = box = _level_box(box, h, w)
    if m.device.type == "cpu":
        return _plain.update_flow_cf_plain(m, winsize, gaussian_win, box, out)
    _check(m, "m", (b, 5, h, w))
    if winsize < 1 or winsize % 2 == 0:
        raise ValueError(f"winsize must be odd and positive, got {winsize}")
    lib = library()
    smem = lib.fb_update_flow_smem_bytes(winsize)
    if smem > _MAX_SMEM:
        raise ValueError(f"winsize={winsize} needs {smem} bytes of shared memory per block")
    if box is None:
        y0, y1, x0, x1 = 0, h, 0, w
        out = torch.empty((b, 2, h, w), dtype=torch.float32, device=m.device)
    else:
        _check(out, "out", (b, 2, h, w))
        if out.device != m.device:
            raise ValueError("m and out must be on one device")
    if b:
        host, weights = _window_weights(winsize, bool(gaussian_win), m.device)
        LAUNCHES["update_flow"] += 1
        _launch(m.device, lib.fb_update_flow, m.data_ptr(), host.ctypes.data, weights.data_ptr(),
                out.data_ptr(), b, h, w, winsize, int(bool(gaussian_win)), y0, y1 - 1, x0, x1 - 1)
    return out


def update_matrices_tiles_cf(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                             sel: torch.Tensor, m: torch.Tensor, tile,
                             precision: str = "fp32") -> torch.Tensor:
    """K4: K2 over the listed tiles, in place into M; returns ``m``.

    ``sel`` (K,) int32 lists flat tile ids ``(b·n_i + i)·n_j + j`` on the
    ``tile = (tile_h, tile_w)`` lattice of the level, n_i = ⌈H/tile_h⌉,
    n_j = ⌈W/tile_w⌉.  M outside the listed tiles is left as it was.
    """
    bf16 = _bf16(precision)
    b, _, h, w = r0.shape
    th, tw = (int(v) for v in tile)
    n_tiles = b * (-(-h // th)) * (-(-w // tw))
    if sel.dtype != torch.int32 or sel.ndim != 1 or not sel.is_contiguous():
        raise ValueError(f"sel must be a contiguous 1-D int32 tensor, got {sel.dtype} "
                         f"{tuple(sel.shape)}")
    if sel.device != r0.device:
        raise ValueError(f"sel is on {sel.device}, the planes on {r0.device}")
    if sel.numel():
        lo, hi = torch.stack(torch.aminmax(sel)).tolist()  # one device read
        if lo < 0 or hi >= n_tiles:
            raise ValueError(f"sel holds tile ids in [{lo}, {hi}], outside [0, {n_tiles})")
    if r0.device.type == "cpu":
        return _plain.update_matrices_tiles_cf_plain(r0, r1, flow, sel, m, (th, tw), precision)
    _check(r0, "r0", (b, 5, h, w))
    _check(r1, "r1", (b, 5, h, w))
    _check(flow, "flow", (b, 2, h, w))
    _check(m, "m", (b, 5, h, w))
    if r1.device != r0.device or flow.device != r0.device or m.device != r0.device:
        raise ValueError("r0, r1, flow and m must be on one device")
    if th * tw > 1024:
        raise ValueError(f"tile {tile} has more pixels than a block has threads (1024)")
    if sel.numel():
        rim = _rim_rows(h, w, 0, h, r0.device)
        LAUNCHES["update_matrices_tiles_bf16" if bf16 else "update_matrices_tiles"] += 1
        _launch(r0.device, library().fb_update_matrices_tiles, r0.data_ptr(), r1.data_ptr(),
                flow.data_ptr(), rim.data_ptr(), sel.data_ptr(), m.data_ptr(),
                sel.numel(), h, w, th, tw, bf16)
    return m
