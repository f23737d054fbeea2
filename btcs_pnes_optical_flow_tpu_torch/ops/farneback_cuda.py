"""Wrappers of the Farnebäck CUDA kernels (``csrc/farneback.cu``).

Port of ``btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py``'s three
main-path kernels:

- ``poly_exp_cf``        ← ``poly_exp_fused_cf`` (K1);
- ``update_matrices_cf`` ← ``update_matrices_banded_cf`` (K2);
- ``update_flow_cf``     ← ``update_flow_fused_cf`` (K3).

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

from btcs_pnes_optical_flow_tpu_torch.ops import _build
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as _plain

LAUNCHES = {"poly_exp": 0, "update_matrices": 0, "update_flow": 0}
# Shared memory one block may use on sm_90 (232,448 bytes).
_MAX_SMEM = 232448
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.lru_cache(maxsize=None)
def library():
    """The built kernel library with its C signatures declared."""
    lib = _build.load("farneback.cu").lib
    sigs = {
        "fb_poly_exp": [_P, _P, _P, _LL, _I, _I, _I, _P],
        "fb_update_matrices": [_P, _P, _P, _P, _P, _LL, _I, _I, _P],
        "fb_update_flow": [_P, _P, _P, _LL, _I, _I, _I, _P],
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


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = library().fb_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _poly_consts(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """[g, xg, xxg, ig11, ig03, ig33, ig55] as float32 on the device."""
    g, xg, xxg, igs = _plain._poly_exp_tables(n, sigma)
    host = np.concatenate([g, xg, xxg, np.asarray(igs)]).astype(np.float32)
    return torch.as_tensor(host, device=device)


@functools.lru_cache(maxsize=None)
def _rim_scale(h: int, w: int, device: torch.device) -> torch.Tensor:
    """[sy (h), sx (w)] rim-damping vectors; sy[y]·sx[x] in float32 is
    bit-equal to ``_border_scale_np(h, w)[y, x]``."""
    host = np.concatenate([_plain._border_scale_1d(h), _plain._border_scale_1d(w)])
    return torch.as_tensor(host, device=device)


@functools.lru_cache(maxsize=None)
def _window_weights(winsize: int, gaussian_win: bool, device: torch.device) -> torch.Tensor:
    """[separable taps (winsize), final scale] as the plain version applies
    them: ones and 1/winsize² for the box, the Gaussian taps and 1."""
    if gaussian_win:
        w = np.append(_plain._gaussian_win_kernel(winsize), 1.0)
    else:
        w = np.append(np.ones(winsize), 1.0 / (winsize * winsize))
    return torch.as_tensor(w.astype(np.float32), device=device)


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
        consts = _poly_consts(n, float(sigma), img.device)
        LAUNCHES["poly_exp"] += 1
        _launch(lib.fb_poly_exp, img.data_ptr(), consts.data_ptr(), out.data_ptr(), b, h, w, n)
    return out


def update_matrices_cf(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K2: r0, r1 (B, 5, H, W), flow (B, 2, H, W) → M (B, 5, H, W)."""
    if r0.device.type == "cpu":
        return _plain.update_matrices_cf_plain(r0, r1, flow)
    b, _, h, w = r0.shape
    _check(r0, "r0", (b, 5, h, w))
    _check(r1, "r1", (b, 5, h, w))
    _check(flow, "flow", (b, 2, h, w))
    if r1.device != r0.device or flow.device != r0.device:
        raise ValueError("r0, r1 and flow must be on one device")
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=r0.device)
    if b:
        rim = _rim_scale(h, w, r0.device)
        LAUNCHES["update_matrices"] += 1
        _launch(library().fb_update_matrices, r0.data_ptr(), r1.data_ptr(), flow.data_ptr(),
                rim.data_ptr(), out.data_ptr(), b, h, w)
    return out


def update_flow_cf(m: torch.Tensor, winsize: int, gaussian_win: bool) -> torch.Tensor:
    """K3: M (B, 5, H, W) → flow (B, 2, H, W)."""
    if m.device.type == "cpu":
        return _plain.update_flow_cf_plain(m, winsize, gaussian_win)
    b, _, h, w = m.shape
    _check(m, "m", (b, 5, h, w))
    if winsize < 1 or winsize % 2 == 0:
        raise ValueError(f"winsize must be odd and positive, got {winsize}")
    lib = library()
    smem = lib.fb_update_flow_smem_bytes(winsize)
    if smem > _MAX_SMEM:
        raise ValueError(f"winsize={winsize} needs {smem} bytes of shared memory per block")
    out = torch.empty((b, 2, h, w), dtype=torch.float32, device=m.device)
    if b:
        weights = _window_weights(winsize, bool(gaussian_win), m.device)
        LAUNCHES["update_flow"] += 1
        _launch(lib.fb_update_flow, m.data_ptr(), weights.data_ptr(), out.data_ptr(),
                b, h, w, winsize)
    return out
