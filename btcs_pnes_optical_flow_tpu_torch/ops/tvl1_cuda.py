"""Wrappers of the TV-L1 CUDA kernels (``csrc/tvl1.cu``).

Port of the two Pallas kernels of the JAX package's TV-L1 engine:

- ``warp_sample_cf`` ← ``ops/farneback_pallas.py warp_sample_banded_cf`` (K5);
- ``pd_chain``       ← ``ops/tvl1_pallas.py pd_chain_resident`` (K6).

Each wrapper takes the plain PyTorch version of ``ops/tvl1.py`` for a
tensor on the CPU.  For a CUDA tensor it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream and raises if a launch fails; there is no
fallback.  ``LAUNCHES`` counts K5 launches (``warp_sample``), K6 chains
(``pd_chain``: one invariants launch each) and K6 per-iteration launches
(``pd_iteration``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from btcs_pnes_optical_flow_tpu_torch.ops import _build
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as _plain
from btcs_pnes_optical_flow_tpu_torch.ops.farneback_cuda import _check

LAUNCHES = {"warp_sample": 0, "pd_chain": 0, "pd_iteration": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.lru_cache(maxsize=None)
def library():
    """The built kernel library with its C signatures declared."""
    lib = _build.load("tvl1.cu").lib
    sigs = {
        "tv_warp_sample": [_P, _P, _P, _LL, _I, _I, _I, _P],
        "tv_pd_init": [_P, _P, _P, _P, _P, _LL, _F, _P],
        "tv_pd_iteration": [_P] * 10 + [_LL, _I, _I, _F, _F, _F, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tv_error_string.argtypes = [_I]
    lib.tv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = library().tv_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


def warp_sample_cf(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K5: src (B, C, H, W) sampled at (x+u, y+v), flow (B, 2, H, W) →
    (B, C, H, W), clamped bilinear (cv2.remap border-replicate)."""
    if src.device.type == "cpu":
        return _plain.warp_sample_cf_plain(src, flow)
    b, c, h, w = src.shape
    _check(src, "src", (b, c, h, w))
    _check(flow, "flow", (b, 2, h, w))
    if flow.device != src.device:
        raise ValueError("src and flow must be on one device")
    out = torch.empty_like(src)
    if out.numel():
        LAUNCHES["warp_sample"] += 1
        _launch(library().tv_warp_sample, src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                b, c, h, w)
    return out


def pd_chain(u: torch.Tensor, v: torch.Tensor, rho_c: torch.Tensor, i1wx: torch.Tensor,
             i1wy: torch.Tensor, grad_sq: torch.Tensor, n_iterations: int, tau: float,
             lambda_: float, theta: float):
    """K6: one warp's primal–dual chain, all planes (B, H, W) float32 →
    (u, v) after ``n_iterations`` steps with the duals started at zero."""
    if u.device.type == "cpu":
        return _plain.pd_chain_plain(u, v, rho_c, i1wx, i1wy, grad_sq,
                                     n_iterations, tau, lambda_, theta)
    b, h, w = u.shape
    planes = {"u": u, "v": v, "rho_c": rho_c, "i1wx": i1wx, "i1wy": i1wy, "grad_sq": grad_sq}
    for name, t in planes.items():
        _check(t, name, (b, h, w))
        if t.device != u.device:
            raise ValueError("the six planes must be on one device")
    out = torch.empty((2, b, h, w), dtype=torch.float32, device=u.device)
    if n_iterations <= 0 or not u.numel():  # no step, as in the plain loop
        out[0].copy_(u)
        out[1].copy_(v)
        return out[0], out[1]
    # Loop constants rounded to float32 from their float64 values, as a
    # Python scalar meets a float32 tensor in the plain version.
    l_t = lambda_ * theta
    tau_theta = tau / theta
    lib = library()
    inv = torch.empty((3, b, h, w), dtype=torch.float32, device=u.device)
    state = torch.empty((2, 6, b, h, w), dtype=torch.float32, device=u.device)  # ping-pong
    LAUNCHES["pd_chain"] += 1
    _launch(lib.tv_pd_init, i1wx.data_ptr(), i1wy.data_ptr(), grad_sq.data_ptr(),
            inv.data_ptr(), state[0, 2].data_ptr(), u.numel(), l_t)
    fixed = (rho_c.data_ptr(), i1wx.data_ptr(), i1wy.data_ptr(), inv.data_ptr())
    cur_u, cur_v, cur_p = u.data_ptr(), v.data_ptr(), state[0, 2].data_ptr()
    for it in range(n_iterations):
        nxt = state[(it + 1) % 2]
        dst = out if it == n_iterations - 1 else nxt
        dst_u, dst_v, dst_p = dst[0].data_ptr(), dst[1].data_ptr(), nxt[2].data_ptr()
        LAUNCHES["pd_iteration"] += 1
        _launch(lib.tv_pd_iteration, cur_u, cur_v, cur_p, *fixed, dst_u, dst_v, dst_p,
                b, h, w, l_t, theta, tau_theta)
        cur_u, cur_v, cur_p = dst_u, dst_v, dst_p
    return out[0], out[1]
