"""Wrappers of the TV-L1 CUDA kernels (``csrc/tvl1.cu``).

Port of the two Pallas kernels of the JAX package's TV-L1 engine:

- ``warp_sample_cf`` ← ``ops/farneback_pallas.py warp_sample_banded_cf`` (K5);
- ``pd_chain``       ← ``ops/tvl1_pallas.py pd_chain_resident`` (K6);

and ``pd_eps_chain``, the per-pair ε loop with one launch of K6's ε step an
iteration (the JAX package runs that loop in XLA ops).

Each wrapper takes the plain PyTorch version of ``ops/tvl1.py`` for a
tensor on the CPU.  For a CUDA tensor it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches
on the current stream and raises if a launch fails; there is no
fallback.  ``LAUNCHES`` counts K5 launches (``warp_sample``), K6 chains
(``pd_chain``), K6 launches (``pd_block``: ``len(pd_schedule(...))``
per chain, each running several iterations) and ε-step launches
(``pd_eps_step``: one an iteration of the ε loop).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from btcs_pnes_optical_flow_tpu_torch.ops import _build
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as _plain
from btcs_pnes_optical_flow_tpu_torch.ops.farneback_cuda import _check

LAUNCHES = {"warp_sample": 0, "pd_chain": 0, "pd_block": 0, "pd_eps_step": 0}
# The iteration depths K6 is compiled for (csrc/tvl1.cu tv_pd_block), and
# the depth a chain runs at unless the caller asks for another.
PD_DEPTHS = tuple(range(1, 11))
PD_DEPTH = 8
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
        "tv_pd_block": [_P] * 10 + [_LL, _I, _I, _I, _F, _F, _F, _P],
        "tv_pd_eps_step": [_P] * 12 + [_LL, _I, _I, _F, _F, _F, _P],
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
    if max(c, 2) * h * w >= 2**31 or b * h * -(-w // 128) * 32 >= 2**31:
        raise ValueError(f"K5 takes fewer than 2^31 elements a frame and threads a launch, "
                         f"got {tuple(src.shape)}")
    out = torch.empty_like(src)
    if out.numel():
        LAUNCHES["warp_sample"] += 1
        _launch(library().tv_warp_sample, src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                b, c, h, w)
    return out


def pd_schedule(n_iterations: int, depth: int = PD_DEPTH) -> Tuple[int, ...]:
    """K6's launches for one chain: the iteration depth of each launch in
    order, ``depth`` each and the remainder last, summing to
    ``n_iterations`` (8+8+8+6 for 30 at depth 8)."""
    if depth not in PD_DEPTHS:
        raise ValueError(f"K6 is compiled for depths {PD_DEPTHS}, got {depth}")
    if n_iterations <= 0:
        return ()
    full, rest = divmod(n_iterations, depth)
    return (depth,) * full + ((rest,) if rest else ())


def _check_planes(u, v, rho_c, i1wx, i1wy, grad_sq):
    """The chain's six planes: (B, H, W) float32, contiguous, on u's device."""
    b, h, w = u.shape
    planes = {"u": u, "v": v, "rho_c": rho_c, "i1wx": i1wx, "i1wy": i1wy, "grad_sq": grad_sq}
    for name, t in planes.items():
        _check(t, name, (b, h, w))
        if t.device != u.device:
            raise ValueError("the six planes must be on one device")
    return b, h, w


def pd_chain(u: torch.Tensor, v: torch.Tensor, rho_c: torch.Tensor, i1wx: torch.Tensor,
             i1wy: torch.Tensor, grad_sq: torch.Tensor, n_iterations: int, tau: float,
             lambda_: float, theta: float, *, depth: int = PD_DEPTH):
    """K6: one warp's primal–dual chain, all planes (B, H, W) float32 →
    (u, v) after ``n_iterations`` steps with the duals started at zero, in
    the launches of ``pd_schedule(n_iterations, depth)``."""
    if u.device.type == "cpu":
        return _plain.pd_chain_plain(u, v, rho_c, i1wx, i1wy, grad_sq,
                                     n_iterations, tau, lambda_, theta)
    b, h, w = _check_planes(u, v, rho_c, i1wx, i1wy, grad_sq)
    schedule = pd_schedule(n_iterations, depth)
    out = torch.empty((2, b, h, w), dtype=torch.float32, device=u.device)
    if not schedule or not u.numel():  # no step, as in the plain loop
        out[0].copy_(u)
        out[1].copy_(v)
        return out[0], out[1]
    # Loop constants rounded to float32 from their float64 values, as a
    # Python scalar meets a float32 tensor in the plain version.
    l_t = lambda_ * theta
    tau_theta = tau / theta
    lib = library()
    # Ping-pong state [u, v, p11, p12, p21, p22] between a chain's launches:
    # a launch reads its neighbours' halos, so it never writes in place.
    state = (torch.empty((2, 6, b, h, w), dtype=torch.float32, device=u.device)
             if len(schedule) > 1 else None)
    fixed = (rho_c.data_ptr(), i1wx.data_ptr(), i1wy.data_ptr(), grad_sq.data_ptr())
    cur = (u.data_ptr(), v.data_ptr(), None)  # the first launch starts the duals at zero
    LAUNCHES["pd_chain"] += 1
    for k, d in enumerate(schedule):
        if k == len(schedule) - 1:
            dst = (out[0].data_ptr(), out[1].data_ptr(), None)
        else:
            nxt = state[k % 2]
            dst = (nxt[0].data_ptr(), nxt[1].data_ptr(), nxt[2].data_ptr())
        LAUNCHES["pd_block"] += 1
        _launch(lib.tv_pd_block, *cur, *fixed, *dst, b, h, w, d, l_t, theta, tau_theta)
        cur = dst
    return out[0], out[1]


def pd_eps_chain(u: torch.Tensor, v: torch.Tensor, rho_c: torch.Tensor, i1wx: torch.Tensor,
                 i1wy: torch.Tensor, grad_sq: torch.Tensor, n_iterations: int, tau: float,
                 lambda_: float, theta: float, epsilon: float):
    """The per-pair ε loop of ``pd_chain_plain(..., epsilon=epsilon)``, all
    planes (B, H, W) float32 → (u, v): one launch of K6's ε step an
    iteration, then the plain loop's own stop test on the step's squared
    update (the same reduction, one host read an iteration).  With
    ``epsilon == 0`` it runs ``n_iterations`` launches and reads nothing."""
    if u.device.type == "cpu":
        return _plain.pd_chain_plain(u, v, rho_c, i1wx, i1wy, grad_sq, n_iterations, tau,
                                     lambda_, theta, epsilon=epsilon)
    b, h, w = _check_planes(u, v, rho_c, i1wx, i1wy, grad_sq)
    if b * -(-h // 32) * -(-w // 64) >= 2**31:  # a block per 32×64 tile
        raise ValueError(f"the ε step takes fewer than 2^31 tiles a launch, got {tuple(u.shape)}")
    if n_iterations <= 0 or not u.numel():  # no step, as in the plain loop
        return u, v
    l_t = lambda_ * theta
    tau_theta = tau / theta
    lib = library()
    active = torch.ones((b,), dtype=torch.bool, device=u.device)
    sq = torch.empty_like(u) if epsilon > 0 else None
    fixed = (rho_c.data_ptr(), i1wx.data_ptr(), i1wy.data_ptr(), grad_sq.data_ptr())
    # Ping-pong state, ((u, v), duals) a set: a step reads its neighbours'
    # state, so it never writes in place; the second set only if a second
    # step runs.
    sets = []
    cur = (u, v, None)  # the first step starts the duals at zero
    for k in range(n_iterations):
        if len(sets) <= k % 2:
            sets.append((torch.empty((2, b, h, w), dtype=torch.float32, device=u.device),
                         torch.empty((4, b, h, w), dtype=torch.float32, device=u.device)))
        uv, duals = sets[k % 2]
        LAUNCHES["pd_eps_step"] += 1
        _launch(lib.tv_pd_eps_step, cur[0].data_ptr(), cur[1].data_ptr(),
                cur[2].data_ptr() if cur[2] is not None else None, *fixed, active.data_ptr(),
                uv[0].data_ptr(), uv[1].data_ptr(), duals.data_ptr(),
                sq.data_ptr() if sq is not None else None, b, h, w, l_t, theta, tau_theta)
        cur = (uv[0], uv[1], duals)
        if sq is None:
            continue
        err = sq.mean(dim=(-2, -1))
        active = active & ~(err < epsilon * epsilon)
        if not bool(active.any()):
            break
    return cur[0], cur[1]
