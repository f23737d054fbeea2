"""Wrapper of the band-pass cascade's CUDA kernel (``csrc/filters.cu``).

``sos_cascade`` runs a whole ``sosfilt`` call of the sequential engine
(``ops/filters.py``, ``engine="scan"``) in one launch of
``sos_cascade_kernel``: one thread per row walks every section in
``_section_scan``'s float32 order, so the answer is bit for bit that of
the plain loop on the card.  The JAX package has no kernel here: its
sequential engine is a ``lax.scan``.

For a tensor on the CPU the wrapper takes the plain section-by-section
loop of ``ops/filters.py``.  For a CUDA tensor it checks device, dtype,
shape and contiguity, allocates the outputs with ``torch.empty``,
launches on the current stream and raises if the launch fails; there is
no fallback.  The kernel is compiled for 1 to ``MAX_SECTIONS`` sections;
a longer cascade runs in groups of that many, one launch each, every
group's ``y`` the next group's input, which is the same section order.
``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.ops import _build
from btcs_pnes_optical_flow_tpu_torch.ops import filters as _plain
from btcs_pnes_optical_flow_tpu_torch.ops.farneback_cuda import _check

LAUNCHES = {"sos_cascade": 0}
# The most sections one launch takes (csrc/filters.cu kMaxSections).
MAX_SECTIONS = 8
_P = ctypes.c_void_p


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.lru_cache(maxsize=None)
def library():
    """The built kernel library with its C signatures declared."""
    lib = _build.load("filters.cu").lib
    lib.flt_sos_cascade.argtypes = [_P] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_longlong, _P]
    lib.flt_sos_cascade.restype = ctypes.c_int
    lib.flt_error_string.argtypes = [ctypes.c_int]
    lib.flt_error_string.restype = ctypes.c_char_p
    return lib


def sos_cascade(sos, x: torch.Tensor, zi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential SOS cascade over the last axis of x: sos (S, 6) host
    coefficients (a0 == 1), x (..., L) float32, zi (..., S, 2) → (y, zf)
    with y (..., L) and zf (..., S, 2)."""
    sos = np.asarray(sos, dtype=np.float64)
    n_sec = sos.shape[0]
    if x.device.type == "cpu":
        return _plain._cascade(_plain._section_scan, sos, x, zi)
    if not n_sec:
        raise ValueError("the cascade needs at least one section")
    _check(x, "x", x.shape)
    if zi.device != x.device:
        raise ValueError("x and zi must be on one device")
    zi = zi.contiguous()
    _check(zi, "zi", x.shape[:-1] + (n_sec, 2))
    if not x.numel():  # no sample: the state passes through
        return torch.empty_like(x), zi.clone()
    # float64 → float32 rounds to nearest, as a Python scalar meets a
    # float32 tensor in the plain loop.
    coeffs = np.ascontiguousarray(sos[:, [0, 1, 2, 4, 5]], dtype=np.float32)
    y, zf = x, []
    for s0 in range(0, n_sec, MAX_SECTIONS):  # each group's y is the next group's x
        group = slice(s0, s0 + MAX_SECTIONS)
        y, z = _launch(coeffs[group], y, zi[..., group, :].contiguous())
        zf.append(z)
    return y, zf[0] if len(zf) == 1 else torch.cat(zf, dim=-2)


def _launch(coeffs: np.ndarray, x: torch.Tensor, zi: torch.Tensor):
    """One launch of sos_cascade_kernel over 1 to MAX_SECTIONS sections."""
    n_sec, n = coeffs.shape[0], x.shape[-1]
    y, zf = torch.empty_like(x), torch.empty_like(zi)
    lib = library()
    LAUNCHES["sos_cascade"] += 1
    with torch.cuda.device(x.device):
        err = lib.flt_sos_cascade(x.data_ptr(), zi.data_ptr(), y.data_ptr(), zf.data_ptr(),
                                  coeffs.ctypes.data, n_sec, x.numel() // n, n,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"flt_sos_cascade failed: CUDA error {err} "
                           f"({lib.flt_error_string(err).decode()})")
    return y, zf
