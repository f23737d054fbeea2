"""Frozen, hashable configuration tree of the port.

Mirrors ``btcs_pnes_optical_flow_tpu/config.py``: the same dataclasses
with the same fields and defaults, which are the reference's module-level
constants (``optical_flow.py:48-56``, ``optical_PCA.py:47-58``,
``optical_PC1.py:33-44``), so a default-constructed config reproduces the
reference pipeline.  ``from_fields`` carries a config built elsewhere (any
dataclass with these field names) across into the port's classes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_half_even(x: float) -> int:
    """Banker's rounding, matching Python round(), np.round and cvRound."""
    f = math.floor(x)
    diff = x - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f + 1 if f % 2 else f


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Dense Farnebäck optical-flow parameters.

    Defaults match the reference ``FB_PARAMS`` (optical_flow.py:48-56).
    ``gaussian_win`` is OpenCV's OPTFLOW_FARNEBACK_GAUSSIAN flag bit and
    ``use_initial_flow`` its OPTFLOW_USE_INITIAL_FLOW bit.  The ``warp_*``
    fields after ``warp_precision`` tune the JAX package's banded TPU warp;
    the port accepts and ignores them (``check_supported``).
    ``iter_schedule`` gives the iteration count per level (levels past its
    end reuse the last entry; None = ``iterations`` everywhere).
    ``roi_active_px`` holds per-level (y_lo, y_hi, x_lo, x_hi) pixel boxes
    of ROI dispatch (``ops/farneback.py roi_dispatch_params``); None runs
    every level whole.
    """

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # flags & OPTFLOW_FARNEBACK_GAUSSIAN
    use_initial_flow: bool = False  # flags & OPTFLOW_USE_INITIAL_FLOW
    warp_engine: str = "banded"
    warp_d_max_y: int = 8
    warp_d_max_x: int = 16
    warp_base_max: int = 56
    warp_layout: str = "native"
    warp_s_cap: int = 14
    warp_precision: str = "fp32"
    warp_dual_frac: float = 0.125
    warp_dual_passes: int = 2
    iter_schedule: Optional[Tuple[int, ...]] = None
    warp_coarse_reach: Optional[Tuple[int, int, int]] = None
    warp_coarse_tw: Optional[int] = None
    warp_dma_slots: int = 2
    roi_active_px: Optional[Tuple[Tuple[int, int, int, int], ...]] = None

    def iters_at(self, k: int) -> int:
        """Iteration count at pyramid level k (0 = finest)."""
        if not self.iter_schedule:
            return self.iterations
        return self.iter_schedule[min(k, len(self.iter_schedule) - 1)]

    def num_levels(self, height: int, width: int, min_size: int = 32) -> int:
        """Number of *extra* pyramid levels actually used.

        OpenCV clamps `levels` so that every level is at least
        ``min_size`` pixels on each side; processing then runs from
        level ``k`` (coarsest) down to 0 (full resolution), i.e.
        ``num_levels + 1`` passes in total.
        """
        k = 0
        scale = 1.0
        while k < self.levels:
            scale *= self.pyr_scale
            if width * scale < min_size or height * scale < min_size:
                break
            k += 1
        return k

    def level_size(self, height: int, width: int, k: int) -> Tuple[int, int]:
        scale = self.pyr_scale**k
        return (_round_half_even(height * scale), _round_half_even(width * scale))


@dataclasses.dataclass(frozen=True)
class PCAParams:
    """Band-pass + sliding-window PCA parameters (optical_PCA.py:47-58).

    The reference hardcodes ``fs = 30`` and uses it for window sizing
    regardless of the true frame timestamps; so does this.
    ``max_finite_runs`` bounds the contiguous finite runs the NaN-robust
    band-pass processes.
    """

    fs: float = 30.0
    bpf_low_hz: float = 0.5
    bpf_high_hz: float = 5.0
    bpf_order: int = 4
    win_sec: float = 2.0
    step_sec: float = 0.1
    min_samples_pca: int = 3
    max_finite_runs: int = 64

    @property
    def win_n(self) -> int:
        return max(self.min_samples_pca, _round_half_even(self.win_sec * self.fs))

    @property
    def step_n(self) -> int:
        return max(1, _round_half_even(self.step_sec * self.fs))


@dataclasses.dataclass(frozen=True)
class MetricParams:
    """PC1 metric-extraction parameters (optical_PC1.py:33-44)."""

    window_sec: float = 10.0
    smooth_sec: float = 0.20
    p95_win_sec: float = 2.0
    peak_min_frac: float = 0.20
    peak_min_abs: float = 0.0
    min_dist_sec: float = 0.2
    min_valid_samples: int = 10
    min_intervals_for_tau: int = 5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration (float32 throughout)."""

    flow: FarnebackParams = FarnebackParams()
    pca: PCAParams = PCAParams()
    metrics: MetricParams = MetricParams()
    dtype: str = "float32"


_CLASSES = {c.__name__: c for c in (FarnebackParams, PCAParams, MetricParams, PipelineConfig)}


def from_fields(obj):
    """The port's config equal to ``obj``, a dataclass instance with the
    field names of one of this module's classes (matched by class name),
    recursing into nested configs.  Fields the port's class lacks raise."""
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no port config for {type(obj).__name__}")
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        vals[f.name] = from_fields(v) if dataclasses.is_dataclass(v) else v
    return cls(**vals)


# The warp's precisions: float32, or the TPU kernel's bf16 horizontal lerp.
WARP_PRECISIONS = ("fp32", "bf16")


def check_supported(params: FarnebackParams) -> FarnebackParams:
    """Reject the knobs this package does not implement; returns params.

    - ``warp_precision`` is "fp32" or "bf16" (the TPU kernel's bf16
      horizontal lerp, ``ops/farneback.py _lerp_x``); anything else raises.
    - The TPU banded-warp knobs (``warp_d_max_*``, ``warp_base_max``,
      ``warp_s_cap``, ``warp_dual_*``, ``warp_dma_slots``,
      ``warp_coarse_reach``, ``warp_coarse_tw``, ``warp_layout``) are
      ignored: the CUDA warp samples directly, has no reach and never
      clips.
    - ``roi_active_px`` is honoured: a level whose box, quantized to the
      port's tile lattice, leaves out some tiles computes M (K4) and flow
      (K3 in box mode) over the box only; the flow inside the ROI equals
      the full-frame flow bit for bit (``ops/farneback.py``,
      ``roi_dispatch_params``).
    - ``iter_schedule`` is honoured through ``params.iters_at``.
    - ``use_initial_flow`` is honoured: ``farneback_flow`` and
      ``farneback_flow_seq`` start the pyramid from their ``flow0``
      argument when it is given, as cv2's OPTFLOW_USE_INITIAL_FLOW does.
    """
    if params.warp_precision not in WARP_PRECISIONS:
        raise ValueError(
            f"warp_precision={params.warp_precision!r} is not supported; use one of "
            f"{WARP_PRECISIONS}"
        )
    return params
