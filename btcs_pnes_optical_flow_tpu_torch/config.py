"""Configuration shared with the JAX package.

The frozen dataclasses live in ``btcs_pnes_optical_flow_tpu/config.py``,
which imports only ``dataclasses`` (and the JAX package's ``__init__``
imports only that module), so one config object drives both packages
without pulling JAX into this one.
"""

from __future__ import annotations

from btcs_pnes_optical_flow_tpu.config import (  # noqa: F401
    FarnebackParams,
    MetricParams,
    PCAParams,
    PipelineConfig,
    _round_half_even,
)


def check_supported(params: FarnebackParams) -> FarnebackParams:
    """Reject the knobs this package does not implement; returns params.

    - ``warp_precision="bf16"`` raises: the bf16 warp is not ported yet.
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
    if params.warp_precision != "fp32":
        raise ValueError(
            f"warp_precision={params.warp_precision!r} is not supported; use 'fp32'"
        )
    return params
