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
    - ``roi_active_px`` is ignored: every level is computed full-frame,
      which leaves the flow inside the ROI unchanged.
    - ``iter_schedule`` is honoured through ``params.iters_at``.
    """
    if params.warp_precision != "fp32":
        raise ValueError(
            f"warp_precision={params.warp_precision!r} is not supported; use 'fp32'"
        )
    return params
