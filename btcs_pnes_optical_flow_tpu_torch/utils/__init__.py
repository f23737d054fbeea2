"""Timing, profiling and logging: stage timers fenced on the card
(``StageTimer``, ``device_timer``) and profiler trace capture (``trace``)."""

from btcs_pnes_optical_flow_tpu_torch.utils.timing import (  # noqa: F401
    StageTimer,
    device_timer,
    trace,
)
