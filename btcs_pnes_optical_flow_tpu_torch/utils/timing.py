"""Timing and profiling utilities.

Port of ``btcs_pnes_optical_flow_tpu/utils/timing.py``.  PyTorch returns
before the card has finished, so a stage timed on a CUDA device is
fenced on both edges: pending work is synchronised before the clock
starts, and a CUDA event recorded at the end is waited on before it
stops.  Inside a stage, ``span`` times a part on the host alone, with no
fence.  Stages and spans open a ``torch.profiler`` range of their name on
the host's timeline (``_range``).  ``trace`` captures a ``torch.profiler``
trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("btcs_pnes_optical_flow_tpu_torch")
# Per-chunk progress and stage rates go to stderr unless the embedding
# application configures logging itself or opts out
# (BTCS_LOG_LEVEL=WARNING silences progress).
if not logger.handlers and not logging.getLogger().handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("BTCS_LOG_LEVEL", "INFO"))


def _range(name: str):
    """A ``torch.profiler`` range on the host's timeline alone: a
    function-scope record.  ``torch.profiler.record_function`` opens a
    user-scope range instead, which the profiler mirrors on the device's
    timeline over the kernels launched inside it, so that a reduction of the
    trace that takes every device event for work would count the mirror."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def device_timer(name: str, sink: Optional[Dict[str, float]] = None, device=None):
    """Wall-time a block; on a CUDA ``device`` fenced on both edges."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if cuda:
        end = torch.cuda.Event()
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    logger.debug("stage %s: %.4fs", name, dt)


class StageTimer:
    """Accumulates per-stage wall time and item counts; reports rates.

    ``timed(name, n_items)`` is a stage, fenced on a CUDA device.
    ``span(name)`` is a part of a stage, timed on the host with
    ``time.perf_counter`` and no fence: no synchronisation and no event
    wait.  A span holds the host's time in that part, including time
    blocked inside the CUDA runtime, where a pageable copy to the card and
    a read of a device value synchronise the stream by themselves; work
    the card does for it after the host has moved on falls outside it.
    Each span adds 1 to ``items[name]``, so its count is the number of
    times it ran.  Both open a profiler range of their name (``_range``),
    so in a profiled call they lie on the trace's own clock.
    A lock guards the sums: threads may share a timer (``run_cohort``'s
    per-video flow workers).
    """

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _add(self, name: str, seconds: float, n: int):
        with self._lock:
            self.times[name] = self.times.get(name, 0.0) + seconds
            self.items[name] = self.items.get(name, 0) + n

    @contextlib.contextmanager
    def timed(self, name: str, n_items: int = 0):
        self.add_items(name, n_items)
        sink: Dict[str, float] = {}
        with _range(name), device_timer(name, sink, self.device):
            yield
        self._add(name, sink[name], 0)

    @contextlib.contextmanager
    def span(self, name: str):
        with _range(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self._add(name, dt, 1)

    def add_items(self, name: str, n: int):
        with self._lock:
            self.items[name] = self.items.get(name, 0) + n

    def report(self) -> str:
        rows = {
            k: {
                "seconds": round(t, 4),
                "items": self.items.get(k, 0),
                "items_per_sec": round(self.items.get(k, 0) / t, 2) if t > 0 else None,
            }
            for k, t in self.times.items()
        }
        return json.dumps(rows)


def span(timer: Optional[StageTimer], name: str):
    """``timer.span(name)``; without a timer a context that does nothing,
    so an untimed call reads no clock and opens no range."""
    return contextlib.nullcontext() if timer is None else timer.span(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (CPU, and CUDA when present),
    written to ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
