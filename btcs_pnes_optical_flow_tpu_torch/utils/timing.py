"""Timing and profiling utilities.

Port of ``btcs_pnes_optical_flow_tpu/utils/timing.py``.  PyTorch returns
before the card has finished, so a stage timed on a CUDA device is
fenced on both edges: pending work is synchronised before the clock
starts, and a CUDA event recorded at the end is waited on before it
stops.  ``trace`` captures a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
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
    """Accumulates per-stage wall time and item counts; reports rates."""

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    def timed(self, name: str, n_items: int = 0):
        self.items[name] = self.items.get(name, 0) + n_items
        return device_timer(name, self.times, self.device)

    def add_items(self, name: str, n: int):
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
