"""One ``torch.profiler`` window, reduced to what the per-layer readers need.

The profiler records CPU operators and CUDA activity; the raw events are
read once (no chrome trace is written: a window of the PC1 head's
sequential filter holds hundreds of thousands of launches).  From them:

- the traced window, the span of the ``bench.traced`` range around the
  calls;
- ``busy_s``: the union of the device's kernel, copy and memset intervals
  inside the window;
- device time by operation name (``device_ops``) and by name pattern
  (``kernel_seconds``);
- the device's idle gaps, each labelled by the innermost host operation
  of the calling thread that was running at the gap's midpoint, summed by
  label (``idle_by_host``).
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict

import numpy as np

RANGE = "bench.traced"
NO_OP = "host between operators"


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


def _kind(e):
    f = getattr(e, "activity_type", None)
    return str(f()) if f is not None else ""


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block; fills ``out["trace"]`` with a ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(RANGE):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out["trace"] = Trace.from_events(prof.profiler.kineto_results.events())


class Trace:
    def __init__(self, lo, hi, dev, host):
        self.lo, self.hi = lo, hi          # ns
        self.dev = dev                     # list of (start, end, name), device
        self.host = host                   # list of (start, end, name), calling thread

    @classmethod
    def from_events(cls, events):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu, lo = [], [], None
        for e in events:
            name = e.name()
            s = _ns(e, "start")
            d = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            if e.device_type() == cuda:
                # The range's own mirror on the device's timeline is no work.
                if name != RANGE and "annotation" not in _kind(e):
                    dev.append((s, s + d, name))
            else:
                tid = e.start_thread_id()
                if name == RANGE:
                    lo, hi, host_tid = s, s + d, tid
                cpu.append((s, s + d, name, tid))
        if lo is None:
            raise RuntimeError("the profiler recorded no traced range")
        host = [(s, e, n) for s, e, n, t in cpu if t == host_tid and n != RANGE]
        return cls(lo, hi, dev, host)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def _busy_intervals(self):
        iv = sorted((max(s, self.lo), min(e, self.hi)) for s, e, _ in self.dev
                    if e > self.lo and s < self.hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: str):
        """(seconds, launches) of the device operations whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, n in self.dev if rx.search(n) and self.lo <= s < self.hi]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self, top=10):
        by = defaultdict(float)
        for s, e, n in self.dev:
            if self.lo <= s < self.hi:
                by[n[:160]] += (e - s) / 1e9
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]

    def idle_by_host(self, top=10):
        """Idle device seconds summed by the host operation in progress."""
        busy = self._busy_intervals()
        edges = [self.lo] + [x for iv in busy for x in iv] + [self.hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        if not gaps:
            return []
        mids = np.array([(a + b) // 2 for a, b in gaps])
        order = np.argsort(mids)
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        labels = [NO_OP] * len(gaps)
        stack, k = [], 0
        for gi in order:
            m = mids[gi]
            while k < len(host) and host[k][0] <= m:
                while stack and stack[-1][1] <= host[k][0]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] <= m:
                stack.pop()
            if stack:
                labels[gi] = stack[-1][2]
        by = defaultdict(float)
        for (a, b), lab in zip(gaps, labels):
            by[lab[:160]] += (b - a) / 1e9
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]
