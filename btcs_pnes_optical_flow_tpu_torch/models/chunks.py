"""The flow stage's chunk driver: the one chunk loop of ``run_flow_stage``
(models/pipeline.py) and ``cohort_flow_sharded`` (parallel/cohort.py)."""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.utils import timing
from btcs_pnes_optical_flow_tpu_torch.utils.device import pinned_empty, stages_pinned

_PIPELINE_DEPTH = 2


class ChunkDriver:
    """Puts a chunk's frames and axes on its ROI masks' device, pads a short
    chunk there to the one chunk shape, enqueues ``flow(frames, ex, ey,
    masks, params)`` (the caller's own ``roi_body_flow_seq``, so a test that
    patches the caller's name reaches it), and keeps ``_PIPELINE_DEPTH``
    chunks in flight per device (``devices``, submitted to in turn): the
    device computes a chunk while the host prepares the next.  The oldest
    is then read back and handed to ``sink(key, vx, vy, mag)`` as (n_pairs,
    R) host arrays, in submission order.  The port's warp never clips: a
    clip count raises RuntimeError, naming the chunk ``label(key)``.  A
    ``timer`` gets the spans "flow.copy" (frames, axes, a tail's padding),
    "flow.launch" and "flow.readback" (clip count, reads, NaN mask).

    A page-locked host tensor (``utils/device.py pinned_empty``: the
    frames ``run_flow_stage``'s prefetcher stacks for a card, the axes this
    driver stages for one) goes to the card as a copy queued on the stream,
    without a host sync; a NumPy array or a pageable tensor goes as a
    blocking copy."""

    def __init__(self, flow, params, chunk_pairs: int, sink, label, *, devices: int = 1,
                 timer=None):
        self._flow, self._params, self._chunk = flow, params, chunk_pairs
        self._sink, self._label, self._timer = sink, label, timer
        self._depth = _PIPELINE_DEPTH * devices
        self._pending: deque = deque()

    def submit(self, key, frames, ex, ey, ok, n_pairs: int, masks: torch.Tensor):
        """Enqueue ``n_pairs`` pairs: ``frames`` (n_pairs + 1, H, W) uint8,
        host array or tensor; ``ex``, ``ey``, ``ok``: each pair's current
        frame's axes and their validity (invalid: zeros in, NaN out)."""
        ok = np.asarray(ok[:n_pairs], bool)
        axes = np.zeros((2, self._chunk, 2), np.float32)
        axes[:, :n_pairs] = np.where(ok[:, None], [ex[:n_pairs], ey[:n_pairs]], 0.0)
        if stages_pinned(masks.device):
            axes = pinned_empty(axes.shape, torch.float32).copy_(torch.from_numpy(axes))
        self._push((key, n_pairs, ok, self._launch(frames, axes, masks)))

    def ready(self, key, vx, vy, mag):
        """Queue a chunk already on the host (resumed), for its turn."""
        self._push((key, None, None, (vx, vy, mag)))

    def finish(self):
        while self._pending:
            self._resolve(self._pending.popleft())

    def _launch(self, frames, axes, masks):
        dev = masks.device  # the inputs are dropped on return, for the next copy
        with timing.span(self._timer, "flow.copy"):
            fr = _to(frames, dev, torch.uint8)  # a slice on ``dev`` stays a view
            if len(fr) <= self._chunk:  # one chunk shape: repeat the last frame
                fr = torch.cat([fr, fr[-1:].expand(self._chunk + 1 - len(fr), *fr.shape[1:])])
            ex, ey = _to(axes, dev, torch.float32)
        with timing.span(self._timer, "flow.launch"):
            return self._flow(fr, ex, ey, masks, self._params)

    def _push(self, entry):
        self._pending.append(entry)
        while len(self._pending) > self._depth:
            self._resolve(self._pending.popleft())

    def _resolve(self, entry):
        key, n_pairs, ok, out = entry
        if ok is not None:  # computed, not resumed
            feats, clips = out
            with timing.span(self._timer, "flow.readback"):
                n_clipped = int(torch.count_nonzero(clips[:n_pairs]))
                if n_clipped:
                    raise RuntimeError(f"{self._label(key)}: {n_clipped} pairs clipped; the "
                                       "direct-sample warp never clips, so this is a fault")
                out = [f[:n_pairs].cpu().numpy() for f in feats]
                for v in out:
                    v[~ok] = np.nan
        self._sink(key, *out)


def _to(a, dev, dtype):
    """``a`` as ``dtype`` on ``dev``: from a page-locked host tensor by a copy
    queued on the stream, with no host sync."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype, non_blocking=a.is_pinned())
    return torch.as_tensor(a, dtype=dtype, device=dev)
