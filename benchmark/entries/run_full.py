"""``run_full``: recordings of the pool played one after another through
``models.pipeline.run_full``.

Options (``lib/calls.py``): ``chunk_pairs``; ``checkpoint`` (a chunk store
in ``TMPDIR`` per recording, removed after it); any other key is passed to
``run_full`` as it stands.  Call i plays base i mod pool size for the
mix's (or the configuration's) recording length.
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from benchmark.lib import calls, yardstick
from benchmark.lib.check import farneback_answer


class Entry:
    reports_features = True

    def __init__(self, cfg, traffic, pool, device):
        self.cfg, self.traffic, self.pool, self.device = cfg, traffic, pool, device
        self.config = calls.pipeline_config(cfg)
        self.rois = [np.asarray(p, np.float64) for p in traffic["rois"]]
        self.n = calls.recording_frames(cfg, traffic)
        self.fps = float(cfg["fps"])
        self.skel = calls.skeleton(self.n, self.fps, traffic["theta"])
        opts = calls.options(cfg, traffic, "run_full")
        self.chunk = int(opts.pop("chunk_pairs"))
        self.checkpoint = bool(opts.pop("checkpoint", False))
        self.kwargs = opts

    def _call(self, base: int, n: int, timer=None):
        from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full

        ck = tempfile.mkdtemp(prefix="ckpt") if self.checkpoint else None
        try:
            flow, pc1, mets = run_full(
                calls.played_source(self.pool[base], self.traffic["playback"], n, self.fps),
                self.skel, self.rois, self.config, self.chunk, checkpoint_dir=ck,
                device=self.device, timer=timer, **self.kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            if ck:
                shutil.rmtree(ck, ignore_errors=True)
        return calls.Done(n, [calls.Answer(base, list(mets),
                                           np.stack([flow.vx, flow.vy, flow.mag], 1), pc1)])

    def warm(self):
        """One recording of the cell's chunk shape and metric window: two
        chunks and a tail, and at least 12 s."""
        n = min(self.n, max(2 * self.chunk + 2, int(12 * self.fps) + 1))
        if self.traffic["playback"] == "straight":
            n = self.n
        self._call(0, n)

    def bases(self, i: int) -> list:
        return [i % len(self.pool)]

    def run(self, i: int, timer=None):
        return self._call(self.bases(i)[0], self.n, timer)

    def work(self):
        return yardstick.recording_work(self.cfg.get("flow", {}), self.cfg["height"],
                                        self.cfg["width"], self.traffic["rois"], self.n,
                                        self.chunk)

    def reference(self, base: int, dtype=torch.float32):
        return farneback_answer(self.pool[base], self.cfg, self.traffic, self.n, self.device,
                                dtype)
