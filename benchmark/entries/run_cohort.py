"""``run_cohort``: the pool as one cohort, a clip per item, through
``parallel.runner.run_cohort``; every call runs the whole cohort.

Options (``lib/calls.py``): ``chunk_pairs``; ``mesh_devices`` (the flow
stage over ``make_mesh(n)``, on the CPU a mesh of n shards of the device;
0 runs each video alone, without a mesh); any other key, such as
``flow_workers``, is passed to ``run_cohort`` as it stands.  The cohort
returns metric rows only.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import calls, yardstick
from benchmark.lib.check import farneback_answer


class Entry:
    reports_features = False

    def __init__(self, cfg, traffic, pool, device):
        from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem

        self.cfg, self.traffic, self.pool, self.device = cfg, traffic, pool, device
        self.config = calls.pipeline_config(cfg)
        rois = [np.asarray(p, np.float64) for p in traffic["rois"]]
        skel = calls.skeleton(len(pool[0]), float(cfg["fps"]), traffic["theta"])
        self.items = [CohortItem(f"clip{j}", clip, skel, rois) for j, clip in enumerate(pool)]
        opts = calls.options(cfg, traffic, "run_cohort")
        self.chunk = int(opts.pop("chunk_pairs"))
        self.mesh_devices = int(opts.pop("mesh_devices", 1))
        self.kwargs = opts

    def _mesh(self):
        from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh, make_mesh

        if not self.mesh_devices:
            return None
        if self.device.type == "cuda":
            return make_mesh(self.mesh_devices)
        return Mesh([self.device] * self.mesh_devices)

    def _call(self, items, timer=None):
        from btcs_pnes_optical_flow_tpu_torch.parallel.runner import run_cohort

        mesh = self._mesh()
        rows = run_cohort(items, self.config, self.chunk, mesh=mesh,
                          device=mesh[0] if mesh else self.device, timer=timer, **self.kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        by_clip: dict = {}
        for row in rows:
            by_clip.setdefault(int(row["video"][4:]), []).append(row)
        frames = sum(len(it.video) for it in items)
        return calls.Done(frames, [calls.Answer(j, r) for j, r in sorted(by_clip.items())])

    def warm(self):
        self._call(self.items[:2])

    def bases(self, i: int) -> list:
        return list(range(len(self.items)))

    def run(self, i: int, timer=None):
        return self._call(self.items, timer)

    def work(self):
        one = yardstick.recording_work(self.cfg.get("flow", {}), self.cfg["height"],
                                       self.cfg["width"], self.traffic["rois"],
                                       len(self.pool[0]), self.chunk)
        return one * len(self.items)

    def reference(self, base: int, dtype=torch.float32):
        return farneback_answer(self.pool[base], self.cfg, self.traffic, len(self.pool[base]),
                                self.device, dtype)
