"""What the entry modules (``entries/<entry>.py``) share: the answers a
call returns, the program's configuration built from a configuration
file, the skeleton, a recording played from memory, the entry's options,
and the lookup of the entry a traffic mix names.

An entry module defines ``Entry(cfg, traffic, pool, device)`` with:

- ``warm()``: one short call at the cell's shapes (set-up);
- ``run(i, timer=None) -> Done``: the window's i-th call, closed by a
  device synchronisation, so an answer counts as done when the card has
  finished it;
- ``bases(i)``: the bases (recordings or clips of the pool) call i answers;
- ``work()``: the ``yardstick.FlowWork`` chunks of one call;
- ``reference(base, dtype=torch.float32)``: the plain reference's
  (features, pc1, rows) of one base, in ``dtype`` for the control;
- ``reports_features``: whether its answers carry features and PC1 or
  metric rows only.

Its options are the configuration's group of the entry's name (for
example ``"run_cohort": {"chunk_pairs": 128}``) updated by the traffic
mix's ``"options"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from benchmark.lib.render import play_index

COLUMNS = ("PC1_area_0_10", "ADS_slope_0_10", "ADS_R2_0_10", "Kendall_tau_0_10",
           "Kendall_p_0_10", "Peak_n")


@dataclasses.dataclass
class Answer:
    """One recording's (or one cohort clip's) outputs."""

    base: int
    rows: list                       # per ROI: a metric row dict, or PC1Metrics until read
    feats: Optional[np.ndarray] = None   # (frames, 3, R): vx, vy, mag
    pc1: Optional[np.ndarray] = None     # (frames, R)


@dataclasses.dataclass
class Done:
    frames: int
    answers: List[Answer]


def make_entry(spec, cfg: dict, traffic: dict, pool, device):
    """The ``Entry`` of the module the traffic mix names."""
    return spec.entry(traffic["entry"]).Entry(cfg, traffic, pool, device)


def options(cfg: dict, traffic: dict, entry: str) -> dict:
    return dict(cfg.get(entry, {}), **traffic.get("options", {}))


def pipeline_config(cfg: dict):
    from btcs_pnes_optical_flow_tpu_torch.config import (
        FarnebackParams, MetricParams, PCAParams, PipelineConfig)

    flow = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.get("flow", {}).items()}
    return PipelineConfig(flow=FarnebackParams(**flow), pca=PCAParams(**cfg.get("pca", {})),
                          metrics=MetricParams(**cfg.get("metrics", {})))


def skeleton(n: int, fps: float, theta: float):
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton

    return Skeleton(time_all=np.arange(n) / fps, fps=fps,
                    ex=np.tile([math.cos(theta), -math.sin(theta)], (n, 1)),
                    ey=np.tile([math.sin(theta), math.cos(theta)], (n, 1)))


def recording_frames(cfg: dict, traffic: dict) -> int:
    return int(traffic.get("frames") or cfg["recording_frames"])


def played_source(base: np.ndarray, playback: str, n: int, fps: float):
    """A ``VideoSource`` of ``n`` frames of ``base`` played from memory."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import VideoSource

    idx = play_index(playback, len(base), n)

    class Played(VideoSource):
        def frames(self):
            for i in range(self.n_frames):
                yield base[idx[i]], None

    src = Played()
    src.fps, src.n_frames, (src.height, src.width) = fps, n, base.shape[1:]
    return src


def read_rows(answer: Answer) -> list:
    """The answer's metric rows as plain dicts of floats (reads any the
    program left on the device)."""
    out = []
    for row in answer.rows:
        if isinstance(row, dict):
            out.append({c: float(row[c]) for c in COLUMNS} | {"status": int(row["status"])})
        else:  # a PC1Metrics of 0-d tensors
            vals = [row.pc1_area, row.ads_slope, row.ads_r2, row.kendall_tau, row.kendall_p,
                    row.peak_n]
            out.append({c: float(v) for c, v in zip(COLUMNS, vals)}
                       | {"status": int(row.status)})
    return out
