"""``run_full`` with TV-L1 flow: recordings of the pool played one after
another through ``models.pipeline.run_full`` under
``PipelineConfig(flow=TVL1Params(**cfg["tvl1"]))``.

The loop, warm-up, options and answers are ``entries/run_full.py``'s; this
module changes the pipeline's flow settings, the work count (TV-L1's
warps and chains per chunk, ``TVL1Work``) and the reference answer
(``tvl1_answer``: ``reference/tvl1.py``, then ``reference/pc1_metrics.py``).
"""

import dataclasses
import pathlib
from typing import List, Tuple

import numpy as np
import torch

from benchmark.lib import check, yardstick
from benchmark.lib.render import play_index
from benchmark.lib.spec import load_module
from benchmark.reference import pc1_metrics as rpm
from benchmark.reference import tvl1 as rt
from benchmark.reference.farneback import roi_features
from benchmark.reference.roi import fill_poly

_base = load_module(pathlib.Path(__file__).with_name("run_full.py"))
# Pixels of flow planes per reference call (bounds its memory).
REF_PIXELS = 1 << 25


@dataclasses.dataclass
class TVL1Work:
    """The TV-L1 work of one chunk of ``pairs`` real pairs (a dataclass of
    a module loaded from its file: no postponed annotations): per level
    (finest first) its size and whether it runs the fixed-length chain
    (K6 on the card) or the epsilon loop; ``n_warps`` K5 launches a level
    and, on a fixed-length level, one chain of ``n_iterations`` a warp."""

    pairs: int
    levels: List[Tuple[int, int, bool]]
    n_warps: int
    n_iterations: int


class Entry(_base.Entry):
    def __init__(self, cfg, traffic, pool, device):
        from btcs_pnes_optical_flow_tpu_torch.config import MetricParams, PCAParams, PipelineConfig
        from btcs_pnes_optical_flow_tpu_torch.ops.tvl1 import TVL1Params

        super().__init__(cfg, traffic, pool, device)
        self.config = PipelineConfig(flow=TVL1Params(**cfg.get("tvl1", {})),
                                     pca=PCAParams(**cfg.get("pca", {})),
                                     metrics=MetricParams(**cfg.get("metrics", {})))

    def work(self):
        p = rt.Params.of(self.cfg.get("tvl1", {}))
        levels = [(h, w, rt.fixed_length(h, w, p, self.device))
                  for h, w in rt.pyramid_sizes(self.cfg["height"], self.cfg["width"], p)]
        return [TVL1Work(b, levels, p.n_warps, p.n_iterations)
                for b in yardstick.chunks_of(self.n - 1, self.chunk)]

    def reference(self, base: int, dtype=torch.float32):
        return tvl1_answer(self.pool[base], self.cfg, self.traffic, self.n, self.device, dtype)


def _pairs_flow_features(frames, p, theta, masks, dtype, device):
    """(pairs, 3, R) features of the consecutive pairs of frames."""
    n = len(frames)
    h, w = frames.shape[1:]
    step = max(1, min(32, REF_PIXELS // (h * w)))
    out = []
    for s in range(0, n - 1, step):
        fr = torch.as_tensor(frames[s:s + step + 1], device=device)
        out.append(roi_features(rt.flow_pairs(fr[:-1], fr[1:], p, dtype), theta, masks))
    return np.concatenate(out)


def tvl1_answer(base_clip, cfg, traffic, n_frames, device, dtype=torch.float32):
    """(features (n, 3, R), pc1 (n, R), rows) of one recording of
    ``n_frames`` frames of ``base_clip`` played as the mix says, through
    the reference's TV-L1 flow, PC1 and metric heads, in ``dtype``:
    ``check.farneback_answer`` with TV-L1 in Farnebäck's place.  Each
    distinct pair, forward and backward, is computed once."""
    p = rt.Params.of(cfg.get("tvl1", {}))
    h, w = base_clip.shape[1:]
    theta = traffic["theta"]
    masks = [fill_poly(h, w, r) for r in traffic["rois"]]
    idx = play_index(traffic["playback"], len(base_clip), n_frames)
    fwd = _pairs_flow_features(base_clip, p, theta, masks, dtype, device)
    step = idx[1:] - idx[:-1]
    feats = np.full((n_frames, 3, len(masks)), np.nan)
    feats[1:][step == 1] = fwd[idx[:-1][step == 1]]
    if (step == -1).any():
        # Pair (j, j - 1) is pair n_base - 1 - j of the reversed clip.
        bwd = _pairs_flow_features(base_clip[::-1].copy(), p, theta, masks, dtype, device)
        feats[1:][step == -1] = bwd[len(base_clip) - 1 - idx[:-1][step == -1]]
    if dtype != torch.float32:  # the control keeps its features in its precision
        feats = check._round(feats, dtype)
    t = np.arange(n_frames) / float(cfg["fps"])
    pc1 = np.stack([rpm.pc1_from_features(feats[:, 0, r], feats[:, 1, r], cfg.get("pca", {}))
                    for r in range(len(masks))], 1)
    if dtype != torch.float32:
        pc1 = check._round(pc1, dtype)
    rows = [rpm.metric_row(t, pc1[:, r], cfg.get("metrics", {}))
            | {"status": check._status(t, pc1[:, r], cfg)} for r in range(len(masks))]
    return feats, pc1, rows
