"""The comparison that decides ``correct``.

For each checked base (recording or cohort clip) the entry module's
``reference`` answer is worked out again by the plain reference
(``benchmark/reference``; ``farneback_answer`` below for the Farnebäck
entries): from the frames the program was handed, the ROI masks, the
pyramid and the body axes, the flow features of every frame, each ROI's
PC1 waveform and its metric row.  Each answer the program gave for that
base in the window is compared:

- ``feat_gap_px``: the largest |program - reference| over vx, vy and mag
  of every frame and ROI (px/frame);
- ``pc1_gap_rel``: the largest |program - reference| of a PC1 sample over
  the largest |reference| of its waveform;
- ``metric_gap_rel``: the largest |program - reference| / max(|reference|,
  1e-3) over AUC, decay slope, R^2, Kendall tau and the peak count of every
  row; a row whose status differs, or a missing row, reads ``MISMATCH``.

A NaN where the other side has a number reads as ``MISMATCH`` (1e30).  A
number is compared where the entry's answers carry it: a cohort returns
metric rows only and compares the last number.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark.reference import farneback as rf
from benchmark.reference import pc1_metrics as rpm
from benchmark.reference.roi import fill_poly
from benchmark.lib.render import play_index

ROW_COLUMNS = ("PC1_area_0_10", "ADS_slope_0_10", "ADS_R2_0_10", "Kendall_tau_0_10", "Peak_n")
MISMATCH = 1e30
# Pixels of flow planes per reference call (bounds its memory).
REF_PIXELS = 1 << 24


def sample_bases(seed: int, bases, k: int) -> list:
    """k of the answered bases, drawn from the seed."""
    bases = sorted(set(bases))
    return sorted(random.Random(int(seed) ^ 0x5EED).sample(bases, min(k, len(bases))))


def _pairs_flow_features(frames, p, theta, masks, dtype, device):
    """(pairs, 3, R) features of the consecutive pairs of frames."""
    n = len(frames)
    h, w = frames.shape[1:]
    step = max(1, min(32, REF_PIXELS // (h * w)))
    out = []
    for s in range(0, n - 1, step):
        fr = torch.as_tensor(frames[s:s + step + 1], device=device)
        flow = rf.flow_seq(fr, p, dtype)
        out.append(rf.roi_features(flow, theta, masks))
    return np.concatenate(out)


def farneback_answer(base_clip, cfg, traffic, n_frames, device, dtype=torch.float32):
    """(features (n, 3, R), pc1 (n, R), rows) of one recording or clip of
    ``n_frames`` frames of ``base_clip`` played as the mix says, through the
    reference's Farnebäck flow, PC1 and metric heads, in ``dtype``."""
    p = rf.Params(**cfg.get("flow", {}))
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
        feats = _round(feats, dtype)
    t = np.arange(n_frames) / float(cfg["fps"])
    pc1 = np.stack([rpm.pc1_from_features(feats[:, 0, r], feats[:, 1, r], cfg.get("pca", {}))
                    for r in range(len(masks))], 1)
    if dtype != torch.float32:
        pc1 = _round(pc1, dtype)
    rows = [rpm.metric_row(t, pc1[:, r], cfg.get("metrics", {}))
            | {"status": _status(t, pc1[:, r], cfg)} for r in range(len(masks))]
    return feats, pc1, rows


def _round(a, dtype):
    return torch.as_tensor(a).to(dtype).double().numpy()


def _status(t, pc1, cfg):
    mp = dict(rpm.METRIC_DEFAULTS, **cfg.get("metrics", {}))
    ok = np.isfinite(t) & np.isfinite(pc1)
    if ok.sum() < mp["min_valid_samples"]:
        return 1
    tt = t[ok] - t[ok][0]
    return 2 if ((tt >= 0) & (tt <= mp["window_sec"])).sum() < mp["min_valid_samples"] else 0


def _gap(a, b):
    """Largest |a - b|; MISMATCH where one side is NaN and the other not."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if (np.isnan(a) != np.isnan(b)).any():
        return MISMATCH
    m = ~np.isnan(b)
    return float(np.abs(a[m] - b[m]).max()) if m.any() else 0.0


def compare(answers, refs) -> dict:
    """The numbers of ``answers`` (program answers with their bases)
    against ``refs`` {base: (feats, pc1, rows)}."""
    nums = {"metric_gap_rel": 0.0}
    for ans in answers:
        feats, pc1, rows = refs[ans.base]
        if ans.feats is not None:
            nums["feat_gap_px"] = max(nums.get("feat_gap_px", 0.0), _gap(ans.feats, feats))
        if ans.pc1 is not None:
            for r in range(pc1.shape[1]):
                scale = np.nanmax(np.abs(pc1[:, r])) if np.isfinite(pc1[:, r]).any() else 1.0
                nums["pc1_gap_rel"] = max(nums.get("pc1_gap_rel", 0.0),
                                          _gap(ans.pc1[:, r], pc1[:, r]) / scale)
        gaps = [MISMATCH] * (len(ans.rows) != len(rows))
        for got, want in zip(ans.rows, rows):
            if int(got["status"]) != want["status"]:
                gaps.append(MISMATCH)
            for c in ROW_COLUMNS:
                g = _gap(got[c], want[c])
                gaps.append(g / max(abs(want[c]), 1e-3) if 0 < g < MISMATCH else g)
        nums["metric_gap_rel"] = max([nums["metric_gap_rel"]] + gaps)
    return nums


def verdict(nums: dict, limits: dict):
    """(correct, lines): every limit of the cell with its number."""
    lines, ok = [], True
    for name, lim in limits.items():
        v = nums.get(name)
        v = None if v is None else (int(v) if isinstance(v, int) else float(v))
        good = v is not None and v <= lim
        ok &= good
        lines.append((name, v, lim, good))
    return bool(ok), lines
