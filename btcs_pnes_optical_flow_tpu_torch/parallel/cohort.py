"""Cohort-scale execution on the card.

Port of ``btcs_pnes_optical_flow_tpu/parallel/cohort.py`` (BASELINE.json
config 4: a cohort of seizure videos, per-video metric tables).  The JAX
package shards the video axis over a mesh of chips; on one CUDA card the
cohort's videos are batched: ``cohort_step`` runs the V×B frame pairs of a
cohort step as one batch of ``roi_body_flow``, and ``cohort_flow_batched``
stages a uniform cohort once and runs every chunk of every video on the
card, slicing clips that already lie there on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PCAParams
from btcs_pnes_optical_flow_tpu_torch.models.flow import (
    roi_body_flow,
    roi_body_flow_seq,
    skel_indices,
)
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow_batch
from btcs_pnes_optical_flow_tpu_torch.models.pipeline import FlowStageResult
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device

# Chunks in flight before the oldest is read back (as models/pipeline.py).
_PIPELINE_DEPTH = 2


class CohortStep(NamedTuple):
    vx: torch.Tensor      # (V, B, R)
    vy: torch.Tensor
    mag: torch.Tensor
    pc1: torch.Tensor     # (V, R, B+1)
    cohort_mean_mag: torch.Tensor  # (R,)


def shard_cohort_inputs(mesh, prev, curr, ex, ey, masks, t_valid):
    """Place a cohort step's inputs on the mesh's one device: frames
    uint8, axes float32, masks and live flags bool."""
    (dev,) = mesh
    dtypes = (torch.uint8, torch.uint8, torch.float32, torch.float32, torch.bool, torch.bool)
    return tuple(torch.as_tensor(x, dtype=dt, device=dev)
                 for x, dt in zip((prev, curr, ex, ey, masks, t_valid), dtypes))


def cohort_step(
    prev,      # (V, B, H, W) frame-pair batches per video
    curr,
    ex,        # (V, B, 2)
    ey,
    masks,     # (R, H, W)
    t_valid,   # (V, B) bool — which pairs are live
    flow_params: FarnebackParams = FarnebackParams(),
    pca_params: PCAParams = PCAParams(),
    *,
    device,
) -> CohortStep:
    """One cohort step on ``device``: flow features and dynamic PC1 per
    video, and the cohort mean of the magnitude per ROI (NaN-ignoring)."""
    prev, curr, ex, ey, masks, t_valid = shard_cohort_inputs(
        (resolve_device(device),), prev, curr, ex, ey, masks, t_valid)
    v, b = prev.shape[:2]
    feats = roi_body_flow(prev.flatten(0, 1), curr.flatten(0, 1), ex.flatten(0, 1),
                          ey.flatten(0, 1), masks, flow_params)
    r = feats.vx.shape[1]
    live = t_valid[..., None]
    nan = torch.full((), float("nan"), dtype=feats.vx.dtype, device=prev.device)
    vx, vy, mag = (torch.where(live, f.reshape(v, b, r), nan) for f in feats)
    # Frame 0 has no pair (reference semantics): a NaN sample first.
    nan1 = nan.expand(v, 1, r)
    vx_t, vy_t = (torch.cat([nan1, f], dim=1).transpose(1, 2).reshape(v * r, b + 1)
                  for f in (vx, vy))
    pc1 = pc1_from_flow_batch(vx_t, vy_t, pca_params).reshape(v, r, b + 1)
    return CohortStep(vx=vx, vy=vy, mag=mag, pc1=pc1,
                      cohort_mean_mag=torch.nanmean(mag, dim=(0, 1)))


def cohort_flow_batched(items, flows, config, chunk_pairs: int, *, device):
    """Stage A of ``run_cohort`` with the cohort batched on ``device``.

    Eligible when every item is a 3-D uint8 clip, all NumPy arrays or all
    tensors on ``device``, of one shape and with the same number of ROIs
    (the JAX package's rule for its sharded path).  Fills ``flows[i]`` for
    the items it runs and returns a per-item flag; the caller runs the
    rest per video.  Runs ``config.flow`` as given, without ROI dispatch,
    as the JAX package does; its ROI features equal the dispatched ones.
    Per-video semantics (NaN frame 0, invalid axes masked, one chunk shape
    with the tail padded) are ``run_flow_stage``'s; a non-zero clip count
    raises, as there.
    """
    device = resolve_device(device)
    n = len(items)
    done = [False] * n
    vids = [it.video for it in items]
    on_device = all(isinstance(v, torch.Tensor) and v.ndim == 3 and v.device == device
                    for v in vids)
    if not on_device and not all(isinstance(v, np.ndarray) and v.ndim == 3 for v in vids):
        return done
    if len({tuple(v.shape) for v in vids}) != 1:
        return done
    if len({len(it.roi_polygons) for it in items}) != 1:
        return done
    t_frames, h, w = vids[0].shape
    n_pairs_total = t_frames - 1
    if n_pairs_total <= 0:
        return done

    masks = [torch.as_tensor(np.stack([fill_poly_mask(h, w, p) for p in it.roi_polygons]),
                             device=device) for it in items]
    n_roi = masks[0].shape[0]
    # Per-video timestamps and axes (array clips have no container
    # timestamps: t = idx/fps, optical_flow.py:110-119).
    t_sec, sk_all, ex_p, ey_p, ok_p = [], [], [], [], []
    for it in items:
        t = np.arange(t_frames, dtype=np.float64) / float(it.skeleton.fps)
        sk = skel_indices(t, it.skeleton.time_all)
        ex = it.skeleton.ex[sk][1:]
        ey = it.skeleton.ey[sk][1:]
        ok = np.isfinite(ex).all(axis=1) & np.isfinite(ey).all(axis=1)
        t_sec.append(t)
        sk_all.append(sk)
        ex_p.append(np.where(ok[:, None], ex, 0.0).astype(np.float32))
        ey_p.append(np.where(ok[:, None], ey, 0.0).astype(np.float32))
        ok_p.append(ok)

    feats_all = [[np.empty((n_pairs_total, n_roi)) for _ in range(3)] for _ in range(n)]
    pending = []

    def resolve(entry):
        i, s, b_eff, feats, clips = entry
        n_clipped = int(torch.count_nonzero(clips[:b_eff]))
        if n_clipped:
            raise RuntimeError(f"cohort item {items[i].name} chunk @{s}: {n_clipped} pairs "
                               "clipped; the direct-sample warp never clips, so this is a fault")
        inv = ~ok_p[i][s : s + b_eff]
        for dst, f in zip(feats_all[i], feats):
            vals = f[:b_eff].cpu().numpy()
            vals[inv] = np.nan
            dst[s : s + b_eff] = vals

    for s in range(0, n_pairs_total, chunk_pairs):
        b_eff = min(chunk_pairs, n_pairs_total - s)
        for i in range(n):
            if on_device:
                fr = vids[i][s : s + chunk_pairs + 1].to(torch.uint8)
            else:
                fr = torch.as_tensor(np.asarray(vids[i][s : s + chunk_pairs + 1], np.uint8),
                                     device=device)
            if b_eff < chunk_pairs:  # one chunk shape: repeat the last frame
                fr = torch.cat([fr, fr[-1:].expand(chunk_pairs - b_eff, h, w)])
            ex_c = np.zeros((chunk_pairs, 2), np.float32)
            ey_c = np.zeros_like(ex_c)
            ex_c[:b_eff] = ex_p[i][s : s + b_eff]
            ey_c[:b_eff] = ey_p[i][s : s + b_eff]
            feats, clips = roi_body_flow_seq(
                fr, torch.as_tensor(ex_c, device=device), torch.as_tensor(ey_c, device=device),
                masks[i], config.flow)
            pending.append((i, s, b_eff, feats, clips))
            while len(pending) > _PIPELINE_DEPTH:
                resolve(pending.pop(0))
    for entry in pending:
        resolve(entry)

    nanrow = np.full((1, n_roi), np.nan)
    for i, it in enumerate(items):
        axes_ok = np.concatenate([[False], ok_p[i]])
        # Frame 0's axes validity follows its own skeleton row (it has no
        # pair, so its features are NaN regardless).
        sk0 = sk_all[i][0]
        axes_ok[0] = bool(np.isfinite(it.skeleton.ex[sk0]).all()
                          and np.isfinite(it.skeleton.ey[sk0]).all())
        vx, vy, mg = (np.concatenate([nanrow, f]) for f in feats_all[i])
        flows[i] = FlowStageResult(frame=np.arange(t_frames), t_sec=t_sec[i], skel_idx=sk_all[i],
                                   axes_ok=axes_ok, vx=vx, vy=vy, mag=mg)
        done[i] = True
    return done
