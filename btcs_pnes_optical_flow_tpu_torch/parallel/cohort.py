"""Cohort-scale execution on the card, one card or a mesh of them.

Port of ``btcs_pnes_optical_flow_tpu/parallel/cohort.py`` (BASELINE.json
config 4: a cohort of seizure videos, per-video metric tables).  The JAX
package shards the video axis over a mesh of chips; here one process
drives the devices of a ``Mesh`` (``parallel/mesh.py``): each device takes
a contiguous block of the videos, and the cohort reductions run on the
mesh's first device.  ``cohort_step`` runs the V×B frame pairs of a cohort
step as one batch of ``roi_body_flow`` per device; ``cohort_flow_sharded``
stages a uniform cohort once and runs every chunk of every video on its
block's device, slicing clips that already lie on a card there.  A
one-device mesh is the batched path on that device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PCAParams
from btcs_pnes_optical_flow_tpu_torch.models.chunks import ChunkDriver
from btcs_pnes_optical_flow_tpu_torch.models.flow import (
    roi_body_flow,
    roi_body_flow_seq,
    skel_indices,
)
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow_batch
from btcs_pnes_optical_flow_tpu_torch.models.pipeline import FlowStageResult
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import (
    Mesh,
    as_mesh,
    cohort_sharding,
    replicated,
)
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device

# A cohort step's inputs: frames uint8, axes float32, masks and live flags
# bool; the masks are replicated, the rest split on the video axis.
_STEP_DTYPES = (torch.uint8, torch.uint8, torch.float32, torch.float32, torch.bool, torch.bool)
_MASKS = 4


class CohortStep(NamedTuple):
    vx: torch.Tensor      # (V, B, R)
    vy: torch.Tensor
    mag: torch.Tensor
    pc1: torch.Tensor     # (V, R, B+1)
    cohort_mean_mag: torch.Tensor  # (R,)


def shard_cohort_inputs(mesh, prev, curr, ex, ey, masks, t_valid):
    """Place a cohort step's inputs on the mesh's "data" devices: the video
    axis of frames (uint8), axes (float32) and live flags (bool) split into
    contiguous blocks (``cohort_sharding``), the masks (bool) copied to each
    (``replicated``); an input given as a list of one block per device is
    taken as placed.  With one device the tensors themselves, else a list of
    blocks per input."""
    mesh = as_mesh(mesh)
    data = Mesh(mesh.axis_devices("data"))

    def place(k, x, dtype):
        if isinstance(x, (list, tuple)) and len(x) == len(data):
            return [torch.as_tensor(b, dtype=dtype).to(d) for b, d in zip(x, data)]
        x = torch.as_tensor(x, dtype=dtype)
        return replicated(data, x) if k == _MASKS else cohort_sharding(mesh, x)

    placed = tuple(place(k, x, dt) for k, (x, dt) in enumerate(
        zip((prev, curr, ex, ey, masks, t_valid), _STEP_DTYPES)))
    return tuple(p[0] for p in placed) if len(data) == 1 else placed


def _step_local(prev, curr, ex, ey, masks, t_valid, flow_params, pca_params):
    """(vx, vy, mag, pc1) of one device's videos, where they lie."""
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
    return vx, vy, mag, pc1


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
    device=None,
    mesh=None,
) -> CohortStep:
    """One cohort step: flow features and dynamic PC1 per video, and the
    cohort mean of the magnitude per ROI (NaN-ignoring).

    On ``device``, or over ``mesh``: each "data" device computes its block
    of videos where it lies (every block is enqueued before any is read
    back), and the results and the cohort mean are gathered on the mesh's
    first device.  Inputs may be host arrays, tensors, or the blocks
    ``shard_cohort_inputs`` gives.
    """
    if (device is None) == (mesh is None):
        raise ValueError("cohort_step takes a device or a mesh")
    mesh = Mesh([resolve_device(device)]) if mesh is None else as_mesh(mesh)
    placed = shard_cohort_inputs(mesh, prev, curr, ex, ey, masks, t_valid)
    if isinstance(placed[0], torch.Tensor):
        parts = [_step_local(*placed, flow_params, pca_params)]
    else:
        parts = [_step_local(*block, flow_params, pca_params) for block in zip(*placed)]
    home = mesh[0]
    vx, vy, mag, pc1 = (torch.cat([p[j].to(home) for p in parts]) for j in range(4))
    return CohortStep(vx=vx, vy=vy, mag=mag, pc1=pc1,
                      cohort_mean_mag=torch.nanmean(mag, dim=(0, 1)))


def cohort_flow_sharded(items, flows, config, chunk_pairs: int, mesh, timer=None):
    """Stage A of ``run_cohort`` with the video axis split over ``mesh``.

    Eligible when every item is a 3-D uint8 clip, all NumPy arrays or all
    tensors, of one shape and with the same number of ROIs (the JAX
    package's rule for its sharded path).  The videos go in contiguous
    blocks to the mesh's "data" devices; per chunk, every device's videos
    are enqueued before the oldest chunk is read back.  Fills ``flows[i]``
    for the items it runs and returns a per-item flag; the caller runs the
    rest per video.  Runs ``config.flow`` as given, without ROI dispatch,
    as the JAX package does; its ROI features equal the dispatched ones.
    Per-video semantics (NaN frame 0, invalid axes masked, one chunk shape
    with the tail padded) are ``run_flow_stage``'s, through the same
    ``models/chunks.py ChunkDriver``, and each video's features do not
    depend on the mesh.  A ``timer`` collects the driver's spans, once per
    video per chunk.
    """
    devs = as_mesh(mesh).axis_devices("data")
    n = len(items)
    done = [False] * n
    vids = [it.video for it in items]
    tensors = all(isinstance(v, torch.Tensor) and v.ndim == 3 for v in vids)
    if not tensors and not all(isinstance(v, np.ndarray) and v.ndim == 3 for v in vids):
        return done
    if len({tuple(v.shape) for v in vids}) != 1:
        return done
    if len({len(it.roi_polygons) for it in items}) != 1:
        return done
    t_frames, h, w = vids[0].shape
    n_pairs_total = t_frames - 1
    if n_pairs_total <= 0:
        return done

    blocks = [blk.tolist() for blk in np.array_split(np.arange(n), len(devs))]
    dev_of = {i: devs[d] for d, blk in enumerate(blocks) for i in blk}
    # One video of each device in turn, so every device has work queued.
    order = [blk[j] for j in range(max(map(len, blocks))) for blk in blocks if j < len(blk)]
    masks = [torch.as_tensor(np.stack([fill_poly_mask(h, w, p) for p in it.roi_polygons]),
                             device=dev_of[i]) for i, it in enumerate(items)]
    n_roi = masks[0].shape[0]
    # Per-video timestamps and axes (array clips have no container
    # timestamps: t = idx/fps, optical_flow.py:110-119); pair f - 1 takes
    # frame f's axes, and frame 0 (no pair) NaN features.
    t_sec, sk_all, axes = [], [], []
    for it in items:
        t = np.arange(t_frames, dtype=np.float64) / float(it.skeleton.fps)
        sk = skel_indices(t, it.skeleton.time_all)
        ex, ey = it.skeleton.ex[sk], it.skeleton.ey[sk]
        t_sec.append(t)
        sk_all.append(sk)
        axes.append((ex, ey, np.isfinite(ex).all(axis=1) & np.isfinite(ey).all(axis=1)))
    feats_all = [[np.full((t_frames, n_roi), np.nan) for _ in range(3)] for _ in range(n)]

    def sink(key, *feats):
        i, s = key
        for dst, vals in zip(feats_all[i], feats):
            dst[1 + s : 1 + s + len(vals)] = vals

    driver = ChunkDriver(roi_body_flow_seq, config.flow, chunk_pairs, sink,
                         lambda key: f"cohort item {items[key[0]].name} chunk @{key[1]}",
                         devices=len(devs), timer=timer)
    for s in range(0, n_pairs_total, chunk_pairs):
        b_eff = min(chunk_pairs, n_pairs_total - s)
        cur = slice(s + 1, s + 1 + b_eff)
        for i in order:
            ex, ey, ok = axes[i]
            driver.submit((i, s), vids[i][s : s + b_eff + 1], ex[cur], ey[cur], ok[cur], b_eff,
                          masks[i])
    driver.finish()

    for i in range(n):
        vx, vy, mg = feats_all[i]
        flows[i] = FlowStageResult(frame=np.arange(t_frames), t_sec=t_sec[i], skel_idx=sk_all[i],
                                   axes_ok=axes[i][2], vx=vx, vy=vy, mag=mg)
        done[i] = True
    return done
