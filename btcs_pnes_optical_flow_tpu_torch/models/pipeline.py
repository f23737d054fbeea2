"""End-to-end pipeline: video → flow features → PC1 → metrics.

Port of ``btcs_pnes_optical_flow_tpu/models/pipeline.py``: chunked decode
on a prefetch thread → ROI-dispatched Farnebäck flow + ROI reduction on
the device → band-pass + sliding-window PCA → metric head.  Every entry
point takes the ``device`` it runs on; none picks one.  With
``PipelineConfig(flow=TVL1Params())`` the flow stage runs TV-L1 over whole
frames instead (``models/flow.py``; BASELINE config 5), with no ROI
dispatch; the JAX package's pipeline runs Farnebäck alone.

The port's warp samples directly and never clips, so ``run_flow_stage``
raises if a clip count is ever non-zero; the per-chunk log line keeps its
escalation counters, which stay 0.  ``escalate_clipped_pairs`` keeps the
JAX package's escalation ladder callable for clip counts that come from
elsewhere (the JAX banded warp's), recomputing the listed pairs.  CSVs are
written by the port's pandas-free ``dataio/contracts.py`` writers, byte
for byte what the JAX package's pandas writers give.

With a checkpoint directory, a stored chunk is loaded only when it holds
the pairs this run has at its position: a chunk stored by a run over a
recording that ended inside it (a short tail chunk) is recomputed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.dataio.checkpoint import ChunkStore
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import (
    ChunkPrefetcher,
    VideoSource,
    open_source,
)
from btcs_pnes_optical_flow_tpu_torch.models import metrics as metrics_model
from btcs_pnes_optical_flow_tpu_torch.models import pc1 as pc1_model
from btcs_pnes_optical_flow_tpu_torch.models.chunks import ChunkDriver
from btcs_pnes_optical_flow_tpu_torch.models.flow import (
    roi_body_flow,
    roi_body_flow_seq,
    skel_indices,
)
from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
from btcs_pnes_optical_flow_tpu_torch.ops.farneback import roi_dispatch_params
from btcs_pnes_optical_flow_tpu_torch.ops.tvl1 import TVL1Params
from btcs_pnes_optical_flow_tpu_torch.utils import timing
from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer, logger


def escalate_clipped_pairs(
    vx: np.ndarray,
    vy: np.ndarray,
    mg: np.ndarray,
    clips,
    frames: np.ndarray,
    ex_s: np.ndarray,
    ey_s: np.ndarray,
    masks_dev: torch.Tensor,
    config: PipelineConfig,
    n_pairs: int,
    first: int = 0,
) -> tuple:
    """The JAX package's ladder for pairs whose banded warp clipped
    (``models/pipeline.py:43``): the pairs with ``clips[:n_pairs] > 0`` are
    recomputed from ``frames`` (the chunk's frames, pair i from frames i and
    i+1) and their axes through the port's flow, which computes what the
    JAX exact engine computes, on ``masks_dev``'s device; vx/vy/mg are fixed
    in place.  There is no deep-window tier, so every listed pair goes the
    exact way.  Returns (n_clipped, n_exact), (0, 0) when none is listed.
    The ladder is Farnebäck's: ``config.flow`` a ``TVL1Params`` raises
    ValueError (TV-L1's warp never clips, so it has no pair to escalate).
    """
    if isinstance(config.flow, TVL1Params):
        raise ValueError("escalate_clipped_pairs recomputes Farnebäck pairs whose banded warp "
                         "clipped; TV-L1 (TVL1Params) never clips and has no escalation ladder")
    clips = clips.cpu().numpy() if isinstance(clips, torch.Tensor) else np.asarray(clips)
    bad = np.nonzero(clips[:n_pairs] > 0)[0]
    if not bad.size:
        return 0, 0
    logger.warning("flow chunk @%d: %d/%d pairs exceeded the banded warp span; recomputing "
                   "them through the port's flow", first, bad.size, n_pairs)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=masks_dev.device)

    for s in range(0, bad.size, 8):
        sel = bad[s : s + 8]
        f = roi_body_flow(put(frames[sel], np.uint8), put(frames[sel + 1], np.uint8),
                          put(ex_s[sel], np.float32), put(ey_s[sel], np.float32), masks_dev,
                          config.flow)
        vx[sel] = f.vx.cpu().numpy()
        vy[sel] = f.vy.cpu().numpy()
        mg[sel] = f.mag.cpu().numpy()
    return int(bad.size), int(bad.size)


@dataclasses.dataclass
class FlowStageResult:
    frame: np.ndarray      # (T,)
    t_sec: np.ndarray      # (T,)
    skel_idx: np.ndarray   # (T,)
    axes_ok: np.ndarray    # (T,) bool
    vx: np.ndarray         # (T, R)
    vy: np.ndarray         # (T, R)
    mag: np.ndarray        # (T, R)

    def to_frame(self, roi: int = 0):
        """ROI ``roi``'s rows as flow.csv's pandas DataFrame (needs pandas)."""
        return contracts.flow_frame(self.frame, self.t_sec, self.skel_idx,
                                    self.axes_ok.astype(int), self.vx[:, roi],
                                    self.vy[:, roi], self.mag[:, roi])


def run_flow_stage(
    video,
    skeleton: Skeleton,
    roi_polygons: Sequence[np.ndarray],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 64,
    out_csv: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    *,
    device,
    timer: Optional[StageTimer] = None,
) -> FlowStageResult:
    """Stage A: video + body axes + ROIs → per-frame flow features.

    Behavioral clone of run_body_axis_flow_core (optical_flow.py:195-259),
    chunked and batched: frame 0 and frames with invalid axes get NaN
    features; each valid frame i uses the flow of the pair (i-1, i)
    projected on frame i's axes.  Farnebäck's flow is ROI-dispatched
    (``roi_dispatch_params``) unless ``config.flow`` carries boxes
    already: the ROI means equal the full-frame ones.  A ``TVL1Params``
    flow runs over whole frames.

    A checkpoint store holds the chunk size, ROI count, frame size and
    flow engine with its parameters (``config.flow`` as given); resuming
    it under other values raises ValueError.

    The chunks go through ``models/chunks.py ChunkDriver``: one chunk
    shape, two chunks in flight, a raise on a non-zero clip count.  On a
    card the prefetch thread stacks each chunk's frames in page-locked
    memory, so their copy to the card needs no host sync.  A
    ``timer`` collects the driver's host spans of each computed chunk,
    "flow.copy", "flow.launch" (its count is the chunks computed) and
    "flow.readback", and "flow.store" (the checkpoint write).
    "flow.decode_wait" holds each wait on the prefetch queue: once per
    chunk handed over, resumed or not, and once at the end of the stream.
    """
    device = torch.device(device)
    src = video if isinstance(video, VideoSource) else open_source(video, fps=skeleton.fps)
    h, w = src.height, src.width
    roi_masks = np.stack([fill_poly_mask(h, w, p) for p in roi_polygons])
    masks_dev = torch.as_tensor(roi_masks, device=device)
    n_roi = len(roi_polygons)
    tvl1 = isinstance(config.flow, TVL1Params)
    store = None
    if checkpoint_dir is not None:
        store = ChunkStore(
            checkpoint_dir,
            meta={"chunk_pairs": chunk_pairs, "n_roi": n_roi, "h": h, "w": w,
                  "flow_engine": "tvl1" if tvl1 else "farneback",
                  "flow": dataclasses.asdict(config.flow)},
        )
    if not tvl1 and config.flow.roi_active_px is None:
        config = dataclasses.replace(
            config, flow=roi_dispatch_params(config.flow, h, w, roi_masks))

    rows_t: List[np.ndarray] = []
    feats: List[tuple] = []  # (vx, vy, mag) per chunk
    all_pos: List[Optional[float]] = []
    n_frames = 0
    pairs_done = 0
    t_start = time.perf_counter()

    def sink(key, vx, vy, mg):
        nonlocal pairs_done
        first, t_chunk, sk, ok = key
        if ok is not None and store is not None:  # computed, not resumed
            with timing.span(timer, "flow.store"):
                store.save(first, vx=vx, vy=vy, mag=mg, t=t_chunk, skel=sk, ok=ok)
        feats.append((vx, vy, mg))
        rows_t.append(t_chunk)
        pairs_done += len(vx)
        dt = time.perf_counter() - t_start
        logger.info(
            "flow chunk @%d: %d pairs done, %.1f pairs/s cumulative, "
            "escalated %d (deep tier) / %d (exact engine)",
            first, pairs_done, pairs_done / dt if dt > 0 else 0.0, 0, 0,
        )

    driver = ChunkDriver(roi_body_flow_seq, config.flow, chunk_pairs, sink,
                         lambda key: f"flow chunk @{key[0]}", timer=timer)
    chunks = iter(ChunkPrefetcher(src, chunk_pairs, device=masks_dev.device))
    while True:
        with timing.span(timer, "flow.decode_wait"):
            chunk = next(chunks, None)
        if chunk is None:
            break
        first, frames, pos = chunk
        all_pos.extend(pos if first == 0 else pos[1:])
        n_frames = first + len(frames)
        n_pairs = len(frames) - 1
        if n_pairs <= 0:
            continue
        # Timestamps / axes of each pair's current frame: the container
        # timestamp when positive, else frame/fps (optical_flow.py:110-119).
        idxs = first + 1 + np.arange(n_pairs)
        cur = np.array([p if p is not None else -1.0 for p in pos[1:]], dtype=np.float64)
        t_chunk = np.where(cur > 0, cur / 1000.0, idxs / float(src.fps))
        sk = skel_indices(t_chunk, skeleton.time_all)
        ex = skeleton.ex[sk]
        ey = skeleton.ey[sk]
        ok = np.isfinite(ex).all(axis=1) & np.isfinite(ey).all(axis=1)

        cached = store.load(first) if store is not None and store.has(first) else None
        if cached is not None and len(cached["vx"]) != n_pairs:
            logger.warning("flow chunk @%d: the stored chunk holds %d pairs, this run %d; "
                           "recomputing it", first, len(cached["vx"]), n_pairs)
            cached = None
        if cached is not None:
            driver.ready((first, t_chunk, sk, None), cached["vx"], cached["vy"], cached["mag"])
        else:
            driver.submit((first, t_chunk, sk, ok), frames, ex, ey, ok, n_pairs, masks_dev)
    driver.finish()

    # Frame 0's row (no pair → NaN features), optical_flow.py:236-247.
    pos_all = np.array([p if p is not None else -1.0 for p in all_pos], dtype=np.float64)
    t0 = pos_all[0] / 1000.0 if len(pos_all) and pos_all[0] > 0 else 0.0
    t_sec = np.concatenate([[t0]] + rows_t) if rows_t else np.array([t0])
    sk_all = skel_indices(t_sec, skeleton.time_all)
    axes_ok = (np.isfinite(skeleton.ex[sk_all]).all(axis=1)
               & np.isfinite(skeleton.ey[sk_all]).all(axis=1))
    nanrow = np.full((1, n_roi), np.nan)
    vx, vy, mag = (np.concatenate([nanrow] + [f[j] for f in feats]) for j in range(3))
    res = FlowStageResult(frame=np.arange(n_frames), t_sec=t_sec, skel_idx=sk_all,
                          axes_ok=axes_ok, vx=vx, vy=vy, mag=mag)
    if out_csv is not None:
        contracts.write_flow_csv(out_csv, res.frame, res.t_sec, res.skel_idx,
                                 res.axes_ok.astype(int), res.vx[:, 0], res.vy[:, 0],
                                 res.mag[:, 0])
    return res


def run_pc1_stage(
    flow: FlowStageResult,
    config: PipelineConfig = PipelineConfig(),
    out_csv: Optional[str] = None,
    engine: str = "scan",
    *,
    device,
) -> np.ndarray:
    """Stage B: flow features → pc1_dyn per ROI, (T, R) float32."""
    vx = torch.as_tensor(np.ascontiguousarray(flow.vx.T), dtype=torch.float32, device=device)
    vy = torch.as_tensor(np.ascontiguousarray(flow.vy.T), dtype=torch.float32, device=device)
    pc1 = pc1_model.pc1_from_flow_batch(vx, vy, config.pca, engine=engine).cpu().numpy().T
    if out_csv is not None:
        contracts.write_pc1_csv(out_csv, flow.t_sec, pc1[:, 0])
    return pc1


def run_metrics_stage(
    t_sec: np.ndarray,
    pc1: np.ndarray,
    config: PipelineConfig = PipelineConfig(),
    out_csv: Optional[str] = None,
    strict: bool = False,
    *,
    device,
):
    """Stage C: pc1 waveform(s) → metric rows (a list over ROIs)."""
    pc1 = pc1[:, None] if pc1.ndim == 1 else pc1
    out = [metrics_model.pc1_metrics(t_sec, pc1[:, r], config.metrics, strict=strict,
                                     device=device)
           for r in range(pc1.shape[1])]
    if out_csv is not None:
        contracts.write_summary_csv(out_csv, out[0], config.metrics.window_sec)
    return out


def run_full(
    video,
    skeleton: Skeleton,
    roi_polygons: Sequence[np.ndarray],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 64,
    flow_csv: Optional[str] = None,
    pc1_csv: Optional[str] = None,
    summary_csv: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    *,
    device,
    timer: Optional[StageTimer] = None,
):
    """video + skeleton + ROIs → (flow, pc1, metrics) on ``device``.

    ``checkpoint_dir`` is the flow stage's chunk store (``run_flow_stage``).
    A ``timer`` collects the wall time of the stages "flow" (items:
    frames), "pc1" and "metrics" (items: ROIs), fenced on a CUDA device,
    and the flow stage's spans (``run_flow_stage``).
    """
    def stage(name):
        return timer.timed(name) if timer is not None else contextlib.nullcontext()

    with stage("flow"):
        flow = run_flow_stage(video, skeleton, roi_polygons, config, chunk_pairs, flow_csv,
                              checkpoint_dir, device=device, timer=timer)
    with stage("pc1"):
        pc1 = run_pc1_stage(flow, config, pc1_csv, device=device)
    with stage("metrics"):
        mets = run_metrics_stage(flow.t_sec, pc1, config, summary_csv, device=device)
    if timer is not None:
        timer.add_items("flow", len(flow.frame))
        timer.add_items("pc1", pc1.shape[1])
        timer.add_items("metrics", len(mets))
    return flow, pc1, mets
