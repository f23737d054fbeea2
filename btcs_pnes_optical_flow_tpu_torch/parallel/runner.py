"""Cohort runner: many recordings → per-video metric tables.

Port of ``btcs_pnes_optical_flow_tpu/parallel/runner.py`` (BASELINE.json
config 4 end to end).  A cohort of videos runs through the chunked flow
pipeline with per-video error isolation (a video whose decode or analysis
fails gets NaN rows with status -1 and its error, instead of ending the
cohort), then the PC1 and metric stages run over the whole cohort, and the
result is one row per (video, ROI) with the reference's summary columns.

Stages:

- A (flow): the videos run through ``run_flow_stage`` on a thread pool of
  ``flow_workers``, so one video's decode and read-back overlap the next
  one's device work; with a ``mesh`` a uniform cohort of array clips takes
  ``cohort_flow_sharded`` (``parallel/cohort.py``: contiguous blocks of
  videos, one per device of the mesh) and the rest run per video;
- B (PC1): every (video, ROI) waveform of equal length goes through one
  batched band-pass + PCA call (grouped by exact length, never padded: a
  NaN-padded PCA window is not a shorter input);
- C (metrics): the metric head over each length group
  (``pc1_metrics_batch``).

``run_cohort`` returns the rows as dicts and writes them with the
pandas-free ``write_cohort_csv`` (the JAX runner returns a DataFrame).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.models import metrics as metrics_model
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow_batch
from btcs_pnes_optical_flow_tpu_torch.parallel.cohort import cohort_flow_sharded
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import as_mesh
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device
from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer, logger


@dataclasses.dataclass
class CohortItem:
    name: str
    video: object                   # path, VideoSource, ndarray or tensor
    skeleton: contracts.Skeleton
    roi_polygons: Sequence[np.ndarray]


def _row(item: CohortItem, r: int, window_sec: float, metrics, status: int, err: str) -> dict:
    return {"video": item.name, "roi": r, "PC1_source": "pc1_dyn",
            "window_sec": float(window_sec), **metrics, "status": status, "error": err}


def _nan_row(item: CohortItem, r: int, window_sec: float, err: str) -> dict:
    nan = float("nan")
    return _row(item, r, window_sec, {"PC1_area_0_10": nan, "ADS_slope_0_10": nan,
                                      "ADS_R2_0_10": nan, "Kendall_tau_0_10": nan,
                                      "Kendall_p_0_10": nan, "Peak_n": 0}, -1, err)


def run_cohort(
    items: Sequence[CohortItem],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 32,
    out_csv: Optional[str] = None,
    checkpoint_root: Optional[str] = None,
    mesh=None,
    flow_workers: int = 2,
    *,
    device,
    timer: Optional[StageTimer] = None,
) -> List[dict]:
    """Run the full pipeline for every recording on ``device``; one row per
    (video, ROI), columns ``contracts.COHORT_COLUMNS``.  Failures are
    isolated per video.  With a ``mesh`` (``make_mesh(n)``, or a
    ``Mesh`` layout) a uniform cohort of array clips runs its flow stage
    over the mesh's devices; ``device`` must be the mesh's first device,
    where stages B and C run, so the rows equal the one-device run's.
    ``config.flow`` may be ``FarnebackParams`` or ``TVL1Params`` on either
    path (``models/flow.py`` picks the engine by its type).  A
    ``timer`` collects the stages' wall time (flow items: frames; PC1 and
    metrics items: rows) and the flow stage's spans (``run_flow_stage``,
    ``cohort_flow_sharded``)."""
    device = resolve_device(device)
    if mesh is not None:
        mesh = as_mesh(mesh)
        if mesh[0] != device:
            raise ValueError(f"the mesh's first device {mesh[0]} is not the run's device {device}")
    spans = timer  # the flow stage's spans go to the caller's timer alone
    timer = timer if timer is not None else StageTimer(device)
    n = len(items)
    flows: List[Optional[pipeline.FlowStageResult]] = [None] * n
    errors: List[Optional[str]] = [None] * n

    # ---- Stage A: flow (decode + chunked device flow per video) -----
    def flow_one(i: int):
        item = items[i]
        try:
            ck = f"{checkpoint_root}/{item.name}" if checkpoint_root else None
            flows[i] = pipeline.run_flow_stage(
                item.video, item.skeleton, item.roi_polygons, config, chunk_pairs,
                checkpoint_dir=ck, device=device, timer=spans,
            )
        except Exception as e:  # per-video isolation: the row records the error
            logger.warning("cohort item %s failed: %s", item.name, e)
            errors[i] = f"{type(e).__name__}: {e}"

    with timer.timed("flow"):
        rest = list(range(n))
        if mesh is not None:
            done = cohort_flow_sharded(items, flows, config, chunk_pairs, mesh, timer=spans)
            rest = [i for i in rest if not done[i]]
        if len(rest) > 1 and flow_workers > 1:
            with ThreadPoolExecutor(max_workers=flow_workers) as pool:
                list(pool.map(flow_one, rest))
        else:
            for i in rest:
                flow_one(i)
    timer.add_items("flow", sum(len(f.frame) for f in flows if f is not None))

    # ---- Stage B: PC1, batched over the waveforms of each length -----
    by_len: dict = {}
    for i, f in enumerate(flows):
        if f is not None:
            for r in range(f.vx.shape[1]):
                by_len.setdefault(f.vx.shape[0], []).append((i, r))
    pc1_of = {}
    with timer.timed("pc1"):
        for pairs in by_len.values():
            vx, vy = (torch.as_tensor(np.stack([getattr(flows[i], c)[:, r] for i, r in pairs]),
                                      dtype=torch.float32, device=device) for c in ("vx", "vy"))
            pc1 = pc1_from_flow_batch(vx, vy, config.pca).cpu().numpy()
            pc1_of.update(zip(pairs, pc1))
    timer.add_items("pc1", len(pc1_of))

    # ---- Stage C: metrics, over each length group --------------------
    mets_of = {}
    with timer.timed("metrics"):
        for pairs in by_len.values():
            mets = metrics_model.pc1_metrics_batch(
                np.stack([flows[i].t_sec for i, _ in pairs]),
                np.stack([pc1_of[key] for key in pairs]), config.metrics, device=device)
            for k, key in enumerate(pairs):
                mets_of[key] = {
                    "PC1_area_0_10": float(mets.pc1_area[k]),
                    "ADS_slope_0_10": float(mets.ads_slope[k]),
                    "ADS_R2_0_10": float(mets.ads_r2[k]),
                    "Kendall_tau_0_10": float(mets.kendall_tau[k]),
                    "Kendall_p_0_10": float(mets.kendall_p[k]),
                    "Peak_n": int(mets.peak_n[k]),
                }, int(mets.status[k])
    timer.add_items("metrics", len(mets_of))

    # ---- Row assembly (reference column contract) --------------------
    window = config.metrics.window_sec
    rows: List[dict] = []
    for i, item in enumerate(items):
        if flows[i] is None:
            rows.extend(_nan_row(item, r, window, errors[i] or "")
                        for r in range(len(item.roi_polygons)))
        else:
            rows.extend(_row(item, r, window, *mets_of[(i, r)], "")
                        for r in range(flows[i].vx.shape[1]))
    logger.info("cohort rates: %s", timer.report())
    if out_csv is not None:
        contracts.write_cohort_csv(out_csv, rows)
    return rows
