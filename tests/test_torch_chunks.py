"""The flow stage's chunk driver (models/chunks.py ``ChunkDriver``) on the CPU:
results in submission order with resumed chunks mixed in, at several
depths; the clip-count fault raised from both of its callers; and a short
tail padded to the one chunk shape on the device, its padded pairs kept out
of the result.  A one-level, one-iteration flow keeps the file cheap."""

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
from btcs_pnes_optical_flow_tpu_torch.models import chunks, pipeline
from btcs_pnes_optical_flow_tpu_torch.models.flow import FlowFeatures
from btcs_pnes_optical_flow_tpu_torch.parallel import cohort
from tests.test_pipeline import ROI, make_skeleton, render_clip
from tests.test_torch_cohort import _clips, _items

CPU = torch.device("cpu")
CFG = PipelineConfig(flow=FarnebackParams(levels=1, iterations=1))
FIELDS = ("frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy", "mag")


def _index_flow(calls):
    """A flow whose pair features are the index of the pair's current frame
    (read from the frame's first pixel): vx = i, vy = i + 0.5, mag = i + 0.25
    for each of the masks' R ROIs."""
    def flow(frames, ex, ey, masks, params):
        calls.append((frames.clone(), ex.clone(), ey.clone()))
        i = frames[1:, 0, 0].to(torch.float64)[:, None].expand(-1, masks.shape[0])
        return FlowFeatures(i, i + 0.5, i + 0.25), torch.zeros(len(i), dtype=torch.int32)
    return flow


# The kind of each chunk of a 7-chunk recording: computed ("c") or resumed ("r").
SCHEDULE = "crccrrc"


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_results_come_back_in_submission_order(depth, monkeypatch):
    """Resumed chunks mixed between computed ones reach the sink in the
    order they were handed in, never more than ``depth`` chunks behind; a
    short last chunk is padded with its last frame and zero axes; invalid
    axes go over as zeros and come back NaN."""
    monkeypatch.setattr(chunks, "_PIPELINE_DEPTH", depth)
    chunk, n_frames, n_roi = 4, 27, 2  # a tail of 2 pairs
    frames = np.ascontiguousarray(np.broadcast_to(
        np.arange(n_frames, dtype=np.uint8)[:, None, None], (n_frames, 3, 5)))
    ex = np.tile([[0.6, 0.8]], (n_frames, 1))
    ok = np.ones(n_frames, bool)
    ok[[5, 14, 26]] = False  # pairs whose current frame has no axes
    ex[~ok] = np.nan
    masks = torch.ones((n_roi, 3, 5), dtype=torch.bool)
    calls, got, handed = [], [], []
    driver = chunks.ChunkDriver(_index_flow(calls), None, chunk,
                                lambda key, *f: got.append((key, f)), str)
    for k, first in enumerate(range(0, n_frames - 1, chunk)):
        n = min(chunk, n_frames - 1 - first)
        cur = slice(first + 1, first + 1 + n)
        if SCHEDULE[k] == "r":  # as stored: NaN where the axes are invalid
            want = np.where(ok[cur], np.arange(first + 1, first + 1 + n), np.nan)
            want = want[:, None].repeat(n_roi, 1)
            driver.ready(first, want, want + 0.5, want + 0.25)
        else:
            driver.submit(first, frames[first : first + n + 1], ex[cur], ex[cur], ok[cur], n,
                          masks)
        handed.append(first)
        assert [key for key, _ in got] == handed[: len(got)]
        assert len(handed) - len(got) == min(depth, len(handed))
    driver.finish()
    assert [key for key, _ in got] == handed

    vx, vy, mag = (np.concatenate([f[j] for _, f in got]) for j in range(3))
    want = np.where(ok[1:], np.arange(1, n_frames), np.nan)[:, None].repeat(n_roi, 1)
    for a, off in ((vx, 0.0), (vy, 0.5), (mag, 0.25)):
        np.testing.assert_array_equal(a, want + off)
    assert len(calls) == SCHEDULE.count("c")
    fr, ex_dev, _ = calls[-1]  # the tail: 2 pairs
    assert fr.shape == (chunk + 1, 3, 5) and fr.dtype == torch.uint8
    assert (fr[2:] == fr[2]).all() and fr[2, 0, 0] == n_frames - 1
    assert ex_dev.dtype == torch.float32 and (ex_dev[2:] == 0).all()
    assert (ex_dev[1] == 0).all() and (ex_dev[0] != 0).all()  # frame 26 has no axes


def _clip_at_first_chunk(real):
    def flow(frames, *a):
        feats, clips = real(frames, *a)
        clips = clips.clone()
        clips[1] = 3
        return feats, clips
    return flow


def _run_pipeline(n_frames=40, chunk=16):
    clip = render_clip(n_frames=n_frames)
    return [pipeline.run_flow_stage(ArraySource(clip, fps=30.0),
                                    Skeleton(*make_skeleton(n_frames)), [ROI], CFG,
                                    chunk_pairs=chunk, device=CPU)]


def _run_cohort(n_frames=40, chunk=16, video_of=lambda c: c):
    items = _items(_clips(2, n_frames), video_of)
    flows = [None] * len(items)
    assert cohort.cohort_flow_sharded(items, flows, CFG, chunk, (CPU,)) == [True] * len(items)
    return flows


CALLERS = {"run_flow_stage": (pipeline, _run_pipeline, "flow chunk @0"),
           "cohort_flow_sharded": (cohort, _run_cohort, "cohort item v0 chunk @0")}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_a_clipped_pair_raises_from_both_callers(caller, monkeypatch):
    """A non-zero clip count is a fault of the direct-sample warp: both
    callers raise, naming the chunk their way."""
    module, run, label = CALLERS[caller]
    monkeypatch.setattr(module, "roi_body_flow_seq", _clip_at_first_chunk(module.roi_body_flow_seq))
    with pytest.raises(RuntimeError, match=f"^{label}: 1 pairs clipped"):
        run()


def _padding_recorder(real, seen, n_real_tail):
    """The real flow, recording each chunk's frames; in a short chunk it
    marks the padded pairs' features with 1e9 and their clips with 1, which
    must reach neither the result nor the clip check."""
    def flow(frames, *a):
        seen.append(frames.clone())
        feats, clips = real(frames, *a)
        if torch.equal(frames[n_real_tail:], frames[-1:].expand_as(frames[n_real_tail:])):
            feats = FlowFeatures(*(torch.cat([f[:n_real_tail],
                                              torch.full_like(f[n_real_tail:], 1e9)])
                                   for f in feats))
            clips = clips.clone()
            clips[n_real_tail:] = 1
        return feats, clips
    return flow


@pytest.mark.parametrize("caller,resident", [("run_flow_stage", False),
                                             ("cohort_flow_sharded", False),
                                             ("cohort_flow_sharded", True)],
                         ids=["run_flow_stage", "cohort_flow_sharded", "cohort_resident"])
def test_a_short_tail_is_padded_and_dropped(caller, resident, monkeypatch):
    """40 frames in chunks of 16 pairs: the tail chunk's 7 pairs reach the
    flow as 17 frames, the 9 padding frames equal to the last real one; the
    result holds a row per frame and none of the padded pairs."""
    module, run, _ = CALLERS[caller]
    chunk, n_frames = 16, 40
    n_tail = (n_frames - 1) % chunk
    kw = {"video_of": torch.as_tensor} if resident else {}
    plain = run(n_frames, chunk, **kw)
    seen = []
    monkeypatch.setattr(module, "roi_body_flow_seq",
                        _padding_recorder(module.roi_body_flow_seq, seen, n_tail))
    marked = run(n_frames, chunk, **kw)
    assert {tuple(f.shape) for f in seen} == {(chunk + 1,) + tuple(seen[0].shape[1:])}
    tails = seen[2::3] if caller == "run_flow_stage" else seen[4:]
    assert len(tails) == (1 if caller == "run_flow_stage" else 2)
    for fr in tails:
        assert torch.equal(fr[n_tail + 1:], fr[n_tail].expand_as(fr[n_tail + 1:]))
        assert not torch.equal(fr[n_tail], fr[n_tail - 1])
    for a, b in zip(plain, marked):
        assert len(b.vx) == n_frames and not (b.vx == 1e9).any()
        for name in FIELDS:
            assert np.array_equal(getattr(a, name), getattr(b, name), equal_nan=True), name
