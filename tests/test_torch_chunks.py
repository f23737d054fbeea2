"""The flow stage's chunk driver (models/chunks.py ``ChunkDriver``) on the CPU:
results in submission order with resumed chunks mixed in, at several
depths; the clip-count fault raised from both of its callers; a short
tail padded to the one chunk shape on the device, its padded pairs kept out
of the result; and the staging of a card's chunks in page-locked memory,
decided by the device alone, which changes no result.  A one-level,
one-iteration flow keeps the file cheap."""

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio import video
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
from btcs_pnes_optical_flow_tpu_torch.models import chunks, pipeline
from btcs_pnes_optical_flow_tpu_torch.models.flow import FlowFeatures
from btcs_pnes_optical_flow_tpu_torch.parallel import cohort
from btcs_pnes_optical_flow_tpu_torch.utils import device
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


# --- Page-locked staging of a chunk's frames and axes --------------------

def _prefetched(n_frames, chunk, device, seed=5):
    """What ``ChunkPrefetcher`` emits for ``n_frames`` random 6×7 frames with
    timestamps, and those frames."""
    frames = np.random.default_rng(seed).integers(0, 256, (n_frames, 6, 7), dtype=np.uint8)
    pos = np.arange(n_frames) * 33.0
    src = ArraySource(frames, fps=30.0, pos_msec=pos)
    return list(video.ChunkPrefetcher(src, chunk, device=device)), frames, pos


# 23 frames in 5-pair chunks: four full chunks and a tail of 2 pairs; 21: five
# full chunks and no tail; 1: the lone frame, no pairs.
PREFETCH_CASES = [(23, 5, [0, 5, 10, 15, 20]), (21, 5, [0, 5, 10, 15]), (1, 5, [0])]


@pytest.mark.parametrize("n_frames,chunk,firsts", PREFETCH_CASES)
@pytest.mark.parametrize("device", [None, "cpu", CPU], ids=["none", "cpu_str", "cpu"])
def test_the_prefetcher_for_the_cpu_emits_arrays_and_pins_nothing(n_frames, chunk, firsts,
                                                                   device, monkeypatch):
    """For the CPU (or no device) each chunk is the NumPy stack of its
    frames, overlapping the last by one frame, with their timestamps; no
    page-locked tensor is asked for."""
    def no_pinning(*a):
        raise AssertionError("pinned memory asked for a CPU device")
    monkeypatch.setattr(video, "pinned_empty", no_pinning)
    got, frames, pos = _prefetched(n_frames, chunk, device)
    assert [first for first, _, _ in got] == firsts
    for first, fr, p in got:
        last = min(first + chunk + 1, n_frames)
        assert type(fr) is np.ndarray and fr.dtype == np.uint8
        np.testing.assert_array_equal(fr, frames[first:last])
        assert p == list(pos[first:last])


def test_the_pinning_decision_depends_on_the_device_alone(monkeypatch):
    """Only a CUDA device stages in page-locked memory, whatever its index or
    spelling.  For one the prefetcher stacks each chunk into one such tensor
    (here a pageable stand-in: this machine may have no card) holding the
    bytes the CPU's arrays hold."""
    for dev in ("cuda", "cuda:1", torch.device("cuda", 0)):
        assert device.stages_pinned(dev)
    for dev in ("cpu", CPU, "meta"):
        assert not device.stages_pinned(dev)
    asked = []

    def pageable(shape, dtype):
        asked.append((shape, dtype))
        return torch.empty(shape, dtype=dtype)
    monkeypatch.setattr(video, "pinned_empty", pageable)
    for n_frames, chunk, firsts in PREFETCH_CASES:
        asked.clear()
        staged, _, _ = _prefetched(n_frames, chunk, "cuda")
        arrays, _, _ = _prefetched(n_frames, chunk, CPU)
        assert [(len(fr), 6, 7) for _, fr, _ in arrays] == [s for s, _ in asked]
        assert {d for _, d in asked} == {torch.uint8}
        for (f1, t, p1), (f2, a, p2) in zip(staged, arrays, strict=True):
            assert isinstance(t, torch.Tensor) and (f1, p1) == (f2, p2)
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("chunk_form", ["numpy", "tensor", "staged"])
def test_a_tensor_chunk_gives_what_a_numpy_chunk_gives(chunk_form, monkeypatch):
    """``ChunkDriver`` through ``run_flow_stage`` (40 frames, 16-pair chunks
    with a 7-pair tail): chunks handed over as CPU tensors, or staged the way
    a card's are (the frames stacked into a tensor by the prefetcher, the
    axes into one by the driver, both pageable stand-ins here), give the
    features of chunks handed over as NumPy arrays, bit for bit."""
    want = _run_pipeline()[0]
    if chunk_form == "tensor":
        real = video.ChunkPrefetcher

        class TensorChunks(real):
            def __iter__(self):
                for first, frames, pos in real.__iter__(self):
                    yield first, torch.from_numpy(frames), pos
        monkeypatch.setattr(pipeline, "ChunkPrefetcher", TensorChunks)
    elif chunk_form == "staged":
        for module in (video, chunks):
            monkeypatch.setattr(module, "stages_pinned", lambda dev: True)
            monkeypatch.setattr(module, "pinned_empty",
                                lambda shape, dtype: torch.empty(shape, dtype=dtype))
    seen = []
    real_launch = chunks.ChunkDriver._launch

    def launch(self, frames, axes, masks):
        seen.append((type(frames), type(axes)))
        return real_launch(self, frames, axes, masks)
    monkeypatch.setattr(chunks.ChunkDriver, "_launch", launch)
    got = _run_pipeline()[0]
    kinds = {"numpy": (np.ndarray, np.ndarray), "tensor": (torch.Tensor, np.ndarray),
             "staged": (torch.Tensor, torch.Tensor)}[chunk_form]
    assert seen == [kinds] * 3
    for name in FIELDS:
        assert np.array_equal(getattr(got, name), getattr(want, name), equal_nan=True), name
