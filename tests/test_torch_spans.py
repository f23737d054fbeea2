"""The flow stage's host spans (utils/timing.py ``span``, ``StageTimer.span``)
on the CPU: opened only for a caller's timer, one per computed chunk, inside
the fenced "flow" stage, safe across threads, and with the answers bit-equal
with and without them.  A one-level, one-iteration flow keeps the file cheap;
the spans do not depend on the flow's parameters."""

import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, MetricParams, PipelineConfig
from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.parallel.runner import run_cohort
from btcs_pnes_optical_flow_tpu_torch.utils import timing
from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer
from tests.test_pipeline import ROI, make_skeleton, render_clip
from tests.test_torch_cohort import _clips, _items

CPU = torch.device("cpu")
CFG = PipelineConfig(flow=FarnebackParams(levels=1, iterations=1),
                     metrics=MetricParams(window_sec=3.0))
COHORT_CFG = PipelineConfig(flow=FarnebackParams(levels=1, iterations=1),
                            metrics=MetricParams(window_sec=0.5))
CHILDREN = ("flow.decode_wait", "flow.copy", "flow.launch", "flow.readback", "flow.store")


@pytest.fixture(scope="module")
def clip():
    return render_clip()


def _forbid_spans(m):
    """Opening any span fails the test."""
    def opened(self, name):
        raise AssertionError(f"span {name!r} opened without a caller's timer")

    m.setattr(StageTimer, "span", opened)


def _bits(res: pipeline.FlowStageResult):
    return [getattr(res, f).tobytes() for f in ("frame", "t_sec", "skel_idx", "axes_ok", "vx",
                                                 "vy", "mag")]


def test_span_without_a_timer_does_nothing():
    assert isinstance(timing.span(None, "flow.copy"), contextlib.nullcontext)


def test_run_flow_stage_opens_no_span_without_a_timer(clip, monkeypatch):
    _forbid_spans(monkeypatch)
    skel = Skeleton(*make_skeleton(len(clip)))
    res = pipeline.run_flow_stage(ArraySource(clip[:33], fps=30.0), skel, [ROI], CFG,
                                  chunk_pairs=32, device=CPU)
    assert len(res.frame) == 33


def test_run_full_spans_each_computed_chunk(clip, tmp_path, monkeypatch):
    """Untimed (no span may open) and timed runs of the fixture at 32 pairs
    a chunk give the same bits; the timed run has every child span once per
    chunk, inside the flow stage; a resumed run opens none but the waits."""
    skel = Skeleton(*make_skeleton(len(clip), nan_rows=((40, 44),)))
    with monkeypatch.context() as m:
        _forbid_spans(m)
        plain = pipeline.run_full(ArraySource(clip, fps=30.0), skel, [ROI], CFG, chunk_pairs=32,
                                  checkpoint_dir=str(tmp_path / "a"), device=CPU)
    timer = StageTimer(CPU)
    timed = pipeline.run_full(ArraySource(clip, fps=30.0), skel, [ROI], CFG, chunk_pairs=32,
                              checkpoint_dir=str(tmp_path / "b"), device=CPU, timer=timer)
    assert _bits(timed[0]) == _bits(plain[0])
    assert timed[1].tobytes() == plain[1].tobytes()
    assert repr(timed[2]) == repr(plain[2])

    assert set(CHILDREN) <= set(timer.times)
    for name in ("flow.copy", "flow.launch", "flow.readback", "flow.store"):
        assert timer.items[name] == 3, name
    assert timer.items["flow.decode_wait"] == 4  # three chunks and the end of the stream
    assert sum(timer.times[k] for k in CHILDREN) <= timer.times["flow"]

    resumed = StageTimer(CPU)
    again = pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], CFG,
                                    chunk_pairs=32, checkpoint_dir=str(tmp_path / "b"),
                                    device=CPU, timer=resumed)
    assert _bits(again) == _bits(timed[0])
    assert set(resumed.items) == {"flow.decode_wait"}


@pytest.mark.parametrize("mesh", [(CPU,), None], ids=["mesh", "per_video"])
def test_run_cohort_spans_only_for_a_caller_timer(mesh, monkeypatch):
    """The mesh path (``cohort_flow_sharded``) and the per-video path (two
    flow workers sharing the timer) open no span for ``run_cohort``'s own
    timer, and a span per video per chunk for the caller's; rows are
    bit-equal either way."""
    items = _items(_clips(2, 33))
    with monkeypatch.context() as m:
        _forbid_spans(m)
        plain = run_cohort(items, COHORT_CFG, chunk_pairs=16, mesh=mesh, device=CPU)
    timer = StageTimer(CPU)
    timed = run_cohort(items, COHORT_CFG, chunk_pairs=16, mesh=mesh, device=CPU, timer=timer)
    assert repr(timed) == repr(plain)
    for name in ("flow.copy", "flow.launch", "flow.readback"):
        assert timer.items[name] == 4, name  # 2 videos x 2 chunks
    if mesh is None:  # two threads' spans may sum to more than the stage's wall time
        assert timer.items["flow.decode_wait"] == 6  # 2 videos x (2 chunks + the end)
    else:
        assert "flow.decode_wait" not in timer.items
        assert sum(t for k, t in timer.times.items() if k.startswith("flow.")) <= \
            timer.times["flow"]


def test_ranges_are_host_operations_not_user_annotations(tmp_path):
    """Stages and spans open function-scope ranges (``cpu_op`` in a chrome
    trace): the profiler mirrors a user annotation on the device's timeline,
    and the benchmark's trace reduction would count the mirror as work."""
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer(CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.timed("flow"), timing.span(timer, "flow.copy"):
            torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e["name"]: e.get("cat") for e in events if e.get("name") in ("flow", "flow.copy")}
    assert cats == {"flow": "cpu_op", "flow.copy": "cpu_op"}


def test_concurrent_spans_lose_no_update():
    """More threads than cores add spans to one timer under a short switch
    interval; every span is counted."""
    timer = StageTimer(CPU)
    n_threads, n_spans = (os.cpu_count() or 1) + 1, 500
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(n_spans):
            with timing.span(timer, "flow.copy"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert timer.items == {"flow.copy": n_threads * n_spans}
    assert np.isfinite(timer.times["flow.copy"]) and timer.times["flow.copy"] > 0
