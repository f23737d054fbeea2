"""The yardstick's counts at known shapes, the trace's reductions on
synthetic spans, and the window's closed loop."""

import time

import numpy as np
import pytest

from benchmark.lib import harness, yardstick
from benchmark.lib.calls import Done
from benchmark.lib.spec import BENCH_DIR, load_module
from benchmark.lib.trace import NO_OP, Trace

K2 = load_module(BENCH_DIR / "kernels" / "k2.py")
K3 = load_module(BENCH_DIR / "kernels" / "k3.py")


def test_k2_work_at_256_pairs_of_480p():
    work = yardstick.FlowWork(256, [], "fp32", 15)
    assert K2.per_pixel(work) == (48.078125, 70)
    assert K2.per_pixel(yardstick.FlowWork(256, [], "bf16", 15))[1] == 122
    ms = 1e3 * yardstick.bound_s(*K2.per_pixel(work), 256 * 480 * 640)
    assert ms == pytest.approx(1.1287, abs=1e-4)  # bytes-bound, as chip_smoke's _k2_cost


def test_k3_work_per_pixel():
    assert K3.per_pixel(yardstick.FlowWork(64, [], "fp32", 15)) == (28, 157)


def test_need_boxes_are_the_ports_roi_dispatch_boxes_clipped():
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
    from btcs_pnes_optical_flow_tpu_torch.ops.farneback import roi_dispatch_params

    roi = [[420.0, 270.0], [1560.0, 330.0], [1500.0, 900.0], [360.0, 840.0]]
    flow = {"warp_precision": "bf16", "iter_schedule": [3, 3, 2, 1]}
    levels = yardstick.need_levels(yardstick.Params(**flow), 1080, 1920, [roi])
    p = roi_dispatch_params(FarnebackParams(warp_precision="bf16", iter_schedule=(3, 3, 2, 1)),
                            1080, 1920, fill_poly_mask(1080, 1920, np.array(roi)))
    assert len(levels) == len(p.roi_active_px) == 4
    for lev, box in zip(levels, p.roi_active_px):
        hk, wk = lev.size
        assert lev.box == (max(box[0], 0), min(box[1], hk), max(box[2], 0), min(box[3], wk))
        assert lev.iters == p.iters_at(lev.k)


def test_recording_work_counts_the_tail_chunk_as_its_pairs():
    work = yardstick.recording_work({}, 480, 640, [[[140, 90], [520, 110], [500, 400],
                                                    [120, 380]]], 361, 128)
    assert [w.pairs for w in work] == [128, 128, 104]


def _trace():
    dev = [(10, 20, "update_matrices_kernel<true>"), (15, 30, "update_flow_kernel<7,true>"),
           (50, 60, "Memcpy HtoD")]
    host = [(0, 100, "aten::copy_"), (35, 45, "cudaStreamSynchronize")]
    return Trace(0, 100, dev, host)


def test_busy_share_is_the_union_of_device_spans():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(30e-9)
    assert tr.kernel_seconds("update_matrices_kernel") == (pytest.approx(10e-9), 1)
    reader = load_module(BENCH_DIR / "metrics" / "device_idle_pct.py")

    class Ctx:
        trace = tr
        call_s = 100e-9

    assert reader.read(Ctx) == pytest.approx(70.0)
    Ctx.call_s = 120e-9  # the profiled call's host ran slower than the window's calls
    assert reader.read(Ctx) == pytest.approx(75.0)


def test_idle_gaps_are_labelled_by_the_innermost_host_operation():
    by = dict(map(tuple, _trace().idle_by_host()))
    # gaps [0, 10] and [60, 100] under the copy, [30, 50] under the sync
    assert by == {"aten::copy_": pytest.approx(50e-9),
                  "cudaStreamSynchronize": pytest.approx(20e-9)}
    bare = Trace(0, 10, [], [])
    assert dict(map(tuple, bare.idle_by_host())) == {NO_OP: pytest.approx(10e-9)}


def test_a_roofline_of_a_kernel_the_trace_never_ran_is_left_out():
    assert yardstick.roofline_pct(K2, [], Trace(0, 10, [], [])) is None


class _Entry:
    def __init__(self, seconds):
        self.seconds, self.calls = seconds, 0

    def run(self, i, timer=None):
        assert i == self.calls
        self.calls += 1
        time.sleep(self.seconds)
        return Done(100, [])


def test_the_call_in_progress_at_the_end_of_the_window_runs_to_its_end_and_counts():
    entry = _Entry(0.05)
    done, window_s, each = harness.drive(entry, 0.12)
    assert len(done) == entry.calls == len(each) == 3
    assert sum(d.frames for d in done) == 300
    assert window_s >= 0.15
