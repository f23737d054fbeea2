"""The check refuses what it must: the control (the reference in bfloat16
put in the program's place) and the program with its timed path broken
underneath, at a size a CPU test run holds.  The harness runs a small
cell on the CPU past its look for a card; everything after that is a
whole run."""

import io
import json

import pytest
import torch

from benchmark import calibrate
from benchmark.lib import check, harness
from benchmark.lib.spec import Spec


def _run(root, cell, seed=2**31 + 11, trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], root=root, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny.rec", "tiny.coh"])
def test_the_program_passes_and_the_control_fails(tiny_root, cell):
    limits = Spec(tiny_root).limits(cell)
    recs = calibrate.readings(cell, [5], [6], device="cpu", root=tiny_root, emit=lambda _: None)
    prog, ctrl = recs
    assert prog["kind"] == "program" and check.verdict(prog["nums"], limits)[0], prog
    assert ctrl["kind"] == "control" and not check.verdict(ctrl["nums"], limits)[0], ctrl


def _shift_vx(real, amount):
    def fault(*a, **k):
        feats, clips = real(*a, **k)
        vx = feats.vx.clone()
        vx[3] += amount
        return feats._replace(vx=vx), clips
    return fault


def _half_pairs(real):
    def fault(frames, *a, **k):
        feats, clips = real(frames, *a, **k)
        half = (len(frames) - 1) // 2
        return type(feats)(*(torch.cat([f[:half], f[:len(f) - half]]) for f in feats)), clips
    return fault


def _half_roi(real):
    def fault(flow, ex, ey, roi_masks):
        m = roi_masks.clone()
        m[:, m.shape[1] // 2:] = False  # the mean over the upper half of each ROI only
        return real(flow, ex, ey, m)
    return fault


def _pc1_sample(real):
    def fault(vx, vy, *a, **k):
        pc1 = real(vx, vy, *a, **k)
        pc1[:, 100] += 0.05 * pc1.nan_to_num().abs().max()
        return pc1
    return fault


def _metric_area(real):
    def fault(*a, **k):
        m = real(*a, **k)
        return m._replace(pc1_area=m.pc1_area * 1.03)
    return fault


FAULTS = {
    # an answer altered where it is produced, at each layer
    "flow feature": ("tiny.rec", "models.pipeline", "roi_body_flow_seq",
                     lambda r: _shift_vx(r, 1e-3)),
    "pc1 sample": ("tiny.rec", "models.pc1", "pc1_from_flow_batch", _pc1_sample),
    "metric row": ("tiny.rec", "models.metrics", "pc1_metrics", _metric_area),
    "cohort row": ("tiny.coh", "models.metrics", "pc1_metrics_batch", _metric_area),
    # half of the batch left out, the mean taken over the rest
    "half the ROI": ("tiny.rec", "models.flow", "_project_reduce", _half_roi),
    "half the pairs": ("tiny.rec", "models.pipeline", "roi_body_flow_seq", _half_pairs),
    "half the cohort pairs": ("tiny.coh", "parallel.cohort", "roi_body_flow_seq", _half_pairs),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(tiny_root, monkeypatch, fault):
    import importlib

    cell, module, name, make = FAULTS[fault]
    target = importlib.import_module("btcs_pnes_optical_flow_tpu_torch." + module)
    monkeypatch.setattr(target, name, make(getattr(target, name)))
    res = _run(tiny_root, cell)
    assert res["correct"] is False, res["check"]
    assert any(v["value"] > v["limit"] for v in res["check"].values())


def test_an_unbroken_small_run_is_correct_and_reports_its_metrics(tiny_root):
    res = _run(tiny_root, "tiny.rec")
    assert res["correct"] is True, res["check"]
    assert set(res["metrics"]) == {"recording_frames_per_s", "peak_device_gib", "setup_s"}
    assert list(res)[-1] == "check"
