"""A new configuration, traffic mix, entry module, per-layer metric and
kernel work count are picked up by name from files of their own, with no
existing file edited: the tiny cells of ``conftest.py`` are such an
addition, and these tests add a metric that reads a new kernel's work, a
cohort cell whose options (no mesh, two flow workers) are data alone, and
a cell driven by an entry module of its own."""

import io
import json
import shutil

import pytest

from benchmark.lib import harness
from benchmark.lib.spec import Spec

NEW_KERNEL = '''
PATTERN = r"poly_exp"


def per_pixel(work):
    return 24, 0
'''
NEW_METRIC = '''
def read(ctx):
    return float(sum(w.pairs for w in ctx.work)) * ctx.kernel("k_new").per_pixel(None)[0]
'''
# An entry that drives the flow stage alone and answers features only.
FLOW_ENTRY = '''
import numpy as np
import torch

from benchmark.lib import calls, yardstick
from benchmark.lib.check import farneback_answer


class Entry:
    reports_features = True

    def __init__(self, cfg, traffic, pool, device):
        self.cfg, self.traffic, self.pool, self.device = cfg, traffic, pool, device
        self.config = calls.pipeline_config(cfg)
        self.n = calls.recording_frames(cfg, traffic)
        self.skel = calls.skeleton(self.n, float(cfg["fps"]), traffic["theta"])
        self.chunk = int(calls.options(cfg, traffic, "flow_stage")["chunk_pairs"])

    def bases(self, i):
        return [i % len(self.pool)]

    def run(self, i, timer=None):
        from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage

        b = self.bases(i)[0]
        src = calls.played_source(self.pool[b], self.traffic["playback"], self.n,
                                  float(self.cfg["fps"]))
        rois = [np.asarray(p, np.float64) for p in self.traffic["rois"]]
        f = run_flow_stage(src, self.skel, rois, self.config, self.chunk, device=self.device)
        return calls.Done(self.n, [calls.Answer(b, [], np.stack([f.vx, f.vy, f.mag], 1))])

    def warm(self):
        self.run(0)

    def work(self):
        return yardstick.recording_work(self.cfg.get("flow", {}), self.cfg["height"],
                                        self.cfg["width"], self.traffic["rois"], self.n,
                                        self.chunk)

    def reference(self, base, dtype=torch.float32):
        feats, _, _ = farneback_answer(self.pool[base], self.cfg, self.traffic, self.n,
                                       self.device, dtype)
        return feats, None, []
'''


def _mix(root, name, **changes):
    return dict(json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text()),
                **changes)


def _add_cell(root, cell, traffic, limits):
    b = root / "benchmark"
    (b / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
    (b / "limits" / f"tiny.{cell}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": f"tiny.{cell}", "config": "tiny", "traffic": cell,
                              "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] == traffic["rate_metric"]:
            m["workloads"].append(f"tiny.{cell}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _run(root, cell, trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", "3", "--seconds", "0", "--trace",
                       str(trace)], root=root, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    (root / "benchmark" / "kernels" / "k_new.py").write_text(NEW_KERNEL)
    (root / "benchmark" / "metrics" / "pair_bytes.recording.py").write_text(NEW_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "pair_bytes.recording", "unit": "B", "better": "lower",
                              "source": "program_counter", "layer": "flow stage",
                              "moves": "recording_frames_per_s", "workloads": ["tiny.rec"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run(root, "tiny.rec", trace=1)
    assert res["metrics"]["pair_bytes.recording"]["value"] == 160 * 24
    assert "flow_stage_ms_per_frame.recording" in res["metrics"]
    assert "device_idle_pct.recording" in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_a_metric_reader_is_found_by_its_name_its_base_or_its_kernel(tiny_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    (root / "benchmark" / "kernels" / "k_new.py").write_text(NEW_KERNEL)
    spec = Spec(root)
    roofline = spec.metric_reader("k2_roofline.recording")
    assert spec.metric_reader("k3_roofline.cohort") is roofline
    assert spec.metric_reader("k_new_roofline.recording") is roofline
    assert spec.metric_reader("device_idle_pct.cohort") is spec.metric_reader("device_idle_pct")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("k9_roofline.cohort")


def test_entry_options_are_data_alone(tiny_root, tmp_path, monkeypatch):
    from btcs_pnes_optical_flow_tpu_torch.parallel import runner

    def no_mesh(*a, **k):
        raise AssertionError("the cell asks for no mesh")

    monkeypatch.setattr(runner, "cohort_flow_sharded", no_mesh)
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    _add_cell(root, "per_video", _mix(root, "tiny_coh", options={"mesh_devices": 0,
                                                                 "flow_workers": 2}),
              {"metric_gap_rel": 0.01})
    res = _run(root, "tiny.per_video")
    assert res["correct"] is True, res["check"]
    assert "cohort_frames_per_s" in res["metrics"]


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "broken"])
def test_a_new_entry_module_is_found_by_name(tiny_root, tmp_path, monkeypatch, broken):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    (root / "benchmark" / "entries" / "flow_stage.py").write_text(FLOW_ENTRY)
    _add_cell(root, "flow", _mix(root, "tiny_rec", entry="flow_stage",
                                 options={"chunk_pairs": 16}), {"feat_gap_px": 1e-3})
    if broken:  # a feature altered where it is produced
        from btcs_pnes_optical_flow_tpu_torch.models import pipeline

        real = pipeline.roi_body_flow_seq

        def shifted(*a, **k):
            feats, clips = real(*a, **k)
            vx = feats.vx.clone()
            vx[3] += 1e-2
            return feats._replace(vx=vx), clips

        monkeypatch.setattr(pipeline, "roi_body_flow_seq", shifted)
    res = _run(root, "tiny.flow")
    assert res["correct"] is (not broken), res["check"]
    assert set(res["check"]) == {"feat_gap_px"}
