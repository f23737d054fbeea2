"""Fixtures of the benchmark's CPU tests.

``tiny_root`` is a checkout-like directory holding a copy of
``benchmark/`` and a ``BENCHMARK.json`` with two small cells added by
files and entries only (a configuration, two traffic mixes, their
limits): a pingpong recording through ``run_full`` and a cohort of four
clips through ``run_cohort`` over a two-shard CPU mesh, at 96 x 128.  The
harness runs them on the CPU (the program's plain path), with the limits
of the real cells of the same entry.
"""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIG = {"name": "tiny", "height": 96, "width": 128, "fps": 30.0,
               "flow": {"warp_precision": "bf16", "iter_schedule": [3, 3, 2, 1]},
               "run_full": {"chunk_pairs": 16, "checkpoint": True},
               "run_cohort": {"chunk_pairs": 16, "mesh_devices": 2}}
TINY_RENDER = {"frames": 17, "blobs": [{"x_frac": 0.5, "hz": 3.0}], "ax": 8, "ay": 4,
               "sx": 10, "sy": 8}
TINY_REC = {"entry": "run_full", "rate_metric": "recording_frames_per_s",
            "render": TINY_RENDER, "playback": "pingpong", "frames": 161, "pool": 2,
            "rois": [[[30, 20], [100, 25], [95, 80], [25, 75]]], "theta": 0.3, "check": 1}
TINY_COH = dict(TINY_REC, entry="run_cohort", rate_metric="cohort_frames_per_s",
                playback="straight", pool=4, check=2, render=dict(TINY_RENDER, frames=161))


def make_root(dst: pathlib.Path) -> pathlib.Path:
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = dst / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (b / "traffic" / "tiny_rec.json").write_text(json.dumps(TINY_REC))
    (b / "traffic" / "tiny_coh.json").write_text(json.dumps(TINY_COH))
    spec["configs"].append({"name": "tiny", "source": "a test deployment",
                            "file": "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny.rec", "config": "tiny", "traffic": "tiny_rec", "chips": 1, "why": "t"},
        {"name": "tiny.coh", "config": "tiny", "traffic": "tiny_coh", "chips": 1, "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.coh" if m["name"].startswith("cohort") or
                                  m["name"].endswith(".cohort") else "tiny.rec")
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell, like in (("tiny.rec", "rec1080.arm_2min"), ("tiny.coh", "clip480.cohort32_12s")):
        shutil.copy(b / "limits" / f"{like}.json", b / "limits" / f"{cell}.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))
