"""The TV-L1 cell's files on the CPU: a tiny cell of the ``tvl1``
configuration's shape (``run_full_tvl1`` over a pingpong recording, 16-pair
chunks with a store) runs through the harness, is ``correct`` against the
plain TV-L1 reference, fails its limits with the reference in bfloat16 in
the program's place, and reports the TV-L1 engine's per-layer metrics that
a CPU trace holds (the kernels' shares need the card)."""

import io
import json
import shutil

import numpy as np
import torch

from benchmark.lib import harness
from benchmark.lib.spec import Spec

TINY = {"name": "tiny_tvl1", "height": 64, "width": 96, "fps": 30.0, "tvl1": {},
        "pca": {"win_sec": 0.3, "step_sec": 0.1},
        "metrics": {"window_sec": 1.2, "p95_win_sec": 0.5, "smooth_sec": 0.1,
                    "min_dist_sec": 0.1, "min_intervals_for_tau": 2},
        "run_full": {"chunk_pairs": 16, "checkpoint": True}}
MIX = {"entry": "run_full_tvl1", "rate_metric": "recording_frames_per_s",
       "render": {"frames": 9, "blobs": [{"x_frac": 0.5, "hz": 3.0}], "ax": 8, "ay": 4,
                  "sx": 10, "sy": 8},
       "playback": "pingpong", "frames": 41, "pool": 2,
       "rois": [[[20, 14], [76, 18], [72, 50], [16, 46]]], "theta": 0.3, "check": 1}


def _root(tiny_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    b = root / "benchmark"
    (b / "configs" / "tiny_tvl1.json").write_text(json.dumps(TINY))
    (b / "traffic" / "tiny_tvl1.json").write_text(json.dumps(MIX))
    shutil.copy(b / "limits" / "tvl1.hd1080_16pairs.json", b / "limits" / "tiny_tvl1.rec.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_tvl1", "source": "a test deployment",
                            "file": "benchmark/configs/tiny_tvl1.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": "tiny_tvl1.rec", "config": "tiny_tvl1",
                              "traffic": "tiny_tvl1", "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tvl1.hd1080_16pairs" in m.get("workloads", []):
            m["workloads"].append("tiny_tvl1.rec")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, trace):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "tiny_tvl1.rec", "--seed", str(2**31 + 3), "--seconds", "0",
                       "--trace", str(trace)], root=root, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


def test_tvl1_cell_runs_and_is_correct(tiny_root, tmp_path):
    root = _root(tiny_root, tmp_path)
    res = _run(root, 0)
    assert res["correct"] is True, res["check"]
    assert set(res["check"]) == {"feat_gap_px", "pc1_gap_rel", "metric_gap_rel"}
    assert set(res["metrics"]) == {"recording_frames_per_s", "peak_device_gib", "setup_s"}
    traced = _run(root, 1)
    assert traced["correct"] is True
    m = traced["metrics"]
    assert m["tvl1_eps_loop_ms_per_frame.tvl1"]["value"] > 0
    assert m["tvl1_eps_iters_per_warp.tvl1"]["value"] == 0  # no runtime call on the CPU
    listed = {e["name"] for e in json.loads((root / "BENCHMARK.json").read_text())["per_layer"]
              if "tvl1.hd1080_16pairs" in e.get("workloads", [])}
    # The recording cells' flow stage, heads and device readers read this
    # cell too; the kernels' shares need the card.
    assert {"flow_stage_ms_per_frame.recording", "flow_syncs_per_chunk.recording",
            "flow_store_ms_per_frame.recording", "pc1_launches_per_call.recording",
            "device_idle_pct.recording"} <= listed
    assert set(m) - {"recording_frames_per_s", "peak_device_gib", "setup_s"} == (
        listed - {"k5_roofline.tvl1", "k6_roofline.tvl1"})


def test_the_tvl1_limits_refuse_the_reference_in_bfloat16(tiny_root, tmp_path):
    from benchmark.lib import calls, check, render

    root = _root(tiny_root, tmp_path)
    spec = Spec(root)
    cfg, mix = spec.config("tiny_tvl1"), spec.traffic("tiny_tvl1")
    pool = render.render_pool(mix["render"], 1, cfg["height"], cfg["width"], cfg["fps"], 11,
                              torch.device("cpu"))
    entry = calls.make_entry(spec, cfg, mix, pool, torch.device("cpu"))
    ref = entry.reference(0)
    f, p, rows = entry.reference(0, dtype=torch.bfloat16)
    nums = check.compare([calls.Answer(0, rows, f, p)], {0: ref})
    ok, lines = check.verdict(nums, spec.limits("tvl1.hd1080_16pairs"))
    assert not ok, lines
    assert np.isfinite(nums["feat_gap_px"])


def test_tvl1_work_counts_the_levels_and_chains(tiny_root, tmp_path):
    from benchmark.lib import calls

    root = _root(tiny_root, tmp_path)
    spec = Spec(root)
    cfg = json.loads((root / "benchmark" / "configs" / "tvl1.json").read_text())
    mix = spec.traffic("hd1080_16pairs")
    for dev, fixed in (("cuda", [False, False, True]), ("cpu", [False, False, False])):
        entry = calls.make_entry(spec, cfg, mix, [np.zeros((2, 1, 1), np.uint8)],
                                 torch.device(dev))
        work = entry.work()
        assert [w.pairs for w in work] == [16] * 112 + [8]
        assert work[0].levels == [(1080, 1920, fixed[0]), (540, 960, fixed[1]),
                                  (270, 480, fixed[2])]
    k5, k6 = spec.kernel("k5"), spec.kernel("k6")
    assert k5.launch(10) == (320, 280)
    assert k6.chain(10, 30) == (320, 10 * 1507)
