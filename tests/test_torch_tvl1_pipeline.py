"""TV-L1 as a flow engine of the port's pipeline, on the CPU.

``run_full`` and ``run_flow_stage`` take ``PipelineConfig(flow=TVL1Params())``
(BASELINE config 5): TV-L1 over whole frames, then the same projection and
ROI means as Farnebäck.  Held here: the pipeline against the benchmark's
plain TV-L1 reference (``benchmark/reference/tvl1.py``) and its plain PC1
and metric heads; the per-pair epsilon stop (a pair's flow does not depend
on the pairs batched with it, so a recording's features do not depend on
the chunk); each pair against the JAX package's ``tvl1_flow`` alone; the
Farnebäck path as it was; the checkpoint store's flow settings; and the
escalation ladder and the cohort runner under TV-L1.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.ops import tvl1 as jtv
from btcs_pnes_optical_flow_tpu_torch.config import (
    FarnebackParams,
    MetricParams,
    PCAParams,
    PipelineConfig,
)
from btcs_pnes_optical_flow_tpu_torch.models import flow as flow_model
from btcs_pnes_optical_flow_tpu_torch.models.pipeline import (
    escalate_clipped_pairs,
    run_flow_stage,
    run_full,
)
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as ttv
from btcs_pnes_optical_flow_tpu_torch.ops.farneback import farneback_flow_seq, roi_dispatch_params
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh
from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem, run_cohort

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.lib import calls, check, render  # noqa: E402
from benchmark.lib.spec import load_module  # noqa: E402

torch.set_num_threads(1)

H, W, FPS = 40, 56, 30.0
ROI = [[8.0, 6.0], [48.0, 8.0], [46.0, 34.0], [6.0, 32.0]]
# A 13-frame base played forward and back to 41 frames: 24 distinct pairs.
TRAFFIC = {"playback": "pingpong", "rois": [ROI], "theta": 0.3}
# PC1 and metric windows short enough for a 41-frame recording.
CFG = {"fps": FPS, "tvl1": {}, "pca": {"win_sec": 0.3, "step_sec": 0.1},
       "metrics": {"window_sec": 1.2, "p95_win_sec": 0.5, "smooth_sec": 0.1,
                   "min_dist_sec": 0.1, "min_intervals_for_tau": 2}}
N_FRAMES = 41


@pytest.fixture(scope="module")
def base():
    law = {"frames": 13, "blobs": [{"x_frac": 0.5, "hz": 3.0}], "ax": 6, "ay": 3, "sx": 8,
           "sy": 6}
    return render.render_pool(law, 1, H, W, FPS, 2**31 + 17, "cpu")[0]


def _skeleton(n, theta=0.3):
    return calls.skeleton(n, FPS, theta)


def _config(flow):
    return PipelineConfig(flow=flow, pca=PCAParams(**CFG["pca"]),
                          metrics=MetricParams(**CFG["metrics"]))


def _recording(base, n=N_FRAMES):
    return calls.played_source(base, "pingpong", n, FPS)


def _run(base, chunk, flow=ttv.TVL1Params(), **kw):
    return run_full(_recording(base), _skeleton(N_FRAMES), [np.asarray(ROI)], _config(flow),
                    chunk, device="cpu", **kw)


@pytest.fixture(scope="module")
def tvl1_runs(base):
    """run_full under TVL1Params() at chunk_pairs 4 and 7."""
    return {c: _run(base, c) for c in (4, 7)}


def test_run_full_tvl1_matches_the_plain_reference(base, tvl1_runs):
    entry = load_module(REPO / "benchmark" / "entries" / "run_full_tvl1.py")
    flow, pc1, mets = tvl1_runs[4]
    ref = entry.tvl1_answer(base, CFG, TRAFFIC, N_FRAMES, torch.device("cpu"))
    ans = calls.Answer(0, list(mets), np.stack([flow.vx, flow.vy, flow.mag], 1), pc1)
    ans.rows = calls.read_rows(ans)
    assert ans.rows[0]["status"] == 0 and ans.rows[0]["Peak_n"] == 4
    nums = check.compare([ans], {0: ref})
    # The same TV-L1 with the program's divisions by reciprocals, its
    # factored data term and its matmul resizes: a few float32 ulps a step
    # (6.5e-6 px at most per pixel at 64x96), averaged over the ROI.
    assert nums["feat_gap_px"] <= 2e-5, nums
    # float32 band-pass and PCA against the reference's float64 heads on
    # features that differ by the above: the recording cells' limit.
    assert nums["pc1_gap_rel"] <= 3e-3, nums
    # Metric rows from those waveforms: a tenth of the cells' 1e-2.
    assert nums["metric_gap_rel"] <= 1e-3, nums
    bf16 = entry.tvl1_answer(base, CFG, TRAFFIC, N_FRAMES, torch.device("cpu"), torch.bfloat16)
    ctrl = calls.Answer(0, bf16[2], bf16[0], bf16[1])
    assert check.compare([ctrl], {0: ref})["feat_gap_px"] > 2e-5  # the bar sees bfloat16


def test_features_do_not_depend_on_the_chunk(tvl1_runs):
    (f4, p4, m4), (f7, p7, m7) = tvl1_runs[4], tvl1_runs[7]
    for c in ("vx", "vy", "mag"):
        assert np.array_equal(getattr(f4, c), getattr(f7, c), equal_nan=True), c
    assert np.array_equal(p4, p7, equal_nan=True)


def _stop_pairs(rng, h=40, w=56):
    """Three pairs whose epsilon loops stop at different iterations: a
    still texture (every loop stops at its first step), a faint texture
    moved by 0.01 px (some loops run part way) and a strong one moved by
    (0.3, -0.2) px (every loop runs to its end)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    noise = rng.normal(0, 1, (h, w))

    def tex(dx, dy, contrast):
        img = (np.sin((xx + dx) / 5) * np.cos((yy + dy) / 6)
               + 0.5 * np.sin((xx + dx) / 9 + (yy + dy) / 4)) * contrast + 128 + noise
        return np.clip(img, 0, 255).astype(np.uint8)

    moves = [(0.0, 0.0, 60), (0.01, 0.0, 20), (0.3, -0.2, 60)]
    return (np.stack([tex(0, 0, c) for _, _, c in moves]),
            np.stack([tex(dx, dy, c) for dx, dy, c in moves]))


def test_each_pair_of_a_batch_is_the_pair_alone(rng, monkeypatch):
    prev, curr = _stop_pairs(rng)
    p = ttv.TVL1Params()
    batch = ttv.tvl1_flow(torch.as_tensor(prev), torch.as_tensor(curr), p)
    div, steps = ttv._div, []
    monkeypatch.setattr(ttv, "_div", lambda *a: steps.append(1) or div(*a))
    alone = []
    for i in range(3):
        steps.clear()
        alone.append(ttv.tvl1_flow(torch.as_tensor(prev[i:i + 1]),
                                   torch.as_tensor(curr[i:i + 1]), p)[0])
        alone[-1] = (alone[-1], len(steps))
    # The pairs stop after different numbers of iterations (two _div calls
    # an iteration), so a stop on the batch's largest update would have
    # run the early ones longer.
    assert len({n for _, n in alone}) == 3, [n for _, n in alone]
    for i, (flow, _) in enumerate(alone):
        assert torch.equal(batch[i], flow), i
    # Each pair against the JAX package's loop on that pair alone (at
    # B = 1 its batch-wide stop is the pair's own): the defaults test's bar,
    # since the mean is taken in another order.
    for i in range(3):
        ref = np.asarray(jtv.tvl1_flow(jnp.asarray(prev[i:i + 1]), jnp.asarray(curr[i:i + 1])))
        assert np.abs(batch[i].numpy() - ref[0]).max() <= 1e-3, i


def test_farneback_flow_stage_is_the_chunked_farneback_path(base):
    """FarnebackParams keeps its path: ROI-dispatched Farnebäck over each
    chunk's consecutive frames, then the projection and ROI means."""
    fp = FarnebackParams()
    n, chunk = 17, 8
    res = run_flow_stage(_recording(base, n), _skeleton(n), [np.asarray(ROI)], _config(fp),
                         chunk, device="cpu")
    frames = np.stack([f for f, _ in _recording(base, n).frames()])
    masks = torch.as_tensor(cvx.fill_poly_mask(H, W, np.asarray(ROI))[None])
    boxed = roi_dispatch_params(fp, H, W, masks.numpy())
    ex, ey = _skeleton(n).ex[1:], _skeleton(n).ey[1:]
    for s in range(0, n - 1, chunk):
        fr = torch.as_tensor(frames[s:s + chunk + 1])
        feats = flow_model._project_reduce(farneback_flow_seq(fr, boxed),
                                           torch.as_tensor(ex[s:s + chunk], dtype=torch.float32),
                                           torch.as_tensor(ey[s:s + chunk], dtype=torch.float32),
                                           masks)
        assert np.array_equal(res.vx[1 + s:1 + s + chunk, 0], feats.vx[:, 0].numpy())
        assert np.array_equal(res.mag[1 + s:1 + s + chunk, 0], feats.mag[:, 0].numpy())


def test_checkpoint_store_names_the_flow_engine(base, tmp_path):
    n, rois = 9, [np.asarray(ROI)]
    ck = str(tmp_path / "store")
    first = run_flow_stage(_recording(base, n), _skeleton(n), rois, _config(FarnebackParams()),
                           4, checkpoint_dir=ck, device="cpu")
    # Resumed under the same settings: every chunk loads, the same answer.
    again = run_flow_stage(_recording(base, n), _skeleton(n), rois, _config(FarnebackParams()),
                           4, checkpoint_dir=ck, device="cpu")
    assert np.array_equal(first.vx, again.vx, equal_nan=True)
    for flow in (ttv.TVL1Params(), FarnebackParams(iterations=2)):
        with pytest.raises(ValueError, match="different parameters"):
            run_flow_stage(_recording(base, n), _skeleton(n), rois, _config(flow), 4,
                           checkpoint_dir=ck, device="cpu")


def test_escalation_ladder_refuses_tvl1(base):
    frames = base[:3]
    ex = np.tile([1.0, 0.0], (2, 1))
    feats = [np.zeros((2, 1)) for _ in range(3)]
    masks = torch.as_tensor(cvx.fill_poly_mask(H, W, np.asarray(ROI))[None])
    with pytest.raises(ValueError, match="TV-L1"):
        escalate_clipped_pairs(*feats, np.array([1, 0]), frames, ex, ex[:, ::-1], masks,
                               _config(ttv.TVL1Params()), 2)


def test_run_cohort_runs_tvl1_on_both_paths(base, tvl1_runs):
    """The sharded path over a two-shard CPU mesh and the per-video path
    give a clip's row as run_full does (its features do not depend on the
    chunk, so neither does the row)."""
    forward = np.stack([f for f, _ in _recording(base).frames()])
    clips = [forward, np.ascontiguousarray(forward[::-1])]
    items = [CohortItem(f"c{i}", c, _skeleton(N_FRAMES), [np.asarray(ROI)])
             for i, c in enumerate(clips)]
    cfg = _config(ttv.TVL1Params())
    sharded = run_cohort(items, cfg, 8, mesh=Mesh(["cpu"] * 2), device="cpu")
    per_video = run_cohort(items[:1], cfg, 16, device="cpu")
    assert [r["error"] for r in sharded] == ["", ""]
    want = calls.read_rows(calls.Answer(0, list(tvl1_runs[4][2])))[0]
    for row in (sharded[0], per_video[0]):
        np.testing.assert_equal({c: row[c] for c in want}, want)
