"""The JAX package's last public flow and metric entry points in the port,
on the CPU against the JAX package: ``ops/farneback_fused.py``'s names,
``models/flow.py roi_body_flow_checked``, ``models/pipeline.py
escalate_clipped_pairs``, ``models/metrics.py estimate_fs`` /
``pc1_metrics_core`` and ``compat/optical_PC1.ensure_odd``.

The JAX fused path and its checked flow run Pallas kernels, which the
CPU runs only in interpret mode (minutes at these sizes); their JAX
counterparts here are the exact engine that the fused path is held
against (``tests/test_fused_driver.py``) and that the JAX package runs on
the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.compat import optical_PC1 as joptical_PC1
from btcs_pnes_optical_flow_tpu.config import FarnebackParams, MetricParams, PipelineConfig
from btcs_pnes_optical_flow_tpu.models import flow as jflow
from btcs_pnes_optical_flow_tpu.models import metrics as jmetrics
from btcs_pnes_optical_flow_tpu.models import pipeline as jpipeline
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu.ops import farneback_fused as jfused
from btcs_pnes_optical_flow_tpu.ops.filters import smooth_window_len as j_smooth_window_len
from btcs_pnes_optical_flow_tpu_torch.compat import optical_PC1
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.models import flow as tflow
from btcs_pnes_optical_flow_tpu_torch.models import metrics as tmetrics
from btcs_pnes_optical_flow_tpu_torch.models import pipeline
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_fused as tfused
from btcs_pnes_optical_flow_tpu_torch.ops import filters
from tests.test_torch_metrics import _waveform
from tests.test_torch_slice import _inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("entry", ["pairs", "seq"])
def test_fused_names_match_jax(entry):
    """farneback_flow_fused / farneback_flow_seq with and without the clip
    counts, against the JAX engine on the CPU: flow within the port's
    1e-4 px bar of the fused path (``tests/test_fused_driver.py``), clip
    counts zero of the JAX shape and dtype."""
    frames = _inputs(2, 48, 64)[0]
    p = FarnebackParams()
    if entry == "pairs":
        mine = tfused.farneback_flow_fused(torch.as_tensor(frames[:-1]),
                                           torch.as_tensor(frames[1:]), from_fields(p),
                                           return_clip=True)
        flow = jfb.farneback_flow(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), p)
        want = (flow, jnp.zeros((2,), jnp.int32))
        plain = tfused.farneback_flow_fused(torch.as_tensor(frames[:-1]),
                                            torch.as_tensor(frames[1:]), from_fields(p))
    else:
        mine = tfused.farneback_flow_seq(torch.as_tensor(frames), from_fields(p), return_clip=True)
        want = jfb.farneback_flow_seq(jnp.asarray(frames), p, return_clip=True)
        plain = tfused.farneback_flow_seq(torch.as_tensor(frames), from_fields(p))
    (flow, clips), (jflow_, jclips) = mine, want
    assert flow.shape == (2, 48, 64, 2) and torch.equal(flow, plain)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow_), rtol=0, atol=1e-4)
    assert clips.dtype == torch.int32 and np.array_equal(clips.numpy(), np.asarray(jclips))
    one, one_clip = tfused.farneback_flow_fused(torch.as_tensor(frames[0]),
                                                torch.as_tensor(frames[1]), from_fields(p),
                                                return_clip=True)
    assert one.shape == (48, 64, 2) and one_clip.shape == () and int(one_clip) == 0


@pytest.mark.parametrize("params", [FarnebackParams(), FarnebackParams(poly_n=7, winsize=17),
                                    FarnebackParams(poly_n=9), FarnebackParams(winsize=19),
                                    FarnebackParams(iter_schedule=(3, 3, 2, 1), levels=4)])
def test_fused_supported_and_roi_boxes_match_jax(params):
    assert tfused.fused_supported(from_fields(params)) == jfused.fused_supported(params)
    mask = np.zeros((264, 472), bool)
    mask[100:160, 190:290] = True
    mine = tfused.roi_dispatch_params(from_fields(params), 264, 472, mask)
    assert mine.roi_active_px == jfused.roi_dispatch_params(params, 264, 472, mask).roi_active_px


def test_roi_body_flow_checked_matches_jax_flow():
    frames, ex, ey, mask, _ = _inputs(4, 64, 96)
    p = FarnebackParams()
    feats, clips = tflow.roi_body_flow_checked(
        torch.as_tensor(frames[:-1]), torch.as_tensor(frames[1:]), torch.as_tensor(ex),
        torch.as_tensor(ey), torch.as_tensor(mask), from_fields(p))
    ref = jflow.roi_body_flow(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]),
                              jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(mask), p)
    assert clips.dtype == torch.int32 and clips.shape == (4,) and not clips.any()
    for name in ("vx", "vy", "mag"):
        # tests/test_torch_pipeline.py's bar for ROI flow features.
        np.testing.assert_allclose(getattr(feats, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-6)


def _escalation_case():
    """One 8-pair chunk, its axes, JAX-style clip counts (pairs 1, 4 and 6
    clipped; pair 7 past n_pairs) and feature arrays filled with a
    sentinel."""
    frames, ex, ey, mask, _ = _inputs(8, 64, 96)
    clips = np.array([0, 3, 0, 0, 11, 0, 1, 5], np.int32)
    feats = [np.full((8, 1), 99.0) for _ in range(3)]
    return frames, ex, ey, mask, clips, feats


def test_escalate_clipped_pairs_matches_jax():
    frames, ex, ey, mask, clips, feats = _escalation_case()
    cfg = PipelineConfig()
    theirs = [f.copy() for f in feats]
    got = pipeline.escalate_clipped_pairs(*feats, clips, frames, ex, ey, torch.as_tensor(mask),
                                          from_fields(cfg), 7, first=64)
    want = jpipeline.escalate_clipped_pairs(*theirs, clips, frames, ex, ey, jnp.asarray(mask),
                                            cfg, 7, first=64)
    assert got == want == (3, 3)
    listed = np.zeros(8, bool)
    listed[[1, 4, 6]] = True
    for mine, ref in zip(feats, theirs):
        assert np.all(mine[~listed] == 99.0) and np.all(ref[~listed] == 99.0)
        np.testing.assert_allclose(mine[listed], ref[listed], rtol=1e-4, atol=1e-6)
    # The recomputed pairs are the port's flow of those pairs.
    f, _ = tflow.roi_body_flow_seq(*tflow.to_device(frames, ex, ey, mask, "cpu"),
                                   from_fields(cfg).flow)
    np.testing.assert_allclose(feats[0][listed], f.vx.numpy()[listed], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_escalate_with_no_clipped_pair_recomputes_nothing(form, monkeypatch):
    frames, ex, ey, mask, clips, feats = _escalation_case()
    clips = np.zeros(8, np.int32) if form == "numpy" else torch.zeros(8, dtype=torch.int32)

    def never(*_):
        raise AssertionError("a pair was recomputed")

    monkeypatch.setattr(pipeline, "roi_body_flow", never)
    got = pipeline.escalate_clipped_pairs(*feats, clips, frames, ex, ey, torch.as_tensor(mask),
                                          from_fields(PipelineConfig()), 8)
    assert got == (0, 0) and all(np.all(f == 99.0) for f in feats)


@pytest.mark.parametrize("case", ["fs30", "fs32", "nan_gaps", "too_few_in_window"])
def test_estimate_fs_and_pc1_metrics_core_match_jax(case):
    t, x = _waveform(case)
    params = MetricParams()
    tt = torch.as_tensor(t, dtype=torch.float32)
    tx = torch.as_tensor(x, dtype=torch.float32)
    fs, status = tmetrics.estimate_fs(tt, tx, from_fields(params))
    jfs, jstatus = jmetrics.estimate_fs(jnp.asarray(t, jnp.float32), jnp.asarray(x, jnp.float32),
                                        params)
    assert fs.shape == status.shape == () and int(status) == int(jstatus)
    assert float(fs) == pytest.approx(float(jfs), rel=1e-6)
    k_smooth = j_smooth_window_len(float(jfs), params.smooth_sec)
    p95 = max(3, j_smooth_window_len(float(jfs), params.p95_win_sec))
    mine = tmetrics.pc1_metrics_core(tt, tx, k_smooth, p95, from_fields(params))
    ref = jmetrics.pc1_metrics_core(jnp.asarray(t, jnp.float32), jnp.asarray(x, jnp.float32),
                                    k_smooth, p95, params)
    assert int(mine.status) == int(ref.status) and int(mine.peak_n) == int(ref.peak_n)
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(mine, f)), float(getattr(ref, f))
        # tests/test_torch_metrics.py's bar for metric rows.
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(b, rel=1e-4, abs=1e-7), f
    # pc1_metrics runs the two phases of one waveform.
    row = tmetrics.pc1_metrics(t, x, from_fields(params), device="cpu")
    for f in tmetrics.PC1Metrics._fields:
        assert np.array_equal(float(getattr(row, f)), float(getattr(mine, f)), equal_nan=True), f


def test_ensure_odd_is_the_filters_one():
    assert optical_PC1.ensure_odd is filters.ensure_odd
    for n in range(-3, 40):
        assert optical_PC1.ensure_odd(n) == joptical_PC1.ensure_odd(n)


def test_utils_package_exports_the_jax_packages_names():
    """``utils`` re-exports what the JAX package's ``utils/__init__.py``
    does, the port's own timing objects."""
    import types

    import btcs_pnes_optical_flow_tpu.utils as jutils
    import btcs_pnes_optical_flow_tpu_torch.utils as tutils
    from btcs_pnes_optical_flow_tpu_torch.utils import StageTimer, device_timer, trace, timing

    def public(mod):  # submodules imported elsewhere also appear as attributes
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not isinstance(v, types.ModuleType)}

    assert public(tutils) == public(jutils) == {"StageTimer", "device_timer", "trace"}
    assert (StageTimer, device_timer, trace) == (timing.StageTimer, timing.device_timer,
                                                timing.trace)
