"""The port's main path as a whole on the CPU: roi_body_flow_seq →
pc1_from_flow against the JAX package, plus the package's boundaries."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams
from btcs_pnes_optical_flow_tpu.models import flow as jflow
from btcs_pnes_optical_flow_tpu.ops import cvx as jcvx
from btcs_pnes_optical_flow_tpu_torch import check_supported
from btcs_pnes_optical_flow_tpu_torch.models import flow as tflow
from btcs_pnes_optical_flow_tpu_torch.ops import cvx as tcvx
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(n, h, w, seed=0):
    """A textured blob on a noisy background, moving like the bench clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 30.0
    cx = w * 0.5 + 8 * np.sin(2 * np.pi * 3.0 * t)
    cy = h * 0.5 + 4 * np.cos(2 * np.pi * 2.9 * t)
    yy, xx = np.mgrid[0:h, 0:w]
    texture = rng.normal(0, 6, (h, w))
    frames = np.empty((n, h, w), np.uint8)
    for i in range(n):
        blob = 150 * np.exp(-(((xx - cx[i]) / 12.0) ** 2 + ((yy - cy[i]) / 10.0) ** 2))
        frames[i] = np.clip(40 + texture + blob, 0, 255).astype(np.uint8)
    return frames


def _inputs(n_pairs, h, w):
    frames = _clip(n_pairs + 1, h, w)
    roi = np.array([[20.0, 15.0], [110.0, 20.0], [105.0, 80.0], [25.0, 75.0]])
    mask = tcvx.fill_poly_mask(h, w, roi)[None]
    theta = 0.3
    ex = np.tile(np.array([np.cos(theta), -np.sin(theta)], np.float32), (n_pairs, 1))
    ey = np.tile(np.array([np.sin(theta), np.cos(theta)], np.float32), (n_pairs, 1))
    return frames, ex, ey, mask, roi


def test_slice_matches_jax():
    frames, ex, ey, mask, roi = _inputs(32, 96, 128)
    assert np.array_equal(mask[0], jcvx.fill_poly_mask(96, 128, roi))
    p = FarnebackParams()
    ref, ref_clips = jflow.roi_body_flow_seq(
        jnp.asarray(frames), jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(mask), p)
    farneback_cuda.reset_launch_counts()
    feats, clips = tflow.roi_body_flow_seq(*tflow.to_device(frames, ex, ey, mask, "cpu"), p)
    assert clips.dtype == torch.int32 and tuple(clips.shape) == (32,)
    assert not clips.any() and not np.asarray(ref_clips).any()
    for name in ("vx", "vy", "mag"):
        mine, want = getattr(feats, name).numpy(), np.asarray(getattr(ref, name))
        assert mine.shape == want.shape == (32, 1)
        # ROI means of flows that agree to ~1e-5 px, plus float32 sums
        # over ~5k pixels in another order.
        np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-6)
    # The CPU path takes the plain versions and launches no kernel.
    assert set(farneback_cuda.LAUNCHES.values()) == {0}


def test_roi_body_flow_pairs_match_seq():
    frames, ex, ey, mask, _ = _inputs(3, 48, 64)
    fr, exd, eyd, masks = tflow.to_device(frames, ex, ey, mask, "cpu")
    assert (fr.dtype, exd.dtype, masks.dtype) == (torch.uint8, torch.float32, torch.bool)
    seq, _ = tflow.roi_body_flow_seq(fr, exd, eyd, masks)
    pairs = tflow.roi_body_flow(fr[:-1], fr[1:], exd, eyd, masks)
    for a, b in zip(seq, pairs):
        assert torch.equal(a, b)


def test_host_helpers_match_jax():
    pos = np.array([0.0, 33.0, -1.0, 100.0, 0.0])
    assert np.array_equal(tflow.frame_times(pos, 5, 30.0), jflow.frame_times(pos, 5, 30.0))
    assert np.array_equal(tflow.frame_times(None, 5, 30.0), jflow.frame_times(None, 5, 30.0))
    t_all = np.array([0.0, 0.1, 0.2, 0.35])
    t = np.array([-1.0, 0.0, 0.15, 0.2, 9.0])
    assert np.array_equal(tflow.skel_indices(t, t_all), jflow.skel_indices(t, t_all))


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq, to_device\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow\n"
        "from btcs_pnes_optical_flow_tpu_torch.ops import _build, farneback_cuda\n"
        "rng = np.random.default_rng(0)\n"
        "fr = (rng.random((4, 40, 48)) * 255).astype(np.uint8)\n"
        "ax = np.tile(np.array([[1.0, 0.0]], np.float32), (3, 1))\n"
        "f, c = roi_body_flow_seq(*to_device(fr, ax, ax[:, ::-1], np.ones((1, 40, 48), bool), 'cpu'))\n"
        "v = torch.cat([f.vx[:, 0]] * 30)\n"
        "pc1 = pc1_from_flow(v, v.flip(0))\n"
        "assert pc1.shape == (90,) and f.vx.shape == (3, 1)\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules if 'jax' in m]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_check_supported():
    p = FarnebackParams()
    with pytest.raises(ValueError):
        check_supported(dataclasses.replace(p, warp_precision="bf16"))
    # TPU-only warp knobs, the ROI box and the iteration schedule are accepted.
    q = dataclasses.replace(p, warp_s_cap=0, warp_dual_frac=0.0, warp_layout="transposed",
                            warp_coarse_reach=(4, 8, 8), roi_active_px=((0, 8, 0, 8),),
                            iter_schedule=(3, 2, 1))
    assert check_supported(q) is q
    frames = torch.as_tensor(_clip(2, 40, 48))
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb

    with pytest.raises(ValueError):
        tfb.farneback_flow_seq(frames, dataclasses.replace(p, warp_precision="bf16"))
