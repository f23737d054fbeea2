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
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
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
    feats, clips = tflow.roi_body_flow_seq(*tflow.to_device(frames, ex, ey, mask, "cpu"),
                                           from_fields(p))
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


def test_port_never_imports_jax(tmp_path):
    """The port runs where the JAX package, jax, pandas and cv2 are missing:
    a subprocess that cannot import them runs the flow + PC1 slice, TV-L1,
    the pipeline's run_full with its three CSVs (read back with the csv
    module), the flow stage with a checkpoint directory, then resumed from
    it, the three reference-compatible CLIs, run_cohort on its batched
    and per-video paths with its CSV and over a two-shard CPU mesh,
    farneback_flow_sharded over four CPU shards, the fused path's names
    and escalate_clipped_pairs."""
    code = (
        "import csv, math, os, sys\n"
        "BLOCKED = ('btcs_pnes_optical_flow_tpu', 'jax', 'jaxlib', 'pandas', 'cv2')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
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
        "from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda\n"
        "from btcs_pnes_optical_flow_tpu_torch.ops.tvl1 import TVL1Params, tvl1_flow\n"
        "tv, tc = tvl1_flow(torch.as_tensor(fr[:2]), torch.as_tensor(fr[1:3]),\n"
        "                   TVL1Params(n_warps=2, n_iterations=4), return_clip=True)\n"
        "assert tv.shape == (2, 40, 48, 2) and torch.isfinite(tv).all() and not tc.any()\n"
        "from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton\n"
        "from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full\n"
        "clip = np.repeat(fr, 20, axis=0)\n"
        "t = np.arange(80) / 30.0\n"
        "skel = Skeleton(t, 30.0, np.tile([1.0, 0.0], (80, 1)), np.tile([0.0, 1.0], (80, 1)))\n"
        "roi = np.array([[5.0, 5.0], [40.0, 6.0], [38.0, 30.0], [6.0, 32.0]])\n"
        "out = sys.argv[1]\n"
        "paths = [os.path.join(out, n + '.csv') for n in ('flow', 'pc1', 'summary')]\n"
        "flow, pc1, mets = run_full(ArraySource(clip, 30.0), skel, [roi], chunk_pairs=32,\n"
        "                           flow_csv=paths[0], pc1_csv=paths[1], summary_csv=paths[2],\n"
        "                           device='cpu')\n"
        "assert flow.vx.shape == (80, 1) and pc1.shape == (80, 1) and len(mets) == 1\n"
        "assert np.isfinite(flow.vx[1:]).all() and np.isfinite(pc1[1:]).any()\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage\n"
        "ck = os.path.join(out, 'ck')\n"
        "for i in range(2):  # the second run resumes every chunk from the checkpoints\n"
        "    again = run_flow_stage(ArraySource(clip, 30.0), skel, [roi], chunk_pairs=32,\n"
        "                           out_csv=os.path.join(out, f'ck{i}.csv'), checkpoint_dir=ck,\n"
        "                           device='cpu')\n"
        "    assert np.array_equal(again.vx, flow.vx, equal_nan=True)\n"
        "    assert open(os.path.join(out, f'ck{i}.csv'), 'rb').read() == open(paths[0], 'rb').read()\n"
        "    stamps = {n: os.stat(os.path.join(ck, n)).st_mtime_ns for n in os.listdir(ck)}\n"
        "    if i == 0:\n"
        "        assert sorted(stamps) == ['chunk_00000000.npz', 'chunk_00000032.npz',\n"
        "                                  'chunk_00000064.npz', 'meta.json']\n"
        "        written = stamps\n"
        "assert stamps == written  # the resumed run wrote no chunk again\n"
        "def rows(p):\n"
        "    with open(p, newline='') as fh:\n"
        "        return list(csv.reader(fh))\n"
        "def num(s):\n"
        "    return math.nan if s == '' else float(s)\n"
        "fl = rows(paths[0])\n"
        "assert fl[0] == ['frame', 't_sec', 'skel_idx', 'axes_ok', 'vx_body', 'vy_body', 'mag_body']\n"
        "got = np.array([[num(x) for x in r] for r in fl[1:]])\n"
        "want = np.stack([flow.frame, flow.t_sec, flow.skel_idx, flow.axes_ok,\n"
        "                 flow.vx[:, 0], flow.vy[:, 0], flow.mag[:, 0]], 1)\n"
        "assert np.array_equal(got, want, equal_nan=True)\n"
        "p1 = rows(paths[1])\n"
        "assert p1[0] == ['t_sec', 'pc1_dyn'] and len(p1) == 81\n"
        "got = np.array([[num(x) for x in r] for r in p1[1:]])\n"
        "assert np.array_equal(got[:, 1], pc1[:, 0].astype(float), equal_nan=True)\n"
        "sm = rows(paths[2])\n"
        "assert len(sm) == 2 and sm[1][0] == 'pc1_dyn' and int(sm[1][7]) == int(mets[0].peak_n)\n"
        "assert num(sm[1][2]) == float(mets[0].pc1_area)\n"
        "from btcs_pnes_optical_flow_tpu_torch.compat import optical_PC1, optical_PCA, optical_flow\n"
        "from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import save_skeleton_npz\n"
        "video, npz = os.path.join(out, 'clip.npy'), os.path.join(out, 'skel.npz')\n"
        "np.save(video, clip)\n"
        "save_skeleton_npz(npz, skel)\n"
        "cli = [os.path.join(out, 'cli_' + n + '.csv') for n in ('flow', 'pc1', 'summary')]\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()) as said:\n"
        "    optical_flow.main([video, npz, cli[0], str(roi.tolist())], device='cpu')\n"
        "assert said.getvalue() == 'Saved: ' + cli[0] + '\\n'\n"
        "assert open(cli[0], 'rb').read() == open(paths[0], 'rb').read()\n"
        "optical_PCA.main(cli[:2], device='cpu')\n"
        "assert rows(cli[1])[0] == ['t_sec', 'pc1_dyn'] and len(rows(cli[1])) == 81\n"
        "optical_PC1.main(cli[1:], device='cpu')\n"
        "assert len(rows(cli[2])) == 2 and rows(cli[2])[1][0] == 'pc1_dyn'\n"
        "from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem, run_cohort\n"
        "coh = os.path.join(out, 'cohort.csv')\n"
        "batched = run_cohort([CohortItem(n, clip, skel, [roi]) for n in 'ab'], chunk_pairs=32,\n"
        "                     out_csv=coh, mesh=(torch.device('cpu'),), device='cpu')\n"
        "per_video = run_cohort([CohortItem('a', clip, skel, [roi]),\n"
        "                        CohortItem('b', ArraySource(clip, 30.0), skel, [roi])],\n"
        "                       chunk_pairs=32, device='cpu')\n"
        "assert len(batched) == 2 and [r['status'] for r in batched] == [0, 0]\n"
        "assert repr(batched) == repr(per_video)\n"
        "assert rows(coh)[0][:2] == ['video', 'roi'] and len(rows(coh)) == 3\n"
        "from btcs_pnes_optical_flow_tpu_torch.ops.farneback import farneback_flow\n"
        "from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh\n"
        "from btcs_pnes_optical_flow_tpu_torch.parallel.spatial import farneback_flow_sharded\n"
        "sh = farneback_flow_sharded(fr[:2], fr[1:3], mesh=Mesh(['cpu'] * 4, ('spatial',)))\n"
        "whole = farneback_flow(torch.as_tensor(fr[:2]), torch.as_tensor(fr[1:3]))\n"
        "assert sh.shape == (2, 40, 48, 2) and float((sh - whole).abs().max()) <= 1e-4\n"
        "sharded = run_cohort([CohortItem(n, clip, skel, [roi]) for n in 'abc'], chunk_pairs=32,\n"
        "                     mesh=Mesh([torch.device('cpu')] * 2), device='cpu')\n"
        "assert repr(sharded[:2]) == repr(batched) and sharded[2]['status'] == 0\n"
        "from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.pipeline import escalate_clipped_pairs\n"
        "from btcs_pnes_optical_flow_tpu_torch.ops.farneback_fused import farneback_flow_seq\n"
        "seq, zeros = farneback_flow_seq(torch.as_tensor(fr), return_clip=True)\n"
        "assert seq.shape == (3, 40, 48, 2) and zeros.tolist() == [0, 0, 0]\n"
        "fx = [np.zeros((3, 1)) for _ in range(3)]\n"
        "n = escalate_clipped_pairs(*fx, np.array([0, 2, 0]), fr, ax, ax[:, ::-1],\n"
        "                           torch.ones((1, 40, 48), dtype=torch.bool), PipelineConfig(), 3)\n"
        "assert n == (1, 1) and abs(fx[0][1, 0] - float(f.vx[1, 0])) < 1e-6 and fx[0][0, 0] == 0.0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_check_supported():
    p = from_fields(FarnebackParams())
    bf16 = dataclasses.replace(p, warp_precision="bf16")
    assert check_supported(bf16) is bf16
    with pytest.raises(ValueError):
        check_supported(dataclasses.replace(p, warp_precision="fp16"))
    # TPU-only warp knobs, the ROI box and the iteration schedule are accepted.
    q = dataclasses.replace(p, warp_s_cap=0, warp_dual_frac=0.0, warp_layout="transposed",
                            warp_coarse_reach=(4, 8, 8), roi_active_px=((0, 8, 0, 8),),
                            iter_schedule=(3, 2, 1))
    assert check_supported(q) is q
    frames = torch.as_tensor(_clip(2, 40, 48))
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb

    with pytest.raises(ValueError):
        tfb.farneback_flow_seq(frames, dataclasses.replace(p, warp_precision="fp16"))
    flow = tfb.farneback_flow_seq(frames, bf16)
    assert flow.shape == (1, 40, 48, 2) and torch.isfinite(flow).all()
