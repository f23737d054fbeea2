"""The PyTorch port's Farnebäck engine against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs its exact engine (the plain reference of the Pallas
kernels K1–K3); the port's wrappers take their plain versions because
the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams
from btcs_pnes_optical_flow_tpu.ops import cvx as jcvx
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu.ops import filters as jfilters
from btcs_pnes_optical_flow_tpu_torch.ops import cvx as tcvx
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb
from btcs_pnes_optical_flow_tpu_torch.ops import filters as tfilters

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return np.asarray(a)


def _resize_taps(n_in, n_out):
    """Both packages' resize weights along y and x, as applied: the resize
    of the unit images e_i (the JAX package keeps its taps inside
    resize_bilinear)."""
    eye = np.eye(n_in, dtype=np.float32)
    mine = (tcvx.resize_bilinear(_t(eye[:, :, None]), n_out, 1),
            tcvx.resize_bilinear(_t(eye[:, None, :]), 1, n_out))
    ref = (jcvx.resize_bilinear(jnp.asarray(eye[:, :, None]), n_out, 1),
           jcvx.resize_bilinear(jnp.asarray(eye[:, None, :]), 1, n_out))
    return mine, ref


# Each case: (port table, JAX table); they must be equal bit for bit.
_TABLES = {
    "poly_exp_n5": lambda: (tfb._poly_exp_tables(5, 1.2), jfb._poly_exp_tables(5, 1.2)),
    "poly_exp_n7": lambda: (tfb._poly_exp_tables(7, 1.5), jfb._poly_exp_tables(7, 1.5)),
    "gaussian_win_15": lambda: (tfb._gaussian_win_kernel(15), jfb._gaussian_win_kernel(15)),
    "gaussian_win_9": lambda: (tfb._gaussian_win_kernel(9), jfb._gaussian_win_kernel(9)),
    "border_40x56": lambda: (tfb._border_scale_np(40, 56), jfb._border_scale_np(40, 56)),
    "border_7x9": lambda: (tfb._border_scale_np(7, 9), jfb._border_scale_np(7, 9)),
    "gauss_3_sigma0": lambda: (tcvx.gaussian_kernel(3, 0.0), jcvx.gaussian_kernel(3, 0.0)),
    "gauss_19": lambda: (tcvx.gaussian_kernel(19, 3.5), jcvx.gaussian_kernel(19, 3.5)),
    "gauss_11_auto": lambda: (tcvx.gaussian_kernel(11, -1.0), jcvx.gaussian_kernel(11, -1.0)),
    "resize_480_240": lambda: _resize_taps(480, 240),
    "resize_45_23": lambda: _resize_taps(45, 23),
    "resize_23_45": lambda: _resize_taps(23, 45),
    "bandpass": lambda: (tfilters.make_bandpass(0.5, 5.0, 30.0, 4),
                         jfilters.make_bandpass(0.5, 5.0, 30.0, 4)),
}


def _flatten(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flatten(v)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(_TABLES))
def test_constant_tables_bit_equal(name):
    mine, ref = _TABLES[name]()
    mine, ref = _flatten(mine), _flatten(ref)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), name


def test_poly_exp_matches_jax(rng):
    img = (rng.random((2, 40, 56)) * 255).astype(np.float32)
    ref = _np(jfb.poly_exp(jnp.asarray(img), 5, 1.2))
    mine = tfb.poly_exp(_t(img), 5, 1.2).numpy()
    assert mine.shape == ref.shape == (2, 40, 56, 5)
    # fp32 sums of 11 taps taken in another order than XLA's conv: a few
    # ulps of the largest coefficient.
    assert np.abs(mine - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 40, 56), (1, 7, 9)])
def test_update_matrices_matches_jax(shape, rng):
    b, h, w = shape
    img0 = (rng.random(shape) * 255).astype(np.float32)
    img1 = (rng.random(shape) * 255).astype(np.float32)
    r0 = _np(jfb.poly_exp(jnp.asarray(img0), 5, 1.2))
    r1 = _np(jfb.poly_exp(jnp.asarray(img1), 5, 1.2))
    # Sub-pixel, multi-pixel, far-outside and huge displacements: samples
    # inside the guard, outside it, and on the 5-pixel rim.
    flow = (rng.normal(size=(b, h, w, 2)) * 4).astype(np.float32)
    flow[:, ::5, ::3, 0] = 1e4
    flow[:, 1::7, ::4, 1] = -3e4
    ref = _np(jfb.update_matrices(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(flow)))
    mine = tfb.update_matrices(_t(r0), _t(r1), _t(flow)).numpy()
    # Same elementwise operations in the same order; XLA may still fuse
    # a multiply-add, so allow an ulp-level relative difference.
    assert np.abs(mine - ref).max() <= 1e-6 * np.abs(ref).max()


def test_bilinear_gather_matches_jax(rng):
    r1 = rng.normal(size=(2, 12, 15, 5)).astype(np.float32)
    fx = (rng.random((2, 12, 15)) * 19 - 2).astype(np.float32)
    fy = (rng.random((2, 12, 15)) * 16 - 2).astype(np.float32)
    ref, ref_in = jfb._bilinear_gather(jnp.asarray(r1), jnp.asarray(fx), jnp.asarray(fy))
    mine, mine_in = tfb._bilinear_gather(_t(r1), _t(fx), _t(fy))
    assert np.array_equal(mine_in.numpy(), _np(ref_in))
    np.testing.assert_allclose(mine.numpy(), _np(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gaussian_win", [False, True])
def test_update_flow_matches_jax(gaussian_win, rng):
    img0 = (rng.random((2, 40, 56)) * 255).astype(np.float32)
    img1 = np.roll(img0, (1, 2), axis=(1, 2))
    r0 = jfb.poly_exp(jnp.asarray(img0), 5, 1.2)
    r1 = jfb.poly_exp(jnp.asarray(img1), 5, 1.2)
    m = _np(jfb.update_matrices(r0, r1, jnp.zeros((2, 40, 56, 2), jnp.float32)))
    ref = _np(jfb.update_flow(jnp.asarray(m), 15, gaussian_win))
    mine = tfb.update_flow(_t(m), 15, gaussian_win).numpy()
    assert mine.shape == ref.shape == (2, 40, 56, 2)
    # Window sums reordered (rel. ~1e-7), then divided by a determinant:
    # the solve's conditioning amplifies that by up to ~100 here.
    assert np.abs(mine - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize(
    "h,w,k",
    [(96, 128, 0), (96, 128, 1), (96, 128, 2), (45, 67, 1), (45, 67, 2)],
    ids=["k0", "strided_k1", "strided_k2", "generic_k1", "generic_k2"],
)
def test_level_image_matches_jax(h, w, k, rng):
    p = FarnebackParams()
    img = (rng.random((2, h, w)) * 255).astype(np.float32)
    ref, hk, wk = jfb._level_image(jnp.asarray(img), k, p, h, w)
    mine, hk2, wk2 = tfb._level_image(_t(img), k, p, h, w)
    assert (hk, wk) == (hk2, wk2) == p.level_size(h, w, k)
    # Values in [0, 255]; fp32 sums of at most 20 taps in another order.
    assert np.abs(mine.numpy() - _np(ref)).max() <= 2e-6 * 255


def _texture(h, w, shift):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx = xx + shift[0]
    yy = yy + shift[1]
    img = (np.sin(xx / 7) * np.cos(yy / 9) + 0.5 * np.sin(xx / 3 + yy / 5)) * 60 + 128
    return img


def _frames(rng, n, h, w):
    return np.stack([
        np.clip(_texture(h, w, (1.3 * i, -0.9 * i)) + rng.normal(0, 1, (h, w)), 0, 255)
        for i in range(n)
    ]).astype(np.uint8)


def test_farneback_flow_seq_matches_jax_and_cv2(rng):
    import cv2

    frames = _frames(rng, 5, 96, 128)
    p = FarnebackParams()
    ref = _np(jfb.farneback_flow_seq(jnp.asarray(frames), p))
    mine = tfb.farneback_flow_seq(_t(frames), p).numpy()
    assert mine.shape == ref.shape == (4, 96, 128, 2)
    # The JAX package's own differential bar (fused vs exact at 480p).
    assert np.abs(mine - ref).max() <= 1e-3
    for i in range(4):
        cv = cv2.calcOpticalFlowFarneback(frames[i], frames[i + 1], None,
                                          0.5, 3, 15, 3, 5, 1.2, 0)
        epe = np.sqrt(((cv - mine[i]) ** 2).sum(-1))
        assert epe.mean() < 0.1  # the reference contract (BASELINE.md)


def test_flow_pairs_equal_seq_with_level_clamp(rng):
    """farneback_flow on pairs == farneback_flow_seq; 40×48 clamps the
    pyramid to fewer levels (OpenCV stops at 32 px)."""
    frames = _frames(rng, 3, 40, 48)
    p = FarnebackParams(iter_schedule=(3, 2))
    seq = tfb.farneback_flow_seq(_t(frames), p)
    pairs = tfb.farneback_flow(_t(frames[:-1]), _t(frames[1:]), p)
    assert torch.equal(seq, pairs)
    single = tfb.farneback_flow(_t(frames[0]), _t(frames[1]), p)
    assert torch.equal(single, seq[0])
    ref = _np(jfb.farneback_flow(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), p))
    assert np.abs(seq.numpy() - ref).max() <= 1e-3
