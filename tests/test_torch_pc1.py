"""The PyTorch port's band-pass and sliding-window PCA against the JAX
package (sequential-scan engine) and SciPy, on the CPU."""

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import PCAParams
from btcs_pnes_optical_flow_tpu.models import pc1 as jpc1
from btcs_pnes_optical_flow_tpu.ops import filters as jfilters
from btcs_pnes_optical_flow_tpu.ops import pca as jpca
from btcs_pnes_optical_flow_tpu_torch.models import pc1 as tpc1
from btcs_pnes_optical_flow_tpu_torch.ops import filters as tfilters
from btcs_pnes_optical_flow_tpu_torch.ops import pca as tpca

torch.set_num_threads(1)

SOS, ZI, PADREQ = jfilters.make_bandpass(0.5, 5.0, 30.0, 4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _signal(rng, n, nan_spans=()):
    t = np.arange(n) / 30.0
    x = np.sin(2 * np.pi * 2.0 * t) + 0.3 * rng.normal(size=n)
    for a, b in nan_spans:
        x[a:b] = np.nan
    return x.astype(np.float32)


def _close_with_nans(mine, ref, rel):
    """NaN positions equal and max |mine - ref| <= rel · max|ref|."""
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.abs(mine[ok] - ref[ok]).max() <= rel * np.abs(ref[ok]).max()


@pytest.mark.parametrize("n", [80, 300])
def test_sosfiltfilt_matches_scipy(n, rng):
    x = rng.normal(size=n).astype(np.float32)
    ref = scipy.signal.sosfiltfilt(np.ascontiguousarray(SOS), x.astype(np.float64),
                                   padlen=PADREQ)
    mine = tfilters.sosfiltfilt(SOS, _t(x), _t(ZI), PADREQ).numpy()
    # float32 recurrence against SciPy's float64 one.
    assert np.abs(mine - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sosfilt_assoc_engine_not_ported():
    with pytest.raises(NotImplementedError):
        tfilters.sosfilt(SOS, torch.zeros(10), _t(ZI), engine="assoc")


@pytest.mark.parametrize("max_runs", [64, 2])
def test_finite_runs_bounded_matches_jax(max_runs):
    mask = np.ones(50, bool)
    mask[[0, 7, 8, 20, 33, 34, 35, 49]] = False
    ref = jfilters.finite_runs_bounded(jnp.asarray(mask), max_runs)
    mine = tfilters.finite_runs_bounded(_t(mask), max_runs)
    for a, b in zip(mine, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_bandpass_nanrobust_matches_jax(rng):
    # Several NaN gaps; the run [101, 110) is too short to filter (< padreq+1).
    x = _signal(rng, 400, [(0, 1), (50, 60), (100, 101), (110, 112), (300, 305)])
    ref = np.asarray(jfilters.bandpass_nanrobust(
        jnp.asarray(x), SOS, jnp.asarray(ZI), PADREQ, 64, engine="scan"))
    mine = tfilters.bandpass_nanrobust(_t(x), SOS, _t(ZI), PADREQ, 64).numpy()
    assert np.isnan(mine[101:110]).all()
    # The same float32 recurrence; XLA may fuse a multiply-add per step.
    _close_with_nans(mine, ref, 1e-4)
    # Both signals of a batch are filtered independently.
    y = _signal(rng, 400, [(200, 210)])
    both = tfilters.bandpass_nanrobust(torch.stack([_t(x), _t(y)]), SOS, _t(ZI), PADREQ).numpy()
    assert np.array_equal(both[0], mine, equal_nan=True)


def test_eigvec2x2_matches_jax(rng):
    c = rng.normal(size=(50, 3)).astype(np.float32)
    cxx, cyy = np.abs(c[:, 0]), np.abs(c[:, 2])
    cxx[:3] = cyy[:3] = 0.0
    c[:3, 1] = 0.0
    ref = np.asarray(jpca.eigvec2x2_major(jnp.asarray(cxx), jnp.asarray(c[:, 1]), jnp.asarray(cyy)))
    mine = tpca.eigvec2x2_major(_t(cxx), _t(c[:, 1]), _t(cyy)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)


def _axis_signals(rng, n, nan_spans):
    """Velocities with a clear, slowly rotating major axis."""
    t = np.arange(n) / 30.0
    s = np.sin(2 * np.pi * 2.5 * t)
    ang = 0.4 + 0.3 * np.sin(2 * np.pi * t / 7.0)
    vx = s * np.cos(ang) + 0.05 * rng.normal(size=n)
    vy = s * np.sin(ang) + 0.05 * rng.normal(size=n)
    for a, b in nan_spans:
        vx[a:b] = np.nan
    return vx.astype(np.float32), vy.astype(np.float32)


def _pc1_close(mine, ref):
    """The PC1 contract: NaN positions equal, correlation >= 0.9999 and
    max difference <= 1e-4·max|pc1| (window sums taken in another order)."""
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.corrcoef(mine[ok], ref[ok])[0, 1] >= 0.9999
    assert np.abs(mine[ok] - ref[ok]).max() <= 1e-4 * np.abs(ref[ok]).max()


@pytest.mark.parametrize("nan_spans", [(), ((0, 1), (120, 200), (400, 404))])
def test_dynamic_pc1_matches_jax(nan_spans, rng):
    vx, vy = _axis_signals(rng, 513, nan_spans)
    ref = np.asarray(jpca.dynamic_pc1_sliding(jnp.asarray(vx), jnp.asarray(vy), 60, 3))
    mine = tpca.dynamic_pc1_sliding(_t(vx), _t(vy), 60, 3).numpy()
    _pc1_close(mine, ref)


def test_dynamic_pc1_short_input_all_nan():
    out = tpca.dynamic_pc1_sliding(torch.ones(10), torch.ones(10), 60, 3)
    assert torch.isnan(out).all()


def test_pc1_from_flow_matches_jax(rng):
    vx, vy = _axis_signals(rng, 513, [(0, 1), (250, 262)])
    p = PCAParams()
    ref = np.asarray(jpc1.pc1_from_flow(jnp.asarray(vx), jnp.asarray(vy), p))
    mine = tpc1.pc1_from_flow(_t(vx), _t(vy), p).numpy()
    assert mine.shape == (513,)
    _pc1_close(mine, ref)
