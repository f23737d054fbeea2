"""The port's filters on the CPU: both sosfilt engines, the NaN-robust
band-pass and the moving averages against SciPy (with the JAX package's own
tolerances, tests/test_filters.py) and against the JAX package's engines."""

import inspect

import numpy as np
import pytest
import scipy.ndimage
import scipy.signal
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.models import pc1 as jpc1
from btcs_pnes_optical_flow_tpu.ops import design as jdesign
from btcs_pnes_optical_flow_tpu.ops import filters as jfilters
from btcs_pnes_optical_flow_tpu_torch.models import pc1 as tpc1
from btcs_pnes_optical_flow_tpu_torch.models import pipeline as tpipeline
from btcs_pnes_optical_flow_tpu_torch.ops import filters as tfilters
from tests.test_filters import _ref_bandpass_nanrobust, _ref_smooth_ma_nan

torch.set_num_threads(1)

# The port against the JAX package on the same engine: the same float32
# recurrence, its steps rounded in another order (the doubling scan is not
# XLA's associative-scan tree), so within 1e-5 of the largest magnitude.
JAX_REL = 1e-5


def _ref_sos():
    return scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close_to_jax(mine, ref):
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.abs(mine[ok] - ref[ok]).max() <= JAX_REL * np.abs(ref[ok]).max()


@pytest.mark.parametrize("engine", ["scan", "assoc"])
def test_sosfilt_matches_scipy_and_jax(engine, rng):
    sos = _ref_sos()
    zi = scipy.signal.sosfilt_zi(sos)
    x = rng.normal(size=300)
    y_ref, zf_ref = scipy.signal.sosfilt(sos, x, zi=zi)
    y, zf = tfilters.sosfilt(sos, _t(x), _t(zi), engine=engine)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(zf.numpy(), zf_ref, rtol=2e-3, atol=2e-4)
    jy, jzf = jfilters.sosfilt(jnp.asarray(sos, jnp.float32), jnp.asarray(x, jnp.float32),
                               jnp.asarray(zi, jnp.float32), engine=engine)
    _close_to_jax(y.numpy(), np.asarray(jy))
    _close_to_jax(zf.numpy(), np.asarray(jzf))
    # Leading axes are independent signals: each row of a batch is what it
    # gives alone.
    x2 = rng.normal(size=300)
    yb, zfb = tfilters.sosfilt(sos, _t(np.stack([x, x2])), _t(zi), engine=engine)
    assert torch.equal(yb[0], y) and torch.equal(zfb[0], zf)


@pytest.mark.parametrize("engine", ["scan", "assoc"])
@pytest.mark.parametrize("n", [60, 301, 1024])
def test_sosfiltfilt_matches_scipy_and_jax(engine, n, rng):
    sos = _ref_sos()
    zi = scipy.signal.sosfilt_zi(sos)
    pad = min(jdesign.sos_required_padlen(sos), n // 2 - 1)
    t = np.arange(n) / 30.0
    x = np.sin(2 * np.pi * 2.0 * t) + 0.3 * rng.normal(size=n)
    y_ref = scipy.signal.sosfiltfilt(sos, x, padlen=pad)
    y = tfilters.sosfiltfilt(sos, _t(x), _t(zi), pad, engine=engine).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=5e-4, atol=5e-4)
    jy = jfilters.sosfiltfilt(jnp.asarray(sos, jnp.float32), jnp.asarray(x, jnp.float32),
                              jnp.asarray(zi, jnp.float32), pad, engine=engine)
    _close_to_jax(y, np.asarray(jy))


@pytest.mark.parametrize("engine", ["scan", "assoc"])
def test_bandpass_nanrobust_matches_reference_and_jax(engine, rng):
    sos, zi, padreq = tfilters.make_bandpass(0.5, 5.0, 30.0, 4)
    n = 400
    t = np.arange(n) / 30.0
    x = np.sin(2 * np.pi * 3.0 * t) * np.exp(-t / 8) + 0.1 * rng.normal(size=n)
    x[50:60] = np.nan     # splits [0, 50) (filtered)
    x[70:80] = np.nan     # [60, 70) is shorter than padreq + 1: stays NaN
    x[300:302] = np.nan   # long runs either side
    y_ref = _ref_bandpass_nanrobust(x, _ref_sos())
    y = tfilters.bandpass_nanrobust(_t(x), sos, _t(zi), padreq, max_runs=8, engine=engine).numpy()
    assert np.array_equal(np.isnan(y), np.isnan(y_ref))
    fin = np.isfinite(y_ref)
    np.testing.assert_allclose(y[fin], y_ref[fin], rtol=5e-4, atol=5e-4)
    jy = jfilters.bandpass_nanrobust(jnp.asarray(x, jnp.float32), sos, jnp.asarray(zi), padreq,
                                     max_runs=8, engine=engine)
    _close_to_jax(y, np.asarray(jy))


def test_real_pole_sections_fall_back_to_scan(rng):
    """A section with real poles (a1² ≥ 4·a2) takes the sequential scan in
    the associative engine, as in the JAX package; a complex-pole section
    beside it still runs the doubling scan."""
    sos = np.array([[1.0, 0.5, 0.2, 1.0, -1.2, 0.35],     # poles 0.7, 0.5
                    [0.3, 0.0, -0.3, 1.0, -1.0, 0.5]])    # poles 0.5 ± 0.5i
    x = _t(rng.normal(size=(3, 50)))
    zi = _t(rng.normal(size=(2, 2)))
    for s, real in ((0, True), (1, False)):
        b0, b1, b2, _, a1, a2 = sos[s]
        z0 = zi[s].expand(3, 2)
        ya, za = tfilters._section_assoc(b0, b1, b2, a1, a2, x, z0)
        ys, zs = tfilters._section_scan(b0, b1, b2, a1, a2, x, z0)
        if real:
            assert torch.equal(ya, ys) and torch.equal(za, zs)
        else:
            np.testing.assert_allclose(ya.numpy(), ys.numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(za.numpy(), zs.numpy(), rtol=0, atol=1e-5)
    y, _ = tfilters.sosfilt(sos, x, zi)
    jy, _ = jfilters.sosfilt(sos, jnp.asarray(x.numpy()[0]), jnp.asarray(zi.numpy()))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(jy), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [3, 5, 7, 61])
def test_uniform_filter1d_nearest(size, rng):
    x = rng.normal(size=237)
    ref = scipy.ndimage.uniform_filter1d(x, size=size, mode="nearest")
    mine = tfilters.uniform_filter1d_nearest(_t(x), size).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6)
    jx = np.asarray(jfilters.uniform_filter1d_nearest(jnp.asarray(x, jnp.float32), size))
    np.testing.assert_allclose(mine, jx, rtol=1e-6, atol=1e-6)
    batch = tfilters.uniform_filter1d_nearest(_t(np.stack([x, -x])), size)
    assert torch.equal(batch[0], torch.as_tensor(mine))


def test_smooth_ma_nan_matches_reference_and_jax(rng):
    fs, sec = 30.0, 0.2
    x = rng.normal(size=301)
    x[40:55] = np.nan
    x[0] = np.nan
    ref = _ref_smooth_ma_nan(x, fs, sec)
    k = tfilters.smooth_window_len(fs, sec)
    mine = tfilters.smooth_ma_nan(_t(x), k).numpy()
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=1e-4, atol=1e-5)
    jm = np.asarray(jfilters.smooth_ma_nan(jnp.asarray(x, jnp.float32), k))
    assert np.array_equal(np.isnan(mine), np.isnan(jm))
    np.testing.assert_allclose(mine[fin], jm[fin], rtol=1e-6, atol=1e-6)
    # A window with no valid sample is NaN.
    y = np.full(50, np.nan)
    y[:10] = 1.0
    out = tfilters.smooth_ma_nan(_t(y), 7).numpy()
    assert np.isnan(out[14:]).all() and np.isfinite(out[:10]).all()


def _engine_default(fn):
    return inspect.signature(fn).parameters["engine"].default


def test_engine_defaults_equal_jax():
    """The filters default to the associative engine and the PC1 head to
    the sequential one, in both packages."""
    for name in ("sosfilt", "sosfiltfilt", "bandpass_nanrobust"):
        assert _engine_default(getattr(tfilters, name)) == "assoc"
        assert _engine_default(getattr(jfilters, name)) == "assoc"
    for name in ("pc1_from_flow", "pc1_from_flow_batch"):
        assert _engine_default(getattr(tpc1, name)) == "scan"
        assert _engine_default(inspect.unwrap(getattr(jpc1, name))) == "scan"
    assert _engine_default(tpipeline.run_pc1_stage) == "scan"


def _section_loop(sos, x, zi):
    """The sequential engine as a loop of ``_section_scan`` over the
    sections, each over the whole of x (the engine before it had a kernel)."""
    zi = zi.expand(x.shape[:-1] + zi.shape[-2:])
    v, zf = x, []
    for s in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(c) for c in sos[s])
        v, z = tfilters._section_scan(b0, b1, b2, a1, a2, v, zi[..., s, :])
        zf.append(z)
    return v, torch.stack(zf, dim=-2)


@pytest.mark.parametrize("shape,expand", [((300,), False), ((2, 3, 97), True), ((4, 65), False)])
def test_scan_takes_the_plain_loop_on_the_cpu(shape, expand, rng):
    """On the CPU the sequential engine is the section-by-section loop, bit
    for bit, and launches no kernel; a transposed (non-contiguous) x gives
    what its contiguous copy gives."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters_cuda

    sos, zi, _ = tfilters.make_bandpass(0.5, 5.0, 30.0, 4)
    x = _t(rng.normal(size=shape))
    z0 = _t(zi) * x[..., :1, None] if expand else _t(zi)
    filters_cuda.reset_launch_counts()
    y, zf = tfilters.sosfilt(sos, x, z0, engine="scan")
    y_ref, zf_ref = _section_loop(sos, x, z0)
    assert torch.equal(y, y_ref) and torch.equal(zf, zf_ref)
    if x.dim() == 2:
        yt, zft = tfilters.sosfilt(sos, x.T.contiguous().T, z0, engine="scan")
        assert torch.equal(yt, y) and torch.equal(zft, zf)
    assert filters_cuda.LAUNCHES == {"sos_cascade": 0}


def test_filters_cuda_imports_without_card_or_nvcc(tmp_path):
    """ops/filters_cuda.py imports where there is no card, no nvcc and none
    of jax, pandas, cv2 or the JAX package, and the PC1 head's band-pass
    runs there on the plain loop without building the kernel."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "BLOCKED = ('btcs_pnes_optical_flow_tpu', 'jax', 'jaxlib', 'pandas', 'cv2')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from btcs_pnes_optical_flow_tpu_torch.ops import filters_cuda\n"
        "from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow\n"
        "v = torch.sin(torch.arange(120, dtype=torch.float32) / 3)\n"
        "assert pc1_from_flow(v, v.flip(0)).shape == (120,)\n"
        "assert filters_cuda.LAUNCHES == {'sos_cascade': 0}\n"
        "assert filters_cuda.library.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
