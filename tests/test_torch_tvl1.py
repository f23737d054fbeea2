"""The PyTorch port's TV-L1 engine against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs its exact warp and either its "xla" primal–dual loop or
its resident Pallas chain in interpret mode; the port's wrappers take
their plain versions because the tensors lie on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.ops import cvx as jcvx
from btcs_pnes_optical_flow_tpu.ops import tvl1 as jtv
from btcs_pnes_optical_flow_tpu.ops.tvl1_pallas import _block_geometry, pd_chain_resident
from btcs_pnes_optical_flow_tpu_torch.ops import cvx as tcvx
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as ttv
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda

torch.set_num_threads(1)


def _texture(h, w, rng, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx = xx + shift[0]
    yy = yy + shift[1]
    img = (np.sin(xx / 6) * np.cos(yy / 7) + 0.6 * np.sin(xx / 11 + yy / 5)) * 55 + 128
    return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)


def _pairs(rng, h=48, w=64):
    """Two pairs with different sub-pixel motions."""
    f0 = np.stack([_texture(h, w, rng), _texture(h, w, rng, (0.3, 0.2))])
    f1 = np.stack([_texture(h, w, rng, (1.1, -0.6)), _texture(h, w, rng, (-0.8, 0.9))])
    return f0, f1


def test_params_match_jax():
    mine = [(f.name, f.default) for f in dataclasses.fields(ttv.TVL1Params)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jtv.TVL1Params)]
    assert mine == ref
    assert dataclasses.is_dataclass(ttv.TVL1Params) and ttv.TVL1Params.__dataclass_params__.frozen


@pytest.mark.parametrize("shape,out", [((2, 24, 32), (48, 64)), ((2, 48, 64), (24, 32)),
                                       ((1, 45, 67), (23, 34)), ((3, 17, 30), (17, 61))],
                         ids=["up", "down", "odd_down", "width_only"])
def test_resize_bilinear_mm_matches_jax(shape, out, rng):
    img = rng.random(shape, dtype=np.float32)
    assert np.array_equal(tcvx._resize_axis_matrix(shape[-2], out[0]),
                          jcvx._resize_axis_matrix(shape[-2], out[0]))
    ref = np.asarray(jcvx.resize_bilinear_mm(jnp.asarray(img), *out))
    mine = tcvx.resize_bilinear_mm(torch.as_tensor(img), *out).numpy()
    assert mine.shape == ref.shape == shape[:-2] + out
    # w0·a + w1·b on values in [0, 1], each matmul free to fuse one
    # multiply-add: an ulp of the largest value.
    assert np.abs(mine - ref).max() <= 1e-6
    # ... and the gather resize gives the same numbers.
    gather = tcvx.resize_bilinear(torch.as_tensor(img), *out).numpy()
    assert np.abs(mine - gather).max() <= 1e-6


def test_grad_div_match_jax(rng):
    for shape in [(2, 9, 13), (1, 2, 5)]:
        a = rng.normal(size=shape).astype(np.float32)
        b = rng.normal(size=shape).astype(np.float32)
        for mine, ref in zip(ttv._grad(torch.as_tensor(a)), jtv._grad(jnp.asarray(a))):
            assert np.array_equal(mine.numpy(), np.asarray(ref))
        mine = ttv._div(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        ref = np.asarray(jtv._div(jnp.asarray(a), jnp.asarray(b)))
        assert np.abs(mine - ref).max() <= 1e-6


@pytest.mark.parametrize("shape", [(2, 3, 20, 28), (1, 3, 7, 9)])
def test_warp_sample_plain_matches_jax(shape, rng):
    b, c, h, w = shape
    src = rng.normal(size=shape).astype(np.float32)
    flow = (rng.normal(size=(b, 2, h, w)) * 3).astype(np.float32)
    # Displacements past every edge, and some far outside.
    flow[:, 0, :, :2] = -5.5
    flow[:, 0, :, -2:] = 4.25
    flow[:, 1, :2, :] = -3.75
    flow[:, 1, -2:, :] = 6.5
    flow[:, :, ::3, ::4] = 1e4
    flow[:, 1, 1::5, ::3] = -1e4
    mine = ttv.warp_sample_cf_plain(torch.as_tensor(src), torch.as_tensor(flow)).numpy()
    u, v = jnp.asarray(flow[:, 0]), jnp.asarray(flow[:, 1])
    ref = np.stack([np.asarray(jtv._warp_bilinear(jnp.asarray(src[:, ch]), u, v))
                    for ch in range(c)], axis=1)
    assert mine.shape == ref.shape
    # The same float32 operations in the same order.
    assert np.abs(mine - ref).max() <= 1e-6
    one = ttv._warp_bilinear(torch.as_tensor(src[:, 1]), torch.as_tensor(flow[:, 0]),
                             torch.as_tensor(flow[:, 1])).numpy()
    assert np.array_equal(one, mine[:, 1])
    assert torch.equal(tvl1_cuda.warp_sample_cf(torch.as_tensor(src), torch.as_tensor(flow)),
                       torch.as_tensor(mine))


def _chain_inputs(rng, b, h, w):
    u = rng.normal(0, 0.5, (b, h, w)).astype(np.float32)
    v = rng.normal(0, 0.5, (b, h, w)).astype(np.float32)
    rho_c = rng.normal(0, 0.05, (b, h, w)).astype(np.float32)
    i1wx = rng.normal(0, 0.05, (b, h, w)).astype(np.float32)
    i1wy = rng.normal(0, 0.05, (b, h, w)).astype(np.float32)
    i1wx[:, ::7, ::5] = 0.0  # flat pixels: the 1e-9 floor of |∇I|²
    i1wy[:, ::7, ::5] = 0.0
    return u, v, rho_c, i1wx, i1wy, i1wx * i1wx + i1wy * i1wy


def test_pd_chain_plain_matches_resident_kernel(rng):
    b, h, w, k = 2, 40, 56, 8
    assert _block_geometry(h, w, k)[2] == 1  # single-block geometry
    planes = _chain_inputs(rng, b, h, w)
    p = ttv.TVL1Params()
    ref = pd_chain_resident(*map(jnp.asarray, planes), n_iterations=k, tau=p.tau,
                            lambda_=p.lambda_, theta=p.theta, interpret=True)
    mine = ttv.pd_chain_plain(*map(torch.as_tensor, planes), k, p.tau, p.lambda_, p.theta)
    for m, r in zip(mine, ref):
        # Same factored arithmetic; XLA may contract a multiply-add.
        assert np.abs(m.numpy() - np.asarray(r)).max() <= 1e-5
    wrapped = tvl1_cuda.pd_chain(*map(torch.as_tensor, planes), k, p.tau, p.lambda_, p.theta)
    assert all(torch.equal(a, c) for a, c in zip(wrapped, mine))


@pytest.mark.parametrize("engines", [("exact", "xla", False), ("auto", "resident", True)],
                         ids=["exact_xla", "resident"])
def test_tvl1_flow_matches_jax_eps0(engines, rng):
    warp, pd, interpret = engines
    kw = dict(n_scales=2, n_warps=2, n_iterations=8, epsilon=0.0,
              warp_engine=warp, pd_engine=pd)
    f0, f1 = _pairs(rng)
    ref = np.asarray(jtv.tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), jtv.TVL1Params(**kw),
                                   interpret=interpret))
    tvl1_cuda.reset_launch_counts()
    mine, clips = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1),
                                ttv.TVL1Params(**kw), return_clip=True)
    assert mine.shape == (2, 48, 64, 2) and mine.dtype == torch.float32
    assert clips.dtype == torch.int32 and clips.tolist() == [0, 0]
    # tests/test_tvl1.py's engine-equality bar.
    assert np.abs(mine.numpy() - ref).max() <= 2e-5
    # The CPU path takes the plain versions and launches no kernel.
    assert set(tvl1_cuda.LAUNCHES.values()) == {0}
    plain = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1), ttv.TVL1Params(**kw),
                          kernels=False)
    assert torch.equal(plain, mine)


def test_tvl1_flow_defaults_match_jax(rng):
    f0 = _texture(48, 56, rng)
    f1 = _texture(48, 56, rng, shift=(0.8, 0.4))
    ref = np.asarray(jtv.tvl1_flow(jnp.asarray(f0), jnp.asarray(f1)))
    mine, clip = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1), return_clip=True)
    assert mine.shape == (48, 56, 2) and clip.shape == () and int(clip) == 0
    # Default ε: the early exit depends on a mean taken in another order,
    # so an iteration more or less is possible; the flow's px bar.
    assert np.abs(mine.numpy() - ref).max() <= 1e-3


def test_tvl1_recovers_translation(rng):
    h, w = 64, 80
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(1.2, -0.7))
    for pd in ("xla", "resident"):
        flow = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1),
                             ttv.TVL1Params(pd_engine=pd)).numpy()
        inner = flow[12:-12, 12:-12]
        # I1 sampled at x + flow matches I0: the flow is minus the shift.
        epe = np.sqrt((inner[..., 0] + 1.2) ** 2 + (inner[..., 1] - 0.7) ** 2).mean()
        assert epe < 0.25, (pd, epe)


def test_engine_names():
    f = torch.zeros((20, 24), dtype=torch.uint8)
    for bad in (dict(warp_engine="gather"), dict(pd_engine="pallas")):
        with pytest.raises(ValueError):
            ttv.tvl1_flow(f, f, ttv.TVL1Params(**bad))
    # The TPU's banded-warp knobs are accepted and change nothing.
    p = ttv.TVL1Params(n_scales=1, n_warps=1, n_iterations=2)
    q = dataclasses.replace(p, warp_engine="banded", warp_s_cap=0, warp_d_max_x=1,
                            warp_base_max=0, warp_d_max_y=1)
    g = torch.as_tensor(_texture(20, 24, np.random.default_rng(1)))
    assert torch.equal(ttv.tvl1_flow(f, g, p), ttv.tvl1_flow(f, g, q))
