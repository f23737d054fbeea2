"""The port's height sharding (parallel/halo.py, parallel/spatial.py) on CPU
shards against the JAX package's shard_map code on 4 virtual devices, and
against the port's unsharded flow."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from btcs_pnes_optical_flow_tpu.config import FarnebackParams as JFarnebackParams
from btcs_pnes_optical_flow_tpu.ops import cvx as jcvx
from btcs_pnes_optical_flow_tpu.parallel import halo as jhalo
from btcs_pnes_optical_flow_tpu.parallel import mesh as jmesh
from btcs_pnes_optical_flow_tpu.parallel import spatial as jspatial
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda
from btcs_pnes_optical_flow_tpu_torch.parallel import halo, spatial
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh
from tests.test_spatial import _pair

torch.set_num_threads(2)

CPU4 = Mesh(["cpu"] * 4, ("spatial",))


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh(4, axes=("spatial",))


def _jax_blocks(fn, x, jm):
    """fn on each row block of x under JAX's shard_map (height on axis -2)."""
    spec = P(*([None] * (x.ndim - 2)), "spatial", None)
    return np.asarray(jax.shard_map(fn, mesh=jm, in_specs=(spec,), out_specs=spec,
                                    check_vma=False)(jnp.asarray(x)))


@pytest.mark.parametrize("border,halo_rows", [("replicate", 3), ("reflect101", 3),
                                              ("replicate", 12), ("reflect101", 11)])
def test_exchange_rows_matches_jax(jmesh4, rng, border, halo_rows):
    x = rng.normal(size=(2, 3, 48, 20)).astype(np.float32)
    want = _jax_blocks(lambda b: jhalo.exchange_rows(b, halo_rows, "spatial", border), x, jmesh4)
    shards = halo.split_rows(x, CPU4)
    got = torch.cat(halo.exchange_rows(shards, halo_rows, border), dim=-2).numpy()
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        halo.exchange_rows(shards, 13 if border == "replicate" else 12, border)


def test_sharded_stencils_match_jax_and_the_unsharded_ones(jmesh4, rng):
    k = jcvx.gaussian_kernel(11, 1.2)
    x = rng.normal(size=(3, 48, 56)).astype(np.float32)
    from jax.sharding import NamedSharding

    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh4, P(None, "spatial", None)))
    want = np.asarray(jhalo.sep_corr_replicate_sharded(xs, k, k, jmesh4))
    got = halo.gather_rows(halo.sep_corr_replicate_sharded(x, k, k, CPU4), "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)  # JAX test's bar
    assert torch.equal(got, cvx.sep_corr_replicate(torch.as_tensor(x), k, k))

    m = rng.normal(size=(2, 5, 64, 40)).astype(np.float32)
    ms = jax.device_put(jnp.asarray(m), NamedSharding(jmesh4, P(None, None, "spatial", None)))
    want = np.asarray(jhalo.box_sum_replicate_sharded(ms, 15, jmesh4))
    blocks = halo.box_sum_replicate_sharded(halo.split_rows(m, CPU4), 15, CPU4)
    got = halo.gather_rows(blocks, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, cvx.box_sum_replicate(torch.as_tensor(m), 15))


GEOMETRIES = [
    # tests/test_spatial.py's first two: every level sharded on 4 devices.
    (128, 96, JFarnebackParams(levels=1, winsize=7, warp_engine="exact")),
    (192, 256, JFarnebackParams(warp_engine="exact")),
]


@pytest.mark.parametrize("h,w,params", GEOMETRIES)
def test_sharded_flow_matches_jax_and_the_unsharded_flow(jmesh4, h, w, params):
    rng = np.random.default_rng(0)
    prev, curr = _pair(rng, h, w)
    prev = np.stack([prev, np.roll(curr, 3, axis=1)])
    curr = np.stack([curr, np.roll(prev[0], -2, axis=0)])
    want = np.asarray(jspatial.farneback_flow_sharded(prev, curr, params, jmesh4))
    p = from_fields(params)
    farneback_cuda.reset_launch_counts()
    got = spatial.farneback_flow_sharded(prev, curr, p, CPU4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)  # tests/test_spatial.py's bar
    whole = tfb.farneback_flow(torch.as_tensor(prev), torch.as_tensor(curr), p)
    assert float((got - whole).abs().max()) <= 1e-4
    # A plain device list reads as the spatial axis; two 2-D frames squeeze.
    one = spatial.farneback_flow_sharded(prev[0], curr[0], p, [torch.device("cpu")] * 4)
    assert torch.equal(one, got[0])
    assert set(farneback_cuda.LAUNCHES.values()) == {0}  # CPU shards: the plain versions


def test_update_matrices_rows_plain_matches_jax_and_k2(jmesh4, rng):
    """K2's row-offset plain version: on one shard without halo it is K2's
    plain version bit for bit; on 4 shards with a warp_halo band it matches
    JAX's _update_matrices_sharded under shard_map."""
    b, h, w = 2, 64, 40
    r0 = rng.normal(size=(b, 5, h, w)).astype(np.float32)
    r1 = rng.normal(size=(b, 5, h, w)).astype(np.float32)
    flow = (rng.normal(size=(b, 2, h, w)) * 6).astype(np.float32)  # |dy| past the band too
    t0, t1, tf = (torch.as_tensor(a) for a in (r0, r1, flow))
    for prec in ("fp32", "bf16"):
        assert torch.equal(tfb.update_matrices_rows_cf_plain(t0, t1, tf, 0, h, prec),
                           tfb.update_matrices_cf_plain(t0, t1, tf, prec))
        assert torch.equal(farneback_cuda.update_matrices_rows_cf(t0, t1, tf, 0, h, prec),
                           tfb.update_matrices_cf_plain(t0, t1, tf, prec))
    warp_halo = 8
    cl = [np.moveaxis(a, 1, -1) for a in (r0, r1, flow)]  # the JAX layout
    stacked = np.concatenate(cl, axis=-1)

    def local(blk):
        return jspatial._update_matrices_sharded(blk[..., :5], blk[..., 5:10], blk[..., 10:],
                                                 h, warp_halo, "spatial")

    want = np.asarray(jax.shard_map(local, mesh=jmesh4, in_specs=(P(None, "spatial"),),
                                    out_specs=P(None, "spatial"), check_vma=False)(
        jnp.asarray(stacked)))
    r0s, r1s, fs = (halo.split_rows(a, CPU4) for a in (r0, r1, flow))
    got = torch.cat(spatial._update_matrices_sharded(r0s, r1s, fs, h, warp_halo, "fp32"), dim=-2)
    got = np.moveaxis(got.numpy(), 1, -1)
    # JAX's CPU backend contracts multiply-adds (one rounding less).
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        farneback_cuda.update_matrices_rows_cf(t0[:, :, :16], t1[:, :, :17], tf[:, :, :16], 0, h)
    with pytest.raises(ValueError):
        farneback_cuda.update_matrices_rows_cf(t0[:, :, :16], t1[:, :, :16], tf[:, :, :16], 50, h)


def test_sharded_flow_raises_the_jax_errors(jmesh4):
    prev, curr = _pair(np.random.default_rng(0), 100, 72)
    p = JFarnebackParams(levels=1, warp_engine="exact")
    cases = [(p, 100, 64, jmesh4, "must be divisible"),
             (p, 96, 65, jmesh4, "must be divisible by 2"),
             (dataclasses.replace(p, pyr_scale=0.6), 96, 64, jmesh4, "pyr_scale=0.5"),
             (dataclasses.replace(p, use_initial_flow=True), 96, 64, jmesh4, "initial flow"),
             (p, 96, 64, None, "requires a mesh")]
    for params, h, w, jm, msg in cases:
        a, b = prev[None, :h, :w], curr[None, :h, :w]
        with pytest.raises(ValueError, match=msg) as theirs:
            jspatial.farneback_flow_sharded(a, b, params, jm)
        with pytest.raises(ValueError, match=msg) as mine:
            spatial.farneback_flow_sharded(a, b, from_fields(params), None if jm is None else CPU4)
        assert str(mine.value) == str(theirs.value)
