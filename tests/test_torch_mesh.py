"""The port's mesh (parallel/mesh.py) and its cohort paths over a mesh of
CPU shards, against the JAX package's sharded cohort on its 8-device CPU
mesh and against the port's one-device runs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams as JFarnebackParams
from btcs_pnes_optical_flow_tpu.config import MetricParams as JMetricParams
from btcs_pnes_optical_flow_tpu.config import PCAParams as JPCAParams
from btcs_pnes_optical_flow_tpu.config import PipelineConfig as JPipelineConfig
from btcs_pnes_optical_flow_tpu.dataio import contracts as jcontracts
from btcs_pnes_optical_flow_tpu.parallel import cohort as jcohort
from btcs_pnes_optical_flow_tpu.parallel import mesh as jmesh
from btcs_pnes_optical_flow_tpu.parallel import runner as jrunner
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.parallel import cohort
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import (
    Mesh,
    cohort_sharding,
    make_mesh,
    replicated,
)
from btcs_pnes_optical_flow_tpu_torch.parallel.runner import run_cohort
from tests.test_torch_cohort import ROI, _assert_rows_equal, _clips, _items

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh.make_mesh(8, axes=("data",))


def test_mesh_layouts():
    m = Mesh([CPU] * 4, ("data", "spatial"), (2, 2))
    assert m == (CPU,) * 4 and m.size == 4 and m.shape == {"data": 2, "spatial": 2}
    assert m.axis_devices("data") == (CPU, CPU) and len(m.axis_devices("spatial")) == 2
    with pytest.raises(ValueError):
        m.axis_devices("model")
    with pytest.raises(ValueError):
        Mesh([CPU] * 3, ("data", "spatial"), (2, 2))
    x = torch.arange(10.0).reshape(5, 2)
    blocks = cohort_sharding(Mesh([CPU] * 2), x)
    assert [tuple(b.shape) for b in blocks] == [(3, 2), (2, 2)]
    assert torch.equal(torch.cat(blocks), x)
    assert all(torch.equal(c, x) for c in replicated(Mesh([CPU] * 3), x))
    with pytest.raises(ValueError):
        make_mesh(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, axes=("data", "spatial"))


def test_run_cohort_over_a_cpu_mesh_matches_jax_and_one_device(jmesh8):
    """tests/test_parallel.py's cohort (8 videos of 33 frames, chunks of 16,
    an invalid-axes window in video 3) over four CPU shards against JAX's
    run_cohort over its 8-device mesh, at that test's rtol 1e-6 (under the
    default 10 s window the 33-frame metrics are NaN with their status, so
    the bar holds the status, Peak_n, error and NaN columns); then, with a
    2 s window and finite metrics, the 4-shard, uneven 3-shard and
    one-device runs give equal rows."""
    clips = _clips(8, 33)
    jcfg = JPipelineConfig()
    ref = jrunner.run_cohort([jrunner.CohortItem(n, c, jcontracts.Skeleton(*s), [ROI])
                              for n, c, s in clips], jcfg, chunk_pairs=16, mesh=jmesh8)
    cfg = from_fields(jcfg)
    four = run_cohort(_items(clips), cfg, chunk_pairs=16, mesh=Mesh([CPU] * 4), device="cpu")
    assert list(four[0]) == list(ref.columns)
    _assert_rows_equal(ref.to_dict("records"), four, rtol=1e-6)

    cfg = from_fields(JPipelineConfig(metrics=JMetricParams(window_sec=2.0)))
    clips = _clips(5, 61)
    one = run_cohort(_items(clips), cfg, chunk_pairs=16, mesh=Mesh([CPU]), device="cpu")
    four = run_cohort(_items(clips), cfg, chunk_pairs=16, mesh=Mesh([CPU] * 4), device="cpu")
    three = run_cohort(_items(clips, torch.as_tensor), cfg, chunk_pairs=16,
                       mesh=Mesh([CPU] * 3), device="cpu")
    assert all(r["status"] == 0 and np.isfinite(r["PC1_area_0_10"]) for r in one)
    assert repr(four) == repr(one) == repr(three)


def test_cohort_step_over_a_cpu_mesh_matches_jax(jmesh8, rng):
    """tests/test_parallel.py's sharded cohort step: 8 videos over the JAX
    package's 8 devices and over the port's 4 CPU shards."""
    v, b, h, w = 8, 3, 40, 48
    prev = rng.integers(0, 255, (v, b, h, w)).astype(np.uint8)
    curr = np.clip(prev.astype(int) + rng.integers(-20, 20, prev.shape), 0, 255).astype(np.uint8)
    theta = rng.normal(size=(v, b))
    ex = np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)
    ey = np.stack([-np.sin(theta), np.cos(theta)], axis=-1).astype(np.float32)
    masks = np.zeros((1, h, w), bool)
    masks[0, 8:32, 8:40] = True
    t_valid = np.ones((v, b), bool)
    t_valid[5, 1] = False
    params = JFarnebackParams(levels=1, winsize=7, poly_n=5)
    pca = JPCAParams(win_sec=0.1, step_sec=0.05, max_finite_runs=4)
    args = (prev, curr, ex, ey, masks, t_valid)
    ref = jcohort.cohort_step(*jcohort.shard_cohort_inputs(jmesh8, *(jnp.asarray(a)
                                                                     for a in args)),
                              params, pca)
    mesh4 = Mesh([CPU] * 4)
    placed = cohort.shard_cohort_inputs(mesh4, *args)
    assert [len(p) for p in placed] == [4] * 6 and tuple(placed[4][0].shape) == (1, h, w)
    out = cohort.cohort_step(*placed, from_fields(params), from_fields(pca), mesh=mesh4)
    for name in ("vx", "vy", "mag", "cohort_mean_mag"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, equal_nan=True)
    assert out.pc1.shape == ref.pc1.shape == (v, 1, b + 1)
    assert np.array_equal(np.isnan(out.pc1.numpy()), np.isnan(np.asarray(ref.pc1)))
    one = cohort.cohort_step(*args, from_fields(params), from_fields(pca), device="cpu")
    for a, m in zip(one, out):
        torch.testing.assert_close(m, a, rtol=1e-6, atol=1e-7, equal_nan=True)
    with pytest.raises(ValueError):
        cohort.cohort_step(*args, device="cpu", mesh=mesh4)
