"""The CUDA kernels K1–K3 (Farnebäck) and K5–K6 (TV-L1) against their
plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the repository's conftest, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

pytestmark = pytest.mark.cuda

# Shapes that are not tile multiples, tiny images whose rims overlap,
# and a batch larger than one tile row of frames.
SHAPES = [(3, 7, 9), (2, 45, 67), (5, 96, 128), (1, 33, 250)]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _img(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(shape, dtype=np.float32) * 255)


def _rel(kern, plain):
    return float((kern - plain).abs().max()) / max(float(plain.abs().max()), 1e-30)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5), (12, 2.5)])
def test_poly_exp_kernel(card, shape, n, sigma):
    img = _img(shape, 0).to(card)
    kern = fc.poly_exp_cf(img, n, sigma)
    plain = fb.poly_exp_cf_plain(img, n, sigma)
    # fp32 (2n+1)-tap sums in another order with fused multiply-adds.
    assert _rel(kern, plain) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_update_matrices_kernel(card, shape):
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 1).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 2).to(card), 5, 1.2)
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(b, 2, h, w)).astype(np.float32) * 4
    flow[:, 0, ::5, ::3] = 1e4
    flow[:, 1, 1::7, ::4] = -3e9  # far past int range: the clamp before the cast
    flow = torch.as_tensor(flow).to(card)
    kern = fc.update_matrices_cf(p0, p1, flow)
    plain = fb.update_matrices_cf_plain(p0, p1, flow)
    # Same guard and operations; nvcc fuses multiply-adds.
    assert torch.isfinite(kern).all()
    assert _rel(kern, plain) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("winsize,gaussian", [(15, False), (15, True), (5, False), (31, False)])
def test_update_flow_kernel(card, shape, winsize, gaussian):
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 4).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 4).roll(1, -1).to(card), 5, 1.2)
    m = fb.update_matrices_cf_plain(p0, p1, torch.zeros((b, 2, h, w), device=card))
    kern = fc.update_flow_cf(m, winsize, gaussian)
    plain = fb.update_flow_cf_plain(m, winsize, gaussian)
    # Window sums reordered, then divided by a regularized determinant.
    assert float((kern - plain).abs().max()) <= 1e-3


def test_flow_seq_kernels_match_plain(card):
    rng = np.random.default_rng(5)
    base = rng.random((140, 180)) * 200
    frames = np.stack([np.roll(base, (i, 2 * i), (0, 1)) for i in range(4)])
    frames = torch.as_tensor(frames.astype(np.uint8)).to(card)
    p = FarnebackParams()
    fc.reset_launch_counts()
    kern = fb.farneback_flow_seq(frames, p)
    levels = p.num_levels(140, 180) + 1
    iters = sum(p.iters_at(k) for k in range(levels))
    assert fc.LAUNCHES == {"poly_exp": levels, "update_matrices": iters, "update_flow": iters}
    plain = fb.farneback_flow_seq(frames, p, kernels=False)
    assert float((kern - plain).abs().max()) <= 1e-3  # the path's px bar


def test_wrappers_reject_bad_inputs(card):
    img = _img((2, 20, 30), 6).to(card)
    with pytest.raises(ValueError):
        fc.poly_exp_cf(img.double(), 5, 1.2)
    with pytest.raises(ValueError):
        fc.poly_exp_cf(img.transpose(1, 2), 5, 1.2)
    p = fc.poly_exp_cf(img, 5, 1.2)
    with pytest.raises(ValueError):
        fc.update_matrices_cf(p, p[:1], torch.zeros((2, 2, 20, 30), device=card))
    with pytest.raises(ValueError):
        fc.update_flow_cf(p, 14, False)
    with pytest.raises(ValueError):
        fc.poly_exp_cf(img, 200, 30.0)  # halo past the shared memory of a block


# TV-L1: odd sizes, a width past one tile row, B > 1.
TV_SHAPES = [(3, 7, 9), (2, 45, 67), (2, 33, 250)]


def _flow_off_every_edge(b, h, w, seed):
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=(b, 2, h, w)).astype(np.float32) * 3
    flow[:, 0, :, :2] = -5.5
    flow[:, 0, :, -2:] = 4.25
    flow[:, 1, :2, :] = -3.75
    flow[:, 1, -2:, :] = 6.5
    flow[:, :, ::3, ::4] = 1e4
    flow[:, 1, 1::5, ::3] = -1e4
    return torch.as_tensor(flow)


@pytest.mark.parametrize("shape", TV_SHAPES)
@pytest.mark.parametrize("c", [3, 1])
def test_warp_sample_kernel(card, shape, c):
    b, h, w = shape
    src = _img((b, c, h, w), 7).to(card) / 255.0
    flow = _flow_off_every_edge(b, h, w, 8).to(card)
    tc.reset_launch_counts()
    kern = tc.warp_sample_cf(src, flow)
    assert tc.LAUNCHES["warp_sample"] == 1
    plain = tv.warp_sample_cf_plain(src, flow)
    # The plain float32 operations in their order, without FMA contraction.
    assert _rel(kern, plain) <= 1e-5


def _chain_planes(shape, seed, card):
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.normal(0, 1.0, shape).astype(np.float32)) for _ in range(2))
    rho_c = torch.as_tensor(rng.normal(0, 0.05, shape).astype(np.float32))
    i1wx, i1wy = (torch.as_tensor(rng.normal(0, 0.05, shape).astype(np.float32))
                  for _ in range(2))
    i1wx[:, ::7, ::5] = 0.0  # flat pixels: the 1e-9 floor of |grad I|^2
    i1wy[:, ::7, ::5] = 0.0
    planes = (u, v, rho_c, i1wx, i1wy, i1wx * i1wx + i1wy * i1wy)
    return tuple(t.to(card) for t in planes)


@pytest.mark.parametrize("shape", TV_SHAPES)
@pytest.mark.parametrize("n_iterations", [0, 1, 8, 30])
def test_pd_chain_kernel(card, shape, n_iterations):
    planes = _chain_planes(shape, 9, card)
    p = tv.TVL1Params()
    tc.reset_launch_counts()
    kern = tc.pd_chain(*planes, n_iterations, p.tau, p.lambda_, p.theta)
    chains = int(n_iterations > 0)
    assert tc.LAUNCHES == {"warp_sample": 0, "pd_chain": chains, "pd_iteration": n_iterations}
    plain = tv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta)
    for k, q in zip(kern, plain):
        assert k.shape == shape and torch.isfinite(k).all()
        # One chain's px bar; the same operations without FMA contraction.
        assert float((k - q).abs().max()) <= 1e-4


def test_tvl1_flow_kernels_match_plain(card):
    rng = np.random.default_rng(10)
    base = rng.random((70, 90)) * 200
    prev = torch.as_tensor(np.stack([base, np.roll(base, 1, 0)]).astype(np.uint8)).to(card)
    curr = torch.as_tensor(np.stack([np.roll(base, (1, 2), (0, 1)),
                                     np.roll(base, (-1, 1), (0, 1))]).astype(np.uint8)).to(card)
    p = tv.TVL1Params(n_scales=2, n_warps=3, n_iterations=10)
    tc.reset_launch_counts()
    kern, clips = tv.tvl1_flow(prev, curr, p, return_clip=True)
    assert tc.LAUNCHES == {"warp_sample": 6, "pd_chain": 6, "pd_iteration": 60}
    assert clips.tolist() == [0, 0]
    plain = tv.tvl1_flow(prev, curr, p, kernels=False)
    assert float((kern - plain).abs().max()) <= 1e-3  # the path's px bar


def test_tvl1_wrappers_reject_bad_inputs(card):
    src = torch.zeros((2, 3, 10, 12), device=card)
    flow = torch.zeros((2, 2, 10, 12), device=card)
    with pytest.raises(ValueError):
        tc.warp_sample_cf(src, flow[:1])
    with pytest.raises(ValueError):
        tc.warp_sample_cf(src.double(), flow)
    with pytest.raises(ValueError):
        tc.warp_sample_cf(src.transpose(2, 3), flow)
    planes = [torch.zeros((2, 10, 12), device=card) for _ in range(6)]
    with pytest.raises(ValueError):
        tc.pd_chain(*planes[:5], planes[5][:1], 4, 0.25, 0.3, 0.3)
    with pytest.raises(ValueError):
        tc.pd_chain(*planes[:5], planes[5].cpu(), 4, 0.25, 0.3, 0.3)
