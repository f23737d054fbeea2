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


RESOLUTION_SHAPES = [(480, 640), (540, 960), (720, 1280), (1080, 1920), (112, 896),
                     (128, 1024)]


@pytest.mark.parametrize("shape", RESOLUTION_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pd_engine_resolution_per_level_matches_jax(shape):
    """The fixed-length chain is narrowed per pyramid level exactly as JAX
    ``ops/tvl1.py:177`` narrows its resident engine."""
    for n in (8, 30, 60):
        mine_p, ref_p = ttv.TVL1Params(n_iterations=n), jtv.TVL1Params(n_iterations=n)
        sizes = ttv._pyramid_sizes(*shape, mine_p)
        assert sizes == jtv._pyramid_sizes(*shape, ref_p)
        for h, w in sizes:
            assert ttv._resident_ok(h, w, mine_p) == jtv._resident_ok(h, w, ref_p), (h, w, n)
    # At the default 30 iterations, the levels that take the epsilon loop.
    p = ttv.TVL1Params()
    falls = [i for i, s in enumerate(ttv._pyramid_sizes(*shape, p)) if not ttv._resident_ok(*s, p)]
    assert falls == {(540, 960): [0], (720, 1280): [0], (1080, 1920): [0, 1],
                     (112, 896): [0], (128, 1024): [0]}.get(shape, [])


def test_tvl1_flow_resident_falls_back_per_level_as_jax(rng, monkeypatch):
    """At 112×896 the JAX package runs its epsilon loop even when asked for
    the resident engine (no Pallas call); the port takes the same loop
    there, and the fixed-length chain one level down."""
    f0 = _texture(112, 896, rng)
    f1 = _texture(112, 896, rng, shift=(0.8, 0.4))
    kw = dict(pd_engine="resident", n_scales=1, n_warps=1)
    ref = np.asarray(jtv.tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), jtv.TVL1Params(**kw)))
    mine = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1), ttv.TVL1Params(**kw))
    assert mine.shape == (112, 896, 2)
    # Default epsilon: the early exit's mean is taken in another order; the
    # flow's px bar.
    assert np.abs(mine.numpy() - ref).max() <= 1e-3
    # Which levels reach the chain's wrapper: only 56×448 of two levels.
    chain, shapes = tvl1_cuda.pd_chain, []
    monkeypatch.setattr(tvl1_cuda, "pd_chain",
                        lambda u, *a, **k: shapes.append(tuple(u.shape)) or chain(u, *a, **k))
    ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1),
                  ttv.TVL1Params(pd_engine="resident", n_scales=2, n_warps=2))
    assert shapes == [(1, 56, 448)] * 2


def _region_step(region, gy, gx, h, w, j, p):
    """Iteration j of K6's decomposition on one staged region: region =
    (u, v, [p11, p12, p21, p22], rho_c, I1wx, I1wy, |∇I|²) over the image
    rows gy and columns gx (clamped loads), the edge rules at the image's
    edges by global index, a neighbour past the region's edge replaced by
    any value (here the pixel itself; the kernels read the next or previous
    row), and only the kernels' rows computed (u, v on rows j … RH−j, the
    duals on rows j … RH−1−j).  Returns (u, v, duals)."""
    uu, vv, ps, rc, wx, wy, gs = region
    l_t, tau_theta, theta = p.lambda_ * p.theta, p.tau / p.theta, p.theta
    nig = -1.0 / torch.clamp_min(gs, 1e-9)
    wx_igs, wy_igs = wx * nig, wy * nig
    yy, xx = gy[:, None], gx[None, :]
    rows = torch.arange(len(gy))[:, None]
    rh = len(gy)

    def div(px, py):
        left = torch.cat([px[..., :1], px[..., :-1]], -1)
        up = torch.cat([py[..., :1, :], py[..., :-1, :]], -2)
        dx = torch.where(xx == 0, px, torch.where(xx == w - 1, 0.0, px) - left)
        dy = torch.where(yy == 0, py, torch.where(yy == h - 1, 0.0, py) - up)
        return dx + dy

    def grad(f):
        right = torch.cat([f[..., 1:], f[..., -1:]], -1)
        down = torch.cat([f[..., 1:, :], f[..., -1:, :]], -2)
        return (torch.where(xx < w - 1, right - f, 0.0),
                torch.where(yy < h - 1, down - f, 0.0))

    rho = rc + wx * uu + wy * vv
    lo = rho < -l_t * gs
    hi = rho > l_t * gs
    d1 = torch.where(lo, l_t * wx, torch.where(hi, -l_t * wx, rho * wx_igs))
    d2 = torch.where(lo, l_t * wy, torch.where(hi, -l_t * wy, rho * wy_igs))
    rows_a = (rows >= j) & (rows <= rh - j)
    uu = torch.where(rows_a, uu + d1 + theta * div(ps[0], ps[1]), uu)
    vv = torch.where(rows_a, vv + d2 + theta * div(ps[2], ps[3]), vv)
    ux, uy = grad(uu)
    vx, vy = grad(vv)
    r_u = 1.0 / (1.0 + tau_theta * torch.sqrt(ux * ux + uy * uy))
    r_v = 1.0 / (1.0 + tau_theta * torch.sqrt(vx * vx + vy * vy))
    upd = ((ps[0] + tau_theta * ux) * r_u, (ps[1] + tau_theta * uy) * r_u,
           (ps[2] + tau_theta * vx) * r_v, (ps[3] + tau_theta * vy) * r_v)
    rows_b = (rows >= j) & (rows <= rh - 1 - j)
    return uu, vv, [torch.where(rows_b, n_, o_) for n_, o_ in zip(upd, ps)]


def _tiles(planes, duals, d, tile):
    """Each tile of the image grown by d on each side, clamped: yields
    (ty0, tx0, gy, gx, staged region) with the duals zero when None."""
    u = planes[0]
    b, h, w = u.shape
    th, tw = tile
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            gy = torch.arange(ty0 - d, ty0 + th + d)
            gx = torch.arange(tx0 - d, tx0 + tw + d)
            ry, rx = gy.clamp(0, h - 1), gx.clamp(0, w - 1)

            def crop(t):
                return t[:, ry][:, :, rx]

            uu, vv, rc, wx, wy, gs = map(crop, planes)
            ps = [crop(q) for q in duals] if duals else [torch.zeros_like(uu)] * 4
            yield ty0, tx0, gy, gx, (uu, vv, ps, rc, wx, wy, gs)


def _blocked_chain(planes, n_iterations, p, depth, tile):
    """K6's decomposition (csrc/tvl1.cu pd_block_kernel) in plain PyTorch:
    each launch of ``pd_schedule`` stages every tile grown by its depth d
    on each side (clamped loads), runs d iterations on that region
    (``_region_step``), then crops the tile and stitches it into the next
    launch's state."""
    u, v, rho_c, i1wx, i1wy, grad_sq = planes
    b, h, w = u.shape
    th, tw = tile
    duals = None  # zero in the first launch
    for d in tvl1_cuda.pd_schedule(n_iterations, depth):
        new = [torch.empty_like(u) for _ in range(6)]
        for ty0, tx0, gy, gx, region in _tiles((u, v, rho_c, i1wx, i1wy, grad_sq), duals, d,
                                               tile):
            uu, vv, ps = region[:3]
            for j in range(1, d + 1):
                uu, vv, ps = _region_step((uu, vv, ps, *region[3:]), gy, gx, h, w, j, p)
            hh, ww = min(th, h - ty0), min(tw, w - tx0)
            for dst, src in zip(new, (uu, vv, *ps)):
                dst[:, ty0:ty0 + hh, tx0:tx0 + ww] = src[:, d:d + hh, d:d + ww]
        u, v, duals = new[0], new[1], new[2:]
    return u, v


def _eps_step_chain(planes, n_iterations, p, epsilon, tile):
    """K6's ε step (csrc/tvl1.cu pd_eps_step_kernel) and the loop of its
    wrapper (ops/tvl1_cuda.py pd_eps_chain) in plain PyTorch: each step
    stages every tile grown by one pixel, runs one iteration there, and
    writes the tile's u_out = u_new where the pair is still active (else
    u), the duals of u_new whatever the mask, and the squared update; the
    loop then stops a pair whose mean squared update is below epsilon²."""
    u, v, rho_c, i1wx, i1wy, grad_sq = planes
    b, h, w = u.shape
    th, tw = tile
    active = torch.ones((b,), dtype=torch.bool)
    duals = None
    for _ in range(n_iterations):
        keep = active[:, None, None]
        new = [torch.empty_like(u) for _ in range(7)]
        for ty0, tx0, gy, gx, region in _tiles((u, v, rho_c, i1wx, i1wy, grad_sq), duals, 1,
                                               tile):
            uu, vv, ps = _region_step(region, gy, gx, h, w, 1, p)
            u0, v0 = region[:2]
            outs = (torch.where(keep, uu, u0), torch.where(keep, vv, v0), *ps,
                    (uu - u0) * (uu - u0) + (vv - v0) * (vv - v0))
            hh, ww = min(th, h - ty0), min(tw, w - tx0)
            for dst, src in zip(new, outs):
                dst[:, ty0:ty0 + hh, tx0:tx0 + ww] = src[:, 1:1 + hh, 1:1 + ww]
        u, v, duals, sq = new[0], new[1], new[2:6], new[6]
        if epsilon > 0:
            active = active & ~(sq.mean(dim=(-2, -1)) < epsilon * epsilon)
            if not bool(active.any()):
                break
    return u, v


@pytest.mark.parametrize("shape,tile,depth,n_iterations", [
    ((2, 45, 67), (8, 16), 3, 7),      # ragged tiles; D does not divide n
    ((2, 45, 67), (11, 22), 2, 5),     # last tiles one pixel wide, next to the edges
    ((2, 45, 67), (15, 67), 4, 8),     # tile edges on the image edges; D divides n
    ((2, 45, 67), (8, 16), 1, 3),      # the depth of one iteration per launch
    ((1, 33, 250), (32, 64), 8, 30),   # the kernel's tile and the default schedule
    ((1, 33, 250), (32, 64), 10, 7),   # D > n: one launch of n
], ids=["ragged", "edge_next", "edge_on", "depth1", "default", "depth_past_n"])
def test_blocked_chain_emulation_equals_plain(shape, tile, depth, n_iterations, rng):
    """The temporal blocking of K6 proves its halo on the CPU: tiles grown
    by the launch's depth, D iterations, cropped and stitched, give the
    plain chain bit for bit."""
    b, h, w = shape
    planes = tuple(map(torch.as_tensor, _chain_inputs(rng, b, h, w)))
    p = ttv.TVL1Params()
    ref = ttv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta)
    mine = _blocked_chain(planes, n_iterations, p, depth, tile)
    assert torch.equal(mine[0], ref[0]) and torch.equal(mine[1], ref[1])


def _eps_inputs(rng, b, h, w):
    """Chain inputs whose pairs converge at different speeds: pair 0 has no
    image gradient (its first step moves nothing), the others gradients
    scaled from 0.1 to 3 times."""
    u, v, rho_c, i1wx, i1wy, _ = map(torch.as_tensor, _chain_inputs(rng, b, h, w))
    scale = torch.logspace(-1, 0.5, b)[:, None, None]
    scale[0] = 0.0
    i1wx, i1wy, rho_c = i1wx * scale, i1wy * scale, rho_c * scale
    return u, v, rho_c, i1wx, i1wy, i1wx * i1wx + i1wy * i1wy


@pytest.mark.parametrize("shape,tile,epsilon,n_iterations", [
    ((4, 45, 67), (8, 16), 1e-3, 6),    # ragged tiles; pairs stop at different steps
    ((4, 45, 67), (11, 22), 0.0, 3),    # no stop; last tiles one pixel wide
    ((3, 33, 250), (32, 64), 1e-3, 4),  # the kernel's tile
    ((3, 33, 250), (32, 64), 1.0, 4),   # every pair stops at the first step
], ids=["ragged", "no_stop", "kernel_tile", "first_step"])
def test_eps_step_emulation_equals_the_plain_loop(shape, tile, epsilon, n_iterations, rng):
    """The ε step's decomposition proves itself on the CPU: one-pixel halos,
    the mask taken before the stop test, the duals of stopped pairs still
    stepped and the stop read from the squared-update plane give the plain
    ε loop bit for bit."""
    planes = _eps_inputs(rng, *shape)
    p = ttv.TVL1Params()
    ref = ttv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta, epsilon=epsilon)
    mine = _eps_step_chain(planes, n_iterations, p, epsilon, tile)
    assert torch.equal(mine[0], ref[0]) and torch.equal(mine[1], ref[1])


@pytest.mark.parametrize("epsilon", [0.0, 1e-3, 1.0])
@pytest.mark.parametrize("n_iterations", [0, 1, 5])
def test_pd_eps_chain_on_the_cpu_is_the_plain_loop(epsilon, n_iterations, rng):
    planes = _eps_inputs(rng, 3, 24, 40)
    p = ttv.TVL1Params()
    tvl1_cuda.reset_launch_counts()
    mine = tvl1_cuda.pd_eps_chain(*planes, n_iterations, p.tau, p.lambda_, p.theta, epsilon)
    ref = ttv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta, epsilon=epsilon)
    assert torch.equal(mine[0], ref[0]) and torch.equal(mine[1], ref[1])
    assert set(tvl1_cuda.LAUNCHES.values()) == {0}


def test_the_epsilon_loop_goes_through_the_step_wrapper(rng, monkeypatch):
    """tvl1_flow sends every ε loop to tvl1_cuda.pd_eps_chain, with the
    level's ε, and kernels=False to the plain loop; the flow is the same."""
    f0 = _texture(40, 56, rng)
    f1 = _texture(40, 56, rng, shift=(0.8, 0.4))
    p = ttv.TVL1Params(n_scales=2, n_warps=2, n_iterations=6)
    step, calls = tvl1_cuda.pd_eps_chain, []
    monkeypatch.setattr(tvl1_cuda, "pd_eps_chain",
                        lambda u, *a, epsilon: calls.append((tuple(u.shape), epsilon))
                        or step(u, *a, epsilon))
    mine = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1), p)
    assert calls == [((1, 20, 28), p.epsilon)] * 2 + [((1, 40, 56), p.epsilon)] * 2
    plain = ttv.tvl1_flow(torch.as_tensor(f0), torch.as_tensor(f1), p, kernels=False)
    assert len(calls) == 4 and torch.equal(mine, plain)


def test_pd_schedule():
    assert tvl1_cuda.pd_schedule(30) == (8, 8, 8, 6)
    assert tvl1_cuda.pd_schedule(30, 10) == (10, 10, 10)
    assert tvl1_cuda.pd_schedule(7, 8) == (7,)
    assert tvl1_cuda.pd_schedule(0) == () == tvl1_cuda.pd_schedule(-3, 1)
    for depth in tvl1_cuda.PD_DEPTHS:
        for n in range(0, 61):
            s = tvl1_cuda.pd_schedule(n, depth)
            assert sum(s) == n and len(s) == -(-n // depth)
            assert all(1 <= d <= depth for d in s) and list(s) == sorted(s, reverse=True)
    for bad in (0, 11, 16):
        with pytest.raises(ValueError):
            tvl1_cuda.pd_schedule(30, bad)


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
