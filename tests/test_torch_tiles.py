"""ROI dispatch of the port on the CPU: K4's plain version (M over a list
of tiles, in place) against the JAX package, the port's ROI boxes against
JAX's, and the ROI-dispatched flow against the full-frame flow."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.config import FarnebackParams
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu.ops.farneback_fused import roi_dispatch_params as j_roi_params
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda

torch.set_num_threads(1)


def _planes(b, h, w, seed, flow_scale=4.0):
    """Channel-last expansions of two random images (JAX, as numpy) and a
    flow with sub-pixel, multi-pixel and far-outside displacements."""
    rng = np.random.default_rng(seed)
    r0 = np.asarray(jfb.poly_exp(jnp.asarray(rng.random((b, h, w), np.float32) * 255), 5, 1.2))
    r1 = np.asarray(jfb.poly_exp(jnp.asarray(rng.random((b, h, w), np.float32) * 255), 5, 1.2))
    flow = (rng.normal(size=(b, h, w, 2)) * flow_scale).astype(np.float32)
    return r0, r1, flow


def _cf(a):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _tile_ids(case, b, h, w, tile):
    th, tw = tile
    n_i, n_j = -(-h // th), -(-w // tw)
    ids = np.arange(b * n_i * n_j)
    ragged = ((ids // n_j % n_i == n_i - 1) & (h % th != 0)) | ((ids % n_j == n_j - 1)
                                                                 & (w % tw != 0))
    return {
        "one": ids[len(ids) // 2 : len(ids) // 2 + 1],
        "random_subset": np.random.default_rng(1).permutation(ids)[: len(ids) // 3],
        "all": ids,
        "ragged_edges": ids[ragged],
    }[case]


@pytest.mark.parametrize("case", ["one", "random_subset", "all", "ragged_edges"])
def test_tiles_plain_matches_jax_exact(case):
    """K4's contract (JAX's test_dual_window_covers_bimodal_flow): the listed tiles
    of the merged M equal the exact engine's update_matrices, and every
    unlisted tile keeps the previous M bit for bit."""
    b, h, w = 2, 45, 70  # ragged in both directions on the 8×32 lattice
    r0, r1, flow = _planes(b, h, w, seed=2)
    ref = np.asarray(jfb.update_matrices(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(flow)))
    ids = _tile_ids(case, b, h, w, tfb.TILE)
    sel = torch.as_tensor(ids.astype(np.int32))
    m_prev = torch.as_tensor(np.random.default_rng(3).normal(size=(b, 5, h, w)).astype(np.float32))
    m = farneback_cuda.update_matrices_tiles_cf(_cf(r0), _cf(r1), _cf(flow), sel,
                                                m_prev.clone(), tfb.TILE)
    listed = tfb.tile_mask(sel, b, h, w, tfb.TILE)[:, None].expand(b, 5, h, w)
    assert int(listed[:, 0].sum()) > 0
    assert torch.equal(m[~listed], m_prev[~listed])
    want = torch.as_tensor(np.moveaxis(ref, -1, 1).copy())
    # The plain version is the port's exact update_matrices on the listed
    # tiles (tests/test_torch_farneback.py holds it to JAX at this bar).
    diff = (m - want).abs()[listed].max()
    assert float(diff) <= 1e-6 * float(want.abs().max())


def test_tiles_plain_matches_jax_banded_tiles_kernel():
    """One follow-up pass of JAX's K4 itself (interpret mode), with no
    earlier window and a flow its window covers, merges the same M as the
    port's plain version on JAX's 32×256 tile lattice."""
    from btcs_pnes_optical_flow_tpu.ops.farneback_pallas import (
        _TH, _TW, pad_for_band, update_matrices_banded_tiles_cf, window_from_residuals)

    b, h, w = 1, 40, 300  # 2×2 tiles of 32×256, ragged both ways
    d_y, d_x, cap = 8, 16, 14
    r0, r1, flow = _planes(b, h, w, seed=4, flow_scale=0.5)
    flow = np.clip(flow, -2.5, 2.5)  # floor displacements in [-3, 2]
    ht, wt = 2 * _TH, 2 * _TW
    n_t = b * 4
    sel = np.array([1, 2], np.int32)
    m_prev = np.random.default_rng(5).normal(size=(b, 5, ht, wt)).astype(np.float32)
    r0t = jnp.pad(jnp.moveaxis(jnp.asarray(r0), -1, 1), ((0, 0), (0, 0), (0, ht - h), (0, wt - w)))
    ft = jnp.pad(jnp.moveaxis(jnp.asarray(flow), -1, 1), ((0, 0), (0, 0), (0, ht - h), (0, wt - w)))
    r1p = pad_for_band(jnp.moveaxis(jnp.asarray(r1), -1, 1), h, w, d_y, d_x)
    # Residual minima of -3 anchor a window that covers floor displacements
    # of [-3, 10] across (cap slots) and [-3, 14] down.
    cur = window_from_residuals(jnp.full((n_t,), -3, jnp.int32),
                                jnp.full((n_t,), -3, jnp.int32), d_y, d_x, 56, cap)
    merged, clip, _, _ = update_matrices_banded_tiles_cf(
        jnp.asarray(sel), jnp.asarray(m_prev), r0t, ft, r1p, h, w,
        cur_window=cur, prev_windows=[], d_max_y=d_y, d_max_x=d_x, s_cap=cap,
        interpret=True)
    assert int(np.asarray(clip).sum()) == 0
    mine = tfb.update_matrices_tiles_cf_plain(
        _cf(r0), _cf(r1), _cf(flow), torch.as_tensor(sel),
        torch.as_tensor(m_prev[:, :, :h, :w].copy()), (_TH, _TW))
    got = np.asarray(merged)[:, :, :h, :w]
    listed = tfb.tile_mask(torch.as_tensor(sel), b, h, w, (_TH, _TW))[:, None]
    listed = listed.expand(b, 5, h, w).numpy()
    assert np.array_equal(got[~listed], mine.numpy()[~listed])
    assert np.array_equal(got[~listed], m_prev[:, :, :h, :w][~listed])
    # The banded kernel's candidate sums against the direct sample.
    np.testing.assert_allclose(mine.numpy()[listed], got[listed], rtol=0, atol=1e-4)


def test_tiles_wrapper_rejects_bad_sel():
    r0, r1, flow = _planes(1, 20, 40, seed=6)
    m = torch.zeros((1, 5, 20, 40))
    args = (_cf(r0), _cf(r1), _cf(flow))
    # 20×40 is 3×2 tiles of 8×32: id 6 is past the end.
    for bad in (torch.tensor([0, 1], dtype=torch.int64), torch.tensor([6], dtype=torch.int32),
                torch.tensor([-1], dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32)):
        with pytest.raises(ValueError):
            farneback_cuda.update_matrices_tiles_cf(*args, bad, m, tfb.TILE)
    with pytest.raises(ValueError):
        farneback_cuda.update_flow_cf(m, 15, False, (0, 21, 0, 40), torch.zeros((1, 2, 20, 40)))


def _mask(h, w, boxes):
    m = np.zeros((h, w), bool)
    for y0, y1, x0, x1 in boxes:
        m[y0:y1, x0:x1] = True
    return m


@pytest.mark.parametrize("h,w,boxes,params", [
    (480, 640, [(90, 400, 120, 520)], FarnebackParams()),
    (192, 300, [(80, 110, 60, 240)], FarnebackParams(levels=2, iterations=2, winsize=7)),
    (240, 320, [(10, 30, 5, 50), (200, 230, 280, 310)], FarnebackParams(iter_schedule=(3, 2, 1))),
    (100, 100, [(0, 100, 0, 100)], FarnebackParams(winsize=5)),
    (64, 80, [], FarnebackParams()),
])
def test_roi_dispatch_params_match_jax(h, w, boxes, params):
    mask = _mask(h, w, boxes)
    mine = tfb.roi_dispatch_params(from_fields(params), h, w, mask)
    assert mine == from_fields(j_roi_params(params, h, w, mask))
    assert mine == tfb.roi_dispatch_params(from_fields(params), h, w, np.stack([mask, mask]))
    if not boxes:
        assert mine.roi_active_px is None


def test_box_tiles_quantize_outward():
    # The bench ROI at level 0: 376×512 px of 480×640 on the 8×32 lattice.
    assert tfb.box_tiles((59, 432, 89, 552), 480, 640) == (7, 54, 2, 18)
    # Covering every tile (or spilling past the level) runs the level whole.
    assert tfb.box_tiles((-4, 249, 11, 309), 240, 320) is None
    assert tfb.box_tiles((0, 480, 0, 640), 480, 640) is None
    ids = tfb.tile_list(2, (3, 5, 1, 2), 100, 70, "cpu")
    assert ids.dtype == torch.int32
    assert ids.tolist() == [(b * 13 + i) * 3 + 1 for b in range(2) for i in (3, 4)]


def _textured(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 100 + 40 * np.sin(xx / 7.0) * np.cos(yy / 9.0) + rng.normal(0, 5, (h, w))
    return np.stack([np.clip(np.roll(base, (i, 2 * i), (0, 1)), 0, 255)
                     for i in range(n)]).astype(np.uint8)


def test_roi_dispatch_matches_full_inside_roi():
    """Port of the JAX package's test_roi_dispatch_matches_full_inside_roi:
    with its small-halo params at 192×300, the ROI-dispatched flow equals
    the full-frame flow bit for bit inside the ROI, is finite everywhere,
    and at least one level runs boxed (K4 + K3 box mode)."""
    h, w = 192, 300
    frames = torch.as_tensor(_textured(3, h, w, seed=0))
    p = from_fields(FarnebackParams(levels=2, iterations=2, winsize=7, warp_d_max_y=4,
                                    warp_d_max_x=4, warp_s_cap=4, warp_base_max=24))
    mask = _mask(h, w, [(80, 110, 60, 240)])
    p_roi = tfb.roi_dispatch_params(p, h, w, mask)
    boxed = [k for k, box in enumerate(p_roi.roi_active_px)
             if tfb.box_tiles(box, *p.level_size(h, w, k)) is not None]
    assert boxed
    full = tfb.farneback_flow_seq(frames, p)
    roi = tfb.farneback_flow_seq(frames, p_roi)
    assert torch.equal(roi[:, 80:110, 60:240], full[:, 80:110, 60:240])
    assert torch.isfinite(roi).all()
    assert not torch.equal(roi, full)  # outside the box the flow kept its init
    # The plain path boxes the same way.
    plain = tfb.farneback_flow_seq(frames, p_roi, kernels=False)
    assert torch.equal(plain, roi)


def test_roi_dispatch_params_leave_a_whole_level_alone():
    """A box covering the level changes nothing: the boxed run equals the
    full-frame run everywhere."""
    frames = torch.as_tensor(_textured(2, 48, 64, seed=1))
    p = from_fields(FarnebackParams(levels=1, iterations=2))
    p_box = dataclasses.replace(p, roi_active_px=((0, 48, 0, 64), (-9, 40, -9, 50)))
    assert torch.equal(tfb.farneback_flow_seq(frames, p_box), tfb.farneback_flow_seq(frames, p))

