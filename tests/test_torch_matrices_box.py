"""K2's box mode (the port of the TPU kernel's ``active`` tile range) on
the CPU: its plain version against JAX's K2 over a tile range (interpret
mode) and against K4's plain version over the box's tiles, the wrapper's
checks, the level loop running boxed levels through it, and the run
length of K2's walk.  Inputs are made with numpy from a seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.config import FarnebackParams
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb
from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
from tests.test_torch_tiles import _cf, _planes, _textured

torch.set_num_threads(1)


def _seq_planes(b, h, w, seed, flow_scale=3.0):
    """Channel-first expansions of a (b+1)-frame sequence (r0 = p[:-1] and
    r1 = p[1:] share its storage, as in the level loop), an independent
    second expansion, and a flow with multi-pixel and off-image targets."""
    rng = np.random.default_rng(seed)
    p = tfb.poly_exp_cf_plain(torch.as_tensor(rng.random((b + 1, h, w), np.float32) * 255), 5, 1.2)
    other = tfb.poly_exp_cf_plain(torch.as_tensor(rng.random((b, h, w), np.float32) * 255), 5, 1.2)
    flow = torch.as_tensor((rng.normal(size=(b, 2, h, w)) * flow_scale).astype(np.float32))
    flow[:, 0, ::7, ::5] = 1e4
    return p, other, flow


# (b, h, w, box): boxes on the 8×32 lattice of ragged levels, at each edge,
# one tile, the whole level, and one off the lattice.
BOXES = [
    (2, 45, 70, (8, 24, 32, 64)),    # interior
    (2, 45, 70, (0, 16, 0, 32)),     # top-left corner
    (2, 45, 70, (40, 45, 64, 70)),   # bottom-right ragged tile
    (1, 45, 70, (0, 45, 32, 70)),    # right edge, full height, B = 1
    (3, 20, 96, (16, 20, 0, 96)),    # bottom edge, full width
    (1, 8, 32, (0, 8, 0, 32)),       # the whole level, one tile
    (2, 33, 50, (3, 30, 5, 47)),     # off the lattice
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("alias", [True, False])
@pytest.mark.parametrize("b,h,w,box", BOXES)
def test_box_mode_writes_the_box_and_nothing_else(b, h, w, box, alias, precision):
    """The wrapper on CPU tensors: M at the box's pixels is K2's M of the
    whole level, bit for bit, and M outside the box is left as it was,
    whether r1 is r0 shifted by one frame or an independent expansion."""
    p, other, flow = _seq_planes(b, h, w, seed=b * 100 + h)
    r0, r1 = p[:-1], (p[1:] if alias else other)
    y0, y1, x0, x1 = box
    m_prev = torch.as_tensor(np.random.default_rng(7).normal(size=(b, 5, h, w)).astype(np.float32))
    out = m_prev.clone()
    got = fc.update_matrices_cf(r0, r1, flow, precision, box, out)
    assert got is out
    whole = fc.update_matrices_cf(r0, r1, flow, precision)
    inside = torch.zeros((b, 5, h, w), dtype=torch.bool)
    inside[:, :, y0:y1, x0:x1] = True
    assert torch.equal(out[inside], whole[inside])
    assert torch.equal(out[~inside], m_prev[~inside])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,roi", [(2, 45, 70, (10, 30, 40, 60)), (1, 100, 200, (0, 9, 150, 200)),
                                       (3, 24, 64, (20, 24, 0, 5))])
def test_box_plain_equals_k4_plain_over_the_box_tiles(b, h, w, roi, precision):
    """The level loop's box (an ROI box quantised to the tile lattice):
    K2's box mode equals K4's plain version over the box's tile list bit
    for bit, on an M of earlier values."""
    p, _, flow = _seq_planes(b, h, w, seed=11)
    r0, r1 = p[:-1], p[1:]
    tiles = tfb.box_tiles(roi, h, w)
    assert tiles is not None
    box = tfb.tile_box(tiles, h, w)
    m_prev = torch.as_tensor(np.random.default_rng(12).normal(size=(b, 5, h, w)).astype(np.float32))
    mine = tfb.update_matrices_cf_plain(r0, r1, flow, precision, box, m_prev.clone())
    k4 = tfb.update_matrices_tiles_cf_plain(r0, r1, flow, tfb.tile_list(b, tiles, h, w, "cpu"),
                                            m_prev.clone(), tfb.TILE, precision)
    assert torch.equal(mine, k4)


def test_box_plain_matches_jax_k2_over_an_active_tile_range():
    """JAX's K2 itself (``update_matrices_banded_cf``, interpret mode) over
    an ``active`` tile range of its 32×256 lattice, with a flow its band
    covers (clip count 0): its compact M equals the port's box mode over
    the same pixels, within the banded candidate sums' bar of
    ``tests/test_torch_tiles.py``; the port leaves M outside the box."""
    from btcs_pnes_optical_flow_tpu.ops.farneback_pallas import (
        _TH, _TW, pad_for_band, update_matrices_banded_cf)

    b, h, w = 1, 40, 300  # 2×2 tiles of 32×256, ragged both ways
    d_y, d_x = 4, 4  # floor displacements in [-3, 2] around a base of 0
    r0, r1, flow = _planes(b, h, w, seed=8, flow_scale=0.5)
    flow = np.clip(flow, -2.5, 2.5)
    act = (1, 2, 1, 2)  # the ragged corner tile: rows 32-39, columns 256-299
    ht, wt = 2 * _TH, 2 * _TW
    pad = ((0, 0), (0, 0), (0, ht - h), (0, wt - w))
    r0t = jnp.pad(jnp.moveaxis(jnp.asarray(r0), -1, 1), pad)
    ft = jnp.pad(jnp.moveaxis(jnp.asarray(flow), -1, 1), pad, mode="edge")
    r1p = pad_for_band(jnp.moveaxis(jnp.asarray(r1), -1, 1), h, w, d_y, d_x)
    m, clip, _ = update_matrices_banded_cf(r0t, ft[:, :, _TH:, _TW:], r1p, h, w, d_max_y=d_y,
                                           d_max_x=d_x, active=act, interpret=True)
    assert int(np.asarray(clip).sum()) == 0
    box = (_TH, h, _TW, w)
    m_prev = torch.as_tensor(np.random.default_rng(9).normal(size=(b, 5, h, w)).astype(np.float32))
    mine = fc.update_matrices_cf(_cf(r0), _cf(r1), _cf(flow), "fp32", box, m_prev.clone())
    got = np.asarray(m)[:, :, : h - _TH, : w - _TW]
    np.testing.assert_allclose(mine[:, :, _TH:, _TW:].numpy(), got, rtol=0, atol=1e-4)
    inside = torch.zeros_like(m_prev, dtype=torch.bool)
    inside[:, :, _TH:, _TW:] = True
    assert torch.equal(mine[~inside], m_prev[~inside])


def test_wrapper_checks_the_box_on_the_host():
    p, _, flow = _seq_planes(1, 20, 40, seed=13)
    r0, r1 = p[:-1], p[1:]
    m = torch.zeros((1, 5, 20, 40))
    for bad in ((0, 0, 0, 40), (0, 20, 10, 10), (-1, 20, 0, 40), (0, 21, 0, 40), (0, 20, 0, 41),
                (5, 3, 0, 40)):
        with pytest.raises(ValueError, match="empty or outside"):
            fc.update_matrices_cf(r0, r1, flow, "fp32", bad, m)
    with pytest.raises(ValueError, match="go together"):
        fc.update_matrices_cf(r0, r1, flow, "fp32", (0, 8, 0, 32))
    with pytest.raises(ValueError, match="go together"):
        fc.update_matrices_cf(r0, r1, flow, "fp32", None, m)
    with pytest.raises(ValueError, match="precision"):
        fc.update_matrices_cf(r0, r1, flow, "fp16", (0, 8, 0, 32), m)


def _mask(h, w, box):
    m = np.zeros((h, w), bool)
    m[box[0]:box[1], box[2]:box[3]] = True
    return m


def test_roi_flow_seq_matches_jax_exact_engine_inside_the_roi():
    """farneback_flow_seq with ROI boxes (level 0 boxed: K2 and K3 in box
    mode) against the JAX exact engine's full-frame flow inside the ROI,
    at the port's flow bar against JAX (``test_torch_farneback.py``)."""
    h, w = 96, 128
    frames = _textured(3, h, w, seed=3)
    p = FarnebackParams()
    roi = (40, 56, 50, 78)
    p_roi = tfb.roi_dispatch_params(from_fields(p), h, w, _mask(h, w, roi))
    assert tfb.box_tiles(p_roi.roi_active_px[0], h, w) is not None
    mine = tfb.farneback_flow_seq(torch.as_tensor(frames), p_roi).numpy()
    ref = np.asarray(jfb.farneback_flow_seq(jnp.asarray(frames), p))
    y0, y1, x0, x1 = roi
    assert np.abs(mine[:, y0:y1, x0:x1] - ref[:, y0:y1, x0:x1]).max() <= 1e-3
    assert np.isfinite(mine).all()


def test_boxed_levels_run_k2_box_and_never_k4(monkeypatch):
    """The calls a boxed chunk makes, counted on the CPU where the wrappers
    take their plain versions: every iteration of a boxed level is one K2
    call in box mode (the level's tile-quantised box, into one M) and one
    K3 call in box mode; no K4 call; unboxed levels call K2 whole."""
    h, w = 192, 300
    p = from_fields(FarnebackParams(levels=2, iterations=2, winsize=7))
    p_roi = tfb.roi_dispatch_params(p, h, w, _mask(h, w, (80, 110, 60, 240)))
    boxes = {k: tfb.box_tiles(p_roi.roi_active_px[k], *p.level_size(h, w, k))
             for k in range(p.num_levels(h, w) + 1)}
    calls = []
    um = fc.update_matrices_cf

    def spy(r0, r1, flow, precision="fp32", box=None, out=None):
        calls.append((r0.shape[-2:], box, None if out is None else out.data_ptr()))
        return um(r0, r1, flow, precision, box, out)

    def no_k4(*args, **kwargs):
        raise AssertionError("the level loop ran K4")

    monkeypatch.setattr(fc, "update_matrices_cf", spy)
    monkeypatch.setattr(fc, "update_matrices_tiles_cf", no_k4)
    tfb.farneback_flow_seq(torch.as_tensor(_textured(3, h, w, seed=4)), p_roi)
    want = []
    for k in range(p.num_levels(h, w), -1, -1):
        hk, wk = p.level_size(h, w, k)
        box = None if boxes[k] is None else tfb.tile_box(boxes[k], hk, wk)
        want += [((hk, wk), box)] * p.iters_at(k)
    assert [(tuple(s), b) for s, b, _ in calls] == want
    assert sum(b is not None for _, b, _ in calls) > 0
    # One M per boxed level, rewritten in place by each iteration.
    for k in boxes:
        ptrs = {ptr for s, b, ptr in calls if b is not None and tuple(s) == p.level_size(h, w, k)}
        assert len(ptrs) <= 1


@pytest.mark.parametrize("n_tiles,batch,resident,want", [
    (3520, 64, 660, 21),   # 1080p level-0 ROI box at 64 pairs: 4 runs
    (136, 64, 660, 1),     # 1080p level 3 (135×240): a run per pair
    (752, 256, 660, 17),   # 480p level-0 ROI box at 256 pairs: 16 runs
    (10 ** 6, 7, 660, 7),  # tiles enough: one run of every pair
    (1, 5, 660, 1),        # one tile: a run per pair
])
def test_walk_run_length_fills_the_card(n_tiles, batch, resident, want):
    ppr = fc.pairs_per_run(n_tiles, batch, resident)
    assert ppr == want
    runs = -(-batch // ppr)
    assert 1 <= ppr <= batch and (runs - 1) * ppr < batch
    # The grid reaches WALK_WAVES times the resident blocks where the
    # pairs allow; one more pair per run would leave it short.
    assert n_tiles * runs >= min(fc.WALK_WAVES * resident, n_tiles * batch)
    if ppr < batch:
        assert n_tiles * (batch // (ppr + 1)) < fc.WALK_WAVES * resident


def test_box_plain_on_a_whole_level_is_k2():
    b, h, w = 2, 17, 40
    p, _, flow = _seq_planes(b, h, w, seed=14)
    out = torch.full((b, 5, h, w), float("nan"))
    got = tfb.update_matrices_cf_plain(p[:-1], p[1:], flow, "bf16", (0, h, 0, w), out)
    assert torch.equal(got, tfb.update_matrices_cf_plain(p[:-1], p[1:], flow, "bf16"))


def test_roi_dispatch_bf16_schedule_equals_full_frame_inside_the_box():
    """The bench's bf16 flow config with ROI boxes: the boxed levels (K2 bf16
    in box mode) give the full-frame flow inside the ROI bit for bit."""
    h, w = 192, 300
    frames = torch.as_tensor(_textured(3, h, w, seed=5))
    p = from_fields(dataclasses.replace(FarnebackParams(levels=2, iterations=2, winsize=7),
                                        warp_precision="bf16", iter_schedule=(2, 2, 1)))
    p_roi = tfb.roi_dispatch_params(p, h, w, _mask(h, w, (80, 110, 60, 240)))
    roi = tfb.farneback_flow_seq(frames, p_roi)
    full = tfb.farneback_flow_seq(frames, p)
    assert torch.equal(roi[:, 80:110, 60:240], full[:, 80:110, 60:240])
