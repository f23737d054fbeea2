"""The CUDA kernels K1–K4 (Farnebäck) and K5–K6 (TV-L1) against their
plain PyTorch versions, the pipeline's flow stage against the CPU and its
CSV files, the associative band-pass, PC1 and streaming PC1 against the
CPU, the cohort runner's paths against each other and the CLIs against
the CPU, on the card.

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

# Shapes that are not multiples of K1's and K3's 32×64 tile, tiny images
# whose rims overlap, widths that are and are not multiples of 4 (16-byte
# and 4-byte copies), and one with interior tiles.
SHAPES = [(3, 7, 9), (2, 45, 67), (5, 96, 128), (1, 33, 250), (2, 100, 256)]


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
@pytest.mark.parametrize("n,sigma", [(2, 0.9), (3, 1.1), (5, 1.2), (7, 1.5), (8, 1.8),
                                     (12, 2.5)])
def test_poly_exp_kernel(card, shape, n, sigma):
    img = _img(shape, 0).to(card)
    kern = fc.poly_exp_cf(img, n, sigma)
    plain = fb.poly_exp_cf_plain(img, n, sigma)
    # Bit-equal: the plain fp32 tap sums in their order, without FMA
    # contraction (n = 12 runs the run-time-radius instance).
    assert torch.equal(kern, plain)


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
@pytest.mark.parametrize("winsize", [3, 5, 7, 15, 21, 31, 33])
@pytest.mark.parametrize("gaussian", [False, True])
def test_update_flow_kernel(card, shape, winsize, gaussian):
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 4).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 4).roll(1, -1).to(card), 5, 1.2)
    m = fb.update_matrices_cf_plain(p0, p1, torch.zeros((b, 2, h, w), device=card))
    kern = fc.update_flow_cf(m, winsize, gaussian)
    plain = fb.update_flow_cf_plain(m, winsize, gaussian)
    # Bit-equal: the window sums in the plain order without FMA contraction,
    # then the same solve (winsize 33 runs the run-time-radius instance).
    assert torch.equal(kern, plain)


def test_persistent_kernels_take_a_batch_above_the_grid_z_limit(card):
    """K1 and K3 walk over (frame, tile) units in persistent blocks: a batch
    past 65535 frames (the former grid-z limit) is covered to its end."""
    b, h, w = 70000, 3, 6
    img = _img((b, h, w), 21).to(card)
    assert torch.equal(fc.poly_exp_cf(img, 5, 1.2), fb.poly_exp_cf_plain(img, 5, 1.2))
    m = torch.as_tensor(np.random.default_rng(22).normal(size=(b, 5, h, w)).astype(np.float32))
    m = m.to(card)
    kern = fc.update_flow_cf(m, 5, False)
    assert torch.equal(kern, fb.update_flow_cf_plain(m, 5, False))
    assert torch.isfinite(kern[-1]).all()


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
    assert fc.LAUNCHES == dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=levels,
                               update_matrices=iters, update_flow=iters)
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


# K4 / K3 box mode: odd sizes below one tile, ragged edge tiles, a width
# of several tile columns.
TILE_SHAPES = [(3, 7, 9), (2, 45, 67), (1, 33, 250)]


def _tile_ids(case, b, h, w):
    th, tw = fb.TILE
    n_i, n_j = -(-h // th), -(-w // tw)
    total = b * n_i * n_j
    ids = np.arange(total)
    edge = (ids // n_j % n_i == n_i - 1) | (ids % n_j == n_j - 1)
    return {
        "empty": ids[:0],
        "one": ids[total // 2 : total // 2 + 1],
        "all": ids,
        "edges": ids[edge],
        "random_half": np.random.default_rng(7).permutation(total)[: max(1, total // 2)],
    }[case]


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("case", ["empty", "one", "all", "edges", "random_half"])
def test_update_matrices_tiles_kernel(card, shape, case):
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 11).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 12).to(card), 5, 1.2)
    flow = torch.as_tensor(
        np.random.default_rng(13).normal(size=(b, 2, h, w)).astype(np.float32) * 4).to(card)
    sel = torch.as_tensor(_tile_ids(case, b, h, w).astype(np.int32)).to(card)
    m0 = torch.as_tensor(np.random.default_rng(14).normal(size=(b, 5, h, w)).astype(np.float32))
    m0 = m0.to(card)
    fc.reset_launch_counts()
    kern = fc.update_matrices_tiles_cf(p0, p1, flow, sel, m0.clone(), fb.TILE)
    assert fc.LAUNCHES["update_matrices_tiles"] == (1 if sel.numel() else 0)
    plain = fb.update_matrices_tiles_cf_plain(p0, p1, flow, sel, m0.clone(), fb.TILE)
    listed = fb.tile_mask(sel, b, h, w, fb.TILE)[:, None].expand(b, 5, h, w)
    # Unlisted tiles are left bitwise as they were; listed ones are K2's
    # pixels bit for bit (one device function) and K2's bar from the plain.
    assert torch.equal(kern[~listed], m0[~listed])
    assert torch.equal(kern[listed], fc.update_matrices_cf(p0, p1, flow)[listed])
    assert _rel(kern, plain) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("alias", [True, False])
def test_update_matrices_walk_whole_and_box(card, shape, precision, alias):
    """K2's walk over the whole level and in box mode (at each of _boxes'
    boxes) equal to its plain version bit for bit, with r1 the sequence's
    next frames (r0's storage shifted by one frame) or an independent
    expansion; box mode leaves M outside the box as it was."""
    b, h, w = shape
    seq = fb.poly_exp_cf_plain(_img((b + 1, h, w), 51).to(card), 5, 1.2)
    r0 = seq[:-1]
    r1 = seq[1:] if alias else fb.poly_exp_cf_plain(_img(shape, 52).to(card), 5, 1.2)
    rng = np.random.default_rng(53)
    flow = rng.normal(size=(b, 2, h, w)).astype(np.float32) * 4
    flow[:, 0, ::5, ::3] = 1e4
    flow[:, 1, 1::7, ::4] = -3e9
    flow = torch.as_tensor(flow).to(card)
    fc.reset_launch_counts()
    whole = fc.update_matrices_cf(r0, r1, flow, precision)
    assert torch.equal(whole, fb.update_matrices_cf_plain(r0, r1, flow, precision))
    m0 = torch.as_tensor(rng.normal(size=(b, 5, h, w)).astype(np.float32)).to(card)
    for box in _boxes(h, w):
        y0, y1, x0, x1 = box
        kern = fc.update_matrices_cf(r0, r1, flow, precision, box, m0.clone())
        assert torch.equal(kern, fb.update_matrices_cf_plain(r0, r1, flow, precision, box,
                                                              m0.clone()))
        inside = torch.zeros_like(kern, dtype=torch.bool)
        inside[:, :, y0:y1, x0:x1] = True
        assert torch.equal(kern[~inside], m0[~inside]) and torch.equal(kern[inside], whole[inside])
    suffix = "_bf16" if precision == "bf16" else ""
    n_box = len(_boxes(h, w))
    assert fc.LAUNCHES["update_matrices" + suffix] == 1 + n_box
    assert fc.LAUNCHES["update_matrices_box" + suffix] == n_box


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("pairs", [1, 2, 3, 7, 8])
def test_update_matrices_walk_run_boundaries(card, precision, pairs):
    """Runs of 1, 2, 3, 7 and 8 pairs over 7 pairs (runs that divide the
    batch, that do not, and one run of all pairs), whole and boxed: every
    pair bit-equal to the plain version."""
    b, h, w = 7, 45, 100
    seq = fb.poly_exp_cf_plain(_img((b + 1, h, w), 54).to(card), 5, 1.2)
    r0, r1 = seq[:-1], seq[1:]
    flow = torch.as_tensor(np.random.default_rng(55).normal(
        size=(b, 2, h, w)).astype(np.float32) * 3).to(card)
    plain = fb.update_matrices_cf_plain(r0, r1, flow, precision)
    for box in ((0, h, 0, w), (8, 40, 32, 96), (3, 44, 5, 99)):
        y0, y1, x0, x1 = box
        out = torch.full_like(plain, float("nan"))
        fc._walk(r0, r1, flow, precision, box, out, True, pairs)
        assert torch.equal(out[:, :, y0:y1, x0:x1], plain[:, :, y0:y1, x0:x1])
        assert torch.isnan(out).sum() == out.numel() - b * 5 * (y1 - y0) * (x1 - x0)


def test_update_matrices_walk_picks_short_runs_on_a_small_level(card):
    """The 1080p pyramid's level 3 (135×240, 136 tiles) at 64 pairs: the
    wrapper's runs are short enough to fill the card, and its result is
    the plain version's."""
    b, h, w = 64, 135, 240
    resident = fc._resident(card, 1)
    ppr = fc.pairs_per_run(-(-h // 8) * -(-w // 32), b, resident)
    assert resident >= 132 and ppr < 8
    seq = fb.poly_exp_cf_plain(_img((b + 1, h, w), 56).to(card), 5, 1.2)
    flow = torch.as_tensor(np.random.default_rng(57).normal(
        size=(b, 2, h, w)).astype(np.float32) * 2).to(card)
    assert torch.equal(fc.update_matrices_cf(seq[:-1], seq[1:], flow, "bf16"),
                       fb.update_matrices_cf_plain(seq[:-1], seq[1:], flow, "bf16"))


def test_update_matrices_walk_past_2_31_elements(card):
    """Level 0 of a 256-pair 1080p chunk: the expansion holds 2.65e9
    elements, past 2^31, so an int element offset would wrap.  The last
    pairs, whose offsets lie past 2^31, whole and in the 1080p ROI's
    level-0 box, against the plain version on those pairs."""
    b, h, w = 256, 1080, 1920
    g = torch.Generator(device=card).manual_seed(58)
    base = torch.rand((h + 16, w + 16), generator=g, device=card) * 255
    frames = torch.stack([base[i % 16:i % 16 + h, (3 * i) % 16:(3 * i) % 16 + w]
                          for i in range(b + 1)]).contiguous()
    seq = fc.poly_exp_cf(frames, 5, 1.2)
    del frames
    assert seq.numel() > 2 ** 31
    flow = torch.randn((b, 2, h, w), generator=g, device=card) * 2
    tail = slice(b - 4, b)
    for box in (None, (264, 904, 384, 1632)):
        out = None if box is None else torch.zeros((b, 5, h, w), device=card)
        kern = fc.update_matrices_cf(seq[:-1], seq[1:], flow, "bf16", box, out)
        want = fb.update_matrices_cf_plain(seq[:-1][tail], seq[1:][tail], flow[tail], "bf16")
        if box is not None:
            y0, y1, x0, x1 = box
            kern = kern[:, :, y0:y1, x0:x1]
            want = want[:, :, y0:y1, x0:x1]
        assert torch.equal(kern[tail], want)
        del kern, want, out
    torch.cuda.empty_cache()


def _boxes(h, w):
    return [(0, h // 2 + 1, 0, w // 2 + 1), (h // 3, h, w // 3, w), (0, h, 0, w),
            (min(2, h - 1), h - 1, 1, max(2, w - 3))]


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("winsize,gaussian", [(15, False), (5, True), (33, False)])
def test_update_flow_box_mode(card, shape, which, winsize, gaussian):
    b, h, w = shape
    box = _boxes(h, w)[which]
    y0, y1, x0, x1 = box
    p0 = fb.poly_exp_cf_plain(_img(shape, 15).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 15).roll(1, -1).to(card), 5, 1.2)
    m = fb.update_matrices_cf_plain(p0, p1, torch.zeros((b, 2, h, w), device=card))
    out0 = torch.as_tensor(
        np.random.default_rng(16).normal(size=(b, 2, h, w)).astype(np.float32)).to(card)
    kern = fc.update_flow_cf(m, winsize, gaussian, box, out0.clone())
    plain = fb.update_flow_cf_plain(m, winsize, gaussian, box, out0.clone())
    inside = torch.zeros((b, 2, h, w), dtype=torch.bool, device=card)
    inside[:, :, y0:y1, x0:x1] = True
    assert torch.equal(kern[~inside], out0[~inside])
    assert torch.equal(kern, plain)  # bit-equal, as the full-frame kernel
    # The box solved alone equals the kernel on the cut-out M.
    alone = fc.update_flow_cf(m[:, :, y0:y1, x0:x1].contiguous(), winsize, gaussian)
    assert torch.equal(kern[:, :, y0:y1, x0:x1], alone)


def test_tile_and_box_wrappers_reject_bad_inputs(card):
    img = _img((2, 20, 30), 6).to(card)
    p = fc.poly_exp_cf(img, 5, 1.2)
    flow = torch.zeros((2, 2, 20, 30), device=card)
    m = torch.zeros((2, 5, 20, 30), device=card)
    ok = torch.tensor([0, 3], dtype=torch.int32, device=card)
    fc.update_matrices_tiles_cf(p, p, flow, ok, m, fb.TILE)
    # 2 frames of 20×30 are 2 × 3×1 tiles of 8×32: id 6 is past the end.
    for bad in (ok.long(), ok.cpu(), torch.tensor([0, 6], dtype=torch.int32, device=card),
                torch.tensor([-1], dtype=torch.int32, device=card)):
        with pytest.raises(ValueError):
            fc.update_matrices_tiles_cf(p, p, flow, bad, m, fb.TILE)
    with pytest.raises(ValueError):  # more pixels than a block has threads
        fc.update_matrices_tiles_cf(p, p, flow, ok, m, (64, 32))
    with pytest.raises(ValueError):
        fc.update_flow_cf(m, 15, False, (0, 21, 0, 30), flow)
    with pytest.raises(ValueError):
        fc.update_flow_cf(m, 15, False, (0, 10, 0, 30), flow[:1])


def _pipeline_inputs():
    """17 frames of 128×256 with a moving blob, body axes with NaN rows 5-6,
    and an ROI small enough that level 0 runs boxed (K2 and K3 in box
    mode)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton

    n, h, w = 17, 128, 256
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:h, 0:w]
    texture = 30 * np.sin(xx / 6.3) * np.cos(yy / 7.1) + rng.normal(0, 4, (h, w))
    frames = np.stack([np.clip(100 + texture + 120 * np.exp(
        -(((xx - 125 - 6 * np.sin(i / 2)) / 14) ** 2 + ((yy - 64) / 10) ** 2)), 0, 255)
        for i in range(n)]).astype(np.uint8)
    t = np.arange(n) / 30.0
    ex = np.tile([np.cos(0.3), -np.sin(0.3)], (n, 1))
    ey = np.tile([np.sin(0.3), np.cos(0.3)], (n, 1))
    ex[5:7] = np.nan
    skel = Skeleton(time_all=t, fps=30.0, ex=ex, ey=ey)
    roi = np.array([[100.0, 50.0], [150.0, 52.0], [148.0, 80.0], [102.0, 78.0]])
    return frames, skel, roi


def test_run_flow_stage_card_matches_cpu(card):
    """The pipeline's ROI-dispatched flow stage on the card against the
    CPU; the ROI is small enough that level 0 runs boxed (K2's box mode,
    never K4)."""
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage

    frames, skel, roi = _pipeline_inputs()
    fc.reset_launch_counts()
    gpu = run_flow_stage(ArraySource(frames, 30.0), skel, [roi], PipelineConfig(),
                         chunk_pairs=8, device=card)
    assert fc.LAUNCHES["update_matrices_box"] > 0 and fc.LAUNCHES["update_matrices_tiles"] == 0
    cpu = run_flow_stage(ArraySource(frames, 30.0), skel, [roi], PipelineConfig(),
                         chunk_pairs=8, device="cpu")
    assert np.array_equal(gpu.t_sec, cpu.t_sec) and np.array_equal(gpu.axes_ok, cpu.axes_ok)
    for name in ("vx", "vy", "mag"):
        a, c = getattr(gpu, name), getattr(cpu, name)
        assert np.array_equal(np.isnan(a), np.isnan(c))
        fin = np.isfinite(c)
        # ROI means of flows that agree within the path's 1e-3 px bar.
        np.testing.assert_allclose(a[fin], c[fin], atol=1e-3)


def test_run_full_writes_its_csvs_on_the_card(card, tmp_path):
    """run_full on the card writes flow.csv, the PC1 CSV and the summary
    with the port's own writers (the card's machine has no pandas), and
    reading them back with the csv module gives the run's own results."""
    import csv

    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full

    frames, skel, roi = _pipeline_inputs()
    paths = [str(tmp_path / f"{k}.csv") for k in ("flow", "pc1", "summary")]
    flow, pc1, mets = run_full(ArraySource(frames, 30.0), skel, [roi], chunk_pairs=8,
                               flow_csv=paths[0], pc1_csv=paths[1], summary_csv=paths[2],
                               device=card)

    def rows(path):
        with open(path, newline="") as f:
            return list(csv.reader(f))

    def num(text):
        return float("nan") if text == "" else float(text)

    fl = rows(paths[0])
    assert fl[0] == ["frame", "t_sec", "skel_idx", "axes_ok", "vx_body", "vy_body", "mag_body"]
    got = np.array([[num(x) for x in r] for r in fl[1:]])
    want = np.stack([flow.frame, flow.t_sec, flow.skel_idx, flow.axes_ok, flow.vx[:, 0],
                     flow.vy[:, 0], flow.mag[:, 0]], 1)
    assert got.shape == (17, 7) and np.array_equal(got, want, equal_nan=True)
    assert np.isnan(got[[0, 5, 6], 4]).all() and np.isfinite(got[7:, 4]).all()
    p1 = rows(paths[1])
    assert p1[0] == ["t_sec", "pc1_dyn"] and len(p1) == 18
    got = np.array([[num(x) for x in r] for r in p1[1:]])
    assert np.array_equal(got[:, 1], pc1[:, 0].astype(np.float64), equal_nan=True)
    sm = rows(paths[2])
    assert len(sm) == 2 and len(sm[1]) == 8 and sm[1][0] == "pc1_dyn"
    assert int(sm[1][7]) == int(mets[0].peak_n)
    for i, f in enumerate(("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p")):
        assert np.array_equal(num(sm[1][2 + i]), float(getattr(mets[0], f)), equal_nan=True)


def _two_blob_inputs():
    """17 frames of 128×512 with two blobs moving at different rates, body
    axes, and a left and a right ROI 210 px apart whose union box leaves
    level 0 boxed (BASELINE config 2 in small)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton

    n, h, w = 17, 128, 512
    rng = np.random.default_rng(19)
    yy, xx = np.mgrid[0:h, 0:w]
    texture = 30 * np.sin(xx / 6.3) * np.cos(yy / 7.1) + rng.normal(0, 4, (h, w))
    frames = np.stack([np.clip(100 + texture + sum(120 * np.exp(
        -(((xx - cx - 6 * np.sin(i / k)) / 14) ** 2 + ((yy - 64) / 10) ** 2))
        for cx, k in ((120, 2.0), (390, 3.0))), 0, 255) for i in range(n)]).astype(np.uint8)
    t = np.arange(n) / 30.0
    skel = Skeleton(time_all=t, fps=30.0, ex=np.tile([np.cos(0.3), -np.sin(0.3)], (n, 1)),
                    ey=np.tile([np.sin(0.3), np.cos(0.3)], (n, 1)))
    rois = [np.array([[90.0, 40.0], [150.0, 42.0], [148.0, 88.0], [92.0, 86.0]]),
            np.array([[360.0, 40.0], [420.0, 42.0], [418.0, 88.0], [362.0, 86.0]])]
    return frames, skel, rois


def _two_roi_runs(device):
    """run_flow_stage with both ROIs (ROI-dispatched over their union
    boxes), with every level whole (boxes past the frame) and with each ROI
    alone; returns (both, whole, [alone])."""
    import dataclasses

    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage

    frames, skel, rois = _two_blob_inputs()
    cfg = PipelineConfig()
    whole = dataclasses.replace(cfg, flow=dataclasses.replace(
        cfg.flow, roi_active_px=((-10**6, 10**6, -10**6, 10**6),) * 4))

    def run(rs, c=cfg):
        return run_flow_stage(ArraySource(frames, 30.0), skel, rs, c, chunk_pairs=8,
                              device=device)

    fc.reset_launch_counts()
    both = run(rois)
    launches = dict(fc.LAUNCHES)
    return both, launches, run(rois, whole), [run([r]) for r in rois]


def test_run_flow_stage_two_rois_on_the_card(card):
    """Two ROIs through the ROI-dispatched flow stage on the card: level 0
    runs boxed over their union (K2 and K3 in box mode), both ROIs'
    features equal the full-frame flow's (0.0) and a run of each ROI alone
    (each mask is reduced on its own), and the two differ."""
    both, launches, whole, alone = _two_roi_runs(card)
    assert launches["update_matrices_box"] > 0 and launches["update_matrices_tiles"] == 0
    assert both.vx.shape == (17, 2)
    for name in ("vx", "vy", "mag"):
        a = getattr(both, name)
        assert np.array_equal(a, getattr(whole, name), equal_nan=True), name
        for r in range(2):
            assert np.array_equal(a[:, r], getattr(alone[r], name)[:, 0], equal_nan=True)
        assert np.abs(a[1:, 0] - a[1:, 1]).max() > 1e-3


def _nan_signals(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[..., 0] = np.nan
    x[..., 300:340] = np.nan
    return x


def test_assoc_band_pass_card_matches_cpu(card):
    """The associative engine's doubling scan on the card against the CPU:
    the same float32 operations in the same order, one kernel each."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters

    sos, zi, padreq = filters.make_bandpass(0.5, 5.0, 30.0, 4)
    x = _nan_signals((4, 1024), 0)
    out = [filters.bandpass_nanrobust(torch.as_tensor(x, device=d), sos,
                                      torch.as_tensor(zi, device=d), padreq).cpu()
           for d in ("cpu", card)]
    assert torch.equal(torch.isnan(out[0]), torch.isnan(out[1]))
    fin = torch.isfinite(out[0])
    assert float((out[0][fin] - out[1][fin]).abs().max()) <= 1e-6 * float(out[0][fin].abs().max())
    y, zf = zip(*(filters.sosfilt(sos, torch.as_tensor(x[:, 400:], device=d),
                                  torch.as_tensor(zi, device=d)) for d in ("cpu", card)))
    torch.testing.assert_close(y[1].cpu(), y[0], rtol=0, atol=1e-6 * float(y[0].abs().max()))
    torch.testing.assert_close(zf[1].cpu(), zf[0], rtol=0, atol=1e-5 * float(zf[0].abs().max()))


def _section_loop(sos, x, zi):
    """The sequential engine's plain loop on x's device: ``_section_scan``
    over each section in turn, each over the whole of x."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters

    return filters._cascade(filters._section_scan, sos, x,
                            zi.expand(x.shape[:-1] + zi.shape[-2:]))


# The staging rows of the benchmark's cells ((2 signals, ROIs, 64 runs,
# N + 48 samples): 1080p with one and two ROIs, the 480p cohort's 32 rows),
# ragged ones (rows past a 32-row block, a tile of 256 samples cut short),
# and a band-pass of order 10: 10 sections, past the 8 one launch takes.
@pytest.mark.parametrize("shape,order", [((2, 64, 3649), 4), ((2, 2, 64, 3649), 4),
                                         ((2, 32, 64, 409), 4), ((3, 37, 300), 4), ((1, 1), 4),
                                         ((2, 37, 700), 10)])
def test_sos_cascade_kernel_equals_the_section_loop(card, shape, order):
    """sosfilt's sequential engine on the card is one launch of
    sos_cascade_kernel per 8 sections, each group's output the next
    group's input, bit-equal to the plain loop on the card (y and zf), with
    zi per row and broadcast."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters, filters_cuda

    sos, zi, _ = filters.make_bandpass(0.5, 5.0, 30.0, order)
    x = torch.as_tensor(np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
                        * 3, device=card)
    for z0 in (torch.as_tensor(zi, device=card) * x[..., :1, None],
               torch.as_tensor(zi, device=card)):
        filters_cuda.reset_launch_counts()
        y, zf = filters.sosfilt(sos, x, z0, engine="scan")
        assert filters_cuda.LAUNCHES["sos_cascade"] == -(-order // filters_cuda.MAX_SECTIONS)
        y_ref, zf_ref = _section_loop(sos, x, z0)
        assert zf.shape == x.shape[:-1] + (order, 2)
        assert torch.equal(y, y_ref) and torch.equal(zf, zf_ref)


def test_sos_cascade_kernel_on_the_band_pass_staging_rows(card, monkeypatch):
    """Both passes of the NaN-robust band-pass hand the kernel staging rows
    with odd extensions and garbage fill (``_filtfilt_runs``); on each, the
    kernel is bit-equal to the plain loop."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters, filters_cuda

    sos, zi, padreq = filters.make_bandpass(0.5, 5.0, 30.0, 4)
    x = _nan_signals((2, 3, 1200), 4)
    x[0, 1, 500:503] = np.nan   # a run shorter than padreq + 1 between two long ones
    x[1, 2, 800:1000:7] = np.nan
    x[:, 0, 1150:] = np.inf
    seen = []
    kernel = filters_cuda.sos_cascade

    def spy(sos_, x_, zi_):
        seen.append((x_.clone(), zi_.clone()))
        return kernel(sos_, x_, zi_)

    monkeypatch.setattr(filters_cuda, "sos_cascade", spy)
    filters.bandpass_nanrobust(torch.as_tensor(x, device=card), sos,
                               torch.as_tensor(zi, device=card), padreq, engine="scan")
    assert len(seen) == 2 and seen[0][0].shape == (2, 3, 64, 1200 + 2 * padreq)
    for xs, zs in seen:
        y, zf = kernel(sos, xs, zs)
        y_ref, zf_ref = _section_loop(sos, xs, zs)
        assert torch.equal(y, y_ref) and torch.equal(zf, zf_ref)


@pytest.mark.parametrize("order", [4, 10])
def test_pc1_batch_with_the_kernel_equals_the_plain_loop(card, monkeypatch, order):
    """pc1_from_flow_batch on the card (two 3601-sample rows, as the
    bilateral 1080p cell) with the kernel is torch.equal to the same call
    with the plain loop, at the default band-pass and at PCAParams(bpf_order=10)
    (two launches a pass)."""
    from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow_batch
    from btcs_pnes_optical_flow_tpu_torch.ops import filters_cuda

    t = np.arange(3601) / 30.0
    rng = np.random.default_rng(8)
    vx = np.stack([np.sin(2 * np.pi * f * t) + 0.2 * rng.normal(size=t.size) for f in (3.0, 2.5)])
    vy = 0.5 * vx[::-1] + 0.1 * rng.normal(size=vx.shape)
    vx[:, 0] = vy[:, 0] = np.nan
    vx[1, 1200:1260] = np.nan
    args = [torch.as_tensor(v, dtype=torch.float32, device=card) for v in (vx, vy)]
    params = PCAParams(bpf_order=order)
    filters_cuda.reset_launch_counts()
    kern = pc1_from_flow_batch(*args, params)
    assert filters_cuda.LAUNCHES["sos_cascade"] == 2 * -(-order // filters_cuda.MAX_SECTIONS)
    monkeypatch.setattr(filters_cuda, "sos_cascade", _section_loop)
    plain = pc1_from_flow_batch(*args, params)
    assert torch.isfinite(kern[:, 1:]).any() and torch.equal(kern.isnan(), plain.isnan())
    assert torch.equal(torch.nan_to_num(kern), torch.nan_to_num(plain))


def test_run_full_launches_the_cascade_twice_per_band_pass(card, monkeypatch):
    """One run_full on the card (two ROIs) makes one band-pass call, and it
    is two launches of sos_cascade_kernel: the forward and the backward
    pass."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import filters, filters_cuda

    calls = []
    band_pass = filters.bandpass_nanrobust
    monkeypatch.setattr(filters, "bandpass_nanrobust",
                        lambda *a, **k: calls.append(1) or band_pass(*a, **k))
    frames, skel, rois = _two_blob_inputs()
    filters_cuda.reset_launch_counts()
    _, pc1, _ = run_full(ArraySource(frames, 30.0), skel, rois, chunk_pairs=8, device=card)
    assert pc1.shape == (17, 2) and len(calls) == 1
    assert filters_cuda.LAUNCHES["sos_cascade"] == 2


@pytest.mark.parametrize("engine", ["scan", "assoc"])
def test_pc1_and_streaming_card_match_cpu(card, engine):
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
    from btcs_pnes_optical_flow_tpu_torch.models.streaming import pc1_streaming

    t = np.arange(3000) / 30.0
    vx = np.sin(2 * np.pi * 3.0 * t) * np.cos(0.4) + 0.1 * np.random.default_rng(1).normal(size=t.size)
    vy = np.sin(2 * np.pi * 3.0 * t) * np.sin(0.4) + 0.1 * np.random.default_rng(2).normal(size=t.size)
    vx[0] = vy[0] = np.nan
    vx[900:950] = vy[900:950] = np.nan
    full = [pc1_from_flow(torch.as_tensor(vx, dtype=torch.float32, device=d),
                          torch.as_tensor(vy, dtype=torch.float32, device=d),
                          engine=engine).cpu().numpy() for d in ("cpu", card)]
    fin = np.isfinite(full[0])
    assert np.array_equal(np.isnan(full[1]), ~fin)
    assert np.corrcoef(full[0][fin], full[1][fin])[0, 1] >= 0.9999
    chunked = [pc1_streaming(vx, vy, chunk_n=1024, engine=engine, device=d)
               for d in ("cpu", card)]
    assert np.array_equal(np.isnan(chunked[0]), np.isnan(chunked[1]))
    fin = np.isfinite(chunked[0])
    assert np.corrcoef(chunked[0][fin], chunked[1][fin])[0, 1] > 0.9999
    assert np.corrcoef(chunked[1][fin], full[1][fin])[0, 1] > 0.9999


def _cohort_items(n_videos, n_frames, video_of=lambda c: c):
    """Clips of 64×96 with a blob oscillating at 2.5 Hz, one ROI."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
    from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem

    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    t = np.arange(n_frames) / 30.0
    roi = np.array([[10.0, 8.0], [86.0, 9.0], [84.0, 56.0], [9.0, 54.0]])
    skel = Skeleton(time_all=t, fps=30.0, ex=np.tile([np.cos(0.3), -np.sin(0.3)], (n_frames, 1)),
                    ey=np.tile([np.sin(0.3), np.cos(0.3)], (n_frames, 1)))
    items = []
    for v in range(n_videos):
        rng = np.random.default_rng(40 + v)
        tex = 20 * np.sin(xx / 4.7) * np.cos(yy / 5.3) + rng.normal(0, 3, (h, w))
        cx = w / 2 + 10 * np.sin(2 * np.pi * 2.5 * t + v)
        clip = np.stack([np.clip(70 + tex + 150 * np.exp(
            -(((xx - cx[i]) / 8.0) ** 2 + ((yy - h / 2) / 8.0) ** 2)), 0, 255)
            for i in range(n_frames)]).astype(np.uint8)
        items.append(CohortItem(f"v{v}", video_of(clip), skel, [roi]))
    return items


def test_run_cohort_paths_agree_on_the_card(card, tmp_path):
    """run_cohort's batched path (host clips and clips on the card) and its
    per-video path give the same rows on the card; the batched path runs
    the full-frame schedule; make_mesh gives the card."""
    from btcs_pnes_optical_flow_tpu_torch.config import MetricParams, PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import make_mesh
    from btcs_pnes_optical_flow_tpu_torch.parallel.runner import run_cohort

    mesh = make_mesh(1)
    assert mesh == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="CUDA"):  # more cards than the machine has
        make_mesh(torch.cuda.device_count() + 1)
    cfg = PipelineConfig(metrics=MetricParams(window_sec=2.0))
    fc.reset_launch_counts()
    batched = run_cohort(_cohort_items(3, 81), cfg, 32, mesh=mesh, device=card)
    n_lev = cfg.flow.num_levels(64, 96) + 1
    n_it = sum(cfg.flow.iters_at(k) for k in range(n_lev))
    chunks = 3 * 3  # 3 videos of 80 pairs in chunks of 32
    assert fc.LAUNCHES == dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=n_lev * chunks,
                               update_matrices=n_it * chunks, update_flow=n_it * chunks)
    resident = run_cohort(_cohort_items(3, 81, lambda c: torch.as_tensor(c, device=card)), cfg,
                          32, mesh=mesh, device=card)
    per_video = run_cohort(_cohort_items(3, 81), cfg, 32, flow_workers=2, device=card,
                           out_csv=str(tmp_path / "cohort.csv"))
    assert all(r["status"] == 0 and r["error"] == "" for r in batched)
    for other in (resident, per_video):
        for a, b in zip(batched, other):
            assert list(a) == list(b)
            for k, va in a.items():
                if isinstance(va, float):
                    np.testing.assert_allclose(b[k], va, rtol=1e-6, atol=1e-9, equal_nan=True)
                else:
                    assert b[k] == va
    assert (tmp_path / "cohort.csv").read_text().count("\n") == 4


def test_compat_clis_on_the_card(card, tmp_path):
    """The three CLIs' main() on the card against the CPU over the same
    files."""
    import csv

    from btcs_pnes_optical_flow_tpu_torch.compat import optical_flow, optical_PC1, optical_PCA
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import save_skeleton_npz

    item = _cohort_items(1, 81)[0]
    video, npz = str(tmp_path / "clip.npy"), str(tmp_path / "skel.npz")
    np.save(video, item.video)
    save_skeleton_npz(npz, item.skeleton)
    out = {}
    for d in ("cpu", card):
        p = [str(tmp_path / f"{d}_{k}.csv") for k in ("flow", "pc1", "summary")]
        optical_flow.main([video, npz, p[0], str(item.roi_polygons[0].tolist())], device=d)
        optical_PCA.main(p[:2], device=d)
        optical_PC1.main(p[1:], device=d)
        out[d] = []
        for path in p:
            with open(path, newline="") as f:
                out[d].append(list(csv.reader(f)))
    cpu, gpu = out["cpu"], out[card]
    for a, b in zip(cpu, gpu):
        assert a[0] == b[0] and len(a) == len(b)

    def col(rows, name):
        i = rows[0].index(name)
        return np.array([float(r[i]) if r[i] else np.nan for r in rows[1:]])

    np.testing.assert_allclose(col(gpu[0], "vx_body"), col(cpu[0], "vx_body"), atol=1e-3)
    a, c = col(gpu[1], "pc1_dyn"), col(cpu[1], "pc1_dyn")
    fin = np.isfinite(c)
    assert np.array_equal(np.isnan(a), ~fin) and np.corrcoef(a[fin], c[fin])[0, 1] >= 0.999
    assert len(gpu[2]) == 2 and gpu[2][1][0] == "pc1_dyn"


# TV-L1: odd sizes, a width past one tile row, B > 1; for K6 also a shape
# of several 32×64 tiles in both directions, for K5 a width of whole
# 128-pixel warp segments (the others end in a partial one).
TV_SHAPES = [(3, 7, 9), (2, 45, 67), (2, 33, 250)]
PD_SHAPES = TV_SHAPES + [(2, 100, 200)]


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


@pytest.mark.parametrize("shape", TV_SHAPES + [(2, 20, 256)])
@pytest.mark.parametrize("c", [3, 1, 2])
def test_warp_sample_kernel(card, shape, c):
    b, h, w = shape
    src = _img((b, c, h, w), 7).to(card) / 255.0
    flow = _flow_off_every_edge(b, h, w, 8).to(card)
    tc.reset_launch_counts()
    kern = tc.warp_sample_cf(src, flow)
    assert tc.LAUNCHES["warp_sample"] == 1
    plain = tv.warp_sample_cf_plain(src, flow)
    # The plain float32 operations in their order, without FMA contraction
    # (C = 2 runs the run-time channel instance).
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


def _check_chain(planes, n_iterations, depth=tc.PD_DEPTH):
    p = tv.TVL1Params()
    tc.reset_launch_counts()
    kern = tc.pd_chain(*planes, n_iterations, p.tau, p.lambda_, p.theta, depth=depth)
    blocks = len(tc.pd_schedule(n_iterations, depth))
    assert tc.LAUNCHES == {"warp_sample": 0, "pd_chain": int(blocks > 0), "pd_block": blocks,
                           "pd_eps_step": 0}
    plain = tv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta)
    for k, q in zip(kern, plain):
        assert k.shape == planes[0].shape and torch.isfinite(k).all()
        # Bit-equal: the plain factored operations in their order, without
        # FMA contraction, on tiles whose halos are recomputed exactly.
        assert torch.equal(k, q)


@pytest.mark.parametrize("shape", PD_SHAPES)
@pytest.mark.parametrize("n_iterations", [0, 1, 7, 8, 30])
def test_pd_chain_kernel(card, shape, n_iterations):
    _check_chain(_chain_planes(shape, 9, card), n_iterations)


@pytest.mark.parametrize("depth", tc.PD_DEPTHS)
def test_pd_chain_every_depth(card, depth):
    """Each compiled depth once, on several tiles in both directions, with a
    remainder launch (23 is no multiple of 2 … 10)."""
    _check_chain(_chain_planes((2, 100, 200), 12, card), 23, depth)


def test_tvl1_kernels_take_a_batch_above_the_grid_z_limit(card):
    """K5's flat grid and K6's persistent blocks cover a batch past 65535
    frames to its end."""
    b, h, w = 70000, 3, 6
    src = _img((b, 3, h, w), 23).to(card) / 255.0
    flow = _flow_off_every_edge(b, h, w, 24).to(card)
    kern = tc.warp_sample_cf(src, flow)
    assert _rel(kern, tv.warp_sample_cf_plain(src, flow)) <= 1e-5
    assert torch.isfinite(kern[-1]).all()
    _check_chain(_chain_planes((b, h, w), 25, card), 5, 2)


def test_tvl1_flow_kernels_match_plain(card):
    rng = np.random.default_rng(10)
    base = rng.random((70, 90)) * 200
    prev = torch.as_tensor(np.stack([base, np.roll(base, 1, 0)]).astype(np.uint8)).to(card)
    curr = torch.as_tensor(np.stack([np.roll(base, (1, 2), (0, 1)),
                                     np.roll(base, (-1, 1), (0, 1))]).astype(np.uint8)).to(card)
    p = tv.TVL1Params(n_scales=2, n_warps=3, n_iterations=10)
    tc.reset_launch_counts()
    kern, clips = tv.tvl1_flow(prev, curr, p, return_clip=True)
    assert tc.LAUNCHES == {"warp_sample": 6, "pd_chain": 6,
                           "pd_block": 6 * len(tc.pd_schedule(p.n_iterations)), "pd_eps_step": 0}
    assert clips.tolist() == [0, 0]
    plain = tv.tvl1_flow(prev, curr, p, kernels=False)
    assert float((kern - plain).abs().max()) <= 1e-3  # the path's px bar


def test_warp_sample_kernel_at_1080p(card):
    """K5 at BASELINE config 5's full frame, 1080×1920 with three channels,
    bit-equal to its plain version."""
    b, h, w = 2, 1080, 1920
    src = _img((b, 3, h, w), 26).to(card) / 255.0
    flow = _flow_off_every_edge(b, h, w, 27).to(card)
    assert torch.equal(tc.warp_sample_cf(src, flow), tv.warp_sample_cf_plain(src, flow))


def test_pd_chain_kernel_at_the_1080p_level_2_shape(card):
    """K6's one resident level of 1080×1920 TV-L1 (270×480), bit-equal."""
    p = tv.TVL1Params()
    assert [tv._resident_ok(*s, p) for s in tv._pyramid_sizes(1080, 1920, p)] == [False, False,
                                                                                   True]
    _check_chain(_chain_planes((2, 270, 480), 28, card), p.n_iterations)


def test_tvl1_flow_at_720p_kernels_match_plain(card):
    """tvl1_flow at 720×1280 with the default parameters: level 0 runs the
    epsilon loop, levels 1–2 run K6; the kernel path within the path's px
    bar of the plain path."""
    h, w = 720, 1280
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def texture(dx, dy, seed):
        img = (np.sin((xx + dx) / 6) * np.cos((yy + dy) / 7)
               + 0.6 * np.sin((xx + dx) / 11 + (yy + dy) / 5)) * 55 + 128
        noise = np.random.default_rng(seed).normal(0, 1, (h, w))
        return torch.as_tensor(np.clip(img + noise, 0, 255).astype(np.uint8)).to(card)

    prev, curr = texture(0.0, 0.0, 29), texture(1.2, -0.7, 30)
    p = tv.TVL1Params()
    tc.reset_launch_counts()
    kern = tv.tvl1_flow(prev[None], curr[None], p)
    launches = dict(tc.LAUNCHES)
    assert launches.pop("pd_eps_step") >= 5  # level 0: at least one ε step a warp
    assert launches == {"warp_sample": 15, "pd_chain": 10,
                        "pd_block": 10 * len(tc.pd_schedule(p.n_iterations))}
    plain = tv.tvl1_flow(prev[None], curr[None], p, kernels=False)
    assert kern.shape == (1, h, w, 2) and torch.isfinite(kern).all()
    assert float((kern - plain).abs().max()) <= 1e-3  # the path's px bar


def test_tvl1_scales_frames_as_the_cpu(card):
    """TV-L1's frames / 255 gives the CPU's bits on the card for every
    pixel value (a CUDA tensor divided by a Python scalar is multiplied by
    the scalar's reciprocal, an ulp off for 126 of the 256 values)."""
    frames = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16)
    assert torch.equal(tv._unit(frames.to(card)).cpu(), tv._unit(frames))


def test_tvl1_card_matches_cpu_where_level_0_takes_the_epsilon_loop(card):
    """tvl1_flow with the fixed-length chain asked for on both sides, at
    112×896, where level 0 runs the epsilon loop and levels 1–2 K6 (on the
    CPU their plain chain): the card within the path's px bar of the CPU."""
    import dataclasses

    from bench import render_clip

    clip = render_clip(3, 112, 896, seed=2)
    p = dataclasses.replace(tv.TVL1Params(), pd_engine="resident")
    assert not tv._resident_ok(112, 896, p) and tv._resident_ok(56, 448, p)
    cpu = tv.tvl1_flow(torch.as_tensor(clip[:-1]), torch.as_tensor(clip[1:]), p)
    gpu = tv.tvl1_flow(torch.as_tensor(clip[:-1]).to(card), torch.as_tensor(clip[1:]).to(card), p)
    # The CPU's torch.sqrt is not correctly rounded (1.9e-4 px here), and
    # the epsilon loop's mean is taken in another order, so its exit may
    # move by an iteration.  Before frames were divided on the card as on
    # the CPU, 1.1e-3 px.
    assert float((gpu.cpu() - cpu).abs().max()) <= 1e-3


def _eps_planes(card, b=16, h=540, w=960, seed=31):
    """Chain inputs at the 1080p level-1 shape whose pairs converge at
    different speeds: pair 0 has no image gradient (its first step moves
    nothing), the others gradients scaled from 0.1 to 3 times."""
    u, v, rho_c, i1wx, i1wy, _ = _chain_planes((b, h, w), seed, card)
    scale = torch.logspace(-1, 0.5, b, device=card)[:, None, None]
    scale[0] = 0.0
    i1wx, i1wy, rho_c = i1wx * scale, i1wy * scale, rho_c * scale
    return u, v, rho_c, i1wx, i1wy, i1wx * i1wx + i1wy * i1wy


def _plain_stops(planes, n_iterations, epsilon, p):
    """The iteration at which each pair of the plain ε loop stops (n + 1:
    never): its own update equals that of the loop without a stop while it
    iterates, so the stop is the first step whose mean squared update is
    below epsilon²."""
    prev = planes[:2]
    stops = torch.full((planes[0].shape[0],), n_iterations + 1, device=planes[0].device)
    for k in range(1, n_iterations + 1):
        cur = tv.pd_chain_plain(*planes, k, p.tau, p.lambda_, p.theta)
        err = ((cur[0] - prev[0]) ** 2 + (cur[1] - prev[1]) ** 2).mean(dim=(-2, -1))
        stops = torch.where((err < epsilon * epsilon) & (stops > n_iterations), k, stops)
        prev = cur
    return stops.tolist()


def test_pd_eps_step_kernel_matches_the_plain_loop(card):
    """K6's ε step at B=16 on a 540×960 level, torch.equal to the plain ε
    loop: pair 0 stops at the first step and the loop runs on for the rest
    (the duals read back, the ping-pong, the stopped pairs' mask); one
    launch an iteration of the plain loop."""
    p = tv.TVL1Params()
    planes, n, eps = _eps_planes(card), 10, p.epsilon
    stops = _plain_stops(planes, n, eps, p)
    assert stops[0] == 1 and max(stops) >= 3, stops
    tc.reset_launch_counts()
    kern = tc.pd_eps_chain(*planes, n, p.tau, p.lambda_, p.theta, eps)
    assert tc.LAUNCHES == {"warp_sample": 0, "pd_chain": 0, "pd_block": 0,
                           "pd_eps_step": min(max(stops), n)}
    plain = tv.pd_chain_plain(*planes, n, p.tau, p.lambda_, p.theta, epsilon=eps)
    for k, q in zip(kern, plain):
        assert k.shape == planes[0].shape and torch.isfinite(k).all()
        assert torch.equal(k, q)


@pytest.mark.parametrize("shape", PD_SHAPES + [(16, 540, 960)])
@pytest.mark.parametrize("n_iterations", [0, 1, 2, 7])
def test_pd_eps_step_kernel_without_a_stop(card, shape, n_iterations):
    """ε = 0: exactly n_iterations launches and no read, torch.equal to the
    plain loop (ragged tiles, images smaller than a tile)."""
    p = tv.TVL1Params()
    planes = _chain_planes(shape, 32, card)
    tc.reset_launch_counts()
    kern = tc.pd_eps_chain(*planes, n_iterations, p.tau, p.lambda_, p.theta, 0.0)
    assert tc.LAUNCHES["pd_eps_step"] == n_iterations
    plain = tv.pd_chain_plain(*planes, n_iterations, p.tau, p.lambda_, p.theta, epsilon=0.0)
    assert all(torch.equal(k, q) for k, q in zip(kern, plain))


def test_tvl1_flow_at_1080p_steps_the_epsilon_loop_with_the_kernel(card):
    """tvl1_flow at 1080×1920, B=2, default parameters: levels 0–1 run the
    ε loop through K6's ε step, level 2 K6's chains as before; the kernel
    path array_equal to kernels=False."""
    h, w = 1080, 1920
    frames = _img((3, h, w), 33).to(torch.uint8)
    frames[1:] = torch.roll(frames[0], (1, 2), (0, 1))  # a textured shift, then noise
    frames[2] = torch.roll(frames[0], (-1, 3), (0, 1))
    prev, curr = frames[:2].to(card), frames[1:].to(card)
    p = tv.TVL1Params()
    tc.reset_launch_counts()
    kern = tv.tvl1_flow(prev, curr, p)
    launches = dict(tc.LAUNCHES)
    assert launches.pop("pd_eps_step") >= 2 * p.n_warps
    assert launches == {"warp_sample": 15, "pd_chain": 5,
                        "pd_block": 5 * len(tc.pd_schedule(p.n_iterations))}
    plain = tv.tvl1_flow(prev, curr, p, kernels=False)
    assert torch.isfinite(kern).all()
    assert np.array_equal(kern.cpu().numpy(), plain.cpu().numpy())


def test_pd_eps_chain_rejects_bad_inputs(card):
    planes = [torch.zeros((2, 10, 12), device=card) for _ in range(6)]
    with pytest.raises(ValueError):
        tc.pd_eps_chain(*planes[:5], planes[5][:1], 4, 0.25, 0.3, 0.3, 1e-3)
    with pytest.raises(ValueError):
        tc.pd_eps_chain(*planes[:5], planes[5].cpu(), 4, 0.25, 0.3, 0.3, 1e-3)
    with pytest.raises(ValueError):
        tc.pd_eps_chain(*planes[:5], planes[5].double(), 4, 0.25, 0.3, 0.3, 1e-3)


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
    with pytest.raises(ValueError):  # no compiled instance of that depth
        tc.pd_chain(*planes, 4, 0.25, 0.3, 0.3, depth=11)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_instances_of_k2_and_k4(card, shape):
    """K2's and K4's bf16 instances (warp_precision="bf16") against their
    plain versions; K4 over every tile equals K2 bit for bit (one device
    function)."""
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 31).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 32).to(card), 5, 1.2)
    rng = np.random.default_rng(33)
    flow = rng.normal(size=(b, 2, h, w)).astype(np.float32) * 4
    flow[:, 0, ::5, ::3] = 1e4
    flow = torch.as_tensor(flow).to(card)
    fc.reset_launch_counts()
    kern = fc.update_matrices_cf(p0, p1, flow, "bf16")
    plain = fb.update_matrices_cf_plain(p0, p1, flow, "bf16")
    assert torch.isfinite(kern).all() and _rel(kern, plain) <= 1e-5  # K2's bar
    assert not torch.equal(kern, fc.update_matrices_cf(p0, p1, flow))  # bf16 rounds
    sel = torch.as_tensor(_tile_ids("all", b, h, w).astype(np.int32)).to(card)
    tiles = fc.update_matrices_tiles_cf(p0, p1, flow, sel, torch.zeros_like(kern), fb.TILE, "bf16")
    assert torch.equal(tiles, kern)
    assert (fc.LAUNCHES["update_matrices_bf16"], fc.LAUNCHES["update_matrices_tiles_bf16"],
            fc.LAUNCHES["update_matrices"], fc.LAUNCHES["update_matrices_tiles"]) == (1, 1, 1, 0)


@pytest.mark.parametrize("kernel", ["K1", "K2 bf16", "K4 bf16", "K3 box"])
def test_kernels_at_1080p(card, kernel):
    """BASELINE config 3's shapes: 4 pairs of 1080×1920 under the JAX
    bench's flow config and 1080p ROI (bench.py:301-330), where levels 0–2
    are boxed and level 3 (135×240) runs whole.  K1 at level 0, K2's bf16
    instance at level 3, K4's over the level-0 box's tiles and K3 in box
    mode over that box, each bit-equal to its plain version."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    h, w = 1080, 1920
    roi = np.array([[420.0, 270.0], [1560.0, 330.0], [1500.0, 900.0], [360.0, 840.0]])
    p = fb.roi_dispatch_params(FarnebackParams(warp_precision="bf16", iter_schedule=(3, 3, 2, 1)),
                               h, w, fill_poly_mask(h, w, roi)[None])
    frames = torch.as_tensor(render_clip(5, h, w, seed=1)).to(card)
    level = 3 if kernel == "K2 bf16" else 0
    lv, hk, wk = fb._level_image(frames.float(), level, p, h, w)
    lv = lv.contiguous()
    if kernel == "K1":
        assert torch.equal(fc.poly_exp_cf(lv, p.poly_n, p.poly_sigma),
                           fb.poly_exp_cf_plain(lv, p.poly_n, p.poly_sigma))
        return
    poly = fb.poly_exp_cf_plain(lv, p.poly_n, p.poly_sigma)
    r0, r1 = poly[:-1], poly[1:]
    rng = np.random.default_rng(41)
    flow = torch.as_tensor(rng.normal(size=(4, 2, hk, wk)).astype(np.float32) * 3).to(card)
    tiles = fb.box_tiles(p.roi_active_px[level], hk, wk)
    assert (tiles is None) == (level == 3)
    if kernel == "K2 bf16":
        assert torch.equal(fc.update_matrices_cf(r0, r1, flow, "bf16"),
                           fb.update_matrices_cf_plain(r0, r1, flow, "bf16"))
        return
    m = fb.update_matrices_cf_plain(r0, r1, flow, "bf16")
    if kernel == "K4 bf16":
        sel = fb.tile_list(4, tiles, hk, wk, card)
        base = torch.zeros_like(m)
        kern = fc.update_matrices_tiles_cf(r0, r1, flow, sel, base.clone(), fb.TILE, "bf16")
        plain = fb.update_matrices_tiles_cf_plain(r0, r1, flow, sel, base.clone(), fb.TILE, "bf16")
        assert torch.equal(kern, plain) and kern.abs().sum() > 0
        return
    box = fb.tile_box(tiles, hk, wk)
    kern = fc.update_flow_cf(m, p.winsize, p.gaussian_win, box, flow.clone())
    assert torch.equal(kern, fb.update_flow_cf_plain(m, p.winsize, p.gaussian_win, box,
                                                     flow.clone()))


@pytest.mark.parametrize("shape", [(2, 45, 67), (1, 33, 250), (2, 100, 256)])
@pytest.mark.parametrize("n_shards,halo", [(1, 0), (3, 16), (5, 4)])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_update_matrices_rows_kernel(card, shape, n_shards, halo, precision):
    """K2's row-offset instance on the row blocks of an image (ragged last
    block when H is not a multiple) against its plain version; one block
    without halo is K2 bit for bit."""
    b, h, w = shape
    p0 = fb.poly_exp_cf_plain(_img(shape, 34).to(card), 5, 1.2)
    p1 = fb.poly_exp_cf_plain(_img(shape, 35).to(card), 5, 1.2)
    flow = torch.as_tensor(
        np.random.default_rng(36).normal(size=(b, 2, h, w)).astype(np.float32) * 6).to(card)
    step = -(-h // n_shards)
    for off in range(0, h, step):
        rows = min(step, h - off)
        k = min(halo, off, h - off - rows)  # the band the image has on both sides
        r1 = p1[:, :, off - k:off + rows + k].contiguous()
        args = (p0[:, :, off:off + rows].contiguous(), r1,
                flow[:, :, off:off + rows].contiguous(), off, h, precision)
        kern = fc.update_matrices_rows_cf(*args)
        plain = fb.update_matrices_rows_cf_plain(*args)
        assert torch.isfinite(kern).all() and _rel(kern, plain) <= 1e-5  # K2's bar
    if n_shards == 1:
        assert torch.equal(kern, fc.update_matrices_cf(p0, p1, flow, precision))


@pytest.mark.parametrize("n_shards,h,w,levels", [(4, 128, 96, 1), (4, 192, 256, 3),
                                                 (3, 120, 160, 3)])
def test_sharded_flow_on_the_card(card, n_shards, h, w, levels):
    """farneback_flow_sharded over a layout of shards on the card against the
    unsharded flow on the card (≤ 1e-4 px) and against itself on the CPU."""
    from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh
    from btcs_pnes_optical_flow_tpu_torch.parallel.spatial import farneback_flow_sharded

    yy, xx = np.mgrid[0:h + 8, 0:w + 8]
    base = (np.sin(xx / 7) * np.cos(yy / 9) + 0.5 * np.sin(xx / 3 + yy / 5)) * 60 + 128
    base += np.random.default_rng(37).normal(0, 1, base.shape)
    prev = np.stack([base[:h, :w], base[3:h + 3, 2:w + 2]]).astype(np.uint8)
    curr = np.stack([base[2:h + 2, 1:w + 1], base[4:h + 4, 5:w + 5]]).astype(np.uint8)
    p = FarnebackParams(levels=levels)
    fc.reset_launch_counts()
    out = farneback_flow_sharded(prev, curr, p, Mesh([card] * n_shards, ("spatial",)))
    assert fc.LAUNCHES["update_matrices_rows"] > 0 and fc.LAUNCHES["poly_exp"] > 0
    ref = fb.farneback_flow(torch.as_tensor(prev, device=card), torch.as_tensor(curr, device=card),
                            p)
    assert out.device == card and float((out - ref).abs().max()) <= 1e-4
    cpu = farneback_flow_sharded(prev, curr, p, Mesh(["cpu"] * n_shards, ("spatial",)))
    assert float((out.cpu() - cpu).abs().max()) <= 1e-3  # the path's px bar


def test_cohort_over_a_mesh_of_shards_on_the_card(card):
    """run_cohort and cohort_step over four shards on the card equal the
    one-device run."""
    from btcs_pnes_optical_flow_tpu_torch.config import MetricParams, PCAParams, PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.parallel import cohort
    from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh
    from btcs_pnes_optical_flow_tpu_torch.parallel.runner import run_cohort

    cfg = PipelineConfig(metrics=MetricParams(window_sec=2.0))
    one = run_cohort(_cohort_items(5, 49), cfg, 16, mesh=Mesh([card]), device=card)
    four = run_cohort(_cohort_items(5, 49), cfg, 16, mesh=Mesh([card] * 4), device=card)
    assert repr(one) == repr(four)
    clips = np.stack([it.video[:4] for it in _cohort_items(6, 4)])
    prev, curr = clips[:, :-1], clips[:, 1:]
    ex = np.tile(np.array([1.0, 0.0], np.float32), (6, 3, 1))
    masks = np.ones((1, 64, 96), bool)
    live = np.ones((6, 3), bool)
    args = (prev, curr, ex, ex[..., ::-1].copy(), masks, live, FarnebackParams(levels=1),
            PCAParams(win_sec=0.1, step_sec=0.05, max_finite_runs=4))
    a = cohort.cohort_step(*args, device=card)
    m = cohort.cohort_step(*args, mesh=Mesh([card] * 4))
    for x, y in zip(a, m):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-7, equal_nan=True)


def _metric_rows(k=12, n=420):
    """k PC1-like rows at 30 and 32 fps (two window shapes), one with too
    few valid samples and one with too few in the 0–10 s window."""
    rng = np.random.default_rng(9)
    t_all = np.full((k, n), np.nan)
    p_all = np.full((k, n), np.nan)
    for i in range(k):
        fs = 30.0 if i % 2 else 32.0
        t = np.arange(n) / fs
        x = (np.exp(-0.25 * t) * np.sin(2 * np.pi * (3.0 * t - 0.04 * t * t))
             + 0.05 * rng.normal(size=n))
        t_all[i], p_all[i] = t, x
    p_all[0, 5:] = np.nan
    t_all[1, 6:] += 30.0
    return t_all, p_all


@pytest.mark.parametrize("rows_per_block", [1, 5])
def test_metric_head_batched_on_the_card(card, rows_per_block, monkeypatch):
    """pc1_metrics_batch on the card in row blocks: equal to K calls of
    pc1_metrics on the card (rel 1e-6) and to the CPU batch (rel 1e-4)."""
    from btcs_pnes_optical_flow_tpu_torch.models import metrics as mm

    t_all, p_all = _metric_rows()
    n = t_all.shape[1]
    monkeypatch.setattr(mm, "BLOCK_ELEMS", rows_per_block * (n - 1) * n)
    got = mm.pc1_metrics_batch(t_all, p_all, device=card)
    rows = [mm.pc1_metrics(t, p, device=card) for t, p in zip(t_all, p_all)]
    cpu = mm.pc1_metrics_batch(t_all, p_all, device="cpu")
    assert list(got.status[:2]) == [1, 2] and np.all(got.status[2:] == 0)
    for ref, rtol in ((mm.PC1Metrics(*(np.array([float(getattr(r, f)) for r in rows])
                                       for f in mm.PC1Metrics._fields)), 1e-6), (cpu, 1e-4)):
        assert np.array_equal(got.status, ref.status)
        assert np.array_equal(got.peak_n, ref.peak_n)
        for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=rtol, err_msg=f)


# --- TV-L1 through run_full at 1080p (BASELINE config 5) -----------------

HD_ROI = [[420.0, 270.0], [1560.0, 330.0], [1500.0, 900.0], [360.0, 840.0]]


def _hd_tvl1_recording(card, n=41):
    """A 1080p recording of n frames (a 17-frame rendered base played
    forward and back, the benchmark's law) and its skeleton."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark.lib import calls, render

    base = render.render_pool({"frames": 17, "blobs": [{"x_frac": 0.5, "hz": 3.0}]}, 1, 1080,
                              1920, 30.0, 2**31 + 29, card)[0]
    return base, calls.played_source(base, "pingpong", n, 30.0), calls.skeleton(n, 30.0, 0.3)


def _hd_tvl1_run(card, chunk, n=41, kernels=True, monkeypatch=None):
    """run_full under PipelineConfig(flow=TVL1Params()) on the card: (flow, pc1)."""
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.models import flow as fm
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full

    if not kernels:
        plain = tv.tvl1_flow
        monkeypatch.setattr(fm, "tvl1_flow", lambda *a, **k: plain(*a, kernels=False, **k))
    _, src, skel = _hd_tvl1_recording(card, n)
    flow, pc1, _ = run_full(src, skel, [np.asarray(HD_ROI)], PipelineConfig(flow=tv.TVL1Params()),
                            chunk, device=card)
    return flow, pc1


def test_run_full_tvl1_at_1080p_kernels_match_plain(card, monkeypatch):
    """run_full under TVL1Params() on three 1080p chunks (16, 16 and a
    padded 8 pairs): K5 at every level, K6 at 270x480 (the levels above run
    the epsilon loop), within the path's px bar of the plain versions."""
    tc.reset_launch_counts()
    kern, _ = _hd_tvl1_run(card, 16)
    # Per chunk: 3 levels x 5 warps of K5, 5 chains of 8+8+8+6 at level 2,
    # and at least one ε step a warp at levels 0-1.
    launches = dict(tc.LAUNCHES)
    assert launches.pop("pd_eps_step") >= 30
    assert launches == {"warp_sample": 45, "pd_chain": 15, "pd_block": 60}
    plain, _ = _hd_tvl1_run(card, 16, kernels=False, monkeypatch=monkeypatch)
    for c in ("vx", "vy", "mag"):
        a, b = getattr(kern, c)[1:], getattr(plain, c)[1:]
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-3, c  # the path's px bar


def test_run_full_tvl1_does_not_depend_on_the_chunk(card):
    """The per-pair epsilon stop and the per-pair reduction: 16-pair and
    7-pair chunks give the same bits on the card, features and PC1 (81
    frames: the 2-s PCA window fits)."""
    (a, pa), (b, pb) = _hd_tvl1_run(card, 16, n=81), _hd_tvl1_run(card, 7, n=81)
    for c in ("vx", "vy", "mag"):
        assert np.array_equal(getattr(a, c), getattr(b, c), equal_nan=True), c
    assert np.isfinite(pa).any() and np.array_equal(pa, pb, equal_nan=True)


def test_run_full_tvl1_matches_the_plain_reference_at_1080p(card):
    """One 16-pair chunk at 1080x1920 against the benchmark's plain TV-L1
    reference (TF32 off, as the benchmark's check runs it)."""
    from benchmark.reference import tvl1 as rt
    from benchmark.reference.farneback import roi_features
    from benchmark.reference.roi import fill_poly

    base, _, _ = _hd_tvl1_recording(card)
    prog, _ = _hd_tvl1_run(card, 16, n=17)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fr = torch.as_tensor(base, device=card)
        ref = roi_features(rt.flow_pairs(fr[:-1], fr[1:], rt.Params()), 0.3,
                           [fill_poly(1080, 1920, HD_ROI)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = np.stack([prog.vx, prog.vy, prog.mag], 1)[1:]
    # The same TV-L1 with divisions where the program multiplies by
    # reciprocals: ulps a step, through the data term's thresholds, the
    # epsilon stop's exit by an iteration, averaged over the ROI.
    assert np.abs(got - ref).max() <= 1e-4


# --- The flow stage's chunk copy from page-locked memory -----------------

def _hd_recording(card, n=361):
    """A 1080p recording of n frames under the benchmark's rec1080 flow
    settings: (source, skeleton, config)."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark.lib import calls, render
    from benchmark.lib.spec import Spec

    base = render.render_pool({"frames": 33, "blobs": [{"x_frac": 0.5, "hz": 3.0}]}, 1, 1080,
                              1920, 30.0, 2**31 + 41, card)[0]
    return (calls.played_source(base, "pingpong", n, 30.0), calls.skeleton(n, 30.0, 0.3),
            calls.pipeline_config(Spec().config("rec1080")))


def _pageable_chunks(monkeypatch):
    """Make ``run_flow_stage``'s prefetcher emit NumPy chunks, as for the CPU."""
    from btcs_pnes_optical_flow_tpu_torch.dataio import video
    from btcs_pnes_optical_flow_tpu_torch.models import pipeline

    class Pageable(video.ChunkPrefetcher):
        def __init__(self, source, chunk_pairs, depth=2, *, device=None):
            super().__init__(source, chunk_pairs, depth)
    monkeypatch.setattr(pipeline, "ChunkPrefetcher", Pageable)


def test_run_full_gives_the_same_bits_from_pinned_and_pageable_chunks(card, monkeypatch):
    """run_full on 361 1080p frames in 64-pair chunks (a 40-pair tail):
    frames staged in page-locked memory and copied without a sync, and the
    same chunks handed over as NumPy arrays (pageable, blocking copies),
    give equal features, PC1 and metric rows."""
    from btcs_pnes_optical_flow_tpu_torch.models import chunks
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full

    seen = []
    real = chunks.ChunkDriver._launch

    def launch(self, frames, axes, masks):
        seen.append(isinstance(frames, torch.Tensor) and frames.is_pinned()
                    and axes.is_pinned())
        return real(self, frames, axes, masks)
    monkeypatch.setattr(chunks.ChunkDriver, "_launch", launch)

    def run():
        src, skel, cfg = _hd_recording(card)
        return run_full(src, skel, [np.asarray(HD_ROI)], cfg, 64, device=card)

    pinned = run()
    assert seen == [True] * 6
    seen.clear()
    _pageable_chunks(monkeypatch)
    pageable = run()
    assert seen == [False] * 6
    for c in ("vx", "vy", "mag"):
        a, b = getattr(pinned[0], c), getattr(pageable[0], c)
        assert np.isfinite(a[1:]).all() and np.array_equal(a, b, equal_nan=True), c
    assert np.isfinite(pinned[1]).any() and np.array_equal(pinned[1], pageable[1],
                                                           equal_nan=True)
    for ra, rb in zip(pinned[2], pageable[2], strict=True):
        for f in ra._fields:
            assert np.array_equal(getattr(ra, f).cpu().numpy(), getattr(rb, f).cpu().numpy(),
                                  equal_nan=True), f


def test_pinned_chunk_buffers_are_not_reused_while_a_copy_lags(card):
    """200 chunks of 2 pairs of distinct 96x128 frames, staged in page-locked
    memory by the prefetch thread, through ChunkDriver with a sync-free flow
    that queues ~1 ms of device sleep first, so that each copy waits on the
    stream behind the chunk before it while the thread stacks later chunks
    into new blocks: every chunk's features equal those of the same chunk
    copied and computed alone, with a sync after each."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource, ChunkPrefetcher
    from btcs_pnes_optical_flow_tpu_torch.models.chunks import ChunkDriver
    from btcs_pnes_optical_flow_tpu_torch.models.flow import FlowFeatures

    n, chunk = 401, 2
    rng = np.random.default_rng(23)
    frames = rng.integers(0, 256, (n, 96, 128), dtype=np.uint8)
    ex = rng.random((n, 2)).astype(np.float32)
    ey = rng.random((n, 2)).astype(np.float32)
    masks = torch.ones((2, 96, 128), dtype=torch.bool, device=card)

    def flow(fr, ex_d, ey_d, m, params, sleep=True):
        if sleep:
            torch.cuda._sleep(2_000_000)
        f = fr.to(torch.float64)
        cols = lambda v: v[:, None].expand(-1, m.shape[0])  # noqa: E731
        return (FlowFeatures(cols((f[1:] - f[:-1]).sum((1, 2)) + ex_d[:, 0]),
                             cols((f[1:] * f[:-1]).sum((1, 2)) + ey_d[:, 1]),
                             cols(f[1:].sum((1, 2)))),
                torch.zeros(len(fr) - 1, dtype=torch.int32, device=fr.device))

    got = {}
    driver = ChunkDriver(flow, None, chunk, lambda k, *f: got.__setitem__(k, f), str)
    pinned = 0
    for first, fr, _ in ChunkPrefetcher(ArraySource(frames, 30.0), chunk, device=card):
        pinned += fr.is_pinned()
        cur = slice(first + 1, first + 1 + chunk)
        driver.submit(first, fr, ex[cur], ey[cur], np.ones(chunk, bool), chunk, masks)
    driver.finish()
    assert pinned == len(got) == (n - 1) // chunk

    for first, feats in got.items():
        cur = slice(first + 1, first + 1 + chunk)
        want, _ = flow(torch.as_tensor(frames[first:first + chunk + 1], device=card),
                       torch.as_tensor(ex[cur], device=card),
                       torch.as_tensor(ey[cur], device=card), masks, None, sleep=False)
        torch.cuda.synchronize(card)
        for g, w in zip(feats, want, strict=True):
            assert np.array_equal(g, w.cpu().numpy()), first


def test_the_chunk_copy_is_pinned_and_waits_on_no_sync(card):
    """A profiled run_flow_stage on 361 1080p frames (five 64-pair chunks
    and a 40-pair tail): the "flow.copy" ranges hold no
    cudaStreamSynchronize, and each chunk's frames and axes go as two
    host-to-device copies the profiler names "Pinned", the longest copy of
    the call among them."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark.lib import trace

    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    src, skel, cfg = _hd_recording(card)
    out = {}
    with trace.profiled(out):
        run_flow_stage(src, skel, [np.asarray(HD_ROI)], cfg, 64, device=card,
                       timer=StageTimer(card))
    tr = out["trace"]
    copies = [(s, e) for s, e, n in tr.host if n == "flow.copy"]
    assert len(copies) == 6
    syncs = [s for s, _, n in tr.host if n == "cudaStreamSynchronize"]
    assert syncs and not [s for s in syncs if any(a <= s < b for a, b in copies)]
    htod = sorted(((e - s, n) for s, e, n in tr.dev if "Memcpy HtoD" in n), reverse=True)
    assert sum("Pinned" in n for _, n in htod) == 2 * 6
    assert "Pinned" in htod[0][1]
