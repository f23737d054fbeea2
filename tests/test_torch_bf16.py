"""The bf16 warp (``warp_precision="bf16"``, the JAX package's production
flow config) against the JAX package on the CPU.

The TPU kernel's bf16 candidate MAC (``farneback_pallas.py`` ``_make_kernel``)
rounds r1's taps, the weights ``ax`` and ``1 − ax`` and each product and sum
of a row's horizontal lerp to bfloat16; the port's plain version
(``ops/farneback.py _lerp_x``) does the same in one chain per row.  JAX's
interpreted kernel runs under XLA's CPU backend, which (a) by default keeps
excess precision, dropping the bf16 rounding where a bf16 result is widened
straight back to float32, and (b) contracts ``a·b + c`` into one FMA.  The
kernel therefore runs in a subprocess with
``--xla_allow_excess_precision=false``, which makes (a) round as written, and
the bit-equality check uses inputs on which (b) cannot change a bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams as JFarnebackParams
from btcs_pnes_optical_flow_tpu.config import PipelineConfig as JPipelineConfig
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu.ops.farneback_fused import roi_dispatch_params as j_roi_params
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb
from tests.test_fused_driver import _textured_frames

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pallas_interpret.py:53-71's geometry: 120×500, reach (4, 4),
# base 24, s_cap 4, so n_s = 4 slots and one chain spans s_block = 5.
H, W = 120, 500
ONE_CHAIN, DEFAULT_S_BLOCK = 5, 4
# The JAX interpreted kernel, one call per case, in a process of its own.
_KERNEL = r"""
import sys
import numpy as np
import jax.numpy as jnp
from btcs_pnes_optical_flow_tpu.ops import farneback_pallas as fbp

H, W = 120, 500
data = np.load(sys.argv[1])
out = {}
for name in data["names"]:
    r0, flow, s_block = data[name + "_r0"], data[name + "_flow"], int(data[name + "_s_block"])
    ht, wt, tw = fbp.warp_grid(H, W)
    b = r0.shape[0]
    r0p = np.zeros((b, 5, ht, wt), np.float32)
    r0p[:, :, :H, :W] = r0
    fp = np.zeros((b, 2, ht, wt), np.float32)
    fp[:, :, :H, :W] = flow
    r1p = fbp.pad_for_band(jnp.asarray(r0p), H, W, 4, 4, 24, tw=tw)
    m, clip, _ = fbp.update_matrices_banded_cf(
        jnp.asarray(r0p), jnp.asarray(fp), r1p, H, W, d_max_y=4, d_max_x=4, base_max=24,
        s_cap=4, precision="bf16", s_block=s_block, tw=tw, interpret=True)
    out[name + "_m"] = np.asarray(m)[:, :, :H, :W]
    out[name + "_clip"] = np.asarray(clip)
np.savez(sys.argv[2], **out)
"""


def _cases():
    """name → (r0 (B, 5, H, W), flow (B, 2, H, W), s_block); r1 is r0 (the
    kernel's band is padded from it).  Flows within ±1.4 px keep every
    tile's clip count at 0 under reach (4, 4) and s_cap 4."""
    rng = np.random.default_rng(0)
    # FMA-free: integer rows (dy = 0, so the vertical blend is top exactly)
    # and two of the three A channels zero per frame, which leaves every
    # product of the M formulas alone (FMA or not, one rounding each) on
    # the channels listed in EXACT.
    iso = rng.normal(0, 1, (3, 5, H, W)).astype(np.float32)
    for b, zero in enumerate([(3, 4), (2, 3), (2, 4)]):
        iso[b, list(zero)] = 0.0
    iso_flow = np.zeros((3, 2, H, W), np.float32)
    iso_flow[:, 0] = rng.uniform(-1.4, 1.4, (3, H, W))
    gen = rng.normal(0, 1, (2, 5, H, W)).astype(np.float32)
    gen_flow = rng.uniform(-1.4, 1.4, (2, 2, H, W)).astype(np.float32)
    return {"isolated": (iso, iso_flow, ONE_CHAIN), "general": (gen, gen_flow, ONE_CHAIN),
            "default": (gen, gen_flow, DEFAULT_S_BLOCK)}


# Frame of the "isolated" case → the M channels that no FMA contraction can
# reach: with r6 = r5 = 0 every channel; with r4 = r5 = 0 (or r4 = r6 = 0)
# all but h_x = r6·r2 + r5·r3, whose r2 (r3) carries r6·dx (r5·dx).
EXACT = {0: [0, 1, 2, 3, 4], 1: [0, 1, 2, 3], 2: [0, 1, 2, 3]}


@pytest.fixture(scope="module")
def jax_kernel(tmp_path_factory):
    """M and clip counts of JAX's interpreted bf16 kernel for each case."""
    tmp = tmp_path_factory.mktemp("bf16")
    cases = _cases()
    arrays = {"names": np.array(list(cases))}
    for name, (r0, flow, s_block) in cases.items():
        arrays.update({name + "_r0": r0, name + "_flow": flow, name + "_s_block": s_block})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", _KERNEL, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = np.load(tmp / "out.npz")
    return cases, {k: out[k] for k in out.files}


def _port(r0, flow, precision="bf16"):
    r0t = torch.as_tensor(r0)
    return tfb.update_matrices_cf_plain(r0t, r0t, torch.as_tensor(flow), precision).numpy()


def test_bf16_k2_bit_equal_to_the_jax_kernel_with_one_chain(jax_kernel):
    cases, ref = jax_kernel
    r0, flow, _ = cases["isolated"]
    assert not ref["isolated_clip"].any()
    mine = _port(r0, flow)
    for b, channels in EXACT.items():
        for c in channels:
            assert np.array_equal(mine[b, c], ref["isolated_m"][b, c]), (b, c)
    # Not vacuous: the fp32 lerp differs from the kernel on most pixels.
    fp32 = _port(r0, flow, "fp32")
    assert (fp32[0, 0] != ref["isolated_m"][0, 0]).mean() > 0.5


def _fma_slack(m):
    """XLA's FMA contractions (in the vertical blend, the Δb fold and the M
    products) each move a float32 result by at most one ulp; through the M
    formulas that stays within 16 ulps of max|M|."""
    return 16 * np.spacing(np.float32(np.abs(m).max()))


def test_bf16_k2_matches_the_jax_kernel_on_general_inputs(jax_kernel):
    """All five channels, fractional rows: equal up to XLA's FMA
    contractions."""
    cases, ref = jax_kernel
    r0, flow, _ = cases["general"]
    assert not ref["general_clip"].any()
    mine = _port(r0, flow)
    d = np.abs(mine - ref["general_m"])
    assert d.max() <= _fma_slack(ref["general_m"])
    assert (d == 0).mean() > 0.5


def _split_chain_bound(r0, flow):
    """max |ΔM| per channel when a pixel's two horizontal taps fall in two
    bf16 chains (the default s_block = 4: a pixel whose floor slot is the
    last of a 4-slot block).  The kernel then sums the two rounded products
    in float32 instead of rounding their sum to bf16, so each sampled value
    s_c moves by at most one bf16 ulp of a row value, δ = 2^-7·S with S =
    max|r1| (the lerp of bf16 taps is a convex combination).  Through
    r4 = (a + s)/2, r5 = (a + s)/2, r6 = (a + s)/4, r2,3 = (a − s)/2 + r·dy
    + r·dx (rim damping ≤ 1 only shrinks them) and the M products."""
    a = float(np.abs(r0).max())
    s = a
    dmax = float(np.abs(flow).max())
    delta = 2.0 ** -7 * s
    r4 = r5 = (a + s) / 2
    r6 = (a + s) / 4
    r2 = r3 = (a + s) / 2 + dmax * r4 + dmax * r6
    d4 = d5 = delta / 2
    d6 = delta / 4
    d2 = d3 = delta / 2 + dmax * d4 + dmax * d6
    return np.array([
        2 * r4 * d4 + 2 * r6 * d6 + d4 * d4 + d6 * d6,
        (d4 + d5) * r6 + (r4 + r5) * d6 + (d4 + d5) * d6,
        2 * r5 * d5 + 2 * r6 * d6 + d5 * d5 + d6 * d6,
        r4 * d2 + r2 * d4 + r6 * d3 + r3 * d6 + d4 * d2 + d6 * d3,
        r6 * d2 + r2 * d6 + r5 * d3 + r3 * d5 + d6 * d2 + d5 * d3,
    ])


def test_bf16_k2_within_the_split_chain_bound_with_the_default_s_block(jax_kernel):
    cases, ref = jax_kernel
    r0, flow, _ = cases["default"]
    assert not ref["default_clip"].any()
    m_ref = ref["default_m"]
    d = np.abs(_port(r0, flow) - m_ref).max(axis=(0, 2, 3))
    bound = _split_chain_bound(r0, flow) + _fma_slack(m_ref)
    assert (d <= bound).all(), (d, bound)
    # The split chains are real: past the FMA slack on the A channels.
    assert d[0] > _fma_slack(m_ref) and d[2] > _fma_slack(m_ref)


def test_bf16_flow_within_0_05_px_of_the_exact_fp32_flow():
    """tests/test_fused_driver.py's frames and its bf16 EPE bar."""
    frames = _textured_frames(np.random.default_rng(7), 3, 64, 96)
    ref = np.asarray(jfb.farneback_flow(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]),
                                        JFarnebackParams(warp_engine="exact")))
    p = from_fields(JFarnebackParams(warp_precision="bf16"))
    mine = tfb.farneback_flow(torch.as_tensor(frames[:-1]), torch.as_tensor(frames[1:]), p)
    d = np.abs(mine.numpy() - ref)
    assert d.max() < 0.05
    assert d.max() > 1e-4  # bf16 rounds: not the fp32 flow


def test_flow_seq_under_the_jax_bench_flow_config():
    """bench.py:150-155's flow config (bf16 warp, iteration schedule
    (3, 3, 2, 1), coarse reach (4, 8, 8)) with its ROI boxes, carried across
    with from_fields: the ROI flow is within 0.05 px of the JAX exact
    engine's fp32 flow under the same schedule."""
    n, h, w = 5, 96, 128
    frames = _textured_frames(np.random.default_rng(3), n, h, w)
    roi = np.array([[28.0, 18.0], [104.0, 22.0], [100.0, 80.0], [24.0, 76.0]])  # bench ROI / 5
    mask = cvx.fill_poly_mask(h, w, roi)
    bench = dataclasses.replace(JPipelineConfig().flow, warp_precision="bf16",
                                iter_schedule=(3, 3, 2, 1), warp_coarse_reach=(4, 8, 8))
    jp = j_roi_params(bench, h, w, mask)
    p = from_fields(jp)
    assert p.roi_active_px == tfb.roi_dispatch_params(from_fields(bench), h, w,
                                                      mask).roi_active_px
    mine = tfb.farneback_flow_seq(torch.as_tensor(frames), p).numpy()
    ref = np.asarray(jfb.farneback_flow_seq(jnp.asarray(frames),
                                            dataclasses.replace(bench, warp_engine="exact")))
    d = np.abs(mine - ref)[:, mask]
    assert d.max() < 0.05
