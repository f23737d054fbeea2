"""The port's Farnebäck engine started from an initial flow
(``FarnebackParams.use_initial_flow``, cv2's OPTFLOW_USE_INITIAL_FLOW)
against the JAX package and cv2 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from btcs_pnes_optical_flow_tpu.config import FarnebackParams
from btcs_pnes_optical_flow_tpu.ops import farneback as jfb
from btcs_pnes_optical_flow_tpu_torch.config import from_fields
from btcs_pnes_optical_flow_tpu_torch.ops import farneback as tfb

torch.set_num_threads(1)

H, W = 64, 80
INIT = dataclasses.replace(FarnebackParams(), use_initial_flow=True)


def _texture(rng, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xx = xx + shift[0]
    yy = yy + shift[1]
    img = (np.sin(xx / 7) * np.cos(yy / 9) + 0.5 * np.sin(xx / 3 + yy / 5)) * 60 + 128
    return np.clip(img + rng.normal(0, 1, (H, W)), 0, 255).astype(np.uint8)


def _init_flow(base=(-1.0, 0.5), ripple=(0.3, 0.2)):
    """A constant guess plus a smooth ripple, so the coarsest-level resize
    of flow0 has something to interpolate."""
    yy, xx = np.mgrid[0:H, 0:W]
    init = np.empty((H, W, 2), np.float32)
    init[..., 0] = base[0] + ripple[0] * np.sin(xx / 9.0)
    init[..., 1] = base[1] + ripple[1] * np.cos(yy / 7.0)
    return init


def _epe(a, b):
    return np.sqrt(((a - b) ** 2).sum(-1))


# (levels, iterations, frame shift, flow0 base, ripple).  "pyramid" is the
# JAX package's cv2 case; there the pyramid recovers the motion from any
# start.  "single_level" runs 2 iterations on the full-size image only, so
# a 5.8-px motion is found only from the initial flow.
CASES = {
    "pyramid": (3, 3, (1.0, -0.6), (-1.0, 0.5), (0.3, 0.2)),
    "single_level": (0, 2, (5.0, -3.0), (-4.0, 2.5), (0.5, 0.4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_initial_flow_matches_jax_and_cv2(case, rng):
    import cv2

    levels, iters, shift, base, ripple = CASES[case]
    p = dataclasses.replace(INIT, levels=levels, iterations=iters)
    f0 = _texture(rng)
    f1 = _texture(rng, shift=shift)
    init = _init_flow(base, ripple)
    ref = np.asarray(jfb.farneback_flow(jnp.asarray(f0), jnp.asarray(f1), p,
                                        flow0=jnp.asarray(init)))
    mine = tfb.farneback_flow(torch.as_tensor(f0), torch.as_tensor(f1), from_fields(p),
                              torch.as_tensor(init)).numpy()
    assert mine.shape == ref.shape == (H, W, 2)
    # The JAX package's exact-engine bar for the whole path.
    assert np.abs(mine - ref).max() <= 1e-3
    cv = cv2.calcOpticalFlowFarneback(f0, f1, init.copy(), 0.5, levels, 15, iters, 5, 1.2,
                                      cv2.OPTFLOW_USE_INITIAL_FLOW)
    # The JAX package's own cv2 bar for this flag (tests/test_farneback.py).
    assert _epe(cv, mine).max() < 1e-3
    if case == "single_level":
        # The initial flow really took part: a zero start ends elsewhere.
        zero = tfb.farneback_flow(torch.as_tensor(f0), torch.as_tensor(f1),
                                  from_fields(p)).numpy()
        assert np.abs(zero - mine).max() > 0.5


def test_initial_flow_flag_and_argument_both_needed(rng):
    f0 = torch.as_tensor(_texture(rng))
    f1 = torch.as_tensor(_texture(rng, shift=(0.7, 0.4)))
    init = torch.as_tensor(_init_flow())
    zero = tfb.farneback_flow(f0, f1)
    # The flag without a flow0 starts from zero ...
    assert torch.equal(tfb.farneback_flow(f0, f1, from_fields(INIT)), zero)
    # ... and a flow0 without the flag is ignored, as cv2 ignores it.
    assert torch.equal(tfb.farneback_flow(f0, f1, from_fields(FarnebackParams()), init), zero)


def test_initial_flow_seq_equals_pairs(rng):
    frames = np.stack([_texture(rng, shift=(0.8 * i, -0.5 * i)) for i in range(4)])
    init = np.stack([_init_flow() * (1.0 + 0.1 * i) for i in range(3)])
    t = torch.as_tensor(frames)
    p = from_fields(INIT)
    seq = tfb.farneback_flow_seq(t, p, torch.as_tensor(init))
    pairs = tfb.farneback_flow(t[:-1], t[1:], p, torch.as_tensor(init))
    assert seq.shape == (3, H, W, 2)
    assert torch.equal(seq, pairs)
    assert not torch.equal(seq, tfb.farneback_flow_seq(t, p))
