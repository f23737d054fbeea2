"""The port's chunked PC1 (models/streaming.py) on the CPU, against the
port's full-signal PC1 and the JAX package's pc1_streaming."""

import numpy as np
import pytest
import torch

from btcs_pnes_optical_flow_tpu.models.streaming import pc1_streaming as jpc1_streaming
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
from btcs_pnes_optical_flow_tpu_torch.models.streaming import pc1_streaming
from tests.test_streaming import _long_signal

torch.set_num_threads(1)

N = 3000


@pytest.fixture(scope="module")
def signal():
    return _long_signal(N, np.random.default_rng(0))


@pytest.fixture(scope="module")
def chunked(signal):
    return pc1_streaming(*signal, chunk_n=1024, margin_n=240, device="cpu")


def test_pc1_streaming_matches_full_signal(signal, chunked):
    vx, vy = signal
    full = pc1_from_flow(torch.as_tensor(vx, dtype=torch.float32),
                         torch.as_tensor(vy, dtype=torch.float32)).numpy()
    assert chunked.shape == (N,) and chunked.dtype == np.float64
    assert np.array_equal(np.isnan(chunked), np.isnan(full))
    fin = np.isfinite(full)
    # Transient tolerance: band-pass boundary effects are ~2e-4 relative.
    assert np.corrcoef(chunked[fin], full[fin])[0, 1] > 0.9999
    np.testing.assert_allclose(chunked[fin], full[fin], rtol=5e-3, atol=5e-3)
    # A signal that fits one chunk is the full-signal PC1.
    short = pc1_streaming(vx[:600], vy[:600], chunk_n=1024, device="cpu")
    np.testing.assert_array_equal(short, pc1_from_flow(
        torch.as_tensor(vx[:600], dtype=torch.float32),
        torch.as_tensor(vy[:600], dtype=torch.float32)).numpy())


def test_pc1_streaming_matches_jax(signal, chunked):
    ref = jpc1_streaming(*signal, chunk_n=1024, margin_n=240)
    assert np.array_equal(np.isnan(chunked), np.isnan(ref))
    fin = np.isfinite(ref)
    # The PC1 contract of tests/test_torch_pc1.py: the same float32 scan,
    # window sums taken in another order.
    assert np.corrcoef(chunked[fin], ref[fin])[0, 1] >= 0.9999
    assert np.abs(chunked[fin] - ref[fin]).max() <= 1e-4 * np.abs(ref[fin]).max()


def test_pc1_streaming_matches_full_signal_over_ten_minutes():
    """18000 samples (10 minutes at 30 fps) of the same signal, whose chirp
    leaves the pass band after ~125 s: the chunks' signs follow the full
    signal through the out-of-band stretches (the JAX package's rule, a dot
    product over the leading margin, negates every chunk after the first
    here)."""
    vx, vy = _long_signal(18000, np.random.default_rng(0))
    full = pc1_from_flow(torch.as_tensor(vx, dtype=torch.float32),
                         torch.as_tensor(vy, dtype=torch.float32), engine="assoc").numpy()
    chunked = pc1_streaming(vx, vy, engine="assoc", device="cpu")
    assert np.array_equal(np.isnan(chunked), np.isnan(full))
    fin = np.isfinite(full)
    assert np.corrcoef(chunked[fin], full[fin])[0, 1] > 0.9999
    for s in range(0, 18000, 4095):  # every chunk, not only the whole
        seg = slice(s, s + 4095)
        assert np.dot(chunked[seg][fin[seg]], full[seg][fin[seg]]) > 0
    # The JAX package's rule on the second chunk's own output: the dot
    # product over its leading margin with what precedes it (the first
    # chunk, equal to the full signal there) keeps its sign, yet the part
    # it keeps is the full signal negated.
    c, m = 4095, 240
    second = pc1_from_flow(torch.as_tensor(vx[c - m : 2 * c + m], dtype=torch.float32),
                           torch.as_tensor(vy[c - m : 2 * c + m], dtype=torch.float32),
                           engine="assoc").numpy()
    assert np.nansum(second[:m] * full[c - m : c]) > 0
    assert np.nansum(second[m : m + c] * full[c : 2 * c]) < 0


def test_pc1_streaming_needs_a_card_it_is_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pc1_streaming(np.zeros(10), np.zeros(10), device="cuda")
