"""Dynamic-PC1 stage: band-pass + sliding-window PCA.

Port of ``btcs_pnes_optical_flow_tpu/models/pc1.py`` (reference:
optical_PCA.py main(), :241-270): NaN-robust zero-phase Butterworth
band-pass of the body-axis velocities, then the sliding-window PCA
projection; ``pc1_from_flow_batch`` does it for several ROIs at once.
"""

from __future__ import annotations

import torch

from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
from btcs_pnes_optical_flow_tpu_torch.ops import filters, pca


def pc1_from_flow(vx: torch.Tensor, vy: torch.Tensor, params: PCAParams = PCAParams(),
                  engine: str = "scan") -> torch.Tensor:
    """(vx_body, vy_body) (N,) → pc1_dyn waveform (N,): the batch of one.

    Both signals go through the band-pass as one batch.  Windows use the
    reference's hardcoded fs (optical_PCA.py:50,174-175), not timestamps.
    """
    return pc1_from_flow_batch(vx[None], vy[None], params, engine)[0]


def pc1_from_flow_batch(vx: torch.Tensor, vy: torch.Tensor, params: PCAParams = PCAParams(),
                        engine: str = "scan") -> torch.Tensor:
    """Batched variant: (B, N) velocities → (B, N) pc1, row b equal to
    ``pc1_from_flow(vx[b], vy[b])``.  The band-pass filters all 2B signals
    as one batch; the sliding-window PCA runs row by row."""
    sos, zi, padreq = filters.make_bandpass(
        params.bpf_low_hz, params.bpf_high_hz, params.fs, params.bpf_order
    )
    zi_t = torch.as_tensor(zi, dtype=vx.dtype, device=vx.device)
    both = filters.bandpass_nanrobust(
        torch.stack([vx, vy]), sos, zi_t, padreq, max_runs=params.max_finite_runs,
        engine=engine,
    )
    rows = [pca.dynamic_pc1_sliding(both[0, b], both[1, b], params.win_n, params.step_n,
                                    params.min_samples_pca) for b in range(vx.shape[0])]
    return torch.stack(rows)
