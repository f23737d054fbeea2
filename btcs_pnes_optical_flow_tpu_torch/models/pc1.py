"""Dynamic-PC1 stage: band-pass + sliding-window PCA.

Port of ``btcs_pnes_optical_flow_tpu/models/pc1.py`` (reference:
optical_PCA.py main(), :241-270): NaN-robust zero-phase Butterworth
band-pass of the body-axis velocities, then the sliding-window PCA
projection.
"""

from __future__ import annotations

import torch

from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
from btcs_pnes_optical_flow_tpu_torch.ops import filters, pca


def pc1_from_flow(vx: torch.Tensor, vy: torch.Tensor, params: PCAParams = PCAParams(),
                  engine: str = "scan") -> torch.Tensor:
    """(vx_body, vy_body) (N,) → pc1_dyn waveform (N,).

    Both signals go through the band-pass as one batch.  Windows use the
    reference's hardcoded fs (optical_PCA.py:50,174-175), not timestamps.
    """
    sos, zi, padreq = filters.make_bandpass(
        params.bpf_low_hz, params.bpf_high_hz, params.fs, params.bpf_order
    )
    zi_t = torch.as_tensor(zi, dtype=vx.dtype, device=vx.device)
    both = filters.bandpass_nanrobust(
        torch.stack([vx, vy]), sos, zi_t, padreq, max_runs=params.max_finite_runs,
        engine=engine,
    )
    return pca.dynamic_pc1_sliding(
        both[0], both[1], params.win_n, params.step_n, params.min_samples_pca
    )
