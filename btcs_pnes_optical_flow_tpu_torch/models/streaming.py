"""Time-chunked PC1 for long recordings (sequence-chunked streaming).

Port of ``btcs_pnes_optical_flow_tpu/models/streaming.py``.  A 10-minute
recording is ~18k frames: the flow stage already streams (chunked frame
pairs with prefetch, ``models/pipeline.py``); this module chunks the
signal stage, so that the band-pass and the windowed PCA run in bounded
device memory, one chunk shape at a time.

Chunking strategy (overlap-save):

- each chunk is processed with a margin M on both sides; only the
  interior [M, M+C) is kept;
- the zero-phase band-pass transient decays like |p|^n with the slowest
  pole |p| ≈ 0.966 (0.5 Hz edge at 30 fps), so M = 240 samples attenuates
  boundary effects to ~2e-4 relative;
- chunk starts are multiples of the PCA step, so the sliding-window grid
  of every chunk coincides with the full signal's, making the windowed PCA
  exact on the kept interior;
- the per-window sign-stabilisation chain is translation-invariant up to
  one global sign per chunk, resolved against the previous chunk over the
  2M samples both buffers hold, [s - M, s + M) around the chunk start s,
  by a vote of the samples' signs.

The JAX package resolves that sign by the dot product over the leading
margin [s - M, s) alone.  Where the signal is out of band (noise, so the
window axes wander), the band-pass transient at a buffer's start can flip
one link of the sign chain inside the margin; the margin's part before the
flip then outweighs the part after it, and the kept chunk comes out
negated (tests/test_streaming.py's signal at 18000 samples, 10 minutes at
30 fps, whose chirp leaves the pass band after ~125 s: every chunk after
the first).  Over [s - M, s + M)
the previous chunk's settled output and this chunk's settled interior hold
most of the samples, and counting signs keeps a loud stretch before the
flip from outvoting them.
"""

from __future__ import annotations

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device


def pc1_streaming(
    vx: np.ndarray,
    vy: np.ndarray,
    params: PCAParams = PCAParams(),
    chunk_n: int = 4096,
    margin_n: int = 240,
    engine: str = "scan",
    *,
    device,
) -> np.ndarray:
    """Chunked dynamic PC1 on ``device``, equal (to float and transient
    tolerance) to the full-signal ``pc1_from_flow``; (N,) float64."""
    device = resolve_device(device)

    def pc1_of(x, y):
        return pc1_from_flow(
            torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(y, np.float64), dtype=torch.float32, device=device),
            params, engine,
        ).cpu().numpy().astype(np.float64)

    n = len(vx)
    if n <= chunk_n + 2 * margin_n:
        return pc1_of(vx, vy)

    step = params.step_n
    # Align chunk boundaries to the sliding-window grid.
    chunk_n = (chunk_n // step) * step
    margin_n = max(((margin_n + step - 1) // step) * step, params.win_n)

    out = np.full(n, np.nan, dtype=np.float64)
    buf_len = chunk_n + 2 * margin_n
    prev_tail = None  # the previous chunk's output over [s - M, s + M)

    for s in range(0, n, chunk_n):
        lo = s - margin_n
        hi = s + chunk_n + margin_n
        # One shape: NaN beyond the signal (every downstream op ignores
        # NaN samples, as it does absent data).
        seg_x = np.full(buf_len, np.nan, dtype=np.float64)
        seg_y = np.full(buf_len, np.nan, dtype=np.float64)
        a = max(lo, 0)
        b = min(hi, n)
        seg_x[a - lo : b - lo] = vx[a:b]
        seg_y[a - lo : b - lo] = vy[a:b]
        pc1 = pc1_of(seg_x, seg_y)

        # The chunk-global sign of the PCA axis chain, against the previous
        # chunk over the samples both buffers hold.
        if prev_tail is not None:
            ov_mine = pc1[: 2 * margin_n]
            both = np.isfinite(ov_mine) & np.isfinite(prev_tail)
            if both.sum() >= 3 and np.sign(ov_mine[both] * prev_tail[both]).sum() < 0:
                pc1 = -pc1

        keep_lo = margin_n
        keep_hi = min(margin_n + chunk_n, margin_n + (n - s))
        out[s : s + (keep_hi - keep_lo)] = pc1[keep_lo:keep_hi]
        # Buffer [C, C + 2M) holds samples [s + C - M, s + C + M): the next
        # chunk's first 2M (read only when this chunk was a full one).
        prev_tail = pc1[chunk_n:]

    return out
