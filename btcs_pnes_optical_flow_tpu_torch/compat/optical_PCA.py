"""Drop-in equivalent of the reference's optical_PCA.py entry point.

Same public surface (butter_bandpass_sos, sos_required_padlen,
finite_runs, bandpass_nanrobust, align_axis_to_ref,
dynamic_pc1_sliding, main — optical_PCA.py:64-270) as the JAX package's
``compat.optical_PCA``, backed by the port's ops on ``device``.
Parameters default to the reference constants (optical_PCA.py:47-58).

Usage:  python -m btcs_pnes_optical_flow_tpu_torch.compat.optical_PCA \\
            [flow.csv] [flow_pc1.csv]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
from btcs_pnes_optical_flow_tpu_torch.ops import design
from btcs_pnes_optical_flow_tpu_torch.ops import filters as _filters
from btcs_pnes_optical_flow_tpu_torch.ops import pca as _pca
from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device

FLOW_CSV = "flow.csv"
OUT_CSV = "flow_pc1.csv"

fs = 30
BPF_LOW_HZ = 0.5
BPF_HIGH_HZ = 5.0
BPF_ORDER = 4
WIN_SEC = 2.0
STEP_SEC = 0.1
MIN_SAMPLES_PCA = 3


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                           device=resolve_device(device))


def butter_bandpass_sos(low_hz, high_hz, fs, order=4):
    """Native Butterworth band-pass design (scipy-equivalent SOS)."""
    return design.butter_bandpass_sos(low_hz, high_hz, fs, order)


def sos_required_padlen(sos):
    return design.sos_required_padlen(sos)


def finite_runs(mask):
    """Contiguous True runs as inclusive (start, end) tuples."""
    idx = np.flatnonzero(np.asarray(mask))
    if idx.size == 0:
        return []
    gap = np.where(np.diff(idx) > 1)[0]
    starts = np.r_[idx[0], idx[gap + 1]]
    ends = np.r_[idx[gap], idx[-1]]
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def bandpass_nanrobust(x, sos, *, device="cuda"):
    """NaN-robust zero-phase band-pass (the filters' default engine)."""
    xt = _f32(x, device)
    zi = torch.as_tensor(design.sosfilt_zi(sos).astype(np.float32), device=xt.device)
    y = _filters.bandpass_nanrobust(xt, sos, zi, design.sos_required_padlen(sos))
    return y.cpu().numpy().astype(float)


def align_axis_to_ref(w, ref=np.array([0.0, 1.0])):
    """Sign-resolve an eigenvector against a reference direction."""
    w = np.asarray(w, float)
    if np.any(~np.isfinite(w)):
        return w
    return -w if float(np.dot(w, ref)) < 0 else w


def dynamic_pc1_sliding(time_sec, vx, vy, win_sec, step_sec, ref=np.array([0.0, 1.0]), *,
                        device="cuda"):
    """Sliding-window PCA → pc1_dyn."""
    win_n = max(MIN_SAMPLES_PCA, int(round(win_sec * fs)))
    step_n = max(1, int(round(step_sec * fs)))
    out = _pca.dynamic_pc1_sliding(_f32(vx, device), _f32(vy, device), win_n, step_n,
                                   MIN_SAMPLES_PCA, tuple(np.asarray(ref, float)))
    return out.cpu().numpy().astype(float)


def main(argv=None, *, device="cuda") -> None:
    argv = argv if argv is not None else sys.argv[1:]
    device = resolve_device(device)
    flow_csv = argv[0] if len(argv) > 0 else FLOW_CSV
    out_csv = argv[1] if len(argv) > 1 else OUT_CSV

    cols = contracts.read_flow_csv(flow_csv)
    t = cols["t_sec"].astype(float)
    params = PCAParams(
        fs=fs, bpf_low_hz=BPF_LOW_HZ, bpf_high_hz=BPF_HIGH_HZ, bpf_order=BPF_ORDER,
        win_sec=WIN_SEC, step_sec=STEP_SEC, min_samples_pca=MIN_SAMPLES_PCA,
    )
    pc1 = pc1_from_flow(_f32(cols["vx_body"], device), _f32(cols["vy_body"], device), params)
    contracts.write_pc1_csv(out_csv, t, pc1.cpu().numpy())


if __name__ == "__main__":
    main()
