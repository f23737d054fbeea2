"""The reference pipeline's on-disk data contracts, without pandas.

Mirrors ``btcs_pnes_optical_flow_tpu/dataio/contracts.py``, which builds
pandas DataFrames; the port must run where pandas is missing, so it
writes the same files with the ``csv`` module:

- ``skeleton_pc1.npz``: time_all (T,), fps, ex (T,2), ey (T,2)
  (optical_flow.py:20-30, 204-210).
- ``flow.csv``: frame, t_sec, skel_idx, axes_ok, vx_body, vy_body,
  mag_body (optical_flow.py:255-259).
- ``flow_pc1.csv``: t_sec, pc1_dyn (optical_PCA.py:270).
- ``flow_summary_dyn_core.csv``: one row, 8 columns
  (optical_PC1.py:285-299).

The bytes equal ``DataFrame.to_csv(index=False)`` of the JAX contracts'
frames: integer columns as integers, float64 values in their shortest
round-trip form (``repr``), NaN as an empty field, ``\\n`` line ends.
"""

from __future__ import annotations

import csv
import math
from typing import NamedTuple, Sequence

import numpy as np

FLOW_COLUMNS = ["frame", "t_sec", "skel_idx", "axes_ok", "vx_body", "vy_body", "mag_body"]
PC1_COLUMNS = ["t_sec", "pc1_dyn"]
SUMMARY_COLUMNS = [
    "PC1_source",
    "window_sec",
    "PC1_area_0_10",
    "ADS_slope_0_10",
    "ADS_R2_0_10",
    "Kendall_tau_0_10",
    "Kendall_p_0_10",
    "Peak_n",
]


class Skeleton(NamedTuple):
    """skeleton_pc1.npz (optical_flow.py:20-30): upstream timestamps and
    per-timestamp body-axis unit vectors (NaN rows where the pose failed)."""

    time_all: np.ndarray  # (T,)
    fps: float
    ex: np.ndarray        # (T, 2)
    ey: np.ndarray        # (T, 2)


def load_skeleton_npz(path: str) -> Skeleton:
    dat = np.load(path, allow_pickle=True)
    return Skeleton(
        time_all=np.asarray(dat["time_all"], dtype=float),
        fps=float(dat["fps"]),
        ex=np.asarray(dat["ex"], dtype=float),
        ey=np.asarray(dat["ey"], dtype=float),
    )


def save_skeleton_npz(path: str, skel: Skeleton) -> None:
    np.savez(path, time_all=skel.time_all, fps=skel.fps, ex=skel.ex, ey=skel.ey)


def _float_field(x) -> str:
    x = float(x)
    return "" if math.isnan(x) else repr(x)


def _write(path: str, header: Sequence[str], columns, kinds: str) -> None:
    """One CSV: ``columns`` are equal-length sequences, ``kinds`` one letter
    each ('i' integer, 'f' float64, 's' text)."""
    fmt = {"i": lambda v: str(int(v)), "f": _float_field, "s": str}
    cols = [[fmt[k](v) for v in col] for col, k in zip(columns, kinds)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*cols))


def write_flow_csv(path: str, frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag) -> None:
    """flow.csv, as ``flow_frame(...).to_csv(path, index=False)``."""
    cols = [np.asarray(frame_idx, dtype=int), np.asarray(t_sec, dtype=float),
            np.asarray(skel_idx, dtype=int), np.asarray(axes_ok, dtype=int),
            np.asarray(vx, dtype=float), np.asarray(vy, dtype=float),
            np.asarray(mag, dtype=float)]
    _write(path, FLOW_COLUMNS, cols, "ifiifff")


def write_pc1_csv(path: str, t_sec, pc1_dyn) -> None:
    """flow_pc1.csv, as ``pc1_frame(...).to_csv(path, index=False)``."""
    _write(path, PC1_COLUMNS, [np.asarray(t_sec, float), np.asarray(pc1_dyn, float)], "ff")


def write_summary_csv(path: str, metrics, window_sec: float = 10.0,
                      source: str = "pc1_dyn") -> None:
    """flow_summary_dyn_core.csv (one row, optical_PC1.py:285-299), as
    ``summary_frame(...).to_csv(path, index=False)``."""
    row = [[source], [window_sec], [metrics.pc1_area], [metrics.ads_slope], [metrics.ads_r2],
           [metrics.kendall_tau], [metrics.kendall_p], [metrics.peak_n]]
    _write(path, SUMMARY_COLUMNS, row, "sffffffi")
