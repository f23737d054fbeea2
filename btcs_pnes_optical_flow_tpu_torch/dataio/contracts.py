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
  (optical_PC1.py:285-299);
- the cohort table: one row per (video, ROI), the summary's columns with
  the video, ROI, status and error of each row (``parallel/runner.py``).

The bytes equal ``DataFrame.to_csv(index=False)`` of the JAX contracts'
frames and of the JAX cohort runner's table: integer columns as integers,
float64 values in their shortest round-trip form (``repr``), NaN as an
empty field, text quoted only where it holds a comma, a quote or a line
break, ``\\n`` line ends.  The readers return a dict of NumPy columns.

``flow_frame``, ``pc1_frame`` and ``summary_frame`` build the JAX
contracts' pandas frames (same columns, order and dtypes) for callers
that have pandas; they import it when called, so this module loads
where pandas is missing.
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
COHORT_COLUMNS = ["video", "roi"] + SUMMARY_COLUMNS + ["status", "error"]


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


def _pandas():
    try:
        import pandas
    except ImportError as exc:
        raise ImportError("the frame helpers need pandas, which is not installed; the "
                          "write_*_csv functions write the same files without it") from exc
    return pandas


def flow_frame(frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag):
    """flow.csv's rows as a pandas DataFrame (JAX ``contracts.flow_frame``)."""
    return _pandas().DataFrame(dict(zip(FLOW_COLUMNS, _flow_columns(
        frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag))))


def pc1_frame(t_sec, pc1_dyn):
    """flow_pc1.csv's rows as a pandas DataFrame (JAX ``contracts.pc1_frame``)."""
    return _pandas().DataFrame({"t_sec": np.asarray(t_sec, float),
                                "pc1_dyn": np.asarray(pc1_dyn, float)})


def summary_frame(metrics, window_sec: float = 10.0, source: str = "pc1_dyn"):
    """The one-row summary (optical_PC1.py:285-299) as a pandas DataFrame
    (JAX ``contracts.summary_frame``)."""
    return _pandas().DataFrame([{
        "PC1_source": source,
        "window_sec": float(window_sec),
        "PC1_area_0_10": float(metrics.pc1_area),
        "ADS_slope_0_10": float(metrics.ads_slope),
        "ADS_R2_0_10": float(metrics.ads_r2),
        "Kendall_tau_0_10": float(metrics.kendall_tau),
        "Kendall_p_0_10": float(metrics.kendall_p),
        "Peak_n": int(metrics.peak_n),
    }])


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


def _flow_columns(frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag):
    """flow.csv's columns in FLOW_COLUMNS order, as their dtypes."""
    return [np.asarray(frame_idx, dtype=int), np.asarray(t_sec, dtype=float),
            np.asarray(skel_idx, dtype=int), np.asarray(axes_ok, dtype=int),
            np.asarray(vx, dtype=float), np.asarray(vy, dtype=float),
            np.asarray(mag, dtype=float)]


def write_flow_csv(path: str, frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag) -> None:
    """flow.csv, as ``flow_frame(...).to_csv(path, index=False)``."""
    _write(path, FLOW_COLUMNS, _flow_columns(frame_idx, t_sec, skel_idx, axes_ok, vx, vy, mag),
           "ifiifff")


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


def write_cohort_csv(path: str, rows: Sequence[dict]) -> None:
    """The cohort table, as the JAX runner's
    ``pd.DataFrame(rows).to_csv(path, index=False)``."""
    cols = [[row[c] for row in rows] for c in COHORT_COLUMNS]
    _write(path, COHORT_COLUMNS, cols, "sis" + "f" * 6 + "iis")


def _column(values):
    """A CSV column as pandas reads it: int64 when every field is an
    integer, float64 when every field is a number or empty (NaN), else text."""
    for parse, dtype in ((int, np.int64), (lambda v: float(v) if v else math.nan, np.float64)):
        try:
            return np.array([parse(v) for v in values], dtype=dtype)
        except ValueError:
            pass
    return np.array(values, dtype=object)


def _read(path: str, required) -> dict:
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    missing = [c for c in sorted(required) if c not in header]
    if missing:
        raise KeyError(
            f"Missing columns in {path}. Required={sorted(required)}, missing={missing}.")
    return {name: _column([r[i] for r in rows]) for i, name in enumerate(header)}


def read_flow_csv(path: str) -> dict:
    """flow.csv as {column: array}; KeyError without t_sec, vx_body, vy_body."""
    return _read(path, {"t_sec", "vx_body", "vy_body"})


def read_pc1_csv(path: str, pc1_col: str = "pc1_dyn") -> dict:
    """flow_pc1.csv as {column: array}; KeyError without t_sec and ``pc1_col``."""
    return _read(path, {"t_sec", pc1_col})
