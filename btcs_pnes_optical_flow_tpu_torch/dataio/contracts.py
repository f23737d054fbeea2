"""The body-axis skeleton of the reference's file contracts, without pandas.

``btcs_pnes_optical_flow_tpu/dataio/contracts.py`` defines the same
``Skeleton`` but imports pandas for its CSV frames, and the port must run
where pandas is missing.  The CSV writers of ``models/pipeline.py`` import
that module only when a CSV is asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Skeleton(NamedTuple):
    """skeleton_pc1.npz (optical_flow.py:20-30): upstream timestamps and
    per-timestamp body-axis unit vectors (NaN rows where the pose failed)."""

    time_all: np.ndarray  # (T,)
    fps: float
    ex: np.ndarray        # (T, 2)
    ey: np.ndarray        # (T, 2)
