"""Chunk-level checkpoint/resume for the streaming pipeline.

A copy of ``btcs_pnes_optical_flow_tpu/dataio/checkpoint.py``, so that the
port imports nothing of the JAX package.

The reference re-runs from scratch and persists only final CSVs
(SURVEY.md §5).  Here every flow chunk's features are persisted as
they complete, so a killed run resumes at the first missing chunk —
the natural recovery unit of the chunked streaming design.  Stores are
plain npz-per-chunk directories (no database, rsync-able, and doubling
as the intermediate-artifact archive).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class ChunkStore:
    """``meta`` is compared as ``meta.json`` reads it back (a tuple as a
    list); a store written with other meta raises ValueError."""

    def __init__(self, directory: str, meta: Optional[dict] = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.meta_path = os.path.join(directory, "meta.json")
        if meta is not None:
            meta = json.loads(json.dumps(meta))
            existing = self.load_meta()
            if existing is not None and existing != meta:
                raise ValueError(
                    f"checkpoint dir {directory} was written with different "
                    f"parameters: {existing} != {meta}"
                )
            if existing is None:
                with open(self.meta_path, "w") as f:
                    json.dump(meta, f)

    def load_meta(self) -> Optional[dict]:
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                return json.load(f)
        return None

    def _path(self, first: int) -> str:
        return os.path.join(self.dir, f"chunk_{first:08d}.npz")

    def has(self, first: int) -> bool:
        return os.path.exists(self._path(first))

    def save(self, first: int, **arrays) -> None:
        # np.savez appends .npz when missing — keep the suffix so the
        # temp file lands where we expect, then publish atomically.
        tmp = self._path(first) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(first))

    def load(self, first: int) -> Dict[str, np.ndarray]:
        with np.load(self._path(first)) as z:
            return {k: z[k] for k in z.files}

    def completed_chunks(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("chunk_") and name.endswith(".npz"):
                out.append(int(name[6:14]))
        return out
