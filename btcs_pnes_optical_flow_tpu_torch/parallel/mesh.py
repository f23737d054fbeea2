"""The devices a cohort runs on.

The JAX package builds a ``jax.sharding.Mesh`` and falls back to virtual
CPU devices when the platform has too few; here a mesh is the tuple of
CUDA devices the cohort runs on, and a machine without them raises: a
fallback would hide the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from btcs_pnes_optical_flow_tpu_torch.utils.device import resolve_device


def make_mesh(n_devices: int = 1) -> Tuple[torch.device, ...]:
    """The first ``n_devices`` CUDA devices.  Raises RuntimeError when the
    machine has fewer; a cohort over more than one card is not ported
    (NotImplementedError)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if n_devices > 1:
        raise NotImplementedError("cohorts over more than one CUDA card are not ported")
    return tuple(resolve_device(f"cuda:{i}") for i in range(n_devices))
