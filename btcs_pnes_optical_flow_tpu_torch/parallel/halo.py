"""Halo exchange between height shards, and the sharded window stencils.

Port of ``btcs_pnes_optical_flow_tpu/parallel/halo.py``.  A frame's height
is split into row blocks, one per shard (``parallel/spatial.py``); before a
stencil each block takes ``halo`` rows from its neighbours (the JAX
package's ``lax.ppermute`` inside a ``shard_map``), and the boundary blocks
fill theirs from their own edge, which reproduces the unsharded border.
One process drives every shard: a row block moves with ``tensor.to``,
peer to peer between cards and a no-op where two shards share a device.
Communication per stencil is O(halo · W) per shard; compute stays
O(h_loc · W).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from btcs_pnes_optical_flow_tpu_torch.ops import cvx
from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import axis_devices

BORDERS = ("replicate", "reflect101")


def exchange_rows(shards: Sequence[torch.Tensor], halo: int,
                  border: str = "replicate") -> List[torch.Tensor]:
    """Each shard's block (..., h_loc, W) with ``halo`` rows above and below.

    ``shards`` are the row blocks of one image in order down it, each on its
    own device.  Block i's top halo is the last ``halo`` rows of block i−1
    and its bottom halo the first ``halo`` rows of block i+1; on the
    boundary blocks ``border="replicate"`` repeats the edge row (clamp) and
    ``"reflect101"`` mirrors without repeating it (cv2.GaussianBlur's
    default).  Returns the (..., h_loc + 2·halo, W) blocks, each on its
    shard's device.
    """
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    n = len(shards)
    if halo == 0:
        return list(shards)
    for x in shards:
        rows = x.shape[-2]
        if halo > rows or (border == "reflect101" and halo >= rows):
            raise ValueError(f"a shard of {rows} rows cannot give a {halo}-row {border} halo")
    out = []
    for i, x in enumerate(shards):
        if i > 0:
            top = shards[i - 1][..., -halo:, :].to(x.device)
        elif border == "replicate":
            top = x[..., :1, :].expand(*x.shape[:-2], halo, x.shape[-1])
        else:
            top = x[..., 1:halo + 1, :].flip(-2)
        if i < n - 1:
            bot = shards[i + 1][..., :halo, :].to(x.device)
        elif border == "replicate":
            bot = x[..., -1:, :].expand(*x.shape[:-2], halo, x.shape[-1])
        else:
            bot = x[..., -halo - 1:-1, :].flip(-2)
        out.append(torch.cat([top, x, bot], dim=-2))
    return out


def split_rows(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The row blocks of ``x`` (..., H, W), H divisible by the number of
    devices, block i on devices[i]."""
    x = torch.as_tensor(x)
    n, h = len(devices), x.shape[-2]
    if h % n:
        raise ValueError(f"H={h} must be divisible by the {n} shards")
    return [blk.to(d) for blk, d in zip(x.split(h // n, dim=-2), devices)]


def gather_rows(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks joined into one image on ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=-2)


def _shards(x, mesh, axis_name: str) -> List[torch.Tensor]:
    if isinstance(x, (list, tuple)):
        return list(x)
    return split_rows(x, axis_devices(mesh, axis_name))


def sep_corr_replicate_sharded(x, kv, kh, mesh, axis_name: str = "spatial") -> List[torch.Tensor]:
    """Height-sharded separable correlation with replicate border.

    ``x`` is an image (..., H, W), split into row blocks over the devices
    of ``axis_name``, or the list of its blocks.  Returns the blocks of
    ``cvx.sep_corr_replicate(x, kv, kh)``.  Requires each block to have at
    least len(kv)//2 rows.
    """
    exts = exchange_rows(_shards(x, mesh, axis_name), len(kv) // 2, "replicate")
    return [cvx.corr1d(cvx.corr1d(cvx.pad_replicate(e, 0, len(kh) // 2), kv, axis=-2), kh,
                       axis=-1) for e in exts]


def box_sum_replicate_sharded(x, size: int, mesh, axis_name: str = "spatial") -> List[torch.Tensor]:
    """Height-sharded size×size box sum (the Farnebäck M averaging)."""
    ones = np.ones(size, dtype=np.float64)
    return sep_corr_replicate_sharded(x, ones, ones, mesh, axis_name)
