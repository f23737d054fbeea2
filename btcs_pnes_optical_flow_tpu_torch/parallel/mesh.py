"""The devices a cohort or a sharded frame runs on.

Port of ``btcs_pnes_optical_flow_tpu/parallel/mesh.py``.  The JAX package
builds a ``jax.sharding.Mesh`` and falls back to virtual CPU devices when
the platform has too few.  Here the model is the same single-controller
one (one process drives every device), and a mesh is an explicit sequence
of ``torch.device``s laid out over named axes: ``Mesh`` is a tuple of
devices, row-major over ``axes``.  ``make_mesh`` gives the first n CUDA
cards and raises without them (a fallback would hide the card); a layout
that is not the machine's cards (four CPU shards, or four shards on
``cuda:0``) is built with ``Mesh`` itself.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index, so that it compares equal to a
    tensor's device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh(tuple):
    """Devices laid out row-major over named axes.

    ``Mesh(devices, axes=("data",), shape=None)``: ``shape`` defaults to
    one axis of every device.  As a tuple it iterates over (and compares
    equal to) its devices; ``shape[axis]`` is the axis' size, as in JAX.
    Devices may repeat: four shards on one card are ``Mesh([cuda0] * 4)``.
    """

    def __new__(cls, devices: Sequence, axes: Tuple[str, ...] = ("data",),
                shape: Optional[Tuple[int, ...]] = None):
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        shape = (len(devs),) if shape is None else tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(axes) != len(shape) or math.prod(shape) != len(devs) or not devs:
            raise ValueError(f"a mesh of shape {shape} over axes {axes} cannot hold "
                             f"{len(devs)} device(s)")
        self = super().__new__(cls, devs)
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        return self

    @property
    def size(self) -> int:
        return len(self)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis (the
        shards of an operand split over ``axis`` and replicated over the
        rest)."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {self.axes}, not {axis!r}")
        k = self.axes.index(axis)
        stride = math.prod(list(self.shape.values())[k + 1:])
        return tuple(self[i * stride] for i in range(self.shape[axis]))

    def __repr__(self) -> str:
        return f"Mesh({list(self)}, axes={self.axes}, shape={tuple(self.shape.values())})"


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a ``Mesh``: a sequence of devices becomes a 1-D "data"
    mesh."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def axis_devices(mesh, axis: str) -> Tuple[torch.device, ...]:
    """``Mesh.axis_devices``; a bare sequence of devices is read as ``axis``."""
    return (mesh if isinstance(mesh, Mesh) else Mesh(mesh, (axis,))).axis_devices(axis)


def make_mesh(n_devices: Optional[int] = None, axes: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (default: every card).

    The default is a 1-D "data" mesh (the cohort axis); axes=("data",
    "spatial") with a shape like (2, 2) combines cohort and spatial
    sharding (a 2-D default shape is (n // 2, 2), as in JAX).  Raises
    RuntimeError when the machine has fewer cards than asked for."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n > count or n < 1:
        raise RuntimeError(f"make_mesh({n_devices}) asks for {n} CUDA card(s); this machine "
                           f"has {count}. Build a CPU layout with Mesh([...]) to run on the CPU.")
    if shape is None:
        shape = (n,) if len(axes) == 1 else (n // 2, 2)
    return Mesh([torch.device("cuda", i) for i in range(n)], axes, shape)


def cohort_sharding(mesh, x: torch.Tensor, axis: str = "data") -> List[torch.Tensor]:
    """``x``'s leading (video) axis split into contiguous blocks over the
    devices of ``axis`` (sizes differ by at most one), each block on its
    device; the counterpart of JAX's ``NamedSharding(mesh, P(axis))``."""
    devs = as_mesh(mesh).axis_devices(axis)
    x = torch.as_tensor(x)
    return [blk.to(d) for blk, d in zip(torch.tensor_split(x, len(devs)), devs)]


def replicated(mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A copy of ``x`` on every device of the mesh."""
    x = torch.as_tensor(x)
    return [x.to(d) for d in as_mesh(mesh)]
