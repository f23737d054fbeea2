"""The device an entry point runs on, and the staging of host data bound for it."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA one with its index (so that
    it compares equal to a tensor's device).  Raises RuntimeError when it
    names a CUDA card that this machine does not have: no entry point falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = dev.index if dev.index is not None else (torch.cuda.current_device() if count else 0)
        if index >= count:
            raise RuntimeError(f"device {dev} was asked for; this machine has {count} CUDA "
                               "card(s). Pass device='cpu' to run on the CPU.")
        dev = torch.device("cuda", index)
    return dev


def stages_pinned(device) -> bool:
    """Whether host data bound for ``device`` is staged in page-locked
    memory (``pinned_empty``): on a CUDA device, and on nothing else.  A
    copy to the card from such memory is queued on the stream
    (``non_blocking=True``) and leaves the host free; from pageable memory
    it synchronises the stream first and holds the host for its length."""
    return torch.device(device).type == "cuda"


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An empty page-locked host tensor from PyTorch's caching host
    allocator.  A non-blocking copy from it records an event on its block,
    and the allocator hands the block out again only after that event, so
    a tensor allocated after the copy was queued never overwrites its
    bytes in flight.  Blocks are cached for reuse, in power-of-two sizes."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)
