"""The device an entry point runs on."""

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
