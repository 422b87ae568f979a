"""Device selection shared by the port's entry points: the card unless the
caller asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device=None` means the card ("cuda"). Asking for CUDA on a machine
    without a card raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
