"""The port's device rule: entry points run on the CUDA card unless the
caller names the CPU, and a CUDA device with no card raises."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but "
                           "torch.cuda.is_available() is False")
    return device
