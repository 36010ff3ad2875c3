"""The device an entry point uses when the caller names none: the card."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA device. Without one this raises instead of falling
    back to the CPU: the port's entry points run on the card unless the
    caller asks for the CPU with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\" to "
                           "run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, or the default device when it is None."""
    return default_device() if device is None else torch.device(device)
