"""Hand-written Hopper kernels, each with a plain PyTorch version beside it."""

import torch


def device_of(*tensors) -> torch.device:
    """The one device all ``tensors`` lie on; raises if they disagree."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devs))}")
    return devs.pop()
