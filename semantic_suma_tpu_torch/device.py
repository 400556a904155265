"""Device selection for the port's entry points, and the one door through
which the port reads device values to the host."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device. Raises when CUDA is
    asked for (explicitly or by default) and no GPU is present: the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def to_host(t: torch.Tensor):
    """``t.tolist()``: a Python scalar or (nested) list. On a GPU this waits
    for the device, so every read of the port goes through here and
    ``to_host.count`` counts them."""
    to_host.count += 1
    return t.tolist()


to_host.count = 0
