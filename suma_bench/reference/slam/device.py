"""Device selection for the port's entry points, and the one door through
which the port reads device values to the host."""

from __future__ import annotations

import numpy as np
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


class AsyncFetch:
    """A device tensor on its way to the host: on CUDA a ``non_blocking`` copy
    into pinned memory followed by a recorded event, on the CPU the tensor
    itself. :meth:`wait` blocks on the event (one host read, counted in
    ``to_host.count``) and returns the numpy array."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        to_host.count += 1
        return self._host.numpy()
