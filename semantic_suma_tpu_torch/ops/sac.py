"""SqueezeSegV3's spatially-adaptive modulation (``csrc/sac.cu``): the
bfloat16 input of a SAC block's adaptive 3x3 convolution, ``F.unfold(x, 3,
padding=1)`` times ``sigmoid(batch_norm(a))`` per pixel, channel and tap, in
one pass. ``SqueezeSegV3``'s inference walk (``models/squeezesegv3.py``)
calls it once a SAC block.

:func:`sac_modulate` is the wrapper: on a CPU tensor it runs
:func:`sac_modulate_plain`; on a CUDA tensor it launches the kernel or
raises. ``sac_modulate.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["sac_modulate", "sac_modulate_plain"]

TAPS = 9          # a 3x3 neighbourhood
MAX_CHANNELS = 2048


def sac_modulate_plain(a: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                       mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``(F.unfold(x, 3, padding=1) * sigmoid((float(a) - mean) * mul +
    bias)).to(bfloat16)`` as ``[N, 9C, H, W]``: ``a`` the attention
    convolution's ``[N, 9C, H, W]`` output, ``x`` the block's ``[N, C, H,
    W]`` input, ``mean``, ``mul`` and ``bias`` the attention's batch norm in
    evaluation mode over its ``9C`` channels (``mul`` its ``rsqrt(var +
    eps) * scale``). Channel ``c * 9 + t`` is ``x``'s channel ``c`` at tap
    ``t`` (row ``t // 3 - 1``, column ``t % 3 - 1``), F.unfold's order, zero
    outside the image. The PyTorch operations of ``SACBlock``'s module
    forward, in their order."""
    n, c, h, w = x.shape
    att = torch.sigmoid(torch.addcmul(bias[:, None, None],
                                      a.float() - mean[:, None, None],
                                      mul[:, None, None]))
    u = F.unfold(x.float(), 3, padding=1).view(n, TAPS * c, h, w)
    return (u * att).to(torch.bfloat16)


def _lib():
    lib = cuda_build.library("sac")
    if lib.sac_modulate.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sac_modulate.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.sac_modulate.restype = i
    return lib


def sac_modulate(a: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                 mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The contract of :func:`sac_modulate_plain`. On a CUDA tensor the
    kernel takes a bfloat16 ``a`` ``[N, 9C, H, W]`` and ``x`` ``[N, C, H,
    W]``, both in ``channels_last`` memory, with ``C`` a multiple of 8 and at
    most 2048, and float32 ``mean``, ``mul`` and ``bias`` of ``9C``
    channels, contiguous, all on one device and 16-byte aligned; its output
    is ``channels_last`` too. A CUDA call with anything else raises."""
    if a.device.type == "cpu":
        return sac_modulate_plain(a, x, mean, mul, bias)
    if a.device.type != "cuda":
        raise ValueError(f"sac_modulate: unsupported device {a.device}")
    cl = torch.channels_last
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.numel() == 0 \
            or not x.is_contiguous(memory_format=cl):
        raise ValueError("sac_modulate: x must be a non-empty bfloat16 [N, C, "
                         f"H, W] in channels_last memory, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"sac_modulate: {c} channels, not a multiple of 8 "
                         f"up to {MAX_CHANNELS}")
    if a.dtype != torch.bfloat16 or a.shape != (n, TAPS * c, h, w) \
            or not a.is_contiguous(memory_format=cl) or a.device != x.device:
        raise ValueError(f"sac_modulate: a must be bfloat16 [{n}, {TAPS * c}, "
                         f"{h}, {w}] in channels_last memory on x's device, "
                         f"got {a.dtype} {tuple(a.shape)}")
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (TAPS * c,) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"sac_modulate: {name} must be float32 "
                             f"[{TAPS * c}], contiguous, on x's device")
    if any(t.data_ptr() % 16 for t in (a, x, mean, mul, bias)):
        raise ValueError("sac_modulate: an input is not 16-byte aligned")
    out = torch.empty_like(a, memory_format=cl)
    rc = _lib().sac_modulate(a.data_ptr(), x.data_ptr(), mean.data_ptr(),
                             mul.data_ptr(), bias.data_ptr(), out.data_ptr(),
                             n, h, w, c,
                             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "sac_modulate")
    sac_modulate.launches += 1
    return out


sac_modulate.launches = 0
