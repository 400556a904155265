"""SqueezeSegV3's SAC block on the card, two kernels that
``SqueezeSegV3``'s inference walk (``models/squeezesegv3.py``) calls once a
SAC block each:

* the attention convolution with its bias (``csrc/sac_attention.cu``):
  ``a``, the 7x7 convolution from the three coordinate channels to 9C
  channels, rounded to bfloat16, plus the bias, rounded again;
* the spatially-adaptive modulation (``csrc/sac.cu``): the bfloat16 input of
  the block's adaptive 3x3 convolution, ``F.unfold(x, 3, padding=1)`` times
  ``sigmoid(batch_norm(a))`` per pixel, channel and tap, in one pass.

:func:`sac_attention` and :func:`sac_modulate` are the wrappers: on a CPU
tensor each runs its plain version (:func:`sac_attention_plain`,
:func:`sac_modulate_plain`); on a CUDA tensor it launches its kernel or
raises. ``sac_attention.launches`` and ``sac_modulate.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["sac_attention", "sac_attention_plain", "sac_modulate",
           "sac_modulate_plain"]

TAPS = 9          # a 3x3 neighbourhood
MAX_CHANNELS = 2048
COORDS = 3        # the attention's input: x, y, z
WINDOW = 7        # the attention's 7x7 window, padded by 3


def sac_attention_plain(p: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(p, weight, bias, padding=3)`` with all three in
    bfloat16: ``Conv.forward``'s operations for a SAC block's attention
    (``blk.attention(p)`` bit for bit), ``[N, 9C, H, W]`` from the
    coordinates ``p`` ``[N, 3, H, W]``, the weight ``[9C, 3, 7, 7]`` and the
    bias ``[9C]``. On a card this is cuDNN's convolution followed by ATen's
    bias add."""
    bf = torch.bfloat16
    return F.conv2d(p.to(bf), weight.to(bf), bias.to(bf),
                    padding=WINDOW // 2)


def _attention_lib():
    lib = cuda_build.library("sac_attention")
    if lib.sac_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sac_attention.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.sac_attention.restype = i
    return lib


def sac_attention(p: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The contract of :func:`sac_attention_plain`. The weight and the bias
    are first cast to bfloat16, the weight into ``channels_last`` memory (no
    copy for ``Segmenter``'s inference copy, which holds them so). On a CUDA
    tensor the kernel then takes a bfloat16 ``p`` ``[N, 3, H, W]`` in
    ``channels_last`` memory, a weight ``[9C, 3, 7, 7]`` with ``C`` a
    multiple of 8 and at most 2048 and a bias ``[9C]``, all on one device and
    16-byte aligned; its output is ``channels_last`` too. A CUDA call with
    anything else raises."""
    if p.device.type == "cpu":
        return sac_attention_plain(p, weight, bias)
    if p.device.type != "cuda":
        raise ValueError(f"sac_attention: unsupported device {p.device}")
    cl = torch.channels_last
    if weight.dim() != 4:
        raise ValueError(f"sac_attention: weight must be [9C, {COORDS}, "
                         f"{WINDOW}, {WINDOW}], got {tuple(weight.shape)}")
    weight = weight.to(torch.bfloat16).contiguous(memory_format=cl)
    bias = bias.to(torch.bfloat16).contiguous()
    if p.dtype != torch.bfloat16 or p.dim() != 4 or p.shape[1] != COORDS \
            or p.numel() == 0 or not p.is_contiguous(memory_format=cl):
        raise ValueError("sac_attention: p must be a non-empty bfloat16 [N, "
                         f"{COORDS}, H, W] in channels_last memory, got "
                         f"{p.dtype} {tuple(p.shape)} strides {p.stride()}")
    n, _, h, w = p.shape
    if p.numel() >= 2**31:
        raise ValueError(f"sac_attention: {p.numel()} coordinates, not "
                         "under 2^31")
    cout = weight.shape[0]
    if weight.shape != (cout, COORDS, WINDOW, WINDOW) \
            or cout % (TAPS * 8) or cout > TAPS * MAX_CHANNELS:
        raise ValueError(f"sac_attention: weight must be [9C, {COORDS}, "
                         f"{WINDOW}, {WINDOW}] with C a multiple of 8 up to "
                         f"{MAX_CHANNELS}, got {tuple(weight.shape)}")
    if bias.shape != (cout,):
        raise ValueError(f"sac_attention: bias must be [{cout}], got "
                         f"{tuple(bias.shape)}")
    if weight.device != p.device or bias.device != p.device:
        raise ValueError("sac_attention: weight and bias must be on p's "
                         "device")
    if any(t.data_ptr() % 16 for t in (p, weight, bias)):
        raise ValueError("sac_attention: an input is not 16-byte aligned")
    out = torch.empty((n, cout, h, w), dtype=torch.bfloat16, device=p.device,
                      memory_format=cl)
    rc = _attention_lib().sac_attention(
        p.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, w, cout, torch.cuda.current_stream(p.device).cuda_stream)
    cuda_build.check(rc, "sac_attention")
    sac_attention.launches += 1
    return out


sac_attention.launches = 0


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
