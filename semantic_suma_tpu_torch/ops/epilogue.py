"""The batch-norm epilogue (``csrc/bn_act.cu``): batch norm with the running
statistics, ``leaky_relu`` of a given slope (darknet's 0.1 by default; 0,
a ReLU, in SqueezeSegV3's blocks), an optional residual or skip sum, and the
outputs its consumers need, in one pass over a bfloat16 convolution output.
The inference walks of ``RangeNet`` (``models/rangenet.py``) and
``SqueezeSegV3`` (``models/squeezesegv3.py``) call it once a batch-norm
site.

:func:`bn_act` is the wrapper: on a CPU tensor it runs :func:`bn_act_plain`;
on a CUDA tensor it launches the kernel or raises. ``bn_act.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["bn_act", "bn_act_plain"]

SLOPE = 0.1   # darknet's leaky_relu


def bn_act_plain(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, r: torch.Tensor | None = None, *,
                 f32: bool = True, bf16: bool = True,
                 slope: float = SLOPE) -> tuple:
    """``(s, s.to(bfloat16))`` of ``s = [r +] leaky_relu((float(y) - mean)
    * mul + bias, slope)`` over the channels (dimension 1) of an ``[N, C,
    H, W]`` ``y``, each part None where ``f32`` or ``bf16`` is False; slope
    0 is a ReLU (a negative ``v`` gives ``v * 0``, -0.0). The
    PyTorch operations of ``BatchNorm.forward`` in evaluation mode (``mul``
    its ``rsqrt(var + eps) * scale``), ``F.leaky_relu``, the sum and the
    next convolution's cast, in their order."""
    v = torch.addcmul(bias[:, None, None], y.float() - mean[:, None, None],
                      mul[:, None, None])
    s = F.leaky_relu(v, slope)
    if r is not None:
        s = r + s
    return (s if f32 else None), (s.to(torch.bfloat16) if bf16 else None)


def _lib():
    lib = cuda_build.library("bn_act")
    if lib.bn_act.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bn_act.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i,
                               ctypes.c_float, p]
        lib.bn_act.restype = i
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bn_act(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
           bias: torch.Tensor, r: torch.Tensor | None = None, *,
           f32: bool = True, bf16: bool = True,
           slope: float = SLOPE) -> tuple:
    """The contract of :func:`bn_act_plain`. On a CUDA tensor the kernel
    takes a bfloat16 ``y`` in ``channels_last`` memory with ``C`` a
    multiple of 8, float32 ``mean``, ``mul`` and ``bias`` of its ``C``
    channels, contiguous, and a float32 ``r`` of ``y``'s shape in
    ``channels_last`` memory, all on one device and 16-byte aligned; its
    outputs are ``channels_last`` too. A CUDA call with anything else
    raises."""
    if y.device.type == "cpu":
        return bn_act_plain(y, mean, mul, bias, r, f32=f32, bf16=bf16,
                            slope=slope)
    if y.device.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {y.device}")
    if not (f32 or bf16):
        raise ValueError("bn_act: asks for no output")
    cl = torch.channels_last
    if y.dtype != torch.bfloat16 or y.dim() != 4 or y.numel() == 0 \
            or not y.is_contiguous(memory_format=cl):
        raise ValueError("bn_act: expects a non-empty bfloat16 [N, C, H, W] "
                         f"in channels_last memory, got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    c = y.shape[1]
    if c % 8:
        raise ValueError(f"bn_act: {c} channels, not a multiple of 8")
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (c,) \
                or not t.is_contiguous() or t.device != y.device:
            raise ValueError(f"bn_act: {name} must be float32 [{c}], "
                             "contiguous, on y's device")
    if r is not None and (r.dtype != torch.float32 or r.shape != y.shape
                          or not r.is_contiguous(memory_format=cl)
                          or r.device != y.device):
        raise ValueError("bn_act: r must be float32 of y's shape in "
                         "channels_last memory on y's device")
    if any(t is not None and t.data_ptr() % 16
           for t in (y, mean, mul, bias, r)):
        raise ValueError("bn_act: an input is not 16-byte aligned")
    out_f = torch.empty_like(y, dtype=torch.float32, memory_format=cl) \
        if f32 else None
    out_b = torch.empty_like(y, memory_format=cl) if bf16 else None
    rc = _lib().bn_act(y.data_ptr(), _ptr(r), mean.data_ptr(),
                       mul.data_ptr(), bias.data_ptr(), _ptr(out_f),
                       _ptr(out_b), y.numel(), c, slope,
                       torch.cuda.current_stream(y.device).cuda_stream)
    cuda_build.check(rc, "bn_act")
    bn_act.launches += 1
    return out_f, out_b


bn_act.launches = 0
