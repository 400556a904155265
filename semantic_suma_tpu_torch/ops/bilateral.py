"""Kernel A: the range-image bilateral filter (``csrc/bilateral.cu``), the
port of the TPU kernel ``semantic_suma_tpu/ops/pallas_kernels.py``
(``bilateral_filter_pallas``).

:func:`bilateral_filter` is the wrapper the main path calls: on a CPU tensor
it runs :func:`bilateral_filter_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .filters import bilateral_filter as bilateral_filter_plain

__all__ = ["bilateral_filter", "bilateral_filter_plain"]


def _lib():
    lib = cuda_build.library("bilateral")
    if lib.bilateral_filter.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bilateral_filter.argtypes = [p, p, p, i, i, i, f, f, p]
        lib.bilateral_filter.restype = i
        lib.bilateral_smem_bytes.argtypes = [i]
        lib.bilateral_smem_bytes.restype = i
    return lib


_radius_fits: dict = {}  # radius -> its tile fits a block's shared memory


def bilateral_filter(vertex_map: torch.Tensor, vertex_valid: torch.Tensor,
                     sigma_space: float = 4.5, sigma_range: float = 30.0,
                     radius: int = 6) -> torch.Tensor:
    """Range bilateral filter of a [H, W, 3] vertex map (same contract as
    :func:`bilateral_filter_plain`). On a CUDA tensor, radius 6 runs the
    kernel's unrolled instantiation and any other radius its generic one."""
    if vertex_map.device.type == "cpu":
        return bilateral_filter_plain(vertex_map, vertex_valid.to(torch.bool),
                                      sigma_space, sigma_range, radius)
    if vertex_map.device.type != "cuda":
        raise ValueError(f"bilateral: unsupported device {vertex_map.device}")
    h, w = vertex_map.shape[:2]
    if vertex_map.shape != (h, w, 3) or vertex_valid.shape != (h, w):
        raise ValueError("bilateral: expects vertex [H, W, 3], valid [H, W]")
    if vertex_valid.device != vertex_map.device:
        raise ValueError("bilateral: vertex and valid on different devices")
    vm = vertex_map.to(torch.float32).contiguous()
    vv = vertex_valid.contiguous()
    if vv.dtype == torch.bool:
        vv = vv.view(torch.uint8)   # one byte each: no copy
    elif vv.dtype != torch.uint8:
        vv = (vv != 0).view(torch.uint8)
    lib = _lib()
    fits = _radius_fits.get(radius)
    if fits is None:
        fits = _radius_fits[radius] = (
            0 <= radius and lib.bilateral_smem_bytes(radius) <= 48 * 1024)
    if not fits or w < radius:
        raise ValueError(f"bilateral: radius {radius} does not fit a block "
                         f"or exceeds the image width {w}")
    if not sigma_range < 1e15:
        raise ValueError("bilateral: sigma_range must be below 1e15")
    out = torch.empty_like(vm)
    ssf = -0.5 / (sigma_space * sigma_space)
    srf = -0.5 / (sigma_range * sigma_range)
    rc = lib.bilateral_filter(
        vm.data_ptr(), vv.data_ptr(), out.data_ptr(), h, w, radius, ssf, srf,
        torch.cuda.current_stream(vm.device).cuda_stream)
    cuda_build.check(rc, "bilateral_filter")
    bilateral_filter.launches += 1
    return out


bilateral_filter.launches = 0
