"""PyTorch/CUDA port of the semantic surfel SLAM engine.

A second implementation of ``semantic_suma_tpu`` for one NVIDIA H100: plain
tensor code is PyTorch (the segmenter's convolutions go to cuDNN), and the
kernels on the odometry, loop-closure and segmenter paths (the range-image
bilateral filter, the per-pixel z-buffer and the KNN label vote) are
hand-written CUDA C++ under ``csrc/``, built at first use with ``nvcc`` for
``sm_90a``. The package never imports JAX; the JAX package stays the
reference the tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version. The headless entry
point is ``python -m semantic_suma_tpu_torch.cli`` (``run``, ``eval`` and
``train-segmenter``; the top-level ``--cpu`` sends a command to the CPU).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry needs true f32 products (the ICP normal equations, 4x4 pose
# compositions); TF32 keeps ~3 decimal digits, so it is switched off for both
# matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import SumaConfig, loop_config, odometry_config  # noqa: E402,F401
from .device import resolve_device  # noqa: E402,F401
