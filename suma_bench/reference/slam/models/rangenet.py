"""Range-image semantic segmentation network (counterpart of
``semantic_suma_tpu/models/rangenet.py``): a darknet residual encoder that
downsamples the ``[B, 64, W, 5]`` range image along the width only, a
decoder with transposed-convolution upsampling and skip connections, and a
1x1 head over the 20 training classes.

The public functions keep the JAX package's channels-last layout (``[B, H,
W, 5]`` in, ``[B, H, W, classes]`` out); inside, the modules work in NCHW
(``channels_last`` memory on the GPU). They compute as flax does:

* each convolution and transposed convolution takes bfloat16 inputs and
  weights and gives a bfloat16 output; batch norm (eps 1e-5, the running
  statistics: the network only infers) promotes to float32, then
  ``leaky_relu(0.1)`` and the residual sums
  run in float32; the head (1x1 with bias) runs in float32;
* ``padding="SAME"`` pads as flax does: a total of ``max((ceil(W / s) - 1)
  * s + k - W, 0)``, the low half rounded down, so the stride-(1, 2)
  downsampling pads an even width by (0, 1) and not (1, 1);
* flax's ``ConvTranspose`` does not flip its kernel: the port keeps the
  weight flipped along the width, so that ``conv_transpose2d`` (which
  flips) computes the same sum;
* the width is wrap-padded to a multiple of ``2 ** len(stage_blocks)``
  (900 -> 928) and the logits are cropped back.

Submodules carry flax's names (``Encoder_0``, ``ConvBlock_3``,
``ResidualBlock_5``, ``Conv_0``, ...), numbered per parent in order of
creation, so that a state dict key is a flax path with dots
(``convert.rangenet_state_from_flax``).

The KNN label vote and ``labels_for_points`` live in ``ops/knn.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .labels import TRAIN_CLASSES

BN_EPS = 1e-5
IN_CHANNELS = 5   # range, x, y, z, remission


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in the convolutions' compute type. ``float8_e4m3fn`` (the
    benchmark's control) is emulated: the tensor is scaled to the format's
    range, rounded to it, and computed in bfloat16."""
    if dtype != torch.float8_e4m3fn:
        return t.to(dtype)
    scale = t.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((t.float() / scale).to(dtype).float() * scale).to(torch.bfloat16)


def _same_pads(size: int, k: int, s: int):
    """(low, high) padding of flax's ``"SAME"`` along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``; ``weight`` is
    ``[out, in, kh, kw]``."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hl, hh), (wl, wh) = (_same_pads(x.shape[2 + a], self.kernel[a],
                                         self.stride[a]) for a in (0, 1))
        b = None if self.bias is None else self.bias.to(
            torch.bfloat16 if self.dtype == torch.float8_e4m3fn
            else self.dtype)

        x = _cast(x, self.dtype)
        pad = (0, 0)
        if hl == hh and wl == wh:
            pad = (hl, wl)
        else:
            x = F.pad(x, (wl, wh, hl, hh))
        return F.conv2d(x, _cast(self.weight, self.dtype), b, self.stride,
                        pad)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose((1, 4), strides=(1, 2), padding="SAME")``,
    no bias. ``weight`` is ``[in, out, 1, 4]``, flipped along the width
    against flax's ``[1, 4, in, out]`` kernel."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cin, cout, 1, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's SAME transpose pads the dilated input by (2, 2): padding 1
        return F.conv_transpose2d(_cast(x, self.dtype),
                                  _cast(self.weight, self.dtype),
                                  stride=(1, 2), padding=(0, 1))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, dtype=float32)``:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, with the
    running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return torch.addcmul(self.bias[:, None, None],
                             x.float() - self.mean[:, None, None],
                             mul[:, None, None])


class ConvBlock(nn.Module):
    """Conv (no bias) -> BatchNorm -> leaky_relu(0.1)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 dtype=torch.bfloat16):
        super().__init__()
        self.add_module("Conv_0", Conv(cin, cout, kernel, stride, dtype=dtype))
        self.add_module("BatchNorm_0", BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.1)


class ResidualBlock(nn.Module):
    """Darknet bottleneck: 1x1 reduce -> 3x3 expand + skip."""

    def __init__(self, c: int, dtype=torch.bfloat16):
        super().__init__()
        self.add_module("ConvBlock_0", ConvBlock(c, c // 2, (1, 1),
                                                 dtype=dtype))
        self.add_module("ConvBlock_1", ConvBlock(c // 2, c, (3, 3),
                                                 dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() + self.ConvBlock_1(self.ConvBlock_0(x))


def _named(parent: nn.Module, kind: str, counts: dict, module: nn.Module):
    """Register ``module`` as ``<kind>_<n>``, flax's name for the n-th
    submodule of that type in ``parent``."""
    n = counts.get(kind, 0)
    counts[kind] = n + 1
    parent.add_module(f"{kind}_{n}", module)
    return module


class Encoder(nn.Module):
    """Width-downsampling darknet encoder; returns the features and the
    skip features."""

    def __init__(self, stage_blocks: Sequence[int], widths: Sequence[int],
                 dtype=torch.bfloat16):
        super().__init__()
        counts: dict = {}
        _named(self, "ConvBlock", counts,
               ConvBlock(IN_CHANNELS, widths[0], dtype=dtype))   # the stem
        self.stages = []
        c = widths[0]
        for blocks, width in zip(stage_blocks, widths[1:]):
            down = _named(self, "ConvBlock", counts,
                          ConvBlock(c, width, (3, 3), (1, 2), dtype=dtype))
            res = [_named(self, "ResidualBlock", counts,
                          ResidualBlock(width, dtype=dtype))
                   for _ in range(blocks)]
            self.stages.append((down, res))
            c = width

    def forward(self, x: torch.Tensor):
        skips = []
        x = self.ConvBlock_0(x)
        for down, res in self.stages:
            skips.append(x)
            x = down(x)
            for block in res:
                x = block(x)
        return x, skips


class Decoder(nn.Module):
    """Width-upsampling decoder with skip connections."""

    def __init__(self, widths: Sequence[int], dtype=torch.bfloat16):
        super().__init__()
        counts: dict = {}
        self.stages = []
        c = widths[-1]
        for width in reversed(widths[:-1]):
            up = _named(self, "ConvTranspose", counts,
                        ConvTranspose(c, width, dtype=dtype))
            bn = _named(self, "BatchNorm", counts, BatchNorm(width))
            skip = _named(self, "ConvBlock", counts,
                          ConvBlock(width, width, (1, 1), dtype=dtype))
            res = _named(self, "ResidualBlock", counts,
                         ResidualBlock(width, dtype=dtype))
            self.stages.append((up, bn, skip, res))
            c = width

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for (up, bn, skip_conv, res), skip in zip(self.stages,
                                                  reversed(skips)):
            x = F.leaky_relu(bn(up(x)), 0.1)
            if skip.shape[3] != x.shape[3]:  # odd widths
                skip = skip[:, :, :, :x.shape[3]]
            x = res(x + skip_conv(skip))
        return x


class RangeNet(nn.Module):
    """Full segmenter: ``[B, H, W, 5]`` -> ``[B, H, W, num_classes]``
    float32 logits."""

    def __init__(self, num_classes: int = len(TRAIN_CLASSES),
                 stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 widths: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.stage_blocks = tuple(stage_blocks)
        self.widths = tuple(widths)
        self.dtype = dtype
        self.add_module("Encoder_0", Encoder(stage_blocks, widths, dtype))
        self.add_module("Decoder_0", Decoder(widths, dtype))
        self.add_module("Conv_0", Conv(widths[0], num_classes, (1, 1),
                                       bias=True, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride = 2 ** len(self.stage_blocks)
        w = x.shape[2]
        pad = (-w) % stride
        x = x.permute(0, 3, 1, 2)                 # NCHW view of NHWC memory
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        feats, skips = self.Encoder_0(x)
        y = self.Decoder_0(feats, skips)
        logits = self.Conv_0(y.float())
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def make_input(vertex_map: torch.Tensor, depth_map: torch.Tensor,
               remission: torch.Tensor,
               vertex_valid: torch.Tensor) -> torch.Tensor:
    """The 5-channel network input (range, x, y, z, remission), ``[..., H,
    W, 5]``, zero on invalid pixels, as RangeNet++ stacks it."""
    depth = torch.where(torch.isfinite(depth_map), depth_map, 0.0)
    feats = torch.cat([depth[..., None], vertex_map, remission[..., None]],
                      dim=-1)
    return torch.where(vertex_valid[..., None], feats, 0.0)
