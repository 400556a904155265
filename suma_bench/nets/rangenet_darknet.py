"""RangeNet++'s darknet network (Milioto et al., IROS 2019;
github.com/PRBonn/lidar-bonnetal, ``darknet53.yaml``), the plain reference
of the segmenter group ``"arch": "rangenet_darknet"``: a frozen copy of the
port's ``models/rangenet.py`` in evaluation mode, which reads the group's
``stage_blocks`` and ``widths``.

A darknet residual encoder downsamples the ``[B, 64, W, 5]`` range image
along the width only, a decoder upsamples it with transposed convolutions
and skip connections, and a 1x1 head gives the classes. Inputs and logits
are channels-last (``[B, H, W, 5]`` in, ``[B, H, W, classes]`` out); inside,
the modules work in NCHW. They compute as the JAX package's flax network:

* each convolution and transposed convolution takes its inputs and weights
  in the compute type (``float32`` for the reference, ``float8_e4m3fn``
  emulated for the control, ``bfloat16`` as the port serves it); batch norm
  (eps 1e-5, the running statistics) promotes to float32, then
  ``leaky_relu(0.1)`` and the residual sums run in float32; the head (1x1
  with bias) runs in float32;
* ``padding="SAME"`` pads as flax does: a total of ``max((ceil(W / s) - 1)
  * s + k - W, 0)``, the low half rounded down;
* flax's ``ConvTranspose`` does not flip its kernel: the weight is kept
  flipped along the width, so that ``conv_transpose2d`` (which flips)
  computes the same sum;
* the width is wrap-padded to a multiple of ``2 ** len(stage_blocks)`` and
  the logits are cropped back.

Submodules carry flax's names (``Encoder_0``, ``ConvBlock_3``,
``ResidualBlock_5``, ``Conv_0``, ...), numbered per parent in order of
creation, so that a state dict key is a flax path with dots
(:func:`state_dict`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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

    def __init__(self, num_classes: int, stage_blocks: Sequence[int],
                 widths: Sequence[int], dtype=torch.bfloat16):
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


def build(seg: dict, dtype) -> RangeNet:
    """The darknet RangeNet of the segmenter group ``seg``, its
    convolutions in ``dtype``."""
    return RangeNet(seg["num_classes"], tuple(seg["stage_blocks"]),
                    tuple(seg["widths"]), dtype=dtype)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state_from_flax(variables) -> dict:
    """A ``RangeNet`` state dict from the weights file's flax variables."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flat(variables.get(coll, {})):
            *mods, leaf = path
            a = np.asarray(a, dtype=np.float32)
            if leaf == "kernel":
                if mods[-1].startswith("ConvTranspose"):
                    a = a.transpose(2, 3, 0, 1)[..., ::-1]
                else:
                    a = a.transpose(3, 2, 0, 1)
                leaf = "weight"
            out[".".join(mods + [leaf])] = torch.from_numpy(np.array(a))
    return out


def state_dict(blob, seg: dict) -> dict:
    """The reference's state dict from the weights file (``{"variables":
    flax variables, "model": {"num_classes", "stage_blocks", "widths"}}``,
    as the port writes it); ``ValueError`` where the blob is not a darknet
    RangeNet's or not of ``seg``'s sizes."""
    model = blob.get("model") if isinstance(blob, dict) else None
    if not isinstance(model, dict) or "variables" not in blob \
            or not {"stage_blocks", "widths"} <= set(model):
        raise ValueError("the weights file is not a darknet RangeNet's: it "
                         "has no variables or no model stage_blocks/widths")
    want = (seg["num_classes"], tuple(seg["stage_blocks"]),
            tuple(seg["widths"]))
    got = (model.get("num_classes"), tuple(model["stage_blocks"]),
           tuple(model["widths"]))
    if got != want:
        raise ValueError(f"the weights file's network (classes, blocks, "
                         f"widths) {got} is not the configuration's {want}")
    state = _state_from_flax(blob["variables"])
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  build(seg, torch.float32).state_dict().items()}
    bad = sorted(k for k in shapes.keys() | state.keys()
                 if k not in state or k not in shapes
                 or tuple(state[k].shape) != shapes[k])
    if bad:
        raise ValueError(f"the weights file's tensors differ from the "
                         f"network's in {len(bad)} keys: {bad[:5]}")
    return state


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def forward_flops(seg: dict, in_channels: int = IN_CHANNELS) -> int:
    """Multiply-adds times two of one forward on one ``seg["data"]``
    ``height x width`` image, the width wrap-padded to a multiple of ``2 **
    len(stage_blocks)``: every convolution ``2 * cout * cin * kh * kw *
    out_h * out_w``, every transposed convolution ``2 * cin * cout * kh * kw
    * in_h * in_w``; batch norms, activations and sums are left out (under
    0.1%). 601,572,245,504 for darknet53 at 64x2048."""
    stage_blocks, widths = seg["stage_blocks"], seg["widths"]
    w = seg["data"]["width"]
    w += (-w) % (2 ** len(stage_blocks))
    h = seg["data"]["height"]
    flops = 0

    def conv(cin, cout, k, wi, stride=1):
        nonlocal flops
        wo = _same_out(wi, stride)
        flops += 2 * cout * cin * k[0] * k[1] * h * wo
        return wo

    c = widths[0]
    cur = conv(in_channels, c, (3, 3), w)
    for blocks, width_ in zip(stage_blocks, widths[1:]):
        cur = conv(c, width_, (3, 3), cur, 2)
        for _ in range(blocks):
            conv(width_, width_ // 2, (1, 1), cur)
            conv(width_ // 2, width_, (3, 3), cur)
        c = width_
    for width_ in reversed(widths[:-1]):
        flops += 2 * c * width_ * 1 * 4 * h * cur   # (1, 4) stride (1, 2)
        cur *= 2
        conv(width_, width_, (1, 1), cur)
        conv(width_, width_ // 2, (1, 1), cur)
        conv(width_ // 2, width_, (3, 3), cur)
        c = width_
    conv(widths[0], seg["num_classes"], (1, 1), cur)
    return flops
