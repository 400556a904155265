"""Range-image semantic segmentation network (counterpart of
``semantic_suma_tpu/models/rangenet.py``): a darknet residual encoder that
downsamples the ``[B, 64, W, 5]`` range image along the width only, a
decoder with transposed-convolution upsampling and skip connections, and a
1x1 head over the 20 training classes.

The public functions keep the JAX package's channels-last layout (``[B, H,
W, 5]`` in, ``[B, H, W, classes]`` out); inside, the modules work in NCHW
(``channels_last`` memory on the GPU). They compute as flax does:

* each convolution and transposed convolution takes bfloat16 inputs and
  weights and gives a bfloat16 output; batch norm (eps 1e-5; the running
  statistics in ``eval()`` mode, the batch's in ``train()`` mode, see
  :class:`BatchNorm`) promotes to float32, then ``leaky_relu(0.1)`` and the residual sums
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

In ``eval()`` mode, with bfloat16 convolutions and where no layer is split
over a ``model_group``, :meth:`RangeNet.forward` walks the same submodules
another way (:meth:`RangeNet._walk`): after each convolution one call of the
batch-norm epilogue (``ops/epilogue.py``, a CUDA kernel on the card)
computes batch norm, ``leaky_relu``, the sum that follows and the roundings,
and writes only what the activation's consumers read: its float32 stream
where a sum or the head reads it, its bfloat16 copy where a convolution
does. The arithmetic, its order and its roundings are the modules'; the
logits are equal.

The KNN label vote and ``labels_for_points`` live in ``ops/knn.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.epilogue import bn_act
from .labels import TRAIN_CLASSES

BN_EPS = 1e-5
IN_CHANNELS = 5   # range, x, y, z, remission


def _same_pads(size: int, k: int, s: int):
    """(low, high) padding of flax's ``"SAME"`` along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pair(v) -> tuple:
    """An int or an (h, w) pair as an (h, w) pair."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _column_parallel(group, x: torch.Tensor, conv) -> torch.Tensor:
    """``conv(x)`` of a layer whose output channels the ranks of ``group``
    split (``parallel.sharding.shard_train_state``): each rank convolves the
    whole input with its slice of the weight, and the slices' outputs are
    gathered along the channels, so every rank holds the whole activation.
    The input's gradient is summed over the ranks."""
    return group.gather_cat(conv(group.copy_in(x)), 1)


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``, or with the explicit
    symmetric ``padding`` (an int or an (h, w) pair, PyTorch's reading) and
    ``dilation`` of a network that has no flax counterpart (SalsaNext's 2x2
    kernel at dilation 2, padded by 1); ``weight`` is ``[out, in, kh, kw]``.
    With a ``model_group`` the weight holds this rank's slice of the output
    channels (:func:`_column_parallel`)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 bias: bool = False, dtype=torch.bfloat16, dilation=1,
                 padding=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.dtype = dtype
        self.dilation = _pair(dilation)
        self.padding = None if padding is None else _pair(padding)
        if self.padding is None and self.dilation != (1, 1):
            raise ValueError("a dilated Conv takes an explicit padding")
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.model_group = None

    def reset_parameters(self, generator=None) -> None:
        kh, kw = self.kernel
        _lecun_normal_(self.weight, kh * kw * self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            (hl, hh), (wl, wh) = (_same_pads(x.shape[2 + a], self.kernel[a],
                                             self.stride[a]) for a in (0, 1))
        else:
            (hl, wl), (hh, wh) = self.padding, self.padding
        b = None if self.bias is None else self.bias.to(self.dtype)

        def conv(x, b):
            x = x.to(self.dtype)
            pad = (0, 0)
            if hl == hh and wl == wh:
                pad = (hl, wl)
            else:
                x = F.pad(x, (wl, wh, hl, hh))
            return F.conv2d(x, self.weight.to(self.dtype), b, self.stride,
                            pad, self.dilation)

        if self.model_group is None:
            return conv(x, b)
        y = _column_parallel(self.model_group, x, lambda x: conv(x, None))
        return y if b is None else y + b[:, None, None]


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose((1, 4), strides=(1, 2), padding="SAME")``,
    no bias. ``weight`` is ``[in, out, 1, 4]``, flipped along the width
    against flax's ``[1, 4, in, out]`` kernel; with a ``model_group`` this
    rank's slice of the output channels (:func:`_column_parallel`)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cin, cout, 1, 4))
        self.model_group = None

    def reset_parameters(self, generator=None) -> None:
        # flax computes the fan-in of the [1, 4, in, out] kernel: 4 * in
        _lecun_normal_(self.weight, 4 * self.weight.shape[0], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's SAME transpose pads the dilated input by (2, 2): padding 1
        def up(x):
            return F.conv_transpose2d(x.to(self.dtype),
                                      self.weight.to(self.dtype),
                                      stride=(1, 2), padding=(0, 1))

        if self.model_group is None:
            return up(x)
        return _column_parallel(self.model_group, x, up)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not train, dtype=float32)``:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32.

    In evaluation mode ``mean`` and ``var`` are the running statistics. In
    training mode (``self.training``) they are the batch's, over (N, H, W)
    in float32, with flax's *biased* variance ``max(mean(x²) - mean(x)², 0)``;
    the running statistics then move to ``0.99 * running + 0.01 * batch``
    with that same variance (``F.batch_norm`` would update them with the
    unbiased one).

    With a ``group`` (set by ``parallel.sharding.shard_train_state``) the
    batch is this rank's part of a global batch of equal parts: the means of
    ``x`` and ``x²`` are averaged over the ranks (differentiably) before the
    variance, so the statistics are the global batch's."""

    MOMENTUM = 0.99

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            sq = (x * x).mean(dim=(0, 2, 3))
            if self.group is not None and self.group.size > 1:
                both = self.group.sum_grad(torch.cat([mean, sq])) \
                    / self.group.size
                mean, sq = both[:mean.shape[0]], both[mean.shape[0]:]
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return torch.addcmul(self.bias[:, None, None], x - mean[:, None, None],
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


def batch_norm_constants(net: nn.Module) -> dict:
    """``{batch norm: (mean, mul, bias)}`` of every batch norm of ``net`` in
    evaluation mode, ``mul`` by ``BatchNorm.forward``'s own expression
    ``rsqrt(var + eps) * scale``, on the network's device."""
    out = {}
    for m in net.modules():
        if isinstance(m, BatchNorm):
            mul = torch.rsqrt(m.var + BN_EPS) * m.scale
            out[m] = (m.mean.detach(), mul.detach(), m.bias.detach())
    return out


# The inference walks' steps (``RangeNet._walk``, ``SqueezeSegV3._walk``):
# an activation is the pair ``(float32, bfloat16)``, each part None where no
# consumer reads it; ``consts`` is :func:`batch_norm_constants`.

def walk_block(consts: dict, cb: ConvBlock, xb, r=None, f32=False,
               bf16=True):
    """A :class:`ConvBlock` on the bfloat16 ``xb``, ``r +`` its output where
    a float32 ``r`` is given: one epilogue call."""
    return bn_act(cb.Conv_0(xb), *consts[cb.BatchNorm_0], r, f32=f32,
                  bf16=bf16)


def walk_residual(consts: dict, rb: ResidualBlock, xf, xb, f32: bool,
                  bf16: bool):
    """A :class:`ResidualBlock` on ``(xf, xb)``: two epilogue calls, the
    second adding ``xf``."""
    _, hb = walk_block(consts, rb.ConvBlock_0, xb)
    return walk_block(consts, rb.ConvBlock_1, hb, xf, f32, bf16)


def walk_decoder(consts: dict, dec: Decoder, xb, skips) -> torch.Tensor:
    """:meth:`Decoder.forward` on the bfloat16 ``xb`` and the bfloat16
    ``skips``: the float32 features the head reads."""
    for k, ((up, bn, skip_conv, res), skip) in enumerate(
            zip(dec.stages, reversed(skips))):
        uf, _ = bn_act(up(xb), *consts[bn], f32=True, bf16=False)
        if skip.shape[3] != uf.shape[3]:  # odd widths
            skip = skip[:, :, :, :uf.shape[3]]
        xf, xb = walk_block(consts, skip_conv, skip, uf, f32=True)
        last = k + 1 == len(dec.stages)   # the head reads it in float32
        xf, xb = walk_residual(consts, res, xf, xb, f32=last, bf16=not last)
    return xf


class RangeNet(nn.Module):
    """Full segmenter: ``[B, H, W, 5]`` -> ``[B, H, W, num_classes]``
    float32 logits. It starts in ``eval()`` mode, flax's ``train=False``;
    ``train()`` switches every batch norm to the batch's statistics.

    In ``train()`` mode, with a layer split over a ``model_group`` or with
    convolutions in another type than bfloat16 (a float32 network checks
    the arithmetic against flax's), the forward calls the encoder's and
    decoder's module forwards; otherwise it takes :meth:`_walk`, which
    computes the same logits."""

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
        # the walk's batch-norm constants, held where the weights no longer
        # change (``Segmenter``'s inference copy); None: computed a forward
        self.walk_constants: dict | None = None
        # the JAX package's default is ``train=False``: a network starts in
        # evaluation mode (running statistics) until ``train()``
        self.eval()

    def reset_parameters(self, seed: int = 0) -> "RangeNet":
        """flax's default initialisation (truncated lecun-normal kernels,
        zero biases, unit scales, zero means and unit variances), drawn from
        a ``torch.Generator`` seeded with ``seed``: not the values of the
        JAX package's ``model.init``."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.reset_parameters(gen)
        return self

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder and decoder in evaluation mode, one epilogue call a batch
        norm: the float32 features the head reads. An activation is the pair
        ``(float32, bfloat16)``, each part None where no consumer reads it:
        a convolution reads the bfloat16 copy (its own cast then launches
        nothing), a residual or skip sum and the head the float32 stream."""
        consts = (self.walk_constants if self.walk_constants is not None
                  else batch_norm_constants(self))
        enc = self.Encoder_0
        # the stem: a skip, conv-read only
        _, xb = walk_block(consts, enc.ConvBlock_0, x)
        skips = []
        for down, res in enc.stages:
            skips.append(xb)
            xf, xb = walk_block(consts, down, xb, f32=bool(res))
            for i, rb in enumerate(res):
                # a stage's last output feeds convolutions only
                xf, xb = walk_residual(consts, rb, xf, xb,
                                       f32=i + 1 < len(res), bf16=True)
        return walk_decoder(consts, self.Decoder_0, xb, skips)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride = 2 ** len(self.stage_blocks)
        w = x.shape[2]
        pad = (-w) % stride
        x = x.permute(0, 3, 1, 2)                 # NCHW view of NHWC memory
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        if self.training or self.dtype != torch.bfloat16 or any(
                getattr(m, "model_group", None) is not None
                for m in self.modules()):
            feats, skips = self.Encoder_0(x)
            y = self.Decoder_0(feats, skips)
        else:
            y = self._walk(x)
        logits = self.Conv_0(y.float())
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def small_rangenet(num_classes: int = len(TRAIN_CLASSES),
                   dtype=torch.bfloat16) -> RangeNet:
    """A darknet21-ish variant for tests and fast iteration."""
    return RangeNet(num_classes, (1, 1, 2, 2, 1), (16, 32, 64, 96, 128, 160),
                    dtype)


def mid_rangenet(num_classes: int = len(TRAIN_CLASSES),
                 dtype=torch.bfloat16) -> RangeNet:
    """Darknet21 depth at widths capped at 320: the in-loop deployment
    segmenter (``weights/segmenter_synth_mid.pkl``)."""
    return RangeNet(num_classes, (1, 1, 2, 2, 1), (32, 64, 128, 192, 256, 320),
                    dtype)


def make_input(vertex_map: torch.Tensor, depth_map: torch.Tensor,
               remission: torch.Tensor,
               vertex_valid: torch.Tensor) -> torch.Tensor:
    """The 5-channel network input (range, x, y, z, remission), ``[..., H,
    W, 5]``, zero on invalid pixels, as RangeNet++ stacks it."""
    depth = torch.where(torch.isfinite(depth_map), depth_map, 0.0)
    feats = torch.cat([depth[..., None], vertex_map, remission[..., None]],
                      dim=-1)
    return torch.where(vertex_valid[..., None], feats, 0.0)
