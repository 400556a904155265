"""SalsaNext (Cortinhal, Tzelepis and Aksoy, "SalsaNext: Fast,
Uncertainty-aware Semantic Segmentation of LiDAR Point Clouds",
arXiv:2003.03653; github.com/TiagoCortinhal/SalsaNext,
``train/tasks/semantic/modules/SalsaNext.py``): the port's second
range-image segmentation network beside the darknet ``RangeNet``, at the
published widths (base 32: 6,711,572 parameters with 20 classes).

* three ``ResContextBlock`` at full resolution: ``s = lrelu(conv1x1(x))``,
  ``a1 = bn(lrelu(conv3x3(s)))``, ``a2 = bn(lrelu(conv3x3_dil2(a1)))``,
  ``s + a2``;
* five ``ResBlock`` (32 -> 64 -> 128 -> 256 -> 256 -> 256):
  ``s = lrelu(conv1x1(x))``, ``a1 = bn(lrelu(conv3x3(x)))``, ``a2 =
  bn(lrelu(conv3x3_dil2(a1)))``, ``a3 = bn(lrelu(conv2x2_dil2_pad1(a2)))``,
  ``r = s + bn(lrelu(conv1x1(cat[a1, a2, a3])))``; the first four return
  ``(avg_pool(r, 3, stride 2, pad 1), r)``, halving the height and the
  width, the fifth ``r``;
* four ``UpBlock`` (128, 128, 64, 32): ``u = cat[pixel_shuffle(x, 2),
  skip]``, then the three dilated branches and the 1x1 merge as in a
  ``ResBlock``, without the shortcut;
* a 1x1 head with a bias. The published network ends in a softmax; this one
  returns the logits, as the darknet network does.

Every convolution has a bias and is followed by ``leaky_relu(0.01)`` and
then batch norm, the opposite order of darknet's. ``Dropout2d`` sits where
the published network has it (before the pool of ``ResBlock`` 2-5, around
``UpBlock`` 1-3) and acts in ``train()`` mode only.

It computes as the darknet network does (``models/rangenet.py``): each
convolution takes bfloat16 inputs and weights and gives a bfloat16 output;
``leaky_relu``, batch norm, the residual sums, the pool and the pixel
shuffle run in float32; the head runs in float32. It takes ``[B, H, W, 5]``
and returns ``[B, H, W, C]`` float32 logits; inside, NCHW (``channels_last``
memory on the GPU). The height must be a multiple of 16; the width is
wrap-padded to one and the logits are cropped back.

Submodules carry the published names (``downCntx``, ``resBlock1``,
``upBlock4``, ``logits``; ``conv1``, ``bn1``, ... inside a block), so a state
dict key is the published one, with batch norm's ``scale``, ``bias``,
``mean`` and ``var`` for ``weight``, ``bias``, ``running_mean`` and
``running_var``.

With a ``stopwatch`` (``Segmenter`` hands it its own) the forward opens the
spans ``segmenter/network/context`` (the context blocks),
``segmenter/network/encoder`` (the ``ResBlock``s) and
``segmenter/network/decoder`` (the ``UpBlock``s and the head)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.timing import span
from .labels import TRAIN_CLASSES
from .rangenet import IN_CHANNELS, BatchNorm, Conv

SLOPE = 0.01          # nn.LeakyReLU's default slope
DOWNSAMPLE = 16       # four pools, each halving the height and the width


def _lrelu_bn(bn: BatchNorm, y: torch.Tensor) -> torch.Tensor:
    """A convolution's output through ``leaky_relu`` and batch norm, in
    float32."""
    return bn(F.leaky_relu(y.float(), SLOPE))


def _branches(x: torch.Tensor, convs, bns, dtype) -> torch.Tensor:
    """The three chained branches of a ``ResBlock`` or ``UpBlock``, each
    ``bn(lrelu(conv(previous)))``, concatenated along the channels in the
    merging convolution's compute type (the cast is elementwise: casting
    before the concatenation gives the same input in half the bytes)."""
    outs = []
    for conv, bn in zip(convs, bns):
        x = _lrelu_bn(bn, conv(x))
        outs.append(x.to(dtype))
    return torch.cat(outs, dim=1)


class ResContextBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(cin, cout, (1, 1), bias=True, dtype=dtype,
                          padding=0)
        self.conv2 = Conv(cout, cout, (3, 3), bias=True, dtype=dtype,
                          padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv3 = Conv(cout, cout, (3, 3), bias=True, dtype=dtype,
                          dilation=2, padding=2)
        self.bn2 = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.leaky_relu(self.conv1(x).float(), SLOPE)
        a1 = _lrelu_bn(self.bn1, self.conv2(s))
        return s + _lrelu_bn(self.bn2, self.conv3(a1))


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dropout: float,
                 pooling: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.pooling = pooling
        self.conv1 = Conv(cin, cout, (1, 1), bias=True, dtype=dtype,
                          padding=0)
        self.conv2 = Conv(cin, cout, (3, 3), bias=True, dtype=dtype,
                          padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv3 = Conv(cout, cout, (3, 3), bias=True, dtype=dtype,
                          dilation=2, padding=2)
        self.bn2 = BatchNorm(cout)
        self.conv4 = Conv(cout, cout, (2, 2), bias=True, dtype=dtype,
                          dilation=2, padding=1)
        self.bn3 = BatchNorm(cout)
        self.conv5 = Conv(3 * cout, cout, (1, 1), bias=True, dtype=dtype,
                          padding=0)
        self.bn4 = BatchNorm(cout)

    def forward(self, x: torch.Tensor):
        s = F.leaky_relu(self.conv1(x).float(), SLOPE)
        cat = _branches(x, (self.conv2, self.conv3, self.conv4),
                        (self.bn1, self.bn2, self.bn3), self.dtype)
        r = s + _lrelu_bn(self.bn4, self.conv5(cat))
        out = F.dropout2d(r, self.dropout, self.training) if self.dropout \
            else r
        if not self.pooling:
            return out
        return F.avg_pool2d(out, 3, stride=2, padding=1), r


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dropout: float,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.conv1 = Conv(cin // 4 + 2 * cout, cout, (3, 3), bias=True,
                          dtype=dtype, padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout, (3, 3), bias=True, dtype=dtype,
                          dilation=2, padding=2)
        self.bn2 = BatchNorm(cout)
        self.conv3 = Conv(cout, cout, (2, 2), bias=True, dtype=dtype,
                          dilation=2, padding=1)
        self.bn3 = BatchNorm(cout)
        self.conv4 = Conv(3 * cout, cout, (1, 1), bias=True, dtype=dtype,
                          padding=0)
        self.bn4 = BatchNorm(cout)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout2d(x, self.dropout, self.training) if self.dropout \
            else x

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        u = self._drop(F.pixel_shuffle(x, 2))
        u = self._drop(torch.cat([u, skip], dim=1))
        cat = _branches(u, (self.conv1, self.conv2, self.conv3),
                        (self.bn1, self.bn2, self.bn3), self.dtype)
        return self._drop(_lrelu_bn(self.bn4, self.conv4(cat)))


class SalsaNext(nn.Module):
    """``[B, H, W, 5]`` -> ``[B, H, W, num_classes]`` float32 logits. It
    starts in ``eval()`` mode (running statistics, no dropout); ``train()``
    switches batch norm to the batch's statistics and turns dropout on."""

    stopwatch = None

    def __init__(self, num_classes: int = len(TRAIN_CLASSES), base: int = 32,
                 dropout: float = 0.2, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.base = base
        self.dtype = dtype
        b = base
        self.downCntx = ResContextBlock(IN_CHANNELS, b, dtype)
        self.downCntx2 = ResContextBlock(b, b, dtype)
        self.downCntx3 = ResContextBlock(b, b, dtype)
        self.resBlock1 = ResBlock(b, 2 * b, 0.0, dtype=dtype)
        self.resBlock2 = ResBlock(2 * b, 4 * b, dropout, dtype=dtype)
        self.resBlock3 = ResBlock(4 * b, 8 * b, dropout, dtype=dtype)
        self.resBlock4 = ResBlock(8 * b, 8 * b, dropout, dtype=dtype)
        self.resBlock5 = ResBlock(8 * b, 8 * b, dropout, pooling=False,
                                  dtype=dtype)
        self.upBlock1 = UpBlock(8 * b, 4 * b, dropout, dtype)
        self.upBlock2 = UpBlock(4 * b, 4 * b, dropout, dtype)
        self.upBlock3 = UpBlock(4 * b, 2 * b, dropout, dtype)
        self.upBlock4 = UpBlock(2 * b, b, 0.0, dtype)
        self.logits = Conv(b, num_classes, (1, 1), bias=True,
                           dtype=torch.float32, padding=0)
        self.eval()

    def reset_parameters(self, seed: int = 0) -> "SalsaNext":
        """PyTorch's default ``nn.Conv2d`` initialisation, which the
        published network keeps: each convolution's weights and biases
        uniform in ``±1 / sqrt(fan_in)``, drawn from a ``torch.Generator``
        seeded with ``seed``. Batch norm keeps its unit scales, zero biases,
        zero means and unit variances."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=gen)
                    m.bias.uniform_(-bound, bound, generator=gen)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % DOWNSAMPLE:
            raise ValueError(f"SalsaNext needs a height that is a multiple "
                             f"of {DOWNSAMPLE}, got {h}")
        pad = (-w) % DOWNSAMPLE
        x = x.permute(0, 3, 1, 2)                 # NCHW view of NHWC memory
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        sw = self.stopwatch
        with span(sw, "segmenter/network/context"):
            x = self.downCntx3(self.downCntx2(self.downCntx(x)))
        with span(sw, "segmenter/network/encoder"):
            x, skip1 = self.resBlock1(x)
            x, skip2 = self.resBlock2(x)
            x, skip3 = self.resBlock3(x)
            x, skip4 = self.resBlock4(x)
            x = self.resBlock5(x)
        with span(sw, "segmenter/network/decoder"):
            x = self.upBlock1(x, skip4)
            x = self.upBlock2(x, skip3)
            x = self.upBlock3(x, skip2)
            x = self.upBlock4(x, skip1)
            logits = self.logits(x.float())
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def small_salsanext(num_classes: int = len(TRAIN_CLASSES),
                    dtype=torch.bfloat16) -> SalsaNext:
    """SalsaNext at base width 8 for tests and fast iteration."""
    return SalsaNext(num_classes, base=8, dtype=dtype)
