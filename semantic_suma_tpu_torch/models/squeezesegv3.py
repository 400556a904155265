"""SqueezeSegV3-53 (Xu, Wu, Wang, Zhan, Vajda, Keutzer and Tomizuka,
"SqueezeSegV3: Spatially-Adaptive Convolution for Efficient Point-Cloud
Segmentation", ECCV 2020, arXiv:2004.01803; github.com/chenfengxu714/
SqueezeSegV3, ``src/tasks/semantic/backbones/SAC.py``, ``ssg-v3-53.yaml``):
the port's third range-image segmentation network beside the darknet
``RangeNet`` and ``SalsaNext``, at 24,982,420 parameters with 20 classes
(994,268,151,808 FLOPs a 64x2048 forward).

* a 3x3 stem, 5 -> 32, batch norm and ``leaky_relu(0.1)`` (``ConvBlock``);
* five stages of 1, 2, 8, 8 and 4 :class:`SACBlock` at widths 32, 64, 128,
  256 and 256, each stage's blocks at its input's resolution; stages 1-3 then
  downsample with a 3x3 ``ConvBlock`` of stride (1, 2) to 64, 128 and 256
  channels; stages 4 and 5 do not (output stride 8);
* the point coordinates ``P`` (channels 1-3, x y z, of the wrap-padded
  input) beside the features: after each downsampling ``P`` is resized
  bilinearly to half the width (``align_corners=True``, as SAC.py's
  ``F.upsample_bilinear``), the height kept;
* two stride-1 stages at 256, each a 3x3 ``ConvBlock`` and a darknet
  ``ResidualBlock``, then the darknet ``Decoder`` over widths (32, 64, 128,
  256) fed three skips, each the input of stages 3, 2 and 1 (SAC.py's
  ``run_layer`` keeps a stage's input: 128 x W/4, 64 x W/2, 32 x W), and a
  1x1 head with a bias.

A SAC block (SAC-ISK) on features ``X`` (C channels) and coordinates ``P``::

    A   = sigmoid(BN_9C(Conv7x7_{3->9C}(P)))   # per pixel, channel, tap
    U   = unfold3x3(X)                         # channel c*9 + tap, pad 1
    Z   = ReLU(BN_C(Conv1x1_{9C->C}(U * A)))   # the adaptive 3x3 conv
    out = ReLU(BN_C(Conv3x3_{C->C}(Z))) + X

Its three convolutions have biases (``nn.Conv2d``'s default), the stem's,
the downsamplings' and the decoder's none (darknet's ``ConvBlock``).

It computes as the darknet network does (``models/rangenet.py``): each
convolution takes bfloat16 inputs and weights and gives a bfloat16 output;
batch norm, the sigmoid, the activations, the sums and the bilinear resize
run in float32; the head runs in float32. The adaptive convolution reads its
input in bfloat16 as any convolution does: ``U`` unfolds the bfloat16 copy
of ``X``, and ``U * A`` is rounded once, to bfloat16, as the 1x1
convolution's input. It takes ``[B, H, W, 5]`` and returns ``[B, H, W, C]``
float32 logits; inside, NCHW (``channels_last`` memory on the GPU). The width
is wrap-padded to a multiple of 8 and the logits are cropped back.

Departures from SAC.py, each also in the configuration's ``assumed``:

* the decoder is the port's darknet one (RangeNet++'s, as darknet53 runs it)
  after two stride-1 stages, not SqueezeSegV3's own decoder with its
  auxiliary heads (they matter only in training);
* the downsampling convolutions pad as the darknet ``Conv`` does (flax's
  ``"SAME"``: (0, 1) along an even width, where SAC.py pads (1, 1));
* the input is unnormalised, as in the other two configurations; there is no
  dropout (``Dropout2d(0.01)`` acts in training only).

In ``eval()`` mode, with bfloat16 convolutions, :meth:`SqueezeSegV3.forward`
walks the same submodules another way (:meth:`SqueezeSegV3._walk`): a SAC
block is its attention convolution, one call of ``ops/sac.sac_modulate``
(``csrc/sac.cu`` on the card) for ``U * A``, its 1x1 convolution, one call
of the batch-norm epilogue (``ops/epilogue.bn_act``, slope 0), its 3x3
convolution and one more, which adds the residual; the stem, the
downsamplings and the decoder are darknet's walk. Training keeps the module
forwards, each SAC block under activation checkpointing.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.epilogue import bn_act
from ..ops.sac import TAPS, sac_modulate
from .labels import TRAIN_CLASSES
from .rangenet import (IN_CHANNELS, BatchNorm, Conv, ConvBlock,
                       ConvTranspose, Decoder, ResidualBlock,
                       batch_norm_constants, walk_block, walk_decoder,
                       walk_residual)

DOWNSAMPLE = 8        # three stride-(1, 2) downsamplings
COORDS = slice(1, 4)  # x, y, z of the 5-channel input


def _halve_width(p: torch.Tensor) -> torch.Tensor:
    """SAC.py's ``F.upsample_bilinear(xyz, size=[H, W // 2])``."""
    return F.interpolate(p, size=(p.shape[2], p.shape[3] // 2),
                         mode="bilinear", align_corners=True)


class SACBlock(nn.Module):
    """SqueezeSegV3's SAC-ISK block on ``C`` channels: ``forward(x, p)``
    with the float32 features ``x`` ``[N, C, H, W]`` and the coordinates
    ``p`` ``[N, 3, H, W]`` at their resolution; returns float32."""

    def __init__(self, c: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.attention = Conv(3, TAPS * c, (7, 7), bias=True, dtype=dtype,
                              padding=3)
        self.bn_attention = BatchNorm(TAPS * c)
        self.conv1 = Conv(TAPS * c, c, (1, 1), bias=True, dtype=dtype,
                          padding=0)
        self.bn1 = BatchNorm(c)
        self.conv3 = Conv(c, c, (3, 3), bias=True, dtype=dtype, padding=1)
        self.bn3 = BatchNorm(c)

    def forward(self, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        att = torch.sigmoid(self.bn_attention(self.attention(p)))
        u = F.unfold(x.to(self.dtype), 3, padding=1).view(n, TAPS * c, h, w)
        z = F.relu(self.bn1(self.conv1(u.float() * att)))
        return x.float() + F.relu(self.bn3(self.conv3(z)))


@contextmanager
def _running_stats_kept(module: nn.Module):
    """Batch norm inside ``module`` leaves its running statistics as they
    are (momentum 1): a checkpointed block's recomputation must not move
    them a second time."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.MOMENTUM = 1.0
    try:
        yield
    finally:
        for bn in bns:
            del bn.MOMENTUM


class Stage(nn.Module):
    """A stage of the encoder: its SAC blocks, then (stages 1-3) a
    downsampling ``ConvBlock``."""

    def __init__(self, blocks: int, c: int, out: int | None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.blocks = nn.ModuleList(SACBlock(c, dtype) for _ in range(blocks))
        self.down = None if out is None else ConvBlock(c, out, (3, 3), (1, 2),
                                                       dtype=dtype)


class SqueezeSegV3(nn.Module):
    """``[B, H, W, 5]`` -> ``[B, H, W, num_classes]`` float32 logits. It
    starts in ``eval()`` mode (running statistics); ``train()`` switches
    batch norm to the batch's statistics.

    In ``train()`` mode or with convolutions in another type than bfloat16
    (a float32 network checks the arithmetic against the reference), the
    forward calls the module forwards; otherwise it takes :meth:`_walk`,
    which computes the same logits."""

    def __init__(self, num_classes: int = len(TRAIN_CLASSES),
                 stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 widths: Sequence[int] = (32, 64, 128, 256, 256),
                 dtype=torch.bfloat16):
        super().__init__()
        if len(stage_blocks) != 5 or len(widths) != 5 \
                or widths[3] != widths[4]:
            raise ValueError("SqueezeSegV3 takes five stages, the last two "
                             f"of one width; got blocks {stage_blocks}, "
                             f"widths {widths}")
        self.num_classes = num_classes
        self.stage_blocks = tuple(stage_blocks)
        self.widths = tuple(widths)
        self.dtype = dtype
        self.stem = ConvBlock(IN_CHANNELS, widths[0], dtype=dtype)
        self.stages = nn.ModuleList(
            Stage(b, c, widths[k + 1] if k < 3 else None, dtype)
            for k, (b, c) in enumerate(zip(stage_blocks, widths)))
        c = widths[4]
        self.mid = nn.ModuleList([ConvBlock(c, c, dtype=dtype),
                                  ResidualBlock(c, dtype=dtype),
                                  ConvBlock(c, c, dtype=dtype),
                                  ResidualBlock(c, dtype=dtype)])
        self.add_module("Decoder_0", Decoder(widths[:4], dtype))
        self.head = Conv(widths[0], num_classes, (1, 1), bias=True,
                         dtype=torch.float32, padding=0)
        # the walk's batch-norm constants, held where the weights no longer
        # change (``Segmenter``'s inference copy); None: computed a forward
        self.walk_constants: dict | None = None
        self.eval()

    def reset_parameters(self, seed: int = 0) -> "SqueezeSegV3":
        """PyTorch's default initialisation, which SAC.py keeps: each
        convolution's weights (and biases) uniform in ``±1 / sqrt(fan_in)``,
        the transposed convolutions' fan-in that of ``nn.ConvTranspose2d``
        (output channels times taps), drawn from a ``torch.Generator``
        seeded with ``seed``. Batch norm keeps its unit scales, zero biases,
        zero means and unit variances."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, ConvTranspose)):
                    fan_in = m.weight[0].numel() if isinstance(m, Conv) \
                        else m.weight[:, 0].numel()
                    bound = 1.0 / math.sqrt(fan_in)
                    m.weight.uniform_(-bound, bound, generator=gen)
                    if getattr(m, "bias", None) is not None:
                        m.bias.uniform_(-bound, bound, generator=gen)
        return self

    def _sac(self, blk: SACBlock, x: torch.Tensor, p: torch.Tensor):
        if not (self.training and torch.is_grad_enabled()):
            return blk(x, p)
        # the block's 9C-channel tensors are recomputed in the backward pass
        # rather than kept: 23 blocks of them would not fit a training batch
        return checkpoint(blk, x, p, use_reentrant=False,
                          context_fn=lambda: (nullcontext(),
                                              _running_stats_kept(blk)))

    def _modules_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The module forwards: the float32 features the head reads."""
        p = x[:, COORDS]
        xf = self.stem(x)
        skips = []
        for stage in self.stages:
            if stage.down is not None:
                skips.append(xf)
            for blk in stage.blocks:
                xf = self._sac(blk, xf, p)
            if stage.down is not None:
                xf = stage.down(xf)
                p = _halve_width(p)
        for m in self.mid:
            xf = m(xf)
        return self.Decoder_0(xf, skips)

    def _walk(self, x: torch.Tensor) -> torch.Tensor:
        """The network in evaluation mode, one ``sac_modulate`` call a SAC
        block and one epilogue call a batch norm elsewhere: the float32
        features the head reads (``RangeNet._walk``'s pairs)."""
        consts = (self.walk_constants if self.walk_constants is not None
                  else batch_norm_constants(self))
        cl = torch.channels_last if x.is_cuda else torch.contiguous_format
        p = x[:, COORDS]
        pb = p.to(self.dtype).contiguous(memory_format=cl)
        xf, xb = walk_block(consts, self.stem, x, f32=True)
        left = sum(self.stage_blocks)   # SAC blocks still to run
        skips = []
        for stage in self.stages:
            if stage.down is not None:
                skips.append(xb)
            for j, blk in enumerate(stage.blocks):
                left -= 1
                # the float32 stream only where a SAC block adds it next
                nxt = left > 0 and (stage.down is None or
                                    j + 1 < len(stage.blocks))
                m = sac_modulate(blk.attention(pb), xb,
                                 *consts[blk.bn_attention])
                _, hb = bn_act(blk.conv1(m), *consts[blk.bn1], f32=False,
                               bf16=True, slope=0.0)
                xf, xb = bn_act(blk.conv3(hb), *consts[blk.bn3], xf,
                                f32=nxt, bf16=True, slope=0.0)
            if stage.down is not None:
                xf, xb = walk_block(consts, stage.down, xb, f32=True)
                p = _halve_width(p)
                pb = p.to(self.dtype).contiguous(memory_format=cl)
        conv_a, res_a, conv_b, res_b = self.mid
        xf, xb = walk_block(consts, conv_a, xb, f32=True)
        _, xb = walk_residual(consts, res_a, xf, xb, f32=False, bf16=True)
        xf, xb = walk_block(consts, conv_b, xb, f32=True)
        _, xb = walk_residual(consts, res_b, xf, xb, f32=False, bf16=True)
        return walk_decoder(consts, self.Decoder_0, xb, skips)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.shape[2]
        pad = (-w) % DOWNSAMPLE
        x = x.permute(0, 3, 1, 2)                 # NCHW view of NHWC memory
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        if self.training or self.dtype != torch.bfloat16:
            y = self._modules_forward(x)
        else:
            y = self._walk(x)
        logits = self.head(y.float())
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def small_squeezesegv3(num_classes: int = len(TRAIN_CLASSES),
                       dtype=torch.bfloat16) -> SqueezeSegV3:
    """A one-block-a-stage SqueezeSegV3 at widths 8-24 for tests and fast
    iteration."""
    return SqueezeSegV3(num_classes, (1, 1, 1, 1, 1), (8, 16, 16, 24, 24),
                        dtype)
