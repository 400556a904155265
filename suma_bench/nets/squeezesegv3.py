"""SqueezeSegV3-53 (Xu, Wu, Wang, Zhan, Vajda, Keutzer and Tomizuka, ECCV
2020, arXiv:2004.01803; github.com/chenfengxu714/SqueezeSegV3,
``src/tasks/semantic/backbones/SAC.py``, ``ssg-v3-53.yaml``), the plain
reference of the segmenter group ``"arch": "squeezesegv3"``, which reads the
group's ``num_classes``, ``stage_blocks`` (1, 2, 8, 8, 4) and ``widths``
(32, 64, 128, 256, 256): 24,982,420 parameters with 20 classes.

Written with ``nn.Conv2d``, ``nn.BatchNorm2d`` in evaluation mode,
``nn.ConvTranspose2d``, ``F.unfold``, ``torch.sigmoid``, ``F.relu``,
``F.leaky_relu`` and ``F.interpolate(..., mode="bilinear",
align_corners=True)``. Its convolutions compute in the compute type
(``float32`` for the reference, with TF32 off by the caller;
``float8_e4m3fn`` emulated for the control); batch norm, the sigmoid, the
activations, the sums and the resize run in float32.

* the stem: a 3x3 convolution 5 -> 32, batch norm, ``leaky_relu(0.1)``;
* five stages of SAC blocks at widths 32, 64, 128, 256, 256, each block::

      A   = sigmoid(BN(Conv7x7_{3->9C}(P)))
      U   = F.unfold(X, 3, padding=1)          # channel c*9 + tap
      out = ReLU(BN(Conv3x3(ReLU(BN(Conv1x1_{9C->C}(U * A)))))) + X

  its three convolutions with biases; after the blocks of stages 1-3 a 3x3
  convolution of stride (1, 2) to 64, 128 and 256 channels, batch norm and
  ``leaky_relu(0.1)``, and the coordinates ``P`` (channels 1-3 of the input)
  resized bilinearly to half the width (``align_corners=True``, SAC.py's
  ``F.upsample_bilinear``); output stride 8;
* the skips: the inputs of stages 1-3 (SAC.py's ``run_layer`` keeps a
  stage's input);
* two stride-1 stages at 256, each a 3x3 convolution with batch norm and
  ``leaky_relu(0.1)`` and a darknet residual block (1x1 to 128, 3x3 back to
  256, each with batch norm and ``leaky_relu(0.1)``, plus the input);
* three upsampling stages to 128, 64 and 32 channels, each a transposed
  convolution ``(1, 4)`` of stride (1, 2) padded (0, 1), batch norm and
  ``leaky_relu(0.1)``, plus a 1x1 convolution block of the skip, then a
  darknet residual block; a 1x1 head with a bias, in float32.

Departures from SAC.py, each also under the configuration's ``assumed``:

* the decoder (the two stride-1 stages and the upsampling) is RangeNet++'s
  darknet decoder as the port runs it, not SqueezeSegV3's own with its
  auxiliary heads, which matter only in training; the sizes above are the
  configuration's assumption, not SAC.py's text;
* the stem, the downsamplings and the decoder's convolutions have no bias and
  pad as flax's ``"SAME"``: a stride-(1, 2) 3x3 pads an even width by (0, 1),
  where SAC.py pads (1, 1); the transposed convolution's weight is kept as
  the port writes it (flipped along the width against flax's kernel);
* it takes ``[B, H, W, 5]`` (range, x, y, z, remission) as
  ``reference/slam/models/rangenet.make_input`` stacks them, unnormalised
  (the published network normalises by the dataset's mean and std), and
  returns the logits ``[B, H, W, C]``, not their softmax; no dropout;
* the width is wrap-padded to a multiple of 8 and the logits are cropped
  back.

The weights file, as the port writes it: ``{"model": {"arch":
"squeezesegv3", "num_classes", "stage_blocks", "widths"}, "variables":
{key: array}}``, the arrays under the port's state-dict keys (``stem``,
``stages.<k>.blocks.<i>.attention``, ``...bn_attention``, ``conv1``,
``bn1``, ``conv3``, ``bn3``, ``stages.<k>.down``, ``mid.<i>``,
``Decoder_0``, ``head``), which this module's names mirror but for batch
norm's ``scale``, ``mean`` and ``var`` (:func:`state_dict`).

:func:`sac_bytes` gives the SAC kernel's bytes a forward for its roofline
reader (``metrics/sac_roofline.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IN_CHANNELS = 5   # range, x, y, z, remission
TAPS = 9
DOWNSAMPLE = 8
SLOPE = 0.1       # darknet's leaky_relu
# the port's batch norm names -> nn.BatchNorm2d's
_BN_KEYS = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in the convolutions' compute type. ``float8_e4m3fn`` (the
    benchmark's control) is emulated: the tensor is scaled to the format's
    range, rounded to it, and computed in bfloat16."""
    if dtype != torch.float8_e4m3fn:
        return t.to(dtype)
    scale = t.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((t.float() / scale).to(dtype).float() * scale).to(torch.bfloat16)


def _bias_type(dtype):
    return torch.bfloat16 if dtype == torch.float8_e4m3fn else dtype


def _same_pads(size: int, k: int, s: int):
    """(low, high) padding of flax's ``"SAME"`` along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in ``dtype``; ``same``: padded as flax's
    ``"SAME"`` (the darknet parts), else by its symmetric ``padding``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True,
                 same=False, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.same = same
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if self.same:
            (hl, hh), (wl, wh) = (_same_pads(x.shape[2 + a],
                                             self.kernel_size[a],
                                             self.stride[a]) for a in (0, 1))
            x = F.pad(x, (wl, wh, hl, hh))
            pad = 0
        b = None if self.bias is None else self.bias.to(_bias_type(self.dtype))
        return F.conv2d(_cast(x, self.dtype), _cast(self.weight, self.dtype),
                        b, self.stride, pad).float()


class ConvTranspose(nn.ConvTranspose2d):
    """The darknet decoder's upsampling: ``(1, 4)``, stride (1, 2), padded
    (0, 1), no bias, computed in ``dtype``."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout, (1, 4), stride=(1, 2), padding=(0, 1),
                         bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(_cast(x, self.dtype),
                                  _cast(self.weight, self.dtype),
                                  stride=self.stride,
                                  padding=self.padding).float()


class ConvBlock(nn.Module):
    """Convolution (no bias, ``"SAME"``), batch norm, ``leaky_relu(0.1)``."""

    def __init__(self, cin, cout, kernel=3, stride=1, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, kernel, stride, bias=False,
                             same=True, dtype=dtype)
        self.BatchNorm_0 = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), SLOPE)


class ResidualBlock(nn.Module):
    """Darknet's bottleneck: 1x1 to half, 3x3 back, plus the input."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(c, c // 2, 1, dtype=dtype)
        self.ConvBlock_1 = ConvBlock(c // 2, c, 3, dtype=dtype)

    def forward(self, x):
        return x + self.ConvBlock_1(self.ConvBlock_0(x))


class SACBlock(nn.Module):
    """SAC-ISK (SAC.py's ``SACBlock``): ``forward(x, p)``."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.attention = Conv2d(3, TAPS * c, 7, padding=3, dtype=dtype)
        self.bn_attention = nn.BatchNorm2d(TAPS * c)
        self.conv1 = Conv2d(TAPS * c, c, 1, dtype=dtype)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv3 = Conv2d(c, c, 3, padding=1, dtype=dtype)
        self.bn3 = nn.BatchNorm2d(c)

    def forward(self, x, p):
        n, c, h, w = x.shape
        att = torch.sigmoid(self.bn_attention(self.attention(p)))
        u = F.unfold(x, 3, padding=1).view(n, TAPS * c, h, w)
        z = F.relu(self.bn1(self.conv1(u * att)))
        return F.relu(self.bn3(self.conv3(z))) + x


class Stage(nn.Module):
    def __init__(self, blocks, c, out, dtype):
        super().__init__()
        self.blocks = nn.ModuleList(SACBlock(c, dtype) for _ in range(blocks))
        self.down = None if out is None else ConvBlock(c, out, 3, (1, 2),
                                                       dtype)


class Decoder(nn.Module):
    """The darknet decoder over ``widths`` (32, 64, 128, 256), under the
    port's names (``ConvTranspose_<i>``, ``BatchNorm_<i>``,
    ``ConvBlock_<i>``, ``ResidualBlock_<i>``)."""

    def __init__(self, widths, dtype):
        super().__init__()
        self.n = len(widths) - 1
        c = widths[-1]
        for i, width in enumerate(reversed(widths[:-1])):
            self.add_module(f"ConvTranspose_{i}",
                            ConvTranspose(c, width, dtype))
            self.add_module(f"BatchNorm_{i}", nn.BatchNorm2d(width))
            self.add_module(f"ConvBlock_{i}", ConvBlock(width, width, 1,
                                                        dtype=dtype))
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(width, dtype))
            c = width

    def forward(self, x, skips):
        for i, skip in zip(range(self.n), reversed(skips)):
            up = getattr(self, f"ConvTranspose_{i}")(x)
            x = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(up), SLOPE)
            x = x + getattr(self, f"ConvBlock_{i}")(skip)
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return x


class SqueezeSegV3(nn.Module):
    """``[B, H, W, 5]`` -> ``[B, H, W, num_classes]`` float32 logits."""

    def __init__(self, num_classes, stage_blocks, widths,
                 dtype=torch.float32):
        super().__init__()
        self.stem = ConvBlock(IN_CHANNELS, widths[0], dtype=dtype)
        self.stages = nn.ModuleList(
            Stage(b, c, widths[k + 1] if k < 3 else None, dtype)
            for k, (b, c) in enumerate(zip(stage_blocks, widths)))
        c = widths[4]
        self.mid = nn.ModuleList([ConvBlock(c, c, dtype=dtype),
                                  ResidualBlock(c, dtype),
                                  ConvBlock(c, c, dtype=dtype),
                                  ResidualBlock(c, dtype)])
        self.Decoder_0 = Decoder(tuple(widths[:4]), dtype)
        # the head runs in float32, as the port's does
        self.head = Conv2d(widths[0], num_classes, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.shape[2]
        pad = (-w) % DOWNSAMPLE
        x = x.permute(0, 3, 1, 2).float()
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        xyz = x[:, 1:4]
        feat = self.stem(x)
        skips = []
        for stage in self.stages:
            if stage.down is not None:
                skips.append(feat)
            for blk in stage.blocks:
                feat = blk(feat, xyz)
            if stage.down is not None:
                feat = stage.down(feat)
                xyz = F.interpolate(xyz, size=(xyz.shape[2],
                                               xyz.shape[3] // 2),
                                    mode="bilinear", align_corners=True)
        for m in self.mid:
            feat = m(feat)
        logits = self.head(self.Decoder_0(feat, skips))
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def build(seg: dict, dtype) -> SqueezeSegV3:
    """The SqueezeSegV3 of the segmenter group ``seg``, its convolutions in
    ``dtype``, in evaluation mode."""
    return SqueezeSegV3(seg["num_classes"], tuple(seg["stage_blocks"]),
                        tuple(seg["widths"]), dtype).eval()


def state_dict(blob, seg: dict) -> dict:
    """The reference's state dict from the weights file; ``ValueError``
    where the blob is not a SqueezeSegV3's (a darknet blob names no
    ``"arch"``, or ``"rangenet_darknet"``) or not of ``seg``'s sizes."""
    model = blob.get("model") if isinstance(blob, dict) else None
    if not isinstance(model, dict) or model.get("arch") != "squeezesegv3" \
            or not isinstance(blob.get("variables"), dict):
        raise ValueError("the weights file is not a SqueezeSegV3's: its "
                         "model names no arch \"squeezesegv3\" or it has no "
                         "variables")
    want = (seg["num_classes"], tuple(seg["stage_blocks"]),
            tuple(seg["widths"]))
    got = (model.get("num_classes"), tuple(model.get("stage_blocks", ())),
           tuple(model.get("widths", ())))
    if got != want:
        raise ValueError(f"the weights file's network (classes, blocks, "
                         f"widths) {got} is not the configuration's {want}")
    state = {}
    for key, a in blob["variables"].items():
        *mods, leaf = key.split(".")
        state[".".join(mods + [_BN_KEYS.get(leaf, leaf)])] = \
            torch.from_numpy(np.array(a, dtype=np.float32))
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  build(seg, torch.float32).state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    bad = sorted(k for k in shapes.keys() | state.keys()
                 if k not in state or k not in shapes
                 or tuple(state[k].shape) != shapes[k])
    if bad:
        raise ValueError(f"the weights file's tensors differ from the "
                         f"network's in {len(bad)} keys: {bad[:5]}")
    for k in list(state):
        if k.endswith(".running_var"):
            state[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return state


def _padded_width(seg: dict) -> int:
    w = seg["data"]["width"]
    return w + (-w) % DOWNSAMPLE


def forward_flops(seg: dict, in_channels: int = IN_CHANNELS) -> int:
    """Multiply-adds times two of one forward on one ``seg["data"]``
    ``height x width`` image, the width wrap-padded to a multiple of 8: every
    convolution ``2 * cout * cin * kh * kw * out_h * out_w``, every
    transposed convolution ``2 * cin * cout * kh * kw * in_h * in_w``; batch
    norms, the sigmoid, the modulation ``U * A``, activations, sums and the
    resize are left out (~0.5%). 994,268,151,808 at 64x2048, 255 GFLOP of it
    the 23 attention convolutions."""
    blocks, widths = seg["stage_blocks"], seg["widths"]
    h, cur = seg["data"]["height"], _padded_width(seg)
    flops = 0

    def conv(cin, cout, k):
        nonlocal flops
        flops += 2 * cout * cin * k * k * h * cur

    c = widths[0]
    conv(in_channels, c, 3)                          # the stem
    for k, (b, c) in enumerate(zip(blocks, widths)):
        for _ in range(b):                           # SAC blocks
            conv(3, TAPS * c, 7)
            conv(TAPS * c, c, 1)
            conv(c, c, 3)
        if k < 3:                                    # downsampling
            cur = -(-cur // 2)
            conv(c, widths[k + 1], 3)
    c = widths[4]
    for _ in range(2):                               # the stride-1 stages
        conv(c, c, 3)
        conv(c, c // 2, 1)
        conv(c // 2, c, 3)
    for width in reversed(widths[:3]):               # the decoder
        flops += 2 * c * width * 4 * h * cur         # (1, 4), stride (1, 2)
        cur *= 2
        conv(width, width, 1)
        conv(width, width // 2, 1)
        conv(width // 2, width, 3)
        c = width
    conv(widths[0], seg["num_classes"], 1)           # the head
    return flops


def sac_bytes(seg: dict) -> int:
    """Bytes the SAC kernel (``csrc/sac.cu``) needs in one forward, each
    once: a block's call reads the attention's bfloat16 output (9C) and the
    block's bfloat16 input (C) and writes the bfloat16 ``U * A`` (9C), 38 B a
    pixel and channel. 3,665,821,696 B at 64x2048 (23 calls of
    159,383,552 B)."""
    h, cur = seg["data"]["height"], _padded_width(seg)
    total = 0
    for k, (b, c) in enumerate(zip(seg["stage_blocks"], seg["widths"])):
        total += b * (2 * TAPS + 1) * 2 * c * h * cur
        if k < 3:
            cur = -(-cur // 2)
    return total
