"""SalsaNext (Cortinhal, Tzelepis and Aksoy, arXiv:2003.03653;
github.com/TiagoCortinhal/SalsaNext,
``train/tasks/semantic/modules/SalsaNext.py``), the plain reference of the
segmenter group ``"arch": "salsanext"``, which reads the group's
``num_classes`` and ``base_width`` (32 published: 6,711,572 parameters).

It is the published module written out with ``nn.Conv2d`` (a bias each,
symmetric padding, dilation), ``nn.BatchNorm2d`` in evaluation mode,
``leaky_relu(0.01)`` after each convolution and before its batch norm,
``F.avg_pool2d(3, stride 2, padding 1)``, ``F.pixel_shuffle`` and
``torch.cat``, under the published names (``downCntx``, ``resBlock1``,
``upBlock1``, ``logits``; ``conv1``, ``bn1``, ...). Its convolutions compute
in the compute type (``float32`` for the reference, with TF32 off by the
caller; ``float8_e4m3fn`` emulated for the control); batch norm, the
activations, the sums, the pool and the pixel shuffle run in float32.
Departures from the published module:

* it returns the logits, ``[B, H, W, C]`` float32, and not their softmax;
* it takes ``[B, H, W, 5]`` (range, x, y, z, remission) as
  ``reference/slam/models/rangenet.make_input`` stacks them, with no
  mean/std normalisation of the input, as the darknet configuration has none;
* it makes no Monte-Carlo-dropout uncertainty pass (and has no dropout: it
  runs in evaluation mode only);
* the width is wrap-padded to a multiple of 16 and the logits are cropped
  back; a height that is not a multiple of 16 is refused.

The weights file, as the port writes it: ``{"model": {"arch":
"salsanext", "num_classes", "base"}, "variables": {key: array}}``, the
arrays under the port's state-dict keys, which are the published ones but
for batch norm's ``scale``, ``bias``, ``mean`` and ``var``
(:func:`state_dict`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IN_CHANNELS = 5   # range, x, y, z, remission
SLOPE = 0.01
DOWNSAMPLE = 16
# the port's batch norm names -> nn.BatchNorm2d's
_BN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in the convolutions' compute type. ``float8_e4m3fn`` (the
    benchmark's control) is emulated: the tensor is scaled to the format's
    range, rounded to it, and computed in bfloat16."""
    if dtype != torch.float8_e4m3fn:
        return t.to(dtype)
    scale = t.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((t.float() / scale).to(dtype).float() * scale).to(torch.bfloat16)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a bias, computed in ``dtype``."""

    def __init__(self, cin, cout, kernel, padding=0, dilation=1,
                 dtype=torch.float32):
        super().__init__(cin, cout, kernel, padding=padding,
                         dilation=dilation)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fp8 = self.dtype == torch.float8_e4m3fn
        return F.conv2d(_cast(x, self.dtype), _cast(self.weight, self.dtype),
                        self.bias.to(torch.bfloat16 if fp8 else self.dtype),
                        1, self.padding, self.dilation).float()


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


class ResContextBlock(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 1, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2, dtype=dtype)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x):
        shortcut = _act(self.conv1(x))
        res_a1 = self.bn1(_act(self.conv2(shortcut)))
        res_a2 = self.bn2(_act(self.conv3(res_a1)))
        return shortcut + res_a2


class ResBlock(nn.Module):
    def __init__(self, cin, cout, pooling, dtype):
        super().__init__()
        self.pooling = pooling
        self.conv1 = Conv2d(cin, cout, 1, dtype=dtype)
        self.conv2 = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2, dtype=dtype)
        self.bn2 = nn.BatchNorm2d(cout)
        self.conv4 = Conv2d(cout, cout, 2, padding=1, dilation=2, dtype=dtype)
        self.bn3 = nn.BatchNorm2d(cout)
        self.conv5 = Conv2d(3 * cout, cout, 1, dtype=dtype)
        self.bn4 = nn.BatchNorm2d(cout)

    def forward(self, x):
        shortcut = _act(self.conv1(x))
        res_a1 = self.bn1(_act(self.conv2(x)))
        res_a2 = self.bn2(_act(self.conv3(res_a1)))
        res_a3 = self.bn3(_act(self.conv4(res_a2)))
        concat = torch.cat((res_a1, res_a2, res_a3), dim=1)
        res_a = shortcut + self.bn4(_act(self.conv5(concat)))
        if self.pooling:
            return F.avg_pool2d(res_a, 3, stride=2, padding=1), res_a
        return res_a


class UpBlock(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin // 4 + 2 * cout, cout, 3, padding=1,
                            dtype=dtype)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=2, dilation=2, dtype=dtype)
        self.bn2 = nn.BatchNorm2d(cout)
        self.conv3 = Conv2d(cout, cout, 2, padding=1, dilation=2, dtype=dtype)
        self.bn3 = nn.BatchNorm2d(cout)
        self.conv4 = Conv2d(3 * cout, cout, 1, dtype=dtype)
        self.bn4 = nn.BatchNorm2d(cout)

    def forward(self, x, skip):
        up_b = torch.cat((F.pixel_shuffle(x, 2), skip), dim=1)
        up_e1 = self.bn1(_act(self.conv1(up_b)))
        up_e2 = self.bn2(_act(self.conv2(up_e1)))
        up_e3 = self.bn3(_act(self.conv3(up_e2)))
        concat = torch.cat((up_e1, up_e2, up_e3), dim=1)
        return self.bn4(_act(self.conv4(concat)))


class SalsaNext(nn.Module):
    """``[B, H, W, 5]`` -> ``[B, H, W, num_classes]`` float32 logits."""

    def __init__(self, num_classes: int, base: int, dtype=torch.float32):
        super().__init__()
        b = base
        self.downCntx = ResContextBlock(IN_CHANNELS, b, dtype)
        self.downCntx2 = ResContextBlock(b, b, dtype)
        self.downCntx3 = ResContextBlock(b, b, dtype)
        self.resBlock1 = ResBlock(b, 2 * b, True, dtype)
        self.resBlock2 = ResBlock(2 * b, 4 * b, True, dtype)
        self.resBlock3 = ResBlock(4 * b, 8 * b, True, dtype)
        self.resBlock4 = ResBlock(8 * b, 8 * b, True, dtype)
        self.resBlock5 = ResBlock(8 * b, 8 * b, False, dtype)
        self.upBlock1 = UpBlock(8 * b, 4 * b, dtype)
        self.upBlock2 = UpBlock(4 * b, 4 * b, dtype)
        self.upBlock3 = UpBlock(4 * b, 2 * b, dtype)
        self.upBlock4 = UpBlock(2 * b, b, dtype)
        # the head runs in float32, as the port's does
        self.logits = Conv2d(b, num_classes, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % DOWNSAMPLE:
            raise ValueError(f"SalsaNext needs a height that is a multiple "
                             f"of {DOWNSAMPLE}, got {h}")
        pad = (-w) % DOWNSAMPLE
        x = x.permute(0, 3, 1, 2).float()
        if pad:
            x = torch.cat([x, x[:, :, :, :pad]], dim=3)   # wrap-pad
        down_cntx = self.downCntx3(self.downCntx2(self.downCntx(x)))
        down0c, down0b = self.resBlock1(down_cntx)
        down1c, down1b = self.resBlock2(down0c)
        down2c, down2b = self.resBlock3(down1c)
        down3c, down3b = self.resBlock4(down2c)
        down5c = self.resBlock5(down3c)
        up4e = self.upBlock1(down5c, down3b)
        up3e = self.upBlock2(up4e, down2b)
        up2e = self.upBlock3(up3e, down1b)
        up1e = self.upBlock4(up2e, down0b)
        logits = self.logits(up1e)
        if pad:
            logits = logits[:, :, :, :w]
        return logits.permute(0, 2, 3, 1)


def build(seg: dict, dtype) -> SalsaNext:
    """The SalsaNext of the segmenter group ``seg``, its convolutions in
    ``dtype``, in evaluation mode."""
    return SalsaNext(seg["num_classes"], seg["base_width"], dtype).eval()


def state_dict(blob, seg: dict) -> dict:
    """The reference's state dict from the weights file; ``ValueError``
    where the blob is not a SalsaNext's (a darknet blob has no ``"arch"``,
    or ``"rangenet_darknet"``) or not of ``seg``'s sizes."""
    model = blob.get("model") if isinstance(blob, dict) else None
    if not isinstance(model, dict) or model.get("arch") != "salsanext" \
            or not isinstance(blob.get("variables"), dict):
        raise ValueError("the weights file is not a SalsaNext's: its model "
                         "names no arch \"salsanext\" or it has no variables")
    want = (seg["num_classes"], seg["base_width"])
    got = (model.get("num_classes"), model.get("base"))
    if got != want:
        raise ValueError(f"the weights file's network (classes, base width) "
                         f"{got} is not the configuration's {want}")
    state = {}
    for key, a in blob["variables"].items():
        *mods, leaf = key.split(".")
        if mods and mods[-1].startswith("bn"):
            leaf = _BN_KEYS.get(leaf, leaf)
        state[".".join(mods + [leaf])] = torch.from_numpy(
            np.array(a, dtype=np.float32))
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


def forward_flops(seg: dict, in_channels: int = IN_CHANNELS) -> int:
    """Multiply-adds times two of one forward on one ``seg["data"]``
    ``height x width`` image, the width wrap-padded to a multiple of 16:
    every convolution ``2 * cout * cin * kh * kw * out_h * out_w`` (each
    keeps its input's size); biases, batch norms, activations, sums, pools
    and the pixel shuffle are left out (under 0.2%). 124,595,994,624 at
    64x2048."""
    b, classes = seg["base_width"], seg["num_classes"]
    h = seg["data"]["height"]
    w = seg["data"]["width"]
    w += (-w) % DOWNSAMPLE
    flops = 0

    def conv(cin, cout, k, pixels):
        nonlocal flops
        flops += 2 * cout * cin * k * k * pixels

    px = h * w
    for cin in (in_channels, b, b):                 # context blocks
        conv(cin, b, 1, px)
        conv(b, b, 3, px)
        conv(b, b, 3, px)
    c = b
    widths = (2 * b, 4 * b, 8 * b, 8 * b, 8 * b)
    skips = []
    for i, cout in enumerate(widths):               # ResBlocks
        conv(c, cout, 1, px)
        conv(c, cout, 3, px)
        conv(cout, cout, 3, px)
        conv(cout, cout, 2, px)
        conv(3 * cout, cout, 1, px)
        c = cout
        if i < 4:
            skips.append((cout, px))
            h, w = h // 2, w // 2
            px = h * w
    for cout, (skip_c, skip_px) in zip((4 * b, 4 * b, 2 * b, b),
                                       reversed(skips)):   # UpBlocks
        conv(c // 4 + skip_c, cout, 3, skip_px)
        conv(cout, cout, 3, skip_px)
        conv(cout, cout, 2, skip_px)
        conv(3 * cout, cout, 1, skip_px)
        c = cout
    conv(b, classes, 1, skip_px)                    # the head
    return flops
