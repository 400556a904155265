"""The darknet network's batch-norm epilogue (``ops/epilogue.py``) and
``RangeNet``'s inference walk (``models/rangenet.py``), on the CPU.

* The plain epilogue equals the modules' composition bit for bit:
  ``F.leaky_relu(bn(y), 0.1)``, ``r + that``, ``.to(bfloat16)``, with and
  without ``r``, for each choice of outputs.
* ``small_rangenet`` in ``eval()`` mode gives through the walk the logits
  of its encoder's and decoder's module forwards, bit for bit, at a width
  that needs no wrap pad and at one that does, with one epilogue call a
  batch norm; so does ``Segmenter``'s inference copy, which holds the
  walk's constants.
* Training mode, a network with a ``model_group`` and a float32 network
  call no epilogue.
* SalsaNext calls no epilogue, and its logits from the same seeded weights
  are the same before and after a darknet walk ran in the process.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import pytest
import torch
import torch.nn.functional as F

from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.models import rangenet
from semantic_suma_tpu_torch.models.rangenet import (BN_EPS, BatchNorm, Conv,
                                                     ConvTranspose,
                                                     small_rangenet)
from semantic_suma_tpu_torch.models.salsanext import small_salsanext
from semantic_suma_tpu_torch.models.segmenter import Segmenter
from semantic_suma_tpu_torch.ops.epilogue import bn_act, bn_act_plain
from semantic_suma_tpu_torch.parallel.distributed import Group

H = 16


@pytest.fixture
def calls(monkeypatch):
    """The epilogue calls of the walk (``rangenet.bn_act``) so far:
    ``calls["n"]``."""
    box, real = {"n": 0}, rangenet.bn_act

    def counted(*a, **kw):
        box["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(rangenet, "bn_act", counted)
    return box


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randomize_batch_norms(net, seed: int = 1) -> None:
    """Statistics, scales and biases away from flax's initial ones, so that
    every part of the epilogue's arithmetic moves the result."""
    g = _gen(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                c = m.mean.shape[0]
                m.mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.var.copy_(torch.rand(c, generator=g) + 0.3)
                m.scale.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)


def _darknet(seed: int = 3):
    net = small_rangenet().reset_parameters(seed)
    _randomize_batch_norms(net)
    return net.eval()


def _image(w: int, seed: int = 5) -> torch.Tensor:
    return torch.randn(1, H, w, 5, generator=_gen(seed)) * 4.0


def _module_logits(net, x: torch.Tensor) -> torch.Tensor:
    """The logits by the encoder's and decoder's module forwards, with
    ``RangeNet.forward``'s wrap pad and crop."""
    w = x.shape[2]
    pad = (-w) % (2 ** len(net.stage_blocks))
    xp = x.permute(0, 3, 1, 2)
    if pad:
        xp = torch.cat([xp, xp[:, :, :, :pad]], dim=3)
    feats, skips = net.Encoder_0(xp)
    logits = net.Conv_0(net.Decoder_0(feats, skips).float())
    return logits[:, :, :, :w].permute(0, 2, 3, 1)


@pytest.mark.parametrize("outputs", ["f32", "bf16", "both"])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_epilogue_equals_the_modules(residual, outputs):
    c = 24
    g = _gen(11)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.mean.copy_(torch.randn(c, generator=g))
        bn.var.copy_(torch.rand(c, generator=g) + 0.1)
        bn.scale.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    bn.eval()
    y = (torch.randn(2, c, 5, 7, generator=g) * 3.0).to(torch.bfloat16)
    r = torch.randn(2, c, 5, 7, generator=g) if residual else None
    with torch.no_grad():
        want = F.leaky_relu(bn(y), 0.1)
        if residual:
            want = r + want
        mul = torch.rsqrt(bn.var + BN_EPS) * bn.scale
        f32, bf16 = outputs in ("f32", "both"), outputs in ("bf16", "both")
        for fn in (bn_act_plain, bn_act):
            got_f, got_b = fn(y, bn.mean, mul, bn.bias, r, f32=f32, bf16=bf16)
            assert (got_f is None) == (not f32)
            assert (got_b is None) == (not bf16)
            if f32:
                assert got_f.dtype == torch.float32
                assert torch.equal(got_f, want)
            if bf16:
                assert got_b.dtype == torch.bfloat16
                assert torch.equal(got_b, want.to(torch.bfloat16))
    # the negative side of leaky_relu is taken
    assert bool((want < 0).any()) and bool((want > 0).any())


def test_epilogue_refuses_other_devices():
    y = torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16, device="meta")
    c = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bn_act(y, c, c, c)


@pytest.mark.parametrize("w", [96, 90])
def test_walk_equals_the_module_forwards(w, calls):
    net = _darknet()
    x = _image(w)
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
    with torch.no_grad():
        got = net(x)
        assert calls["n"] == n_bn == 40
        want = _module_logits(net, x)
    assert got.shape == (1, H, w, net.num_classes)
    assert torch.equal(got, want)


def test_inference_copy_computes_its_constants_once():
    seg = Segmenter(DataConfig(height=H, width=96), model=_darknet(),
                    device="cpu")
    consts = seg.net.walk_constants
    assert seg.model.walk_constants is None   # the master computes anew
    assert set(consts) == {m for m in seg.net.modules()
                           if isinstance(m, BatchNorm)}
    for bn, (mean, mul, bias) in consts.items():
        assert torch.equal(mean, bn.mean) and torch.equal(bias, bn.bias)
        assert torch.equal(mul, torch.rsqrt(bn.var + BN_EPS) * bn.scale)
    x = _image(96, seed=7)
    with torch.no_grad():
        assert torch.equal(seg.logits(x), _module_logits(seg.net, x))


def test_training_model_group_and_float32_call_no_epilogue(calls):
    net = _darknet()
    x = _image(96)
    net.train()
    net(x).sum().backward()
    assert calls["n"] == 0
    net.eval()
    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.model_group = Group()
    with torch.no_grad():
        net(x)
        assert calls["n"] == 0
        small_rangenet(dtype=torch.float32)(x)
        assert calls["n"] == 0


def test_salsanext_is_unchanged_by_a_darknet_walk(calls):
    x = torch.randn(1, H, 64, 5, generator=_gen(9)) * 4.0

    def salsa_logits():
        net = small_salsanext().reset_parameters(4).eval()
        _randomize_batch_norms(net, seed=2)
        with torch.no_grad():
            return net(x)

    before = salsa_logits()
    assert calls["n"] == 0
    with torch.no_grad():
        _darknet()(_image(96))
    assert calls["n"] == 40
    assert torch.equal(salsa_logits(), before)
    assert calls["n"] == 40
