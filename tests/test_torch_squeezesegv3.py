"""SqueezeSegV3 in the port (``models/squeezesegv3.py``, ``ops/sac.py``)
against its plain reference (``suma_bench/nets/squeezesegv3.py``), and the
paths it takes: the float32 network equals the reference at two small shapes
(one that needs the width wrap-padded); the bfloat16 network stays within a
bound that the float8 control breaks; the plain SAC modulation is
``F.unfold(x) * sigmoid(BN(a))`` bit for bit, in F.unfold's channel order;
the inference walk gives the module forwards' logits bit for bit with one
modulation a SAC block; the epilogue at slope 0 is a ReLU; a blob saved with
``arch`` ``"squeezesegv3"`` loads back as SqueezeSegV3 through
``Segmenter.load``, and the reference refuses a darknet blob; its FLOP count
equals PyTorch's; two training steps move the loss and each batch norm's
running statistics once; ``cli run --segmenter-weights`` labels scans with
it. Seeded random weights throughout, on the CPU.

CPU wall time: ~15 s on one worker."""

import torch_env  # noqa: F401  (first: one torch thread)

import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from semantic_suma_tpu_torch import cli as tcli
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.convert import arrays_from_state
from semantic_suma_tpu_torch.models import rangenet as rn
from semantic_suma_tpu_torch.models import squeezesegv3 as sq
from semantic_suma_tpu_torch.models.segmenter import (Segmenter,
                                                      create_train_state,
                                                      loss_fn,
                                                      train_synthetic)
from semantic_suma_tpu_torch.models.squeezesegv3 import (SqueezeSegV3,
                                                         small_squeezesegv3)
from semantic_suma_tpu_torch.ops.epilogue import bn_act_plain
from semantic_suma_tpu_torch.ops.sac import sac_modulate, sac_modulate_plain
from suma_bench import harness

SEED = 2**31 + 25
REF = harness.net("squeezesegv3")
SMALL = ((1, 1, 1, 1, 1), (8, 16, 16, 24, 24))


def _seg(height, width, blocks=SMALL[0], widths=SMALL[1]):
    return {"arch": "squeezesegv3", "num_classes": 20,
            "stage_blocks": list(blocks), "widths": list(widths),
            "data": {"height": height, "width": width}}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _random_net(dtype=torch.float32, seed=SEED):
    """A small SqueezeSegV3 with seeded random weights and batch-norm
    statistics (not the identity an initialised network has)."""
    net = SqueezeSegV3(20, *SMALL, dtype=dtype).reset_parameters(seed % 1000)
    gen = _gen(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, rn.BatchNorm):
                c = m.scale.shape
                m.scale.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.mean.copy_(torch.randn(c, generator=gen) * 0.5)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)
    return net.eval()


def _blob(net):
    return {"model": {"arch": "squeezesegv3", "num_classes": net.num_classes,
                      "stage_blocks": net.stage_blocks,
                      "widths": net.widths},
            "variables": arrays_from_state(net.state_dict())}


def _reference(net, seg, dtype=torch.float32):
    ref = REF.build(seg, dtype)
    ref.load_state_dict(REF.state_dict(_blob(net), seg))
    return ref


def _input(h, w, seed=SEED):
    return torch.randn(1, h, w, 5, generator=_gen(seed)) * 10.0


@pytest.mark.parametrize("h, w", [(16, 128), (16, 99)])
def test_float32_network_equals_the_reference(h, w):
    """The same sums but for the port's batch norm (``addcmul`` of
    ``rsqrt(var + eps) * scale``) against ``nn.BatchNorm2d``'s, and the
    order of the residual sums: 1e-5 of the logits' scale covers 29 batch
    norms' float32 rounding (1.7e-7 measured at 16x128). 99 columns are
    wrap-padded to 104."""
    net = _random_net()
    x = _input(h, w)
    with torch.no_grad():
        got = net(x)
        want = _reference(net, _seg(h, w))(x)
    assert got.shape == (1, h, w, 20) and got.dtype == torch.float32
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_bfloat16_network_within_what_float8_breaks():
    """bfloat16 convolutions and the bfloat16 ``U * A`` (the port as served,
    through the walk) against the float32 reference, and the float8 control
    against it: the bound, 2% of the logits' scale, is ~4x the bfloat16 gap
    measured (4.9e-3 of it) and ~3.5x under the float8 gap (7.0e-2 of
    it)."""
    h, w = 16, 128
    net = _random_net()
    served = SqueezeSegV3(20, *SMALL).eval()
    served.load_state_dict(net.state_dict())
    x = _input(h, w)
    with torch.no_grad():
        want = _reference(net, _seg(h, w))(x)
        bf16 = served(x)
        fp8 = _reference(net, _seg(h, w), torch.float8_e4m3fn)(x)
    bound = 0.02 * want.abs().max().item()
    assert (bf16 - want).abs().max().item() < bound
    assert (fp8 - want).abs().max().item() > bound


def _modulation_inputs(n=2, c=8, h=5, w=7, seed=SEED):
    gen = _gen(seed)
    a = (torch.randn(n, 9 * c, h, w, generator=gen) * 3).to(torch.bfloat16)
    x = torch.randn(n, c, h, w, generator=gen).to(torch.bfloat16)
    mean = torch.randn(9 * c, generator=gen)
    mul = torch.rand(9 * c, generator=gen) + 0.5
    bias = torch.randn(9 * c, generator=gen) * 0.2
    return a, x, mean, mul, bias


def test_plain_modulation_is_unfold_times_sigmoid_of_batch_norm():
    """``sac_modulate`` on the CPU is ``F.unfold(x) * sigmoid(BN(a))``
    rounded once to bfloat16, with BN the port's ``BatchNorm`` in
    evaluation mode, bit for bit; channel ``c * 9 + t`` holds ``x``'s
    channel ``c`` at row ``t // 3 - 1`` and column ``t % 3 - 1``, zero
    outside the image."""
    a, x, mean, mul, bias = _modulation_inputs()
    n, c, h, w = x.shape
    bn = rn.BatchNorm(9 * c).eval()
    with torch.no_grad():
        bn.mean.copy_(mean)
        bn.scale.copy_(mul)
        bn.var.fill_(1.0 - rn.BN_EPS)
        bn.bias.copy_(bias)
        k = torch.rsqrt(bn.var + rn.BN_EPS) * bn.scale
        want = (F.unfold(x.float(), 3, padding=1).view(n, 9 * c, h, w)
                * torch.sigmoid(bn(a))).to(torch.bfloat16)
        got = sac_modulate(a, x, mean, k, bias)
    assert got.dtype == torch.bfloat16 and got.shape == (n, 9 * c, h, w)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got, sac_modulate_plain(a, x, mean, k, bias))
    # the channel order, with every attention weight 1 (sigmoid of +inf)
    ones = sac_modulate_plain(a, x, mean, torch.zeros_like(k),
                              torch.full_like(bias, float("inf")))
    xp = F.pad(x.float(), (1, 1, 1, 1))
    for t in range(9):
        dr, dc = divmod(t, 3)
        shifted = xp[:, :, dr:dr + h, dc:dc + w].to(torch.bfloat16)
        assert torch.equal(ones[:, t::9], shifted)


def test_epilogue_slope_zero_is_relu():
    """The plain epilogue at slope 0 against ``F.relu`` of the same batch
    norm (equal values; a negative input gives -0.0, ``v * 0``, where
    ``F.relu`` gives 0.0), with and without the residual; the default slope
    is darknet's 0.1."""
    gen = _gen(SEED)
    y = torch.randn(2, 8, 5, 7, generator=gen).to(torch.bfloat16)
    r = torch.randn(2, 8, 5, 7, generator=gen)
    mean, mul = torch.randn(8, generator=gen), torch.rand(8, generator=gen)
    bias = torch.randn(8, generator=gen)
    v = torch.addcmul(bias[:, None, None], y.float() - mean[:, None, None],
                      mul[:, None, None])
    for res in (None, r):
        f, b = bn_act_plain(y, mean, mul, bias, res, slope=0.0)
        want = F.relu(v) if res is None else res + F.relu(v)
        assert torch.equal(f, want)
        assert torch.equal(b, want.to(torch.bfloat16))
    assert torch.equal(bn_act_plain(y, mean, mul, bias)[0],
                       F.leaky_relu(v, 0.1))


@pytest.fixture
def counted(monkeypatch):
    """The walk's calls of ``sac_modulate`` and of the epilogue."""
    box = {"sac": 0, "bn_act": 0}
    real_sac, real_bn = sq.sac_modulate, sq.bn_act
    real_rn = rn.bn_act

    def sac(*a, **kw):
        box["sac"] += 1
        return real_sac(*a, **kw)

    def bn(real):
        def call(*a, **kw):
            box["bn_act"] += 1
            return real(*a, **kw)
        return call

    monkeypatch.setattr(sq, "sac_modulate", sac)
    monkeypatch.setattr(sq, "bn_act", bn(real_bn))
    monkeypatch.setattr(rn, "bn_act", bn(real_rn))
    return box


@pytest.mark.parametrize("w", [128, 99])
def test_walk_equals_the_module_forwards(counted, w):
    """The bfloat16 network in ``eval()`` mode takes the walk: the logits of
    the module forwards bit for bit, with one ``sac_modulate`` a SAC block
    and one epilogue call a batch norm elsewhere (3 a SAC block's two, the
    stem's, the downsamplings', the stride-1 stages' and the decoder's: 32
    for the small network); ``Segmenter``'s inference copy holds the walk's
    constants and gives the same logits."""
    net = SqueezeSegV3(20, *SMALL).eval()
    net.load_state_dict(_random_net().state_dict())
    x = _input(16, w)
    with torch.no_grad():
        walk = net(x)
        n_sac, n_bn = counted["sac"], counted["bn_act"]
        xp = x.permute(0, 3, 1, 2)
        pad = (-w) % sq.DOWNSAMPLE
        if pad:
            xp = torch.cat([xp, xp[:, :, :, :pad]], dim=3)
        mods = net.head(net._modules_forward(xp).float())[:, :, :, :w]
        mods = mods.permute(0, 2, 3, 1)
    assert torch.equal(walk, mods)
    blocks = sum(SMALL[0])
    assert n_sac == blocks
    assert n_bn == 2 * blocks + 1 + 3 + 2 * 3 + 3 * 4
    seg = Segmenter(DataConfig(height=16, width=w), model=net,
                    variables=arrays_from_state(net.state_dict()),
                    device="cpu")
    assert seg.net.walk_constants is not None
    with torch.no_grad():
        assert torch.equal(seg.logits(x), walk)


def test_save_then_load_builds_squeezesegv3_by_arch(tmp_path):
    cfg = DataConfig(height=16, width=128)
    seg = Segmenter(cfg, model=small_squeezesegv3(), rng_seed=3,
                    device="cpu")
    path = tmp_path / "ssg.pkl"
    seg.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["model"] == {"arch": "squeezesegv3", "num_classes": 20,
                             "stage_blocks": SMALL[0], "widths": SMALL[1]}
    loaded = Segmenter.load(str(path), cfg, device="cpu")
    assert isinstance(loaded.model, SqueezeSegV3)
    assert isinstance(loaded.net, SqueezeSegV3)
    again = Segmenter(cfg, model=small_squeezesegv3(), device="cpu",
                      variables={k: np.asarray(v, np.float32)
                                 for k, v in blob["variables"].items()})
    pts = torch.randn(3000, 3, generator=_gen(SEED)) * 12.0
    lab, prob = loaded(pts)
    lab2, prob2 = again(pts)
    assert torch.equal(lab, lab2) and torch.equal(prob, prob2)
    small = _seg(16, 128)
    assert REF.state_dict(blob, small).keys() \
        == REF.build(small, torch.float32).state_dict().keys()
    with pytest.raises(ValueError, match="not the configuration's"):
        REF.state_dict(blob, _seg(16, 128, (1, 2, 8, 8, 4),
                                  (32, 64, 128, 256, 256)))
    darknet = harness.ROOT / "weights" / "segmenter_synth_mid.pkl"
    with open(darknet, "rb") as f:
        with pytest.raises(ValueError, match="not a SqueezeSegV3's"):
            REF.state_dict(pickle.load(f), small)


@pytest.mark.parametrize("h, w, blocks, widths, expect", [
    (64, 2048, (1, 2, 8, 8, 4), (32, 64, 128, 256, 256), 994_268_151_808),
    (16, 99, *SMALL, None)])
def test_forward_flops_match_the_flop_counter(h, w, blocks, widths, expect):
    seg = _seg(h, w, blocks, widths)
    with torch.device("meta"):
        net = REF.build(seg, torch.float32)
        port = SqueezeSegV3(20, blocks, widths, dtype=torch.float32)
        x = torch.zeros(1, h, w, 5)
    counts = []
    for m in (net, port):
        with FlopCounterMode(display=False) as counter:
            m(x)
        counts.append(counter.get_total_flops())
    assert REF.forward_flops(seg) == counts[0] == counts[1]
    if expect is not None:
        assert counts[0] == expect
        n = sum(p.numel() for p in port.parameters())
        assert n == sum(p.numel() for p in net.parameters()) == 24_982_420
        # 23 calls of 38 B a pixel and channel, C x W = 65,536 at 64 rows
        assert REF.sac_bytes(seg) == 23 * 38 * 65_536 * 64


def test_two_training_steps_move_the_loss():
    logs = []
    seg, miou = train_synthetic(
        DataConfig(height=16, width=64), n_train=2, n_val=1, steps=2,
        batch=2, model=small_squeezesegv3(), log=logs.append, device="cpu")
    losses = [float(s.split("loss=")[1].split()[0]) for s in logs
              if s.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    assert isinstance(seg.model, SqueezeSegV3) and 0.0 <= miou <= 1.0


def test_checkpointed_blocks_move_running_statistics_once():
    """A training step recomputes each SAC block in its backward pass
    (activation checkpointing); the recomputation leaves the running
    statistics as the forward left them, and the gradients equal those of
    the same step without checkpointing."""
    _, state = create_train_state(small_squeezesegv3(dtype=torch.float32),
                                  seed=1, device="cpu")
    net = state.model
    gen = _gen(SEED)
    x = torch.randn(2, 16, 64, 5, generator=gen) * 5.0
    labels = torch.randint(0, 20, (2, 16, 64), generator=gen)
    valid = torch.ones(2, 16, 64, dtype=torch.bool)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    runs = []
    for ckpt in (True, False):
        net.load_state_dict(start)
        net.zero_grad(set_to_none=True)
        if not ckpt:
            net._sac = lambda blk, xf, p: blk(xf, p)
        loss, _ = loss_fn(net, x, labels, valid)
        loss.backward()
        runs.append(({k: v.clone() for k, v in net.state_dict().items()},
                     [p.grad.clone() for p in net.parameters()]))
    del net._sac
    (s1, g1), (s2, g2) = runs
    moved = [k for k in s1 if k.endswith(".mean") and
             not torch.equal(s1[k], start[k])]
    assert moved and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
               for a, b in zip(g1, g2))


XML = """<config>
<param name="data_width" type="integer">128</param>
<param name="data_height" type="integer">32</param>
<param name="model_width" type="integer">128</param>
<param name="model_height" type="integer">32</param>
<param name="max iterations" type="integer">8</param>
</config>
"""


def test_cli_run_labels_scans_with_squeezesegv3(tmp_path, monkeypatch,
                                                 capsys):
    """``run --segmenter-weights`` with a SqueezeSegV3 blob: every scan
    through ``Segmenter.__call__`` on SqueezeSegV3; ``train-segmenter``
    takes ``--arch squeezesegv3`` (``--small``: the test-sized network)."""
    weights = tmp_path / "ssg.pkl"
    Segmenter(DataConfig(height=32, width=128), model=small_squeezesegv3(),
              device="cpu").save(str(weights))
    nets = []
    call = Segmenter.__call__

    def counted_calls(self, points, remissions=None):
        nets.append(type(self.net).__name__)
        return call(self, points, remissions)

    monkeypatch.setattr(Segmenter, "__call__", counted_calls)
    cfg = tmp_path / "small.xml"
    cfg.write_text(XML)
    assert tcli.main(["--cpu", "run", "--config", str(cfg),
                      "--no-loop-closure", "--surfel-capacity", str(1 << 15),
                      "--active-capacity", str(1 << 13), "--synthetic", "2",
                      "--segmenter-weights", str(weights)]) == 0
    assert "processed 2 scans in " in capsys.readouterr().out
    assert nets == ["SqueezeSegV3"] * 2
    for small, blocks in ((True, SMALL[0]), (False, (1, 2, 8, 8, 4))):
        args = tcli.parse_args(["train-segmenter", "--arch", "squeezesegv3",
                                "--synthetic", "8", "--out", "w.pkl"]
                               + ["--small"] * small)
        model = tcli._train_model(args)
        assert isinstance(model, SqueezeSegV3)
        assert model.stage_blocks == tuple(blocks)
