"""SalsaNext in the port (``models/salsanext.py``) against its plain
reference (``suma_bench/nets/salsanext.py``), and the paths it takes: the
float32 network equals the reference at three small sizes (one that needs
the width wrap-padded); the bfloat16 network stays within a bound that the
float8 control breaks; a blob saved with ``arch`` ``"salsanext"`` loads back
as SalsaNext through ``Segmenter.load`` and labels as before, while a blob
without ``arch`` still loads the darknet RangeNet; ``Conv``'s defaults
compute as before its ``dilation`` and ``padding``; the network's spans
nest inside ``segmenter/network``; its FLOP count equals PyTorch's; two
training steps move the loss; ``cli run --segmenter-weights`` labels scans
with it. Seeded random weights throughout, on the CPU.

CPU wall time: ~8 s on one worker."""

import torch_env  # noqa: F401  (first: one torch thread)

import json
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
from semantic_suma_tpu_torch.models.salsanext import SalsaNext, small_salsanext
from semantic_suma_tpu_torch.models.segmenter import (Segmenter,
                                                      build_network,
                                                      train_synthetic)
from suma_bench import harness

SEED = 2**31 + 21
REF = harness.net("salsanext")


def _seg(height, width, base=32):
    return {"arch": "salsanext", "num_classes": 20, "base_width": base,
            "data": {"height": height, "width": width}}


def _random_net(base=32, dtype=torch.float32, seed=SEED):
    """A SalsaNext with seeded random weights and batch-norm statistics (not
    the identity an initialised network has)."""
    net = SalsaNext(base=base, dtype=dtype).reset_parameters(seed % 1000)
    gen = torch.Generator().manual_seed(seed)
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
    return {"model": {"arch": "salsanext", "num_classes": net.num_classes,
                      "base": net.base},
            "variables": arrays_from_state(net.state_dict())}


def _reference(net, seg, dtype=torch.float32):
    ref = REF.build(seg, dtype)
    ref.load_state_dict(REF.state_dict(_blob(net), seg))
    return ref


def _input(h, w, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(1, h, w, 5, generator=gen) * 10.0


@pytest.mark.parametrize("h, w, base", [(16, 128, 32), (32, 256, 8),
                                        (16, 120, 32)])
def test_float32_network_equals_the_reference(h, w, base):
    """The same sums in the same order but for the port's batch norm
    (``addcmul`` of ``rsqrt(var + eps) * scale``) against
    ``nn.BatchNorm2d``'s and its float32 casts: 1e-5 of the logits' scale
    covers 42 batch norms' float32 rounding (~3e-7 measured). The
    published base width at 16 rows, and with the width wrap-padded; 32x256
    at base 8, where the CPU's time goes."""
    net = _random_net(base)
    x = _input(h, w)
    with torch.no_grad():
        got = net(x)
        want = _reference(net, _seg(h, w, base))(x)
    assert got.shape == (1, h, w, 20) and got.dtype == torch.float32
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_bfloat16_network_within_what_float8_breaks():
    """bfloat16 convolutions (the port as served) against the float32
    reference, and the float8 control against it: the bound, 1% of the
    logits' scale, is ~2.8x the bfloat16 gap measured (3.5e-3 of it) and
    ~3.4x under the float8 gap (3.4e-2 of it)."""
    h, w = 16, 128
    net = _random_net()
    served = SalsaNext(dtype=torch.bfloat16).eval()
    served.load_state_dict(net.state_dict())
    x = _input(h, w)
    with torch.no_grad():
        want = _reference(net, _seg(h, w))(x)
        bf16 = served(x)
        fp8 = _reference(net, _seg(h, w), torch.float8_e4m3fn)(x)
    bound = 0.01 * want.abs().max().item()
    assert (bf16 - want).abs().max().item() < bound
    assert (fp8 - want).abs().max().item() > bound


def test_save_then_load_builds_salsanext_by_arch(tmp_path):
    cfg = DataConfig(height=16, width=128)
    seg = Segmenter(cfg, model=small_salsanext(), rng_seed=3, device="cpu")
    path = tmp_path / "salsa.pkl"
    seg.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["model"] == {"arch": "salsanext", "num_classes": 20,
                             "base": 8}
    loaded = Segmenter.load(str(path), cfg, device="cpu")
    assert isinstance(loaded.model, SalsaNext)
    assert isinstance(loaded.net, SalsaNext)
    # the saved float16 weights against the float32 originals: the same
    # network to float16's rounding, so compare the loaded one with a
    # segmenter made from the blob's own weights
    again = Segmenter(cfg, model=small_salsanext(), device="cpu",
                      variables={k: np.asarray(v, np.float32)
                                 for k, v in blob["variables"].items()})
    gen = torch.Generator().manual_seed(SEED)
    pts = torch.randn(3000, 3, generator=gen) * 12.0
    lab, prob = loaded(pts)
    lab2, prob2 = again(pts)
    assert torch.equal(lab, lab2) and torch.equal(prob, prob2)
    seg8 = _seg(16, 128, base=8)
    assert REF.state_dict(blob, seg8).keys() \
        == REF.build(seg8, torch.float32).state_dict().keys()
    with pytest.raises(ValueError, match="not the configuration's"):
        REF.state_dict(blob, _seg(16, 128))


def test_a_blob_without_arch_loads_the_darknet():
    """``weights/segmenter_synth_mid.pkl`` has no ``arch``: the darknet
    RangeNet of its sizes, with the logits of the network built by hand."""
    path = str(harness.ROOT / "weights" / "segmenter_synth_mid.pkl")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert "arch" not in blob["model"]
    cfg = DataConfig(height=16, width=128)
    seg = Segmenter.load(path, cfg, device="cpu")
    assert isinstance(seg.model, rn.RangeNet)
    assert seg.model.widths == (32, 64, 128, 192, 256, 320)
    by_hand = Segmenter.load(path, cfg, model=rn.mid_rangenet(),
                             device="cpu")
    x = _input(16, 64)
    assert torch.equal(seg.logits(x), by_hand.logits(x))
    with pytest.raises(ValueError, match="unknown segmentation network"):
        build_network({"arch": "no_such_net", "num_classes": 20})
    with pytest.raises(ValueError, match="not a SalsaNext's"):
        REF.state_dict(blob, _seg(16, 128))


def _conv_before(conv, x):
    """``Conv.forward`` as it was before ``dilation`` and ``padding``."""
    (hl, hh), (wl, wh) = (rn._same_pads(x.shape[2 + a], conv.kernel[a],
                                        conv.stride[a]) for a in (0, 1))
    b = None if conv.bias is None else conv.bias.to(conv.dtype)
    x = x.to(conv.dtype)
    pad = (0, 0)
    if hl == hh and wl == wh:
        pad = (hl, wl)
    else:
        x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(x, conv.weight.to(conv.dtype), b, conv.stride, pad)


@pytest.mark.parametrize("kernel, stride, bias, dtype", [
    ((3, 3), (1, 1), False, torch.bfloat16),
    ((3, 3), (1, 2), False, torch.bfloat16),
    ((1, 1), (1, 1), True, torch.float32),
    ((3, 3), (1, 2), True, torch.float32),
])
def test_conv_defaults_compute_as_before(kernel, stride, bias, dtype):
    conv = rn.Conv(6, 8, kernel, stride, bias=bias, dtype=dtype)
    gen = torch.Generator().manual_seed(SEED)
    conv.reset_parameters(gen)
    if bias:
        with torch.no_grad():
            conv.bias.copy_(torch.randn(8, generator=gen))
    x = torch.randn(2, 6, 9, 17, generator=gen)
    with torch.no_grad():
        assert torch.equal(conv(x), _conv_before(conv, x))
    with pytest.raises(ValueError, match="explicit padding"):
        rn.Conv(6, 8, (3, 3), dilation=2)


def test_a_height_not_a_multiple_of_16_is_refused():
    net = small_salsanext().eval()
    with pytest.raises(ValueError, match="multiple of 16, got 24"):
        net(torch.zeros(1, 24, 128, 5))


def test_spans_nest_inside_the_network_span(tmp_path):
    seg = Segmenter(DataConfig(height=16, width=128), model=small_salsanext(),
                    device="cpu")
    assert seg.net.stopwatch is seg.stopwatch
    pts = torch.randn(2000, 3, generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        seg(pts * 12.0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("segmenter/"))
    names = [r[2] for r in ranges]
    inner = ["segmenter/network/context", "segmenter/network/encoder",
             "segmenter/network/decoder"]
    assert names == ["segmenter/project", "segmenter/network", *inner,
                     "segmenter/vote"]
    net = ranges[1]
    kids = ranges[2:5]
    assert all(net[0] <= s and t <= net[1] for s, t, _ in kids)
    assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
    # the laps, a profiler or not; the darknet network opens none
    assert all(seg.stopwatch.stats[n].count == 1 for n in inner)
    dark = Segmenter(DataConfig(height=16, width=128), device="cpu")
    dark(pts * 12.0)
    assert not any(k.startswith("segmenter/network/")
                   for k in dark.stopwatch.stats)
    # a network without a segmenter times nothing
    assert small_salsanext().stopwatch is None


@pytest.mark.parametrize("h, w, expect", [(64, 2048, 124_595_994_624),
                                          (16, 128, None)])
def test_forward_flops_match_the_flop_counter(h, w, expect):
    seg = _seg(h, w)
    with torch.device("meta"):
        net = REF.build(seg, torch.float32)
        port = SalsaNext(dtype=torch.float32)
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
    assert n == sum(p.numel() for p in net.parameters()) == 6_711_572


def test_two_training_steps_move_the_loss():
    logs = []
    seg, miou = train_synthetic(
        DataConfig(height=16, width=64), n_train=2, n_val=1, steps=2,
        batch=2, model=small_salsanext(), log=logs.append, device="cpu")
    losses = [float(s.split("loss=")[1].split()[0]) for s in logs
              if s.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    assert isinstance(seg.model, SalsaNext) and 0.0 <= miou <= 1.0


XML = """<config>
<param name="data_width" type="integer">128</param>
<param name="data_height" type="integer">32</param>
<param name="model_width" type="integer">128</param>
<param name="model_height" type="integer">32</param>
<param name="max iterations" type="integer">8</param>
</config>
"""


def test_cli_run_labels_scans_with_salsanext(tmp_path, monkeypatch, capsys):
    """``run --segmenter-weights`` with a SalsaNext blob: every scan through
    ``Segmenter.__call__`` on SalsaNext; ``train-segmenter`` takes ``--arch``
    and refuses ``--mid`` beside ``--arch salsanext``."""
    weights = tmp_path / "salsa.pkl"
    Segmenter(DataConfig(height=32, width=128), model=small_salsanext(),
              device="cpu").save(str(weights))
    nets = []
    call = Segmenter.__call__

    def counted(self, points, remissions=None):
        nets.append(type(self.net).__name__)
        return call(self, points, remissions)

    monkeypatch.setattr(Segmenter, "__call__", counted)
    cfg = tmp_path / "small.xml"
    cfg.write_text(XML)
    assert tcli.main(["--cpu", "run", "--config", str(cfg),
                      "--no-loop-closure", "--surfel-capacity", str(1 << 15),
                      "--active-capacity", str(1 << 13), "--synthetic", "2",
                      "--segmenter-weights", str(weights)]) == 0
    assert "processed 2 scans in " in capsys.readouterr().out
    assert nets == ["SalsaNext"] * 2
    args = tcli.parse_args(["train-segmenter", "--arch", "salsanext",
                            "--synthetic", "8", "--out", "w.pkl"])
    assert isinstance(tcli._train_model(args), SalsaNext)
    with pytest.raises(SystemExit):
        tcli.parse_args(["train-segmenter", "--arch", "salsanext", "--mid",
                         "--synthetic", "8", "--out", "w.pkl"])
