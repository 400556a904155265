"""The segmentation networks the benchmark can name (``nets/<arch>.py``) keep
the contract of ``nets/__init__.py``: each module defines ``build``,
``state_dict`` and ``forward_flops`` and imports nothing of the port or of
JAX; each one's FLOP count equals PyTorch's ``FlopCounterMode`` count of its
own network; the darknet reference gives the port's logits bit for bit; a
network under a new name runs a cell with no edit to the runner, the check
or the control; a ``segmenter`` group without ``arch`` and an ``arch``
without a module are refused by name; and the two network metrics read the
run's span table.

CPU wall time: ~21 s on one worker."""

import json
import pickle
import re
import shutil

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.models.rangenet import RangeNet
from semantic_suma_tpu_torch.models.segmenter import Segmenter
from suma_bench import harness, run, yardstick
from suma_bench.tests.small import MID_NETWORK, small

ARCHS = sorted(p.stem for p in harness.NETS.glob("*.py")
               if p.stem != "__init__")
# the segmenter group of each configuration
NETWORKS = [harness.load_json(p)["segmenter"]
            for p in sorted((harness.HERE / "configs").glob("*.json"))]
CELL = "sumapp-rangenet53-offline"
SEED = 2**31 + 11
DARKNET53 = {"stage_blocks": (1, 2, 8, 8, 4),
             "widths": (32, 64, 128, 256, 512, 1024)}
MID = {"stage_blocks": (1, 1, 2, 2, 1),
       "widths": (32, 64, 128, 192, 256, 320)}


def _seg(height, width, **net):
    return {"arch": "rangenet_darknet", "num_classes": 20,
            "data": {"height": height, "width": width}, **net}


def _counted(mod, seg) -> int:
    """``FlopCounterMode``'s count of one forward of ``mod``'s network on
    one image of ``seg``'s size, on the meta device."""
    with torch.device("meta"):
        net = mod.build(seg, torch.float32)
        x = torch.zeros(1, seg["data"]["height"], seg["data"]["width"], 5)
    with FlopCounterMode(display=False) as counter:
        net(x)
    return counter.get_total_flops()


def test_there_is_a_network_module():
    assert "rangenet_darknet" in ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_each_network_module_keeps_the_contract(arch):
    mod = harness.net(arch)
    for name in ("build", "state_dict", "forward_flops"):
        assert callable(getattr(mod, name)), name
    assert not re.search(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|semantic_suma_tpu\w*)\b",
        (harness.NETS / f"{arch}.py").read_text(), re.M)


@pytest.mark.parametrize("seg, expect", [
    (_seg(64, 900, **DARKNET53), 272_587_423_744),
    (_seg(64, 2048, **DARKNET53), 601_572_245_504),
    (_seg(64, 900, **MID), None),
    (_seg(16, 100, stage_blocks=(1, 1, 2, 2, 1),
          widths=(16, 32, 64, 96, 128, 160)), None),
])
def test_network_flops_match_the_flop_counter(seg, expect):
    mod = harness.net(seg["arch"])
    ours = mod.forward_flops(seg)
    assert ours == _counted(mod, seg)
    if expect is not None:
        # 272.6 GFLOP a 1x64x928x5 forward, 601.6 at RangeNet++'s 64x2048
        assert ours == expect


@pytest.mark.parametrize("seg", [s for s in NETWORKS if s is not None],
                         ids=lambda s: s["arch"])
def test_each_configured_network_counts_its_flops(seg):
    """Every configuration's network, at its own size and cut to 16x128:
    its module's count against PyTorch's."""
    mod = harness.net(seg["arch"])
    small_seg = dict(seg, data=dict(seg["data"], height=16, width=128))
    for s in (seg, small_seg):
        assert mod.forward_flops(s) == _counted(mod, s)


def _mid_blob():
    with open(harness.ROOT / MID_NETWORK["weights"], "rb") as f:
        return pickle.load(f)


def test_darknet_reference_gives_the_ports_logits():
    """The reference is a frozen copy of the port's ``RangeNet``: from the
    mid weights at 32x400, both in float32 on the CPU, the same bits."""
    seg = dict(MID_NETWORK, num_classes=20)
    mod = harness.net("rangenet_darknet")
    ref = mod.build(seg, torch.float32)
    ref.load_state_dict(mod.state_dict(_mid_blob(), seg))
    ref.eval()
    port = Segmenter.load(
        str(harness.ROOT / seg["weights"]), DataConfig(height=32, width=400),
        model=RangeNet(20, MID["stage_blocks"], MID["widths"],
                       dtype=torch.float32), device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(1, 32, 400, 5, generator=gen) * 10.0
    with torch.no_grad():
        want = port.logits(x)
        got = ref(x)
    assert got.shape == (1, 32, 400, 20) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_state_dict_refuses_another_network():
    mod = harness.net("rangenet_darknet")
    blob = _mid_blob()
    with pytest.raises(ValueError, match="not the configuration's"):
        mod.state_dict(blob, _seg(32, 400, **DARKNET53))
    with pytest.raises(ValueError, match="not a darknet RangeNet's"):
        mod.state_dict({"variables": blob["variables"]},
                       _seg(32, 400, **MID))
    conv = blob["variables"]["params"]["Conv_0"]
    conv["kernel"] = conv["kernel"][..., :19]
    conv["bias"] = conv["bias"][:19]
    with pytest.raises(ValueError, match="Conv_0.bias"):
        mod.state_dict(blob, _seg(32, 400, **MID))


def test_a_network_under_a_new_name_needs_no_edit(tmp_path, monkeypatch):
    """A copy of the darknet module under another name, in a ``nets/`` of
    its own that holds nothing else, runs the network cell (traced, so the
    FLOPs come from it too) with no edit to the runner, the check or the
    control, and reads the check's numbers of the original name bit for
    bit. At this size the cell's pose gap is not held against its limit
    (``test_suma_bench_run.py`` says why), so ``correct`` is held to the
    original's as well."""
    records = []
    plain = harness.read_metrics

    def keep(names, record, *a, **kw):
        records.append(record)
        return plain(names, record, *a, **kw)

    monkeypatch.setattr(harness, "read_metrics", keep)
    over = small(8, network=True)
    base = run.run_cell(CELL, SEED, 0.5, True, device="cpu", overrides=over)
    nets = tmp_path / "nets"
    nets.mkdir()
    shutil.copy(harness.NETS / "rangenet_darknet.py",
                nets / "darknet_copy.py")
    monkeypatch.setattr(harness, "NETS", nets)
    with pytest.raises(FileNotFoundError, match="rangenet_darknet.py"):
        harness.net("rangenet_darknet")
    over["config"]["segmenter"] = dict(over["config"]["segmenter"],
                                       arch="darknet_copy")
    got = run.run_cell(CELL, SEED, 0.5, True, device="cpu", overrides=over)
    assert got["checks"] == base["checks"]
    assert set(got["checks"]) == {"pose_gap_m", "logit_gap", "vote_mismatch"}
    assert got["correct"] == base["correct"]
    assert got["checks"]["vote_mismatch"]["value"] == 0
    assert "step_mfu" in got["metrics"]
    # the CPU traces no device: the span table's readers find nothing
    assert not {"network_launches", "network_mfu"} & set(got["metrics"])
    seg = dict(MID_NETWORK, num_classes=20)
    for rec in records:
        assert rec["flops_per_scan"] == \
            harness.net("darknet_copy").forward_flops(seg)
        assert rec["spans"]["segmenter_calls"] == 2
        assert "segmenter/network" in rec["spans"]["spans"]


def test_a_segmenter_group_without_arch_is_refused(tmp_path):
    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(harness.HERE / sub, root / "suma_bench" / sub)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    path = root / "suma_bench" / "configs" / "sumapp-rangenet53.json"
    cfg = json.loads(path.read_text())
    del cfg["segmenter"]["arch"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match='names no "arch"'):
        harness.cell(CELL, root=root)
    assert harness.cell("suma-norevisit-offline", root=root)["config"][
        "segmenter"] is None
    with pytest.raises(FileNotFoundError, match="nets/no_such_net.py"):
        harness.net("no_such_net")


def test_network_readers_read_the_span_table():
    row = {"count": 10, "host_ms": 29.9, "self_ms": 29.9, "launches": 726.0,
           "busy_ms": 5.27, "idle_ms": 24.6}
    table = {"scans": 10, "segmenter_calls": 10, "device_ops": 12575,
             "spans": {"segmenter/network": row}}
    rec = {"flops_per_scan": 601_572_245_504, "spans": table}
    names = ["network_launches", "network_mfu"]
    got = harness.read_metrics(names, rec)
    assert got["network_launches"] == 726.0
    assert got["network_mfu"] == pytest.approx(
        100.0 * 601_572_245_504 / 5.27e-3 / yardstick.H100_BF16_FLOPS)
    assert 11.5 < got["network_mfu"] < 11.6
    assert harness.read_metrics(names, {"flops_per_scan": 1.0}) == {}
    assert harness.read_metrics(
        names, dict(rec, spans=dict(table, device_ops=0))) == {}
    assert harness.read_metrics(
        names, dict(rec, spans=dict(table, spans={}))) == {}
