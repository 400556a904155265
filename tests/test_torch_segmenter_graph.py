"""``Segmenter.__call__``'s network as a CUDA graph (``models/segmenter.py``),
on the CPU.

* On the CPU a call runs the network eagerly (``graphs.decide``'s
  ``"cpu"``) and gives exactly the labels and probabilities of the
  projection, the class's own forward and the vote run by hand.
* A forward hook on ``Segmenter.net`` sees the ``[1, H, W, C]`` logits on
  every call.
* ``Segmenter.logits`` gives a tensor of its own on every call.
* The engagement counts add up to the calls, and each call is a lap.
* The card's rule on an emulated graph (``torch_card``: ``decide`` told
  the device is a card; the capture runs the body, a later replay runs it
  again into the captured logits): eager, capture, replays; a new shape eager once, then
  captured; a shape run before eager once (``"shape"``), then captured;
  a hook sees the logits on every path, a replay hands on the graph's
  buffer, and every call's labels equal the eager ones.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import pytest
import torch
from torch_card import emulate_card

from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.models.rangenet import make_input, small_rangenet
from semantic_suma_tpu_torch.models.salsanext import small_salsanext
from semantic_suma_tpu_torch.models.segmenter import Segmenter
from semantic_suma_tpu_torch.ops.knn import labels_for_points
from semantic_suma_tpu_torch.ops.projection import project_scan

CFG = DataConfig(height=16, width=128)
NETS = {"darknet": small_rangenet, "salsanext": small_salsanext}


def _points(seed: int, n: int = 2000) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, generator=g) * 12.0


def _by_hand(seg: Segmenter, pts: torch.Tensor):
    """What a call computed before the graph path: projection, input, the
    network's class forward, the vote."""
    res = project_scan(pts, remissions=torch.zeros(pts.shape[:1]), cfg=seg.cfg)
    x = make_input(res.vertex_map, res.depth_map, res.remission,
                   res.vertex_valid)[None]
    with torch.no_grad():
        logits = type(seg.net).forward(seg.net, x)[0]
    depth = torch.linalg.vector_norm(pts, dim=-1)
    return labels_for_points(
        logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0), depth,
        res.point_px >= 0, res.depth_map, use_knn=seg.use_knn)


@pytest.fixture(params=sorted(NETS))
def seg(request):
    return Segmenter(CFG, model=NETS[request.param](), device="cpu")


def test_cpu_call_is_eager_and_unchanged(seg):
    for seed in (1, 2):
        pts = _points(seed)
        labels, probs = seg(pts)
        want_labels, want_probs = _by_hand(seg, pts)
        assert torch.equal(labels, want_labels)
        assert torch.equal(probs, want_probs)
    assert seg.replayer.counts["segmenter"] == {"eager": 2}
    assert seg.replayer.invalidations == {"cpu": 2}
    assert seg.stopwatch.stats["graph/segmenter/eager/cpu"].count == 2


def test_forward_hook_sees_the_logits_on_every_call(seg):
    seen = []
    hook = seg.net.register_forward_hook(
        lambda module, inputs, out: seen.append(out[0].detach().clone()))
    for seed in (1, 2, 3):
        seg(_points(seed))
    hook.remove()
    assert len(seen) == 3
    assert all(t.shape == (CFG.height, CFG.width, seg.net.num_classes)
               for t in seen)
    assert not torch.equal(seen[0], seen[1])


def test_logits_results_are_distinct_tensors(seg):
    x = torch.randn(1, CFG.height, CFG.width, 5,
                    generator=torch.Generator().manual_seed(4))
    a = seg.logits(x)
    b = seg.logits(2.0 * x)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, seg.logits(x))
    assert not torch.equal(a, b)
    # the network's own calls go around the graph's books
    assert sum(seg.replayer.counts["segmenter"].values()) == 0


def test_engagement_counts_add_up_to_the_calls(seg):
    n = 3
    for seed in range(n):
        seg(_points(seed))
    seg.logits(torch.zeros(1, CFG.height, CFG.width, 5))
    counts = seg.replayer.counts["segmenter"]
    assert counts["capture"] + counts["replay"] + counts["eager"] == n
    assert sum(seg.replayer.invalidations.values()) == counts["eager"]
    laps = [k for k in seg.stopwatch.stats if k.startswith("graph/segmenter/")]
    assert sum(seg.stopwatch.stats[k].count for k in laps) == n
    assert seg.replayer.capture_s == 0.0


def test_card_rule_on_an_emulated_graph(seg, monkeypatch):
    # a process that has run this network at no shape yet
    emulate_card(monkeypatch)
    wide = DataConfig(height=16, width=64)
    seen = []
    hook = seg.net.register_forward_hook(
        lambda module, inputs, out: seen.append(out))
    calls = [(CFG, 1), (CFG, 2), (CFG, 3), (CFG, 4), (wide, 5), (wide, 6),
             (wide, 7), (CFG, 8), (CFG, 9)]
    for cfg, seed in calls:
        seg.cfg = cfg
        pts = _points(seed)
        labels, probs = seg(pts)
        want_labels, want_probs = _by_hand(seg, pts)
        assert torch.equal(labels, want_labels)
        assert torch.equal(probs, want_probs)
    hook.remove()
    laps = [k for k in seg.stopwatch.stats if k.startswith("graph/")]
    assert seg.replayer.counts["segmenter"] == {"eager": 3, "capture": 3,
                                                "replay": 3}
    assert seg.replayer.invalidations == {"first call": 2, "shape": 1}
    assert sorted(laps) == ["graph/segmenter/capture",
                            "graph/segmenter/eager/first call",
                            "graph/segmenter/eager/shape",
                            "graph/segmenter/replay"]
    assert len(seen) == len(calls)
    # eager (a shape this process has not run), capture, replays; the new
    # shape the same; the first shape again, which the process has run:
    # eager once, captured on the next call. The replays hand on the
    # captured logits buffer, the eager calls their own tensors
    assert seen[2] is seen[1] and seen[3] is seen[1]
    assert seen[6] is seen[5] and seen[5] is not seen[1]
    assert seen[8] is not seen[1] and seen[8] is not seen[5]
    assert all(seen[i] is not seen[j] for i in (0, 4, 7)
               for j in range(len(seen)) if j != i)
    assert seen[5].shape[2] == wide.width and seen[8].shape[2] == CFG.width
