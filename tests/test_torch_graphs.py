"""The port's CUDA-graph replayer (``semantic_suma_tpu_torch/graphs.py``)
on the CPU.

* ``graphs.decide`` as a function of what it observes: eager for a CPU, a
  sharding group, a capture in progress, a first call, a new shape and a
  moved buffer; a capture where the signature held since the last call or
  no graph exists; a replay where it is the graph's.
* On an emulated card (``torch_card``), a body whose capture meets a first
  call of kernel B's table size (``zbuffer.FirstCallUnderCapture``) runs
  eagerly for that call, counted and lapped as a first call; the next call
  captures, and the replays return what their capture returned.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import pytest
import torch
from torch_card import emulate_card

from semantic_suma_tpu_torch import graphs
from semantic_suma_tpu_torch.ops import zbuffer
from semantic_suma_tpu_torch.utils.timing import Stopwatch


@pytest.mark.parametrize("case, kw, want", [
    ("cpu", dict(device_type="cpu"), ("eager", "cpu")),
    ("group", dict(grouped=True), ("eager", "group")),
    ("capturing", dict(capturing=True), ("eager", "capturing")),
    ("first call", dict(seen=False), ("eager", "first call")),
    ("new shape", dict(signature=((2,), (1,)), last=((1,), (1,))),
     ("eager", "shape")),
    ("moved pointer", dict(signature=((1,), (2,)), last=((1,), (1,))),
     ("eager", "pointer")),
    ("held since the last call", dict(signature=((1,), (2,)),
                                      last=((1,), (2,))), ("capture", None)),
    ("no graph yet", dict(captured=None), ("capture", None)),
    ("the graph's", dict(), ("replay", None)),
])
def test_decide_follows_what_it_observes(case, kw, want):
    obs = dict(device_type="cuda", grouped=False, capturing=False, seen=True,
               signature=((1,), (1,)), captured=((1,), (1,)),
               last=((1,), (1,)))
    assert graphs.decide(**{**obs, **kw}) == want, case


def test_a_first_call_under_capture_runs_eagerly(monkeypatch):
    emulate_card(monkeypatch)
    call = {"i": 0, "capturing": False}
    stand_in = graphs.capture

    def capture(pool, device, fn):
        call["capturing"] = True
        try:
            return stand_in(pool, device, fn)
        finally:
            call["capturing"] = False
    monkeypatch.setattr(graphs, "capture", capture)

    def body(_, inputs):
        if call["capturing"] and call["i"] == 4:
            raise zbuffer.FirstCallUnderCapture("a new table size")
        return 2.0 * inputs[0]

    sw = Stopwatch()
    rep = graphs.Replayer("cpu", ("double",), sw)
    outs = []
    for i, n in enumerate((3, 3, 3, 4, 4, 4, 4, 3)):
        call["i"] = i
        x = torch.arange(n, dtype=torch.float32) + i
        outs.append(rep.run("double", (x,), body))
        assert torch.equal(outs[-1], 2.0 * x), i
    # eager (a first call), capture, replay; the new shape eager, its
    # capture refused (eager), captured, replayed; the first shape again
    # eager
    assert rep.counts["double"] == {"eager": 4, "capture": 2, "replay": 2}
    assert rep.invalidations == {"first call": 3, "shape": 1}
    assert outs[2] is outs[1] and outs[6] is outs[5]
    assert outs[5] is not outs[1]
    assert sorted(sw.stats) == ["graph/double/capture",
                                "graph/double/eager/first call",
                                "graph/double/eager/shape",
                                "graph/double/replay"]
    assert sw.stats["graph/double/eager/first call"].count == 3
