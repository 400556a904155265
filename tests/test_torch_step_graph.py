"""The odometry step's stages as ``core.step_graph.StepGraphs`` runs them,
on the CPU at ``SumaConfig().small()`` (spill and loop closure off).

* A 33-scan synthetic sequence, through the confidence warm-up (30 scans),
  with view refreshes and one forced fallback scan (a wild
  ``last_increment`` put into the state), stepped three ways from one
  state: the plain ``odometry_step_fetch``, the stages on the graphs'
  buffers run eagerly (what the CPU does), and the same with every call
  after a stage's first "captured" and "replayed" by a stand-in graph that
  reruns the stage on its buffers (``torch_card``: the scan copied into
  the graph's input buffers, the confidence threshold read from its device
  float, the track-loss flag from the device's jump flag). Packed rows and
  every field of the state are equal bit for bit on every scan.
* The engagement counters add up: captures + replays + eager calls = the
  stage's calls, the eager calls = the invalidations by reason. The launch
  counters a capture bumped are taken back and each replay adds them.
* A finished session hands its graphs to the next session of its
  configuration (not to one still running, nor to another configuration,
  which drops them), whose first state takes their arena and active view
  zeroed: equal to a new session's first state bit for bit.

CPU wall time: ~10 s on one worker."""

import torch_env  # noqa: F401  (first: one torch thread)

import gc

import pytest
import torch
from torch_card import emulate_card

from semantic_suma_tpu_torch import graphs as gr
from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch.core import pipeline as tp
from semantic_suma_tpu_torch.core import step_graph as sg
from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                   default_world, render_scan)
from semantic_suma_tpu_torch.ops import icp, zbuffer

N_SCANS = 33
FALLBACK_AT = 31   # the scan whose state gets a wild last_increment
WILD_M = 0.6


def _cfg():
    return SumaConfig(map=MapConfig(spill_enabled=False),
                      loop=LoopClosureConfig(enabled=False)).small()


@pytest.fixture(scope="module")
def scans():
    cfg = _cfg()
    world = default_world(0)
    poses = circular_trajectory(N_SCANS, radius=18.0, step=1.2)
    return [render_scan(world, p, cfg.data) for p in poses]


def _wild(state):
    inc = state.last_increment.clone()
    inc[0, 3] += WILD_M
    return state._replace(last_increment=inc)


@pytest.mark.parametrize("mode", ["eager", "replayed"])
def test_stages_on_buffers_equal_the_plain_step(monkeypatch, scans, mode):
    cfg = _cfg()
    if mode == "replayed":
        emulate_card(monkeypatch)
    conf = tp.SurfelSLAM(cfg, device="cpu")._conf_at
    graphs = sg.StepGraphs(cfg, "cpu")
    plain = tp.init_state(cfg, "cpu")
    held = tp.init_state(cfg, "cpu")
    refreshes, losses = set(), 0
    for i, s in enumerate(scans):
        if i == FALLBACK_AT:
            plain, held = _wild(plain), _wild(held)
        args = (s.points, s.labels, s.probs, s.valid, conf(i), cfg)
        plain, want = tp.odometry_step_fetch(plain, *args)
        held, got = tp.odometry_step_fetch(held, *args, graphs=graphs)
        assert held is graphs.state
        assert torch.equal(got, want), i
        for a, b in zip(sg._leaves(held), sg._leaves(plain), strict=True):
            assert torch.equal(a, b), i
        refreshes.update(v for (stage, v) in graphs.replayer._last
                         if stage == "fuse_render")
        losses += int(want[45] > 0)
    # the sequence went through the warm-up, refreshed and did not, and
    # its forced scan fell back
    assert conf(N_SCANS - 1) == cfg.map.confidence_threshold != conf(0)
    assert refreshes == {True, False}
    assert losses >= 1
    s = graphs.replayer.summary()
    if mode == "eager":
        assert s["eager"] == dict.fromkeys(sg.STAGES, N_SCANS)
        assert s["invalidations"] == {"cpu": 4 * N_SCANS}
    else:
        # a first call of each stage (and refresh variant) runs eagerly,
        # every later call replays what the next one captured
        assert s["eager"]["fuse_render"] == 2
        assert all(s["eager"][st] == 1 for st in sg.STAGES
                   if st != "fuse_render")
        assert s["captures"]["fuse_render"] == 2
        assert s["replays"]["preprocess"] == N_SCANS - 2
        assert s["invalidations"] == {"first call": 5}


def test_engagement_and_launch_counters_add_up(monkeypatch, scans):
    cfg = _cfg()
    emulate_card(monkeypatch)
    graphs = sg.StepGraphs(cfg, "cpu")
    state = tp.init_state(cfg, "cpu")
    n = 6
    for i, s in enumerate(scans[:n]):
        state, _ = tp.odometry_step_fetch(state, s.points, s.labels, s.probs,
                                          s.valid, 0.0, cfg, graphs=graphs)
    s = graphs.replayer.summary()
    for st in sg.STAGES:
        assert (s["captures"][st] + s["replays"][st] + s["eager"][st]
                == sum(graphs.replayer.counts[st].values()) == n)
    assert sum(s["eager"].values()) == sum(s["invalidations"].values())

    # a graph's counters: a capture's increments are taken back, and each
    # replay adds them, to the counters as they stand then
    monkeypatch.setattr(icp.gn_loop, "launches", 5)
    monkeypatch.setattr(zbuffer.zbuffer_cells, "launches_by_shape",
                        {(7, 2): 1})
    before = gr.counter_values()
    icp.gn_loop.launches += 1
    zbuffer.zbuffer_cells.launches_by_shape[(7, 2)] += 2
    zbuffer.zbuffer_cells.launches_by_shape[(3, 0)] = 1
    delta = gr.counter_delta(before, gr.counter_values())
    assert delta == {"gn_loop": 1, ("zbuffer_cells_by_shape", (7, 2)): 2,
                     ("zbuffer_cells_by_shape", (3, 0)): 1}
    gr.counter_add(delta, -1)
    assert gr.counter_values() == {**before,
                                   ("zbuffer_cells_by_shape", (3, 0)): 0}
    zbuffer.zbuffer_cells.launches_by_shape = {}
    for _ in range(3):
        gr.counter_add(delta)
    assert icp.gn_loop.launches == 8
    assert zbuffer.zbuffer_cells.launches_by_shape == {(7, 2): 6, (3, 0): 3}


class _Session:
    """What ``StepGraphs.for_session`` reads of a session."""

    def __init__(self, cfg):
        self.cfg, self.device, self.stopwatch = cfg, torch.device("cpu"), None


def test_a_finished_session_hands_its_graphs_to_the_next(monkeypatch):
    monkeypatch.setattr(sg, "_SPARE", {})
    cfg = _cfg()
    a, b = _Session(cfg), _Session(cfg)
    ga = sg.StepGraphs.for_session(a)
    held = ga.enter(tp.init_state(cfg, "cpu"))
    held.map.data.f.fill_(1.0)    # what a session leaves in its buffers
    held.map.active.i.fill_(3)
    assert sg.StepGraphs.for_session(b) is not ga  # a is still running
    del a
    gc.collect()
    c = _Session(cfg)
    assert sg.StepGraphs.for_session(c) is ga
    first = tp.init_state(cfg, "cpu", reuse=ga.state)
    assert first.map.data.f is held.map.data.f
    assert first.map.active.i is held.map.active.i
    for x, y in zip(sg._leaves(first), sg._leaves(tp.init_state(cfg, "cpu")),
                    strict=True):
        assert torch.equal(x, y)
    assert ga.enter(first) is held
    # a session of another configuration drops the spare
    del c
    gc.collect()
    assert sg._SPARE
    other = _Session(SumaConfig().small())
    assert sg.StepGraphs.for_session(other) is not ga
    assert not sg._SPARE
