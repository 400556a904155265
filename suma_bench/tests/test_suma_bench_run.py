"""A run end to end on the CPU at a small size, the harness's look for a
card skipped: the result's keys, the reference against the port's CPU path,
and the check seeing ``correct`` come out false under each fault a cell can
have, planted in the timed path."""

import json

import pytest
import torch

from semantic_suma_tpu_torch.core import pipeline
from semantic_suma_tpu_torch.models import segmenter
from suma_bench import harness, run
from suma_bench.tests.small import small

SEED = 2**31 + 11


def _run(cell, trace=False, network=False, scans=8, online=False):
    over = small(scans, network)
    if online:
        # the runner's open-loop mode, at the sensor's rate
        over["traffic"].update(mode="online", rate_hz=10.0)
    return run.run_cell(cell, SEED, 0.5, trace, device="cpu",
                        overrides=over)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = _run("suma-norevisit-offline", trace)
    log = r.pop("_log")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    spec = harness.cell("suma-norevisit-offline")
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert "host_reads_per_scan" in r["metrics"]
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    assert r["attempted"] == 8 * log["sequences"] and r["failed"] == 0
    json.dumps(r)


@pytest.mark.parametrize("cell, network, online", [
    ("suma-norevisit-offline", False, False),
    ("suma-norevisit-offline", False, True),
    ("sumapp-rangenet53-offline", True, False)])
def test_reference_agrees_with_the_port_cpu_path(cell, network, online):
    r = _run(cell, network=network, online=online)
    checks = r["checks"]
    if not network:
        # the same plain code on the same device: the same bits
        assert r["correct"], checks
        assert checks["pose_gap_m"]["value"] == 0.0
    else:
        # the program's bfloat16 network and the reference's float32 one
        # label some pixels apart; at this size (a 32x180 image) that moves
        # the trajectory by ~1 cm, so only the network's numbers are held
        assert checks["vote_mismatch"]["value"] == 0
        assert checks["logit_gap"]["value"] <= checks["logit_gap"]["limit"]


def _state_unchanged(monkeypatch):
    step = pipeline.odometry_step_fetch

    def broken(state, *a, **kw):
        _, packed = step(state, *a, **kw)
        packed = packed.clone()
        packed[:16] = state.pose.reshape(-1)
        return state, packed
    monkeypatch.setattr(pipeline, "odometry_step_fetch", broken)


def _answer_altered(monkeypatch):
    step = pipeline.odometry_step_fetch
    calls = [0]

    def broken(state, *a, **kw):
        new_state, packed = step(state, *a, **kw)
        calls[0] += 1
        if calls[0] % 5 == 0:
            packed = packed.clone()
            packed[3] += 0.01     # the pose's x, one centimetre off
        return new_state, packed
    monkeypatch.setattr(pipeline, "odometry_step_fetch", broken)


def _half_the_points(monkeypatch):
    step = pipeline.odometry_step_fetch

    def broken(state, points, labels, probs, valid, *a, **kw):
        valid = valid.clone()
        valid[1::2] = False
        return step(state, points, labels, probs, valid, *a, **kw)
    monkeypatch.setattr(pipeline, "odometry_step_fetch", broken)


def _label_altered(monkeypatch):
    call = segmenter.Segmenter.__call__

    def broken(self, points, remissions=None):
        labels, probs = call(self, points, remissions)
        labels = labels.clone()
        labels[torch.nonzero(labels)[:5, 0]] = 10
        return labels, probs
    monkeypatch.setattr(segmenter.Segmenter, "__call__", broken)


@pytest.mark.parametrize("cell, fault, network, online", [
    ("suma-norevisit-offline", _state_unchanged, False, False),
    ("suma-norevisit-offline", _answer_altered, False, False),
    ("suma-norevisit-offline", _half_the_points, False, False),
    ("suma-norevisit-offline", _state_unchanged, False, True),
    ("suma-norevisit-offline", _answer_altered, False, True),
    ("sumapp-rangenet53-offline", _label_altered, True, False),
])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, fault,
                                                  network, online):
    fault(monkeypatch)
    r = _run(cell, network=network, online=online)
    assert not r["correct"], r["checks"]
