"""The harness finds every configuration, traffic mix, metric reader and
limit by name; a cell added in a copy of the benchmark is found with no edit
to an existing file; BENCHMARK.json keeps the contract's shape; the import
check compares whole top-level names; a trace reduces to busy time, named
idle gaps and the top device operations."""

import json
import re
import shutil

import pytest

from suma_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_what_it_names(cell):
    spec = harness.cell(cell)
    assert spec["config"]["suma"]["data"]["height"] == 64
    assert spec["traffic"]["mode"] in ("offline", "online")
    assert set(spec["limits"]) >= {"pose_gap_m"}
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    moved = names
    for m in spec["per_layer"]:
        assert m["moves"] in moved
        assert callable(harness.reader(m["name"]).read)


def test_a_cell_added_in_a_copy_needs_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "suma_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = root / "suma_bench"
    (here / "traffic" / "slow-circle.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "norevisit-offline.json")
                        .read_text()), trajectory={"n": 30, "radius": 12.0,
                                                   "step": 1.0})))
    (here / "metrics" / "scans_seen.py").write_text(
        "def read(rec):\n    return rec['scans']\n")
    (here / "limits" / "suma-slow-offline.json").write_text(
        json.dumps({"pose_gap_m": 0.003}))
    bench["workloads"].append({"name": "suma-slow-offline",
                               "config": "suma-hdl64",
                               "traffic": "slow-circle", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "scans_seen", "unit": "scans",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "host loop", "moves": "scans_per_s",
                               "workloads": ["suma-slow-offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.cell("suma-slow-offline", root=root)
    assert spec["traffic"]["trajectory"]["n"] == 30
    assert [m["name"] for m in spec["per_layer"]] == ["scans_seen"]
    assert harness.read_metrics(["scans_seen"], {"scans": 7},
                                root=root) == {"scans_seen": 7}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["suma_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("suma_bench/")
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_import_check_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "semantic_suma_tpu", "semantic_suma_tpu.core.pipeline",
              "semantic_suma_tpu_torch", "semantic_suma_tpu_torch.core",
              "jaxtyping", "flaxen", "torch", "suma_bench.reference"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "semantic_suma_tpu", "semantic_suma_tpu.core.pipeline"]


def test_the_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert not re.search(
            r"^\s*(import|from)\s+(jax|jaxlib|flax|semantic_suma_tpu\w*)\b",
            path.read_text(), re.M), path


def test_a_trace_reduces_to_busy_time_gaps_and_top_ops():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    events = [x("traced", "user_annotation", 1000, 100),
              x("dispatch", "user_annotation", 1000, 60),
              x("drain", "user_annotation", 1060, 40),
              x("k_a", "kernel", 990, 20),     # clipped to 1000-1010
              x("k_b", "kernel", 1005, 10),    # overlaps k_a
              x("k_a", "kernel", 1030, 5),
              x("copy", "gpu_memcpy", 1070, 12),
              x("k_c", "kernel", 1200, 10)]    # outside the window
    t = harness.reduce_trace(events)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx((15 + 5 + 12) * 1e-6)
    assert t["gaps"][0] == ["dispatch", pytest.approx(35e-6)]
    assert ["dispatch", pytest.approx(15e-6)] in t["gaps"]
    assert ["drain", pytest.approx(18e-6)] in t["gaps"]
    b = harness.breakdown(t)
    assert [n for n, _ in b["device_ops"]] == ["k_a", "copy", "k_b"]
    assert len(b["idle_gaps"]) <= 10
