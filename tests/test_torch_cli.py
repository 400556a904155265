"""The port's headless CLI (``semantic_suma_tpu_torch.cli``) on the CPU,
against the JAX package's CLI and against the port's own ``SurfelSLAM``.

At the small XML of ``tests/test_cli.py`` (24x120, 8 ICP iterations, loops
off, 2^15-row arena, 2^13-row view, spill on as the CLI's default
configuration has it), 12 noise-free synthetic scans:

* the exported poses equal those of ``SurfelSLAM`` driven directly with the
  CLI's configuration on the same scans, within 1e-6 m (the pose file's
  nine significant digits);
* the aligned ATE is within 0.02 m of the JAX CLI's on the same run, and
  the final map count within 0.5% (the two simulators differ by ~7.6e-6 m,
  and a free run amplifies rounding: ROADMAP section 3);
* the stats JSONL records and the evaluation JSON carry the JAX CLI's keys;
* ``eval`` of the exported file gives ``run --eval``'s numbers;
* every flag whose module is not ported ends the run with an error naming
  that module, and without ``--cpu`` and without a GPU ``run`` raises;
* ``--segmenter-weights`` labels every scan with the network, on the
  synthetic world and on a KITTI directory with ``--no-gt-labels``.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from semantic_suma_tpu import cli as jcli
from semantic_suma_tpu_torch import cli as tcli

XML = """<config>
<param name="data_width" type="integer">120</param>
<param name="data_height" type="integer">24</param>
<param name="model_width" type="integer">120</param>
<param name="model_height" type="integer">24</param>
<param name="max iterations" type="integer">8</param>
</config>
"""
N = 12


def _args(tmp_path, tag, extra=()):
    cfg = tmp_path / "cfg.xml"
    if not cfg.exists():
        cfg.write_text(XML)
    return ["--cpu", "run", "--config", str(cfg), "--no-loop-closure",
            "--surfel-capacity", str(1 << 15),
            "--active-capacity", str(1 << 13), "--synthetic", str(N),
            "--export-poses", str(tmp_path / f"{tag}.txt"),
            "--stats-json", str(tmp_path / f"{tag}.jsonl"),
            "--eval", "--eval-breakdown", *extra]


def _eval_json(out: str) -> dict:
    return json.loads(out[out.index("\n{") + 1:])


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tmp dir, port stdout, JAX stdout) of the same CLI run."""
    tmp = tmp_path_factory.mktemp("cli")
    outs = []
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            extra = ("--save-map", str(tmp / f"{tag}.ply"),
                     "--save-cloud", str(tmp / f"{tag}_cloud.ply"))
            assert main(_args(tmp, tag, extra)) == 0
        outs.append(buf.getvalue())
        (tmp / f"{tag}.err").write_text(err.getvalue())
    return tmp, outs[0], outs[1]


def test_run_prints_the_jax_format(runs):
    _, out, jout = runs
    for text in (out, jout):
        first = [line for line in text.splitlines()
                 if line.startswith("processed ")]
        assert len(first) == 1 and f"processed {N} scans in " in first[0]
        assert "scans/s)" in first[0]
    assert set(_eval_json(out)) == set(_eval_json(jout))
    for key in ("by_length", "by_speed"):
        assert key in _eval_json(out)


def test_exported_poses_equal_a_direct_drive(runs):
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.kitti import load_poses
    from semantic_suma_tpu_torch.io.simulation import (SimulationReader,
                                                       default_world)
    tmp, _, _ = runs
    cfg = tcli.build_config(_namespace(tmp))
    assert cfg.map.spill_enabled and not cfg.loop.enabled
    reader = SimulationReader(cfg.data, n_scans=N, world=default_world(seed=0),
                              radius=18.0, step=1.0, device="cpu")
    slam = SurfelSLAM(cfg, device="cpu")
    for i in range(N):
        s = reader.read(i)
        slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
    slam.finalize()
    got = load_poses(str(tmp / "port.txt"))
    np.testing.assert_allclose(got, slam.trajectory(), rtol=0, atol=1e-6)


def _namespace(tmp):
    import argparse
    return argparse.Namespace(config=str(tmp / "cfg.xml"), no_loop_closure=True,
                              surfel_capacity=1 << 15,
                              active_capacity=1 << 13, max_scans=None,
                              approach=None, no_semantics=False)


def test_accuracy_and_map_match_the_jax_cli(runs):
    tmp, out, jout = runs
    ate, jate = _eval_json(out)["ate_rmse_m"], _eval_json(jout)["ate_rmse_m"]
    assert np.isfinite(ate) and abs(ate - jate) <= 0.02, (ate, jate)
    scans = [r for r in _records(tmp / "port.jsonl") if r["event"] == "scan"]
    jscans = [r for r in _records(tmp / "jax.jsonl") if r["event"] == "scan"]
    assert len(scans) == len(jscans) == N
    count, jcount = scans[-1]["map-count"], jscans[-1]["map-count"]
    assert abs(count - jcount) <= 0.005 * jcount, (count, jcount)


def test_stats_and_exports_have_the_jax_keys(runs):
    tmp, _, _ = runs
    recs, jrecs = _records(tmp / "port.jsonl"), _records(tmp / "jax.jsonl")
    assert [r["event"] for r in recs] == [r["event"] for r in jrecs]
    assert [r["idx"] for r in recs if r["event"] == "scan"] == list(range(N))
    for r, jr in zip(recs, jrecs):
        if r["event"] == "scan":
            assert set(r) == set(jr)
    # the stage-times record names the port's own phases
    assert "stage-times" in {r["event"] for r in recs}
    for tag in ("port", "jax"):
        for name in (f"{tag}.ply", f"{tag}_cloud.ply"):
            header = (tmp / name).read_bytes().split(b"end_header")[0]
            n = int([line for line in header.decode().splitlines()
                     if line.startswith("element vertex")][0].split()[-1])
            assert n > 100, name
    # the surfel PLY: the same header as the JAX package's
    assert (tmp / "port.ply").read_bytes().split(b"element vertex")[0] == \
        (tmp / "jax.ply").read_bytes().split(b"element vertex")[0]


def test_eval_command_matches_run_eval(runs, capsys):
    tmp, out, _ = runs
    from semantic_suma_tpu_torch.io.kitti import save_poses
    from semantic_suma_tpu_torch.io.simulation import circular_trajectory
    gt = tmp / "gt.txt"
    save_poses(str(gt), circular_trajectory(N, 18.0, step=1.0).numpy())
    assert tcli.main(["eval", "--gt", str(gt), "--est",
                      str(tmp / "port.txt")]) == 0
    res = _eval_json("\n" + capsys.readouterr().out)
    want = _eval_json(out)
    assert abs(res["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-6
    assert res["num_segments"] == want["num_segments"]


REFUSED = [
    (["run", "--synthetic", "2", "--save-checkpoint", "c.npz"],
     "utils/checkpoint"),
    (["run", "--synthetic", "2", "--resume", "c.npz"], "utils/checkpoint"),
    (["run", "--synthetic", "2", "--sharded", "2"], "parallel/sharding"),
    (["run", "--synthetic", "2", "--save-viewer", "m.html"], "utils/viz3d"),
    (["run", "--synthetic", "2", "--plot-dir", "plots"], "utils/viz"),
    (["eval", "--gt", "a.txt", "--est", "b.txt", "--plot-dir", "plots"],
     "utils/viz"),
    (["train-segmenter", "--synthetic", "4", "--out", "w.pkl"],
     "models/segmenter"),
]


@pytest.mark.parametrize("argv,module", REFUSED,
                         ids=[a[0] + ":" + (a[-2] if a[0] != "train-segmenter"
                                            else "cmd") for a, _ in REFUSED])
def test_unported_flags_are_refused(argv, module, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert module in err and "not ported" in err


@pytest.mark.parametrize("source", ["synthetic", "dataset"])
def test_segmenter_weights_label_every_scan(source, tmp_path, monkeypatch,
                                            capsys):
    """``run --segmenter-weights`` with the versioned mid network at the
    small XML: every scan goes through ``Segmenter.__call__`` (the synthetic
    world's labels, or the files' with ``--no-gt-labels``, are not used),
    and the run tracks (aligned ATE under 0.05 m over a few metres)."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence
    from semantic_suma_tpu_torch.io.simulation import default_world
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    calls = []
    call = Segmenter.__call__

    def counted(self, points, remissions=None):
        labels, probs = call(self, points, remissions)
        calls.append(int((labels > 0).sum()))
        return labels, probs

    monkeypatch.setattr(Segmenter, "__call__", counted)
    cfg = tmp_path / "small.xml"
    cfg.write_text(XML)
    weights = "weights/segmenter_synth_mid.pkl"
    if source == "synthetic":
        n, argv = 4, ["--synthetic", "4"]
    else:
        n, seq = 3, str(tmp_path / "seq")
        export_synthetic_sequence(
            seq, n, DataConfig(width=120, height=24),
            world=default_world(0, movable_fraction=0.3), step=1.0,
            device="cpu")
        argv = ["--dataset", seq, "--no-gt-labels"]
    assert tcli.main(["--cpu", "run", "--config", str(cfg), *argv,
                      "--segmenter-weights", weights, "--eval"]) == 0
    out = capsys.readouterr().out
    assert f"processed {n} scans in " in out
    assert len(calls) == n and min(calls) > 100, calls
    ate = _eval_json(out)["ate_rmse_m"]
    assert np.isfinite(ate) and ate < 0.05, ate


def test_run_without_cpu_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the run would go to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", "--synthetic", "2", "--no-loop-closure"])


def test_ledger_tool_reads_both_clis(runs):
    """``tools/make_results.py``: the JAX ledger's arguments, and one parser
    for the output of either CLI."""
    from semantic_suma_tpu_torch.tools import make_results as mr
    tmp, out, jout = runs
    got = mr.parse_run(out, (tmp / "port.err").read_text())
    want = mr.parse_run(jout, (tmp / "jax.err").read_text())
    assert got["scans"] == want["scans"] == N
    assert got["ate_rmse_m"] == _eval_json(out)["ate_rmse_m"]
    assert set(want) == set(got)
    assert got["creations_dropped"] == 0 and want["creations_dropped"] is None
    assert set(got["spill"]) == {"rows", "chunks", "paged_in", "probes",
                                 "futile", "stale"}
    assert mr.row_args("odometry") == [
        "run", "--synthetic", "150", "--no-loop-closure", "--eval",
        "--eval-breakdown"]
    assert mr.row_args("noisy") == [
        "run", "--synthetic", "150", "--noise", "0.02", "--no-loop-closure",
        "--eval"]
    assert mr.row_args("loop", stats_json="s.jsonl") == [
        "run", "--synthetic", "140", "--config", str(mr.LOOP_XML),
        "--synthetic-step", "1.0", "--eval", "--stats-json", "s.jsonl"]
    seg = {"t_rel_percent": 0.5, "r_rel_deg_per_100m": 0.25, "count": 7}
    text = mr.table({"odometry": dict(got, by_length={"100m": seg}),
                     "loop": dict(got, loop_closures=3)})
    assert text.splitlines()[0].startswith("| run | scans | ATE RMSE (m)")
    assert "| loop | 12 |" in text and "loops=3" in text
    assert "Devkit breakdown (odometry run):" in text
    assert "| 100m | 0.5000 | 0.2500 | 7 |" in text
