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
* ``--plot-dir`` (on ``run`` and ``eval``) writes the files the JAX CLI
  writes, by name, none empty; ``--save-viewer`` writes a self-contained
  WebGL page; ``--save-checkpoint`` writes an archive that ``--resume``
  continues (the port's and the JAX CLI's), from the scan after the last
  one saved; ``--cache-dir`` names the kernels' build directory;
* ``--sharded 2`` (two gloo ranks on the CPU) prints the JAX CLI's lines
  and evaluation keys, writes a checkpoint that ``--resume`` continues,
  and exports the poses of ``ShardedSurfelSLAM`` driven directly on two
  ranks, within 1e-6 m; without ``--cpu`` and without a GPU ``run``
  raises;
* ``--segmenter-weights`` labels every scan with the network, on the
  synthetic world and on a KITTI directory with ``--no-gt-labels``.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import contextlib
import io
import json
from pathlib import Path

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
    """(tmp dir, port stdout, JAX stdout) of the same CLI run, made once a
    run for every xdist worker (``tests/torch_shared.py``); the tests only
    read the directory."""
    import torch_shared
    tmp, out, jout = torch_shared.once(tmp_path_factory, "cli-runs",
                                       _both_clis)
    return Path(tmp), out, jout


def _both_clis(tmp):
    outs = []
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            extra = ("--save-map", str(tmp / f"{tag}.ply"),
                     "--save-cloud", str(tmp / f"{tag}_cloud.ply"),
                     "--plot-dir", str(tmp / f"{tag}_plots"),
                     "--save-viewer", str(tmp / f"{tag}.html"),
                     "--save-checkpoint", str(tmp / f"{tag}.npz"))
            assert main(_args(tmp, tag, extra)) == 0
        outs.append(buf.getvalue())
        (tmp / f"{tag}.err").write_text(err.getvalue())
    return str(tmp), outs[0], outs[1]


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


def test_eval_command_matches_run_eval(runs, tmp_path, capsys):
    tmp, out, _ = runs
    from semantic_suma_tpu_torch.io.kitti import save_poses
    from semantic_suma_tpu_torch.io.simulation import circular_trajectory
    gt = tmp_path / "gt.txt"
    save_poses(str(gt), circular_trajectory(N, 18.0, step=1.0).numpy())
    assert tcli.main(["eval", "--gt", str(gt), "--est",
                      str(tmp / "port.txt")]) == 0
    res = _eval_json("\n" + capsys.readouterr().out)
    want = _eval_json(out)
    assert abs(res["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-6
    assert res["num_segments"] == want["num_segments"]


SHARDED_N = 8


def _sharded(tmp_path, *extra):
    """``--cpu run --sharded 2 --synthetic 8`` at the small XML (loops on,
    as the CLI's default configuration has them) through ``cli.main`` in
    this process: (exit code, stdout, stderr)."""
    cfg = tmp_path / "cfg.xml"
    if not cfg.exists():
        cfg.write_text(XML)
    argv = ["--cpu", "run", "--config", str(cfg), "--surfel-capacity",
            str(1 << 15), "--active-capacity", str(1 << 13), "--sharded",
            "2", "--synthetic", str(SHARDED_N), *extra]
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    return rc, buf.getvalue(), err.getvalue()


@pytest.fixture(scope="session")
def sharded_run(tmp_path_factory):
    """One ``_sharded`` run with the evaluation, the stats log and the
    exported poses, shared by the tests below (and by the xdist workers of
    a run): (its directory, exit code, stdout, stderr)."""
    import torch_shared

    def compute(d):
        rc, out, err = _sharded(d, "--eval", "--eval-breakdown",
                                "--stats-json", str(d / "s.jsonl"),
                                "--export-poses", str(d / "est.txt"))
        return str(d), rc, out, err
    d, rc, out, err = torch_shared.once(tmp_path_factory, "cli-sharded",
                                        compute)
    return Path(d), rc, out, err


def test_sharded_run_prints_the_jax_format(runs, sharded_run):
    from semantic_suma_tpu_torch.tools.make_results import parse_run
    tmp_path, rc, out, err = sharded_run
    assert rc == 0, err
    row = parse_run(out, err)
    assert row["scans"] == SHARDED_N and row["creations_dropped"] == 0
    assert _eval_json(out).keys() == _eval_json(runs[1]).keys()
    assert row["ate_rmse_m"] < 0.05
    recs = [r for r in _records(tmp_path / "s.jsonl") if r["event"] == "scan"]
    assert len(recs) == SHARDED_N
    assert "distributed: 2 ranks, backend gloo" not in out
    ranks = json.loads(err[err.index("sharded ranks: ") + 15:]
                       .splitlines()[0])
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["collectives"]["counts"] == \
        ranks[1]["collectives"]["counts"]


def test_sharded_save_checkpoint_then_resume(tmp_path):
    ckpt = str(tmp_path / "s.npz")
    rc, _, err = _sharded(tmp_path, "--max-scans", "5", "--save-checkpoint",
                          ckpt)
    assert rc == 0 and f"checkpoint -> {ckpt}" in err, err
    rc, out, err = _sharded(tmp_path, "--resume", ckpt, "--eval")
    assert rc == 0, err
    assert f"resumed sharded at scan 5 from {ckpt}" in err
    assert f"processed {SHARDED_N - 5} scans in " in out
    assert np.isfinite(_eval_json(out)["ate_rmse_m"])


def test_sharded_poses_equal_a_direct_drive(sharded_run, tmp_path):
    """The exported poses of the sharded CLI run equal ``ShardedSurfelSLAM``
    driven directly on two ranks with the CLI's configuration, within the
    pose file's nine digits."""
    import argparse

    import torch_ranks
    from semantic_suma_tpu_torch.io.kitti import load_poses
    from semantic_suma_tpu_torch.io.simulation import (SimulationReader,
                                                       default_world)
    from semantic_suma_tpu_torch.parallel.distributed import launch
    run_dir, rc, _, err = sharded_run
    assert rc == 0, err
    est = run_dir / "est.txt"
    cfg = tcli.build_config(argparse.Namespace(
        config=str(run_dir / "cfg.xml"), max_scans=None, approach=None,
        no_semantics=False, no_loop_closure=False,
        surfel_capacity=1 << 15, active_capacity=1 << 13))
    reader = SimulationReader(cfg.data, n_scans=SHARDED_N,
                              world=default_world(seed=0), radius=18.0,
                              step=1.0, device="cpu")
    arrs = {"n": np.asarray(SHARDED_N)}
    for i in range(SHARDED_N):
        s = reader.read(i)
        arrs.update({f"p{i}": s.points.numpy(), f"l{i}": s.labels.numpy(),
                     f"q{i}": s.probs.numpy(), f"v{i}": s.valid.numpy()})
    np.savez(tmp_path / "scans.npz", **arrs)
    out = launch(torch_ranks.drive, 2,
                 (cfg, str(tmp_path / "scans.npz"), SHARDED_N, True, None,
                  True), cpu=True, threads=1, timeout_s=60,
                 join_timeout_s=60)
    np.testing.assert_allclose(load_poses(str(est)), np.stack(out[0]["poses"]),
                               atol=1e-6)


def _files(path):
    return sorted(p.name for p in path.iterdir())


def test_run_plot_dir_writes_the_jax_cli_files(runs):
    tmp, _, _ = runs
    names = _files(tmp / "port_plots")
    assert names == _files(tmp / "jax_plots") == [
        "errors.png", "model_depth.png", "model_normals.png",
        "model_semantics.png", "stats.png", "traj.png"]
    for name in names:
        assert (tmp / "port_plots" / name).stat().st_size > 0, name


def test_eval_plot_dir_writes_the_jax_cli_files(runs, tmp_path):
    tmp, _, _ = runs
    from semantic_suma_tpu_torch.io.kitti import save_poses
    from semantic_suma_tpu_torch.io.simulation import circular_trajectory
    gt = tmp_path / "gt.txt"
    save_poses(str(gt), circular_trajectory(N, 18.0, step=1.0).numpy())
    argv = ["eval", "--gt", str(gt), "--est", str(tmp / "port.txt"),
            "--eval-breakdown", "--plot-dir"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["--cpu", *argv, str(tmp_path / "t")]) == 0
        assert jcli.main(["--cpu", *argv, str(tmp_path / "j")]) == 0
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == [
        "errors.png", "traj.png"]


def test_save_viewer_writes_a_standalone_page(runs):
    import base64
    import re
    tmp, _, _ = runs
    html = (tmp / "port.html").read_text()
    assert "<canvas" in html and "<script src" not in html
    blobs = re.findall(r'decode\("([A-Za-z0-9+/=]*)"', html)
    assert len(blobs) == 4
    pos = np.frombuffer(base64.b64decode(blobs[0]), np.float32)
    traj = np.frombuffer(base64.b64decode(blobs[2]), np.float32)
    assert pos.size > 3000 and np.isfinite(pos).all()
    assert traj.size == 3 * N


@pytest.mark.parametrize("tag", ["port", "jax"])
def test_resume_continues_a_saved_run(runs, tag, tmp_path, capsys):
    """``--resume`` of the archive a run of either CLI saved after its 12
    scans, over 16: four more scans, the first 12 poses the saved run's (to
    the pose file's nine digits), and all 16 within 5 cm of an unstopped
    16-scan run (``tests/test_cli.py``'s bound: the compaction on save
    reorders the surfels, and a free run amplifies the rounding)."""
    from semantic_suma_tpu_torch.io.kitti import load_poses
    tmp, _, _ = runs
    argv = _args(tmp_path, "resumed")
    argv[argv.index("--synthetic") + 1] = str(N + 4)
    assert tcli.main([*argv, "--resume", str(tmp / f"{tag}.npz")]) == 0
    captured = capsys.readouterr()
    assert f"resumed at scan {N} from" in captured.err
    assert "processed 4 scans in " in captured.out
    got = load_poses(str(tmp_path / "resumed.txt"))
    assert got.shape == (N + 4, 4, 4)
    saved = load_poses(str(tmp / f"{tag}.txt"))
    np.testing.assert_allclose(got[:N], saved, rtol=0, atol=1e-6)
    argv = _args(tmp_path, "whole")
    argv[argv.index("--synthetic") + 1] = str(N + 4)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(argv) == 0
    np.testing.assert_allclose(got, load_poses(str(tmp_path / "whole.txt")),
                               rtol=0, atol=5e-2)


def test_cache_dir_names_the_build_directory(tmp_path, monkeypatch, capsys):
    from semantic_suma_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD", cuda_build.BUILD)
    assert tcli.main(["--cpu", "--cache-dir", str(tmp_path / "kernels"),
                      "run", "--synthetic", "1", "--no-loop-closure",
                      "--config", str(_xml(tmp_path)),
                      "--surfel-capacity", str(1 << 15),
                      "--active-capacity", str(1 << 13)]) == 0
    assert cuda_build.BUILD == (tmp_path / "kernels").resolve()
    assert cuda_build._lib_path("zbuffer").parent == cuda_build.BUILD


def _xml(tmp_path):
    cfg = tmp_path / "cfg.xml"
    cfg.write_text(XML)
    return cfg


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
