"""Work that several of the port's multi-process tests share, done once a
run.

Starting two gloo ranks costs each test several seconds before any work,
and JAX compiles its sharded session for each mesh it is given. So the
two-rank checks of ``test_torch_sharding.py`` and
``test_torch_sharded_session.py`` run in ONE start of the ranks
(``torch_ranks.suite``) beside ONE JAX ``make_mesh(2)`` session, and the
tests read their part of the result.

:func:`once` computes a result once for all the xdist workers of a run: the
first worker to ask computes it under a file lock in the run's temporary
directory and pickles it there; the others wait for the lock and read it.
"""
import fcntl
import os
import pickle

import numpy as np
import pytest
import torch

import torch_ranks
from torch_ranks import JAX_SCANS, N_SCANS, PARITY_SCANS, STOP


def once(tmp_path_factory, name: str, compute):
    """``compute(directory)``'s result, computed once a run (see the module
    docstring); ``directory`` holds the files it writes."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the run's directory, shared by its workers
    work = base / f"shared-{name}"
    done = work / "result.pkl"
    with open(base / f"shared-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            work.mkdir(exist_ok=True)
            out = compute(work)
            tmp = work / "result.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, done)
        with open(done, "rb") as f:
            return pickle.load(f)


def jax_small_cfg():
    from semantic_suma_tpu.config import (DataConfig, IcpConfig, MapConfig,
                                          SumaConfig)
    d = DataConfig(width=128, height=32)
    return SumaConfig(
        data=d, model=d, icp=IcpConfig(max_iterations=10),
        map=MapConfig(surfel_capacity=1 << 16, active_capacity=1 << 15,
                      max_poses=64))


def save_scans(reader, n, path):
    arrs = {"n": np.asarray(n)}
    for i in range(n):
        s = reader.read(i)
        arrs.update({f"p{i}": np.asarray(s.points),
                     f"l{i}": np.asarray(s.labels),
                     f"q{i}": np.asarray(s.probs),
                     f"v{i}": np.asarray(s.valid)})
    np.savez(path, **arrs)
    return str(path)


def flat(prefix, tree, out):
    for name, leaf in zip(tree._fields, tree):
        if hasattr(leaf, "_fields"):
            flat(f"{prefix}{name}/", leaf, out)
        else:
            out[f"{prefix}{name}"] = np.asarray(leaf)


def jax_session(scans_file, d, n, forced_path, ckpt_path=None, stop=None):
    """JAX's sharded session on ``make_mesh(d)`` over ``n`` scans: the
    state before each of the first ``PARITY_SCANS`` scans (an .npz for the
    ranks), the results after each scan, and (``ckpt_path``) its archive
    after ``stop`` scans. Returns (rows of (pose, map count, iterations),
    the session)."""
    from semantic_suma_tpu.parallel import sharding as jsh
    from semantic_suma_tpu.utils import checkpoint as jckpt
    z = np.load(scans_file)
    slam = jsh.ShardedSurfelSLAM(jax_small_cfg(), jsh.make_mesh(d),
                                 enable_loop_closure=False)
    forced, rows = {}, []
    for i in range(n):
        if i < PARITY_SCANS:
            flat(f"{i}/map/", slam.map_sh, forced)
            for name in ("last_maps", "model_maps"):
                flat(f"{i}/{name}/", getattr(slam, name), forced)
            forced[f"{i}/pose"] = np.asarray(slam.pose)
            forced[f"{i}/last_increment"] = np.asarray(slam.last_increment)
        st = slam.process_scan(z[f"p{i}"], z[f"l{i}"], z[f"q{i}"],
                               z[f"v{i}"])
        rows.append((np.asarray(slam.poses[-1]), st["map-count"],
                     st["icp-iterations"]))
        if ckpt_path and i == stop - 1:
            jckpt.save_checkpoint(slam, ckpt_path)
    np.savez(forced_path, **forced)
    return rows, slam


def single_device_step(batch_file, sides_path):
    """The port's single-device f32 step of ``small_rangenet`` on the whole
    batch, recording each ``leaky_relu`` input's side for the ranks."""
    from semantic_suma_tpu_torch.models import rangenet as trn
    from semantic_suma_tpu_torch.models import segmenter as tseg
    z = np.load(batch_file)
    rec = torch_ranks.SidedF()
    plain = trn.F
    trn.F = rec
    try:
        model = trn.small_rangenet(dtype=torch.float32)
        schedule, state = tseg.create_train_state(model, seed=0,
                                                  device="cpu")
        step = tseg.make_train_step(schedule, torch.as_tensor(z["cw"]))
        state, m = step(state, *(torch.as_tensor(z[k])
                                 for k in ("images", "labels", "valid")))
    finally:
        trn.F = plain
    np.savez(sides_path, **{f"s{k}": s for k, s in enumerate(rec.recorded)})
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in state.model.named_parameters()},
            "params": {k: p.detach().numpy().copy()
                       for k, p in state.model.named_parameters()},
            "moments": {k: state.optimizer.state[p]["exp_avg"].numpy().copy()
                        for k, p in state.model.named_parameters()},
            "buffers": {k: t.numpy().copy()
                        for k, t in state.model.named_buffers()}}


def write_train_batch(path, b=4, h=16, w=96, seed=3):
    """The seeded batch of the port's multi-rank training tests."""
    rng = np.random.default_rng(seed)
    np.savez(path,
             images=rng.normal(size=(b, h, w, 5)).astype(np.float32),
             labels=rng.integers(0, 20, size=(b, h, w)).astype(np.int32),
             valid=rng.random((b, h, w)) < 0.8,
             cw=rng.uniform(0.5, 2.0, 20).astype(np.float32))
    return path


def _two_rank_suite(work):
    from semantic_suma_tpu.io.simulation import SimulationReader
    from semantic_suma_tpu_torch.parallel.distributed import launch
    reader = SimulationReader(jax_small_cfg().data, n_scans=60, radius=18.0)
    scans = save_scans(reader, N_SCANS, work / "scans.npz")
    jax_ckpt = str(work / "jax.npz")
    rows, slam = jax_session(scans, 2, JAX_SCANS, work / "forced2.npz",
                             jax_ckpt, STOP)
    batch = write_train_batch(work / "batch.npz")
    single = single_device_step(batch, work / "sides.npz")
    ranks = launch(torch_ranks.suite, 2,
                   (torch_ranks.small_cfg(), scans, str(work / "forced2.npz"),
                    jax_ckpt, str(work), str(batch), str(work / "sides.npz")),
                   cpu=True, threads=1, timeout_s=120, join_timeout_s=120)
    return {"dir": str(work), "scans": scans, "jax_ckpt": jax_ckpt,
            "port_ckpt": str(work / "port.npz"), "jax_rows": rows,
            "jax_count": slam.statistics[-1]["map-count"], "ranks": ranks,
            "single_step": single}


@pytest.fixture(scope="session")
def two_ranks(tmp_path_factory):
    """The shared two-rank suite: the scans, the JAX ``make_mesh(2)``
    session's rows and archives, each rank's results by check
    (``torch_ranks.suite``) and the single-device training step."""
    return once(tmp_path_factory, "two-ranks", _two_rank_suite)
