"""Rank bodies of the port's multi-process tests.

Each function runs in a spawned rank (``parallel.distributed.launch``) and
imports only the port: no JAX in the ranks. Inputs come as arguments or as
``.npz`` files the test wrote; the return values go back to the test.
"""
import sys

import numpy as np
import torch

from semantic_suma_tpu_torch.config import (DataConfig, IcpConfig,
                                            LoopClosureConfig, MapConfig,
                                            SumaConfig)


# the scans of the shared two-rank suite (``torch_shared.two_ranks``); the
# JAX session's archive after STOP scans, run on to JAX_SCANS; the free-run
# checks over FREE_SCANS scans; the drive from JAX's states over PARITY_SCANS
N_SCANS = 12
STOP = 6
JAX_SCANS = 8
FREE_SCANS = 6
PARITY_SCANS = 5


def small_cfg():
    """``tests/test_sharding.py``'s ``small_cfg``: 32x128."""
    d = DataConfig(width=128, height=32)
    return SumaConfig(
        data=d, model=d, icp=IcpConfig(max_iterations=10),
        map=MapConfig(surfel_capacity=1 << 16, active_capacity=1 << 15,
                      max_poses=64))


def loop_cfg():
    """``tests/test_sharding.py``'s loop-closure configuration: 24x120."""
    d = DataConfig(width=120, height=24)
    return SumaConfig(
        data=d, model=d, icp=IcpConfig(max_iterations=10),
        map=MapConfig(surfel_capacity=1 << 16, active_capacity=1 << 14,
                      max_poses=256),
        loop=LoopClosureConfig(enabled=True, min_trajectory_distance=60.0,
                               delta_timestamp=20, search_distance=20.0,
                               min_verifications=3, outlier_threshold=6.0))


def _scans(path):
    z = np.load(path)
    n = int(z["n"])
    return [(z[f"p{i}"], z[f"l{i}"], z[f"q{i}"], z[f"v{i}"])
            for i in range(n)]


def _valid_rows(slam) -> int:
    """Valid rows of this rank's shard once its view is written back."""
    from semantic_suma_tpu_torch.core import surfel_map as sm
    return int(sm.sync(slam.local, slam.mcfg).data.valid.sum())


def _loop_counts(slam) -> dict:
    lc = slam._loop
    if lc is None:
        return {}
    return {"closures": lc.num_loop_closures,
            "optimizations": lc.num_optimizations,
            "rebases": lc.num_rebases}


def drive(rank, device, cfg, scans_file, n, loop=False, forced_file=None,
          asynchronous=False):
    """``ShardedSurfelSLAM`` over the first ``n`` scans of ``scans_file``.
    With ``forced_file`` (the JAX session's state before each scan, see
    ``test_torch_sharding.py``) each scan starts from the JAX state."""
    from semantic_suma_tpu_torch.parallel import sharding as shp
    mesh = shp.make_mesh(device=device)
    slam = shp.ShardedSurfelSLAM(cfg, mesh, enable_loop_closure=loop)
    forced = np.load(forced_file) if forced_file else None
    out = {"poses": [], "counts": [], "iterations": [], "dropped": []}
    for i, (p, lab, prob, v) in enumerate(_scans(scans_file)[:n]):
        if forced is not None:
            _force(slam, forced, i, rank, device)
        if asynchronous:
            slam.process_scan_async(p, lab, prob, v)
            continue
        st = slam.process_scan(p, lab, prob, v)
        out["poses"].append(np.asarray(slam.poses[-1]))
        out["counts"].append(st["map-count"])
        out["iterations"].append(st["icp-iterations"])
        out["dropped"].append(st["creations-dropped"])
    if asynchronous:
        slam.flush()
        out["poses"] = list(slam.trajectory())
    out["valid_rows"] = _valid_rows(slam)
    out["map_count"] = slam.statistics[-1]["map-count"]
    out["creations_dropped"] = slam.creations_dropped
    out["collectives"] = dict(mesh.group.counts)
    out.update(_loop_counts(slam))
    return out


def _force(slam, forced, i, rank, device):
    """Install the JAX session's state before scan ``i`` into this rank."""
    from semantic_suma_tpu_torch.convert import (maps_from_numpy,
                                                 sharded_state_from_jax)
    from semantic_suma_tpu_torch.core import surfel_map as sm
    from semantic_suma_tpu_torch.ops.icp import Maps

    def tree(prefix, cls):
        return cls(*[forced[f"{i}/{prefix}{f}"] for f in cls._fields])

    pk = sm.PackedSurfels
    data = pk(*[forced[f"{i}/map/data/{f}"] for f in pk._fields])
    active = pk(*[forced[f"{i}/map/active/{f}"] for f in pk._fields])
    map_sh = sm.MapState(data=data, active=active, **{
        f: forced[f"{i}/map/{f}"] for f in sm.MapState._fields
        if f not in ("data", "active")})
    slam.local = sharded_state_from_jax(map_sh, rank, device)
    slam.pose = torch.as_tensor(forced[f"{i}/pose"], device=device)
    slam.last_increment = torch.as_tensor(forced[f"{i}/last_increment"],
                                          device=device)
    slam.last_maps = maps_from_numpy(tree("last_maps/", Maps), device)
    slam.model_maps = maps_from_numpy(tree("model_maps/", Maps), device)
    slam._dispatched = i


def rebase_and_compact(rank, device, cfg, scans_file):
    """``test_sharding.py::test_sharded_rebase_and_compact`` in the port,
    then a compaction of every shard."""
    from semantic_suma_tpu_torch.core import surfel_map as sm
    from semantic_suma_tpu_torch.parallel import sharding as shp
    mesh = shp.make_mesh(device=device)
    slam = shp.ShardedSurfelSLAM(cfg, mesh)
    scans = _scans(scans_file)
    for s in scans[:4]:
        slam.process_scan(*s)
    before = slam.statistics[-1]["map-count"]
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 1.0
    new_poses = np.stack([shift @ p for p in slam.poses])
    slam.rebase(new_poses, shift @ np.asarray(slam.pose.cpu()))
    out = {"pose0": np.asarray(slam.poses[0]), "want0": new_poses[0],
           "version": slam.map_version, "before": before}
    st = slam.process_scan(*scans[4])
    out["after"] = st["map-count"]
    rows = _valid_rows(slam)
    slam.local = sm.compact(slam.local, slam.mcfg)
    out["valid_before_compact"] = rows
    out["count_after_compact"] = int(slam.local.count)
    st = slam.process_scan(*scans[5])
    out["after_compact"] = st["map-count"]
    return out


def checkpoint_run(rank, device, cfg, scans_file, n, cut, path):
    """Stop after ``cut`` scans and save; resume into a fresh session and
    run to ``n``; beside it, the same run without a stop."""
    from semantic_suma_tpu_torch.parallel import sharding as shp
    from semantic_suma_tpu_torch.utils.checkpoint import (
        load_checkpoint_sharded, save_checkpoint)
    mesh = shp.make_mesh(device=device)
    scans = _scans(scans_file)
    ref = shp.ShardedSurfelSLAM(cfg, mesh)
    for i, s in enumerate(scans[:n]):
        ref.process_scan(*s)
        if i == cut - 1:
            save_checkpoint(ref, path)
    resumed = load_checkpoint_sharded(path, cfg, mesh)
    out = {"resumed_at": len(resumed.poses),
           "resumed_last": np.asarray(resumed.poses[-1])}
    for s in scans[cut:n]:
        resumed.process_scan(*s)
    out.update(ref=ref.trajectory(), got=resumed.trajectory(),
               ref_count=ref.statistics[-1]["map-count"],
               got_count=resumed.statistics[-1]["map-count"])
    return out


def resume_and_save(rank, device, cfg, scans_file, path, start, n, out_path):
    """Resume an archive (either package's), run scans ``start..n``, save
    the session to ``out_path``; returns the poses and counts."""
    from semantic_suma_tpu_torch.parallel import sharding as shp
    from semantic_suma_tpu_torch.utils.checkpoint import (
        load_checkpoint_sharded, save_checkpoint)
    mesh = shp.make_mesh(device=device)
    slam = load_checkpoint_sharded(path, cfg, mesh, enable_loop_closure=False)
    out = {"resumed_at": len(slam.poses),
           "local_count": int(slam.local.count),
           "jax_loaded": any(m.split(".")[0] in ("jax", "semantic_suma_tpu")
                             for m in sys.modules)}
    for s in _scans(scans_file)[start:n]:
        slam.process_scan(*s)
    if out_path:
        save_checkpoint(slam, out_path)
    out.update(poses=slam.trajectory(),
               map_count=slam.statistics[-1]["map-count"])
    return out


class SidedF:
    """``torch.nn.functional`` whose ``leaky_relu`` puts each input on the
    side ``sides[k]`` gives it (the k-th call; ``part`` selects this rank's
    samples), recording the inputs that its own sign would put on the other
    side; with ``sides=None`` it records each call's sides instead."""

    def __init__(self, sides=None, part=slice(None)):
        self.sides, self.part = sides, part
        self.recorded, self.moved = [], []

    def leaky_relu(self, x, slope):
        if self.sides is None:
            self.recorded.append((x > 0).detach().numpy())
            return torch.nn.functional.leaky_relu(x, slope)
        side = torch.as_tensor(self.sides[len(self.moved)][self.part])
        self.moved.append(x.detach().abs()[(x > 0) != side].numpy())
        return torch.where(side, x, slope * x)

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


def train_step(rank, device, batch_file, sides_file=None):
    """One data-parallel f32 step of ``small_rangenet`` on this rank's half
    of the global batch; returns the loss, the batch statistics, the
    gradients and (with ``sides_file``: the single-device step's leaky_relu
    sides, see ``SidedF``) the inputs that changed side."""
    from semantic_suma_tpu_torch.models import rangenet as rn
    from semantic_suma_tpu_torch.models.segmenter import create_train_state
    from semantic_suma_tpu_torch.parallel import sharding as shp
    z = np.load(batch_file)
    mesh = shp.make_mesh(axis="data", device=device)
    b = z["images"].shape[0] // mesh.size
    part = slice(rank * b, (rank + 1) * b)
    sided = None
    if sides_file:
        sides = np.load(sides_file)
        sided = SidedF([sides[f"s{k}"] for k in range(len(sides.files))],
                       part)
        rn.F = sided
    model = rn.small_rangenet(dtype=torch.float32)
    schedule, state = create_train_state(model, seed=0, device=device)
    state = shp.shard_train_state(state, mesh)
    step = shp.make_sharded_train_step(schedule, mesh,
                                       torch.as_tensor(z["cw"]))
    state, metrics = step(state, torch.as_tensor(z["images"][part]),
                          torch.as_tensor(z["labels"][part]),
                          torch.as_tensor(z["valid"][part]))
    return {"moved": (np.concatenate(sided.moved) if sided
                      else np.zeros(0, np.float32)),
            "loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in state.model.named_parameters()},
            "buffers": {k: b_.numpy().copy()
                        for k, b_ in state.model.named_buffers()}}


def model_axis_step(rank, device, batch_file, sides_file):
    """One f32 step of ``small_rangenet`` on a 2 x 2 ``("data", "model")``
    mesh (``make_2d_mesh``): this rank's data row's half of the global
    batch, the widest kernels split over the model axis. Returns the rank's
    place and groups, the split layers with this rank's weight and moment
    shapes, and, gathered back (``unshard_train_state``), the loss, the
    batch statistics, the gradients and the updated weights; with the
    ``leaky_relu`` sides of the single-device step (``SidedF``) the inputs
    that changed side; and the error of a network whose width the model
    axis does not divide."""
    from semantic_suma_tpu_torch.models import rangenet as rn
    from semantic_suma_tpu_torch.models.segmenter import create_train_state
    from semantic_suma_tpu_torch.parallel import sharding as shp
    z = np.load(batch_file)
    mesh = shp.make_2d_mesh(2, 2, device=device)
    data, model = mesh.axes["data"], mesh.axes["model"]
    b = z["images"].shape[0] // data.size
    part = slice(data.rank * b, (data.rank + 1) * b)
    sides = np.load(sides_file)
    sided = SidedF([sides[f"s{k}"] for k in range(len(sides.files))], part)
    rn.F = sided
    schedule, state = create_train_state(rn.small_rangenet(
        dtype=torch.float32), seed=0, device=device)
    full = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    state = shp.shard_train_state(state, mesh)
    step = shp.make_sharded_train_step(schedule, mesh,
                                       torch.as_tensor(z["cw"]))
    state, metrics = step(state, torch.as_tensor(z["images"][part]),
                          torch.as_tensor(z["labels"][part]),
                          torch.as_tensor(z["valid"][part]))
    params = dict(state.model.named_parameters())
    split = {n for n, m in state.model.named_modules()
             if getattr(m, "model_group", None) is not None}
    local = {f"{n}.weight": (tuple(params[f"{n}.weight"].shape),
                             tuple(state.optimizer.state[
                                 params[f"{n}.weight"]]["exp_avg"].shape))
             for n in split}
    state = shp.unshard_train_state(state, mesh)
    out = {"place": (data.rank, model.rank), "data_ranks": data.ranks,
           "model_ranks": model.ranks, "full_shapes": full, "local": local,
           "moved": np.concatenate(sided.moved),
           "loss": float(metrics["loss"]),
           "accuracy": float(metrics["accuracy"]),
           "grads": {k: p.grad.numpy().copy()
                     for k, p in state.model.named_parameters()},
           "params": {k: p.detach().numpy().copy()
                      for k, p in state.model.named_parameters()},
           "moments": {k: state.optimizer.state[p]["exp_avg"].numpy().copy()
                       for k, p in state.model.named_parameters()},
           "buffers": {k: b_.numpy().copy()
                       for k, b_ in state.model.named_buffers()}}
    rn.F = torch.nn.functional
    _, odd = create_train_state(rn.RangeNet(
        stage_blocks=(1, 1, 2, 2, 1), widths=(16, 32, 64, 96, 128, 129),
        dtype=torch.float32), seed=0, device=device)
    try:
        shp.shard_train_state(odd, mesh)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    return out


def suite(rank, device, cfg, scans_file, forced_file, jax_ckpt, out_dir,
          batch_file, sides_file):
    """The two-rank checks of ``torch_shared.two_ranks`` in one start of
    the ranks, each from a fresh session: the drive from the JAX session's
    states, a free drive, rebase and compaction, a stop and resume, the
    resume of the JAX archive (saved again as the port's), and last (it
    patches ``leaky_relu``) the data-parallel training step."""
    return {
        "parity": drive(rank, device, cfg, scans_file, PARITY_SCANS, False,
                        forced_file),
        "free": drive(rank, device, cfg, scans_file, FREE_SCANS),
        "rebase": rebase_and_compact(rank, device, cfg, scans_file),
        "checkpoint": checkpoint_run(rank, device, cfg, scans_file, N_SCANS,
                                     STOP, f"{out_dir}/stop.npz"),
        "resume": resume_and_save(rank, device, cfg, scans_file, jax_ckpt,
                                  STOP, JAX_SCANS, f"{out_dir}/port.npz"),
        "train": train_step(rank, device, batch_file, sides_file)}


def sharded_gauss_newton(rank, device, maps_file, cases):
    """``ops.icp.gauss_newton(..., group=)`` on this rank's share of the
    data rows, for each case of ``cases`` (``{name: (max_iterations,
    IcpConfig fields)}``) on the maps of ``maps_file``
    (``{name}/data/{field}``, ``{name}/model/{field}``, ``inc``), at
    ``SumaConfig().small()``: the pose, the statistics, the iterations,
    the host reads the call made and the bits of the pose and the
    statistics (the lockstep check)."""
    from dataclasses import replace

    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import icp
    from semantic_suma_tpu_torch.parallel.distributed import Group
    z = np.load(maps_file)
    group = Group.world()
    cfg = SumaConfig().small()
    inc = torch.as_tensor(z["inc"])
    out = {}
    for name, (cap, fields) in cases.items():
        def maps(which):
            return icp.Maps(*(torch.as_tensor(z[f"{name}/{which}/{f}"])
                              for f in icp.Maps._fields))
        data = maps("data")
        rows = data.vertex.shape[0] // group.size
        mine = icp.Maps(*(a[group.rank * rows:(group.rank + 1) * rows]
                          for a in data))
        reads0 = to_host.count
        res = icp.gauss_newton(mine, maps("model"), inc,
                               replace(cfg.icp, **fields), cfg.model,
                               max_iterations=cap, group=group)
        reads = to_host.count - reads0
        bits = torch.cat([res.pose.reshape(-1).view(torch.int32),
                          *(s.reshape(1).view(torch.int32)
                            for s in res.stats)])
        out[name] = {"pose": res.pose.numpy().copy(),
                     "stats": {k: v.item()
                               for k, v in res.stats._asdict().items()},
                     "iterations": res.iterations, "reads": reads,
                     "bits": bits.numpy().copy()}
    return out


def fail_on_rank(rank, device, which, message):
    if rank == which:
        raise RuntimeError(message)
    return rank


def sleep(rank, device, seconds):
    import time
    time.sleep(seconds)
    return rank
