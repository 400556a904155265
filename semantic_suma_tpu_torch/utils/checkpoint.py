"""Checkpoint / resume of a single-device SLAM session (counterpart of
``semantic_suma_tpu/utils/checkpoint.py``).

The whole session (the surfel map, compacted by default, the pose table, the
pipeline state, the host pose log and statistics, the pose graph and the
loop-closure state machine, and the spilled chunks) goes into one ``.npz``
archive in the JAX package's layout, so that an archive of either package
resumes in the other:

* the state's leaves keyed by their NamedTuple path (``map/data/f``,
  ``map/active_blocks``, ``last_maps/vertex``, ...), each in the dtype the
  JAX package stores (the port's int64 ``active_blocks`` is written as
  int32 and cast back on load);
* ``__host__``: the host blob as JSON bytes;
* ``__loop__``: the loop closer's host state as a pickle (empty without loop
  closure);
* ``__spill_f_<n>__`` / ``__spill_i_<n>__``: the rows of spilled chunk n.

A JAX archive pickles the JAX package's ``LoopClosureCandidate``. The loader
unpickles ``__loop__`` with :class:`_LoopUnpickler`, which maps that class
to the port's own (same fields), allows builtins and numpy, and refuses
anything else, so a JAX session resumes without importing JAX.

A sharded session (``parallel.sharding.ShardedSurfelSLAM``) goes into the
JAX package's sharded layout: ``__ndev__``, every shard's MapState under
``shard{d}/<path>``, the replicated pipeline arrays under ``repl/...``, the
host and loop blobs, and shard d's spilled chunks as ``__spill{d}_f_<n>__``
/ ``__spill{d}_i_<n>__``. Rank 0 gathers the shards and writes the archive;
on load every rank reads its own shard.
"""

from __future__ import annotations

import io
import json
import pickle
from typing import Optional

import numpy as np
import torch

from ..device import AsyncFetch

# the leaf type the JAX package stores narrower (it runs without 64-bit
# types): the port's int64 ``active_blocks``
_JAX_DTYPE = {torch.int64: np.int32}


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{"map/data/f": tensor, ...}``: the leaves of nested NamedTuples
    keyed by their field path, as ``jax.tree_util`` names them."""
    out = {}
    for name, leaf in zip(tree._fields, tree):
        key = f"{prefix}{name}"
        if hasattr(leaf, "_fields"):
            out.update(_flatten_with_paths(leaf, key + "/"))
        else:
            out[key] = leaf
    return out


def _unflatten(template, leaves: dict, prefix: str = ""):
    return type(template)(*[
        _unflatten(leaf, leaves, f"{prefix}{name}/")
        if hasattr(leaf, "_fields") else leaves[f"{prefix}{name}"]
        for name, leaf in zip(template._fields, template)])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    a = AsyncFetch(t).wait()
    return a.astype(_JAX_DTYPE.get(t.dtype, a.dtype), copy=False)


def _host_blob(slam) -> dict:
    return {
        "poses": [np.asarray(p).tolist() for p in slam.poses],
        "trajectory_distances": list(slam.trajectory_distances),
        "track_loss_count": int(slam.track_loss_count),
        "statistics": slam.statistics,
        # device->output correction pending from a below-gate integration
        # (identity in the common case)
        "frame_correction": np.asarray(slam.frame_correction).tolist(),
    }


def _loop_blob(slam) -> bytes:
    if slam._loop is None:
        return b""
    lc = slam._loop
    return pickle.dumps({
        "posegraph_poses": lc.posegraph._poses,
        "posegraph_edges": lc.posegraph._edges,
        "unverified": lc.unverified,
        "verified": lc.verified,
        "already_verified": lc.already_verified,
        "time_without_loop": lc.time_without_loop,
        "loop_count": lc.loop_count,
        "pose_old": lc.pose_old,
        "last_pose_old": lc.last_pose_old,
        "num_loop_closures": lc.num_loop_closures,
    })


_CANDIDATE_MODULES = ("semantic_suma_tpu.core.loop_closure",
                      "semantic_suma_tpu_torch.core.loop_closure")
_NUMPY_NAMES = {"_reconstruct", "scalar", "ndarray", "dtype", "_frombuffer"}
_BUILTIN_NAMES = {"set", "frozenset", "complex", "slice", "range",
                  "bytearray", "list", "dict", "tuple", "int", "float",
                  "bool", "str", "bytes"}


class _LoopUnpickler(pickle.Unpickler):
    """Unpickles a ``__loop__`` blob of either package: the candidates of
    both map to the port's ``LoopClosureCandidate``; numpy arrays, dtypes
    and scalars and the plain builtin types are allowed; any other global
    raises."""

    def find_class(self, module, name):
        if module in _CANDIDATE_MODULES and name == "LoopClosureCandidate":
            from ..core.loop_closure import LoopClosureCandidate
            return LoopClosureCandidate
        if (module == "numpy" or module.startswith(("numpy.core",
                                                     "numpy._core"))) \
                and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTIN_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint loop blob: {module}.{name} is not allowed")


def _restore_loop(slam, loop_blob: bytes) -> None:
    if not loop_blob or slam._loop is None:
        return
    blob = _LoopUnpickler(io.BytesIO(loop_blob)).load()
    lc = slam._loop
    lc.posegraph._poses = blob["posegraph_poses"]
    lc.posegraph._edges = blob["posegraph_edges"]
    lc.unverified = blob["unverified"]
    lc.verified = blob["verified"]
    lc.already_verified = blob["already_verified"]
    lc.time_without_loop = blob["time_without_loop"]
    lc.loop_count = blob["loop_count"]
    lc.pose_old = blob["pose_old"]
    lc.last_pose_old = blob["last_pose_old"]
    lc.num_loop_closures = blob["num_loop_closures"]


def save_checkpoint(slam, path: str, compact_map: bool = True) -> None:
    """Serialize a ``SurfelSLAM`` session (device and host state). The
    session must have no scan in flight (``flush()`` first): the host pose
    log would otherwise lag the device state."""
    from ..core import surfel_map as sm

    if not hasattr(slam, "state"):
        if hasattr(slam, "mesh"):
            return save_checkpoint_sharded(slam, path)
        raise ValueError(
            f"not a checkpointable SLAM session: {type(slam).__name__}")
    if slam._inflight():
        raise ValueError(f"{slam._inflight()} scans in flight: call "
                         "flush() before save_checkpoint")
    state = slam.state
    if compact_map:
        state = state._replace(map=sm.compact(state.map, slam.cfg.map))

    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(state).items()}
    spill_arrays = {}
    if slam.spill is not None:
        for n, chunk in enumerate(slam.spill.chunks):
            spill_arrays[f"__spill_f_{n}__"] = chunk.f
            spill_arrays[f"__spill_i_{n}__"] = chunk.i

    np.savez_compressed(
        path,
        __host__=np.frombuffer(json.dumps(_host_blob(slam)).encode(),
                               dtype=np.uint8),
        __loop__=np.frombuffer(_loop_blob(slam), dtype=np.uint8),
        **spill_arrays, **arrays)


def save_checkpoint_sharded(slam, path: str) -> None:
    """Serialize a ``ShardedSurfelSLAM`` session. Every rank calls it (the
    shards and the spilled chunks are gathered to every rank); rank 0
    writes ``path``. The session must have no scan in flight."""
    if slam._inflight():
        raise ValueError(f"{slam._inflight()} scans in flight: call "
                         "flush() before save_checkpoint")
    group = slam.group
    arrays = {"__ndev__": np.asarray(slam.ndev, np.int32)}
    for k, v in _flatten_with_paths(slam.local).items():
        every = group.gather(v)
        if group.rank == 0:
            for d in range(slam.ndev):
                arrays[f"shard{d}/{k}"] = _to_numpy(every[d])
    chunks = [(c.f, c.i) for c in slam.spill.chunks] if slam.spill else []
    every_chunks = group.objects(chunks) if slam.spill is not None else []
    if group.rank != 0:
        return
    for name in ("pose", "last_increment"):
        arrays[f"repl/{name}"] = _to_numpy(getattr(slam, name))
    for name in ("last_maps", "model_maps"):
        for k, v in _flatten_with_paths(getattr(slam, name)).items():
            arrays[f"repl/{name}/{k}"] = _to_numpy(v)
    for d, shard_chunks in enumerate(every_chunks):
        for n, (f, i) in enumerate(shard_chunks):
            arrays[f"__spill{d}_f_{n}__"] = f
            arrays[f"__spill{d}_i_{n}__"] = i
    np.savez_compressed(
        path,
        __host__=np.frombuffer(json.dumps(_host_blob(slam)).encode(),
                               dtype=np.uint8),
        __loop__=np.frombuffer(_loop_blob(slam), dtype=np.uint8),
        **arrays)


def _load_leaves(data, prefix: str, template) -> dict:
    leaves = {}
    for key, leaf in _flatten_with_paths(template).items():
        stored = data[prefix + key]
        if stored.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint field {prefix}{key} has shape {stored.shape}, "
                f"config expects {tuple(leaf.shape)} — use the same "
                "capacities")
        leaves[key] = torch.as_tensor(stored, dtype=leaf.dtype,
                                      device=leaf.device)
    return leaves


def load_checkpoint_sharded(path: str, cfg, mesh, axis: str = "map",
                            enable_loop_closure: Optional[bool] = None):
    """Restore a session saved by ``save_checkpoint_sharded`` of either
    package onto ``mesh`` (this rank reads its own shard); the shard count
    and the capacities must match."""
    from ..parallel.sharding import ShardedSurfelSLAM

    data = np.load(path, allow_pickle=False)
    slam = ShardedSurfelSLAM(cfg, mesh, axis=axis,
                             enable_loop_closure=enable_loop_closure)
    ndev = int(data["__ndev__"])
    if ndev != slam.ndev:
        raise ValueError(f"checkpoint has {ndev} shards, mesh has "
                         f"{slam.ndev}")
    d = mesh.rank
    slam.local = _unflatten(slam.local,
                            _load_leaves(data, f"shard{d}/", slam.local))
    dev = slam.device
    slam.pose = torch.as_tensor(data["repl/pose"], dtype=torch.float32,
                                device=dev)
    slam.last_increment = torch.as_tensor(data["repl/last_increment"],
                                          dtype=torch.float32, device=dev)
    for name in ("last_maps", "model_maps"):
        t = getattr(slam, name)
        setattr(slam, name,
                _unflatten(t, _load_leaves(data, f"repl/{name}/", t)))

    host = json.loads(bytes(data["__host__"]).decode())
    slam.poses = [np.asarray(p, np.float32) for p in host["poses"]]
    slam._dispatched = len(slam.poses)
    slam.trajectory_distances = list(host["trajectory_distances"])
    slam.track_loss_count = int(host.get("track_loss_count", 0))
    slam.statistics = host["statistics"]
    slam.frame_correction = np.asarray(
        host.get("frame_correction", np.eye(4)), np.float32)
    _restore_loop(slam, bytes(data["__loop__"]))
    if slam.spill is not None:
        from ..core.spill import SpillChunk
        mgr = slam.spill
        n = 0
        while f"__spill{d}_f_{n}__" in data:
            mgr.chunks.append(SpillChunk(data[f"__spill{d}_f_{n}__"],
                                         data[f"__spill{d}_i_{n}__"]))
            n += 1
        if mgr.chunks:
            mgr.on_rebase(AsyncFetch(slam.local.poses).wait())
    return slam


def load_checkpoint(path: str, cfg, enable_loop_closure: Optional[bool] = None,
                    device=None):
    """Restore a session saved by :func:`save_checkpoint` of either package
    into a fresh ``SurfelSLAM`` on ``device`` (the card unless named). The
    configuration must give the archive's shapes; the poses of the host log
    load as float32, the type the session appends."""
    from ..core.pipeline import SurfelSLAM

    data = np.load(path, allow_pickle=False)
    slam = SurfelSLAM(cfg, enable_loop_closure=enable_loop_closure,
                      device=device)

    template = _flatten_with_paths(slam.state)
    leaves = {}
    for key, leaf in template.items():
        stored = data[key]
        if stored.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint field {key} has shape {stored.shape}, config "
                f"expects {tuple(leaf.shape)} — use the same capacities")
        leaves[key] = torch.as_tensor(stored, dtype=leaf.dtype,
                                      device=leaf.device)
    slam.state = _unflatten(slam.state, leaves)

    host = json.loads(bytes(data["__host__"]).decode())
    slam.poses = [np.asarray(p, np.float32) for p in host["poses"]]
    # the dispatch counter drives the confidence-threshold warmup; resume
    # must continue it where the saved session left off
    slam._dispatched = len(slam.poses)
    slam.trajectory_distances = list(host["trajectory_distances"])
    slam.track_loss_count = int(host["track_loss_count"])
    slam.statistics = host["statistics"]
    if "frame_correction" in host:
        slam.frame_correction = np.asarray(host["frame_correction"],
                                           np.float32)

    _restore_loop(slam, bytes(data["__loop__"]))

    if slam.spill is not None:
        from ..core.spill import SpillChunk
        n = 0
        while f"__spill_f_{n}__" in data:
            slam.spill.chunks.append(SpillChunk(data[f"__spill_f_{n}__"],
                                                data[f"__spill_i_{n}__"]))
            n += 1
        # a chunk's centroid comes from its cached world positions, which
        # are stale if the session rebased after spilling: re-derive every
        # centroid from the restored pose table
        if slam.spill.chunks:
            slam.spill.on_rebase(AsyncFetch(slam.state.map.poses).wait())
    return slam
