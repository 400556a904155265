"""Carry state across from the JAX package: the simulated world, the SLAM
state (a sharded session's shards too), the pose graph and the loop closer's
host state, so both packages can start from the same mid-run point; the
segmenter's weights both ways (flax variables for the darknet RangeNet; for
a network that has no flax tree, SalsaNext, the module's own state dict as
numpy arrays); and the state of its optimizer (optax's AdamW) into the
port's.

Nothing here imports JAX: the inputs are duck-typed (a JAX ``World``'s boxes,
or a JAX ``SlamState`` / ``MapState`` whose leaves were turned into numpy
arrays, e.g. with ``jax.tree.map(np.asarray, state)``; flax variables as
nested dicts of numpy arrays, as the weight files pickle them; an optax state
with numpy leaves).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import surfel_map as sm
from .core.pipeline import SlamState
from .device import resolve_device
from .io.simulation import Box, World
from .ops.icp import Maps


def world_from_numpy(boxes, ground_z: float = -1.8,
                     ground_label: int = 40) -> World:
    """A port ``World`` from boxes with ``center``, ``size`` and ``label``
    attributes (the JAX ``World.boxes``)."""
    return World(boxes=tuple(
        Box(tuple(float(c) for c in b.center), tuple(float(s) for s in b.size),
            int(b.label)) for b in boxes),
        ground_z=float(ground_z), ground_label=int(ground_label))


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def _packed(p, device) -> sm.PackedSurfels:
    return sm.PackedSurfels(f=_t(p.f, device, torch.float32),
                            i=_t(p.i, device, torch.int32))


def maps_from_numpy(m, device=None) -> Maps:
    """Port ``Maps`` from numpy-leaved JAX ``Maps``."""
    device = resolve_device(device)
    return Maps(vertex=_t(m.vertex, device, torch.float32),
                normal=_t(m.normal, device, torch.float32),
                vertex_valid=_t(m.vertex_valid, device, torch.bool),
                normal_valid=_t(m.normal_valid, device, torch.bool),
                sem_label=_t(m.sem_label, device, torch.int32),
                sem_prob=_t(m.sem_prob, device, torch.float32))


def map_state_from_numpy(m, device=None) -> sm.MapState:
    dev = resolve_device(device)
    return sm.MapState(
        data=_packed(m.data, dev),
        count=_t(m.count, dev, torch.int32),
        poses=_t(m.poses, dev, torch.float32),
        active_blocks=_t(m.active_blocks, dev, torch.int64),
        active=_packed(m.active, dev),
        active_count=_t(m.active_count, dev, torch.int32),
        block_count=_t(m.block_count, dev, torch.int32),
        anchor=_t(m.anchor, dev, torch.float32))


def slam_state_from_numpy(state, device=None):
    """A port ``SlamState`` from a numpy-leaved JAX ``SlamState``, or a port
    ``MapState`` from a numpy-leaved JAX ``MapState``."""
    dev = resolve_device(device)
    if not hasattr(state, "map"):
        return map_state_from_numpy(state, dev)
    return SlamState(
        map=map_state_from_numpy(state.map, dev),
        pose=_t(state.pose, dev, torch.float32),
        last_increment=_t(state.last_increment, dev, torch.float32),
        last_maps=maps_from_numpy(state.last_maps, dev),
        model_maps=maps_from_numpy(state.model_maps, dev),
        timestamp=_t(state.timestamp, dev, torch.int32))


def posegraph_from_jax(poses, edges):
    """A port ``Posegraph`` from a JAX ``Posegraph``'s host lists: its poses
    (``g.poses()``, numpy [4,4] each) and edge tuples (``g._edges``:
    ``(i, j, z, info, robust)`` with numpy leaves)."""
    from .core.posegraph import Posegraph
    g = Posegraph()
    for k, p in enumerate(poses):
        g.set_initial(k, np.asarray(p, np.float32))
    for i, j, z, info, *rest in edges:
        g.add_edge(int(i), int(j), np.asarray(z), np.asarray(info),
                   robust=bool(rest[0]) if rest else False)
    return g


_LOOP_HOST_FIELDS = ("already_verified", "time_without_loop", "loop_count",
                     "num_optimizations", "num_loop_closures", "num_rebases",
                     "num_soft_integrations", "sync_request", "pipelined_ok")


def loop_state_from_jax(src, dst):
    """Copy the host fields of a JAX ``LoopCloser`` ``src`` (duck-typed:
    counters, flags, anchors, candidates and the pose graph's host lists)
    into the port's ``LoopCloser`` ``dst`` so both continue from the same
    point. Device-side carries (the verification queue, the pose_old carry,
    a running optimization) are not carried: they restart empty."""
    from .core.loop_closure import LoopClosureCandidate
    for name in _LOOP_HOST_FIELDS:
        setattr(dst, name, getattr(src, name))
    for name in ("pose_old", "last_pose_old"):
        v = getattr(src, name)
        setattr(dst, name, None if v is None else np.array(v, np.float32))
    for name in ("unverified", "verified"):
        setattr(dst, name, [
            LoopClosureCandidate(int(c.frm), int(c.to),
                                 np.array(c.rel_pose, np.float32))
            for c in getattr(src, name)])
    dst.posegraph = posegraph_from_jax(src.posegraph.poses(),
                                       src.posegraph._edges)
    return dst


def spill_from_jax(src, dst, version: int | None = None):
    """Copy a JAX ``SpillManager`` ``src`` (duck-typed: its chunks' host
    rows and centroids, its page-in counter, its probe in flight) into the
    port's ``SpillManager`` ``dst``. The port keys a probe to the map
    version it scored, which the JAX package does not record: a JAX probe is
    carried keyed to ``version`` (the ``map_version`` of the converted
    ``SurfelSLAM``), and dropped when that is not given."""
    from .core.spill import SpillChunk
    from .device import AsyncFetch
    dst.chunks = []
    for c in src.chunks:
        chunk = SpillChunk(np.array(c.f, np.float32), np.array(c.i, np.int32))
        chunk.centroid = np.array(c.centroid, np.float32)
        dst.chunks.append(chunk)
    dst.chunks_paged_in = int(src.chunks_paged_in)
    dst._probe = None
    if src._probe is not None and version is not None:
        dst._probe = (AsyncFetch(torch.as_tensor(np.array(src._probe))),
                      int(version))
    return dst


# ---------------------------------------------------------------------------
# segmenter weights: flax variables <-> the port's RangeNet state dict. The
# port's modules carry flax's names, so a key is the flax path with dots;
# only the leaves are renamed and laid out again:
#   params/.../Conv_i/kernel [kh, kw, in, out] <-> ...Conv_i.weight
#       [out, in, kh, kw]
#   params/.../ConvTranspose_i/kernel [1, 4, in, out] <-> ...weight
#       [in, out, 1, 4], flipped along the width (flax does not flip)
#   params/.../{bias, scale}, batch_stats/.../{mean, var}: unchanged
# ---------------------------------------------------------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def rangenet_state_from_flax(variables) -> dict:
    """The port's ``RangeNet`` state dict from flax variables (``params``
    and ``batch_stats``, nested dicts of numpy arrays)."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flat(variables.get(coll, {})):
            *mods, leaf = path
            if leaf == "kernel":
                if mods[-1].startswith("ConvTranspose"):
                    a = a.transpose(2, 3, 0, 1)[..., ::-1]
                else:
                    a = a.transpose(3, 2, 0, 1)
                leaf = "weight"
            out[".".join(mods + [leaf])] = torch.from_numpy(np.array(a))
    return out


def flax_variables_from_rangenet(state_dict) -> dict:
    """The reverse of :func:`rangenet_state_from_flax`: flax variables as
    nested dicts of numpy arrays."""
    out = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            if mods[-1].startswith("ConvTranspose"):
                a = a[..., ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(2, 3, 1, 0)
            leaf = "kernel"
        node = out["batch_stats" if leaf in ("mean", "var") else "params"]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


# ---------------------------------------------------------------------------
# the weights of a network that has no flax tree (SalsaNext): the module's
# own state dict, {dotted key: array} in PyTorch's layout, under the blob's
# "variables"
# ---------------------------------------------------------------------------

def arrays_from_state(state_dict) -> dict:
    """A module's state dict as the weights file keeps it: ``{key: numpy
    array}``, the keys and layouts PyTorch's."""
    return {k: np.ascontiguousarray(t.detach().cpu().numpy())
            for k, t in state_dict.items()}


def state_from_arrays(arrays) -> dict:
    """The reverse of :func:`arrays_from_state`."""
    return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}


def adamw_state_from_optax(opt_state, model) -> dict:
    """The port's AdamW state from the state of ``optax.adamw`` (its leaves
    as numpy arrays, e.g. ``jax.tree.map(np.asarray, opt_state)``): the
    first and second moments ``mu`` and ``nu``, laid out as
    :func:`rangenet_state_from_flax` lays out the parameters, and the step
    ``count``. Returns ``{parameter: {"step", "exp_avg", "exp_avg_sq"}}``
    keyed by the parameters of ``model`` (a port ``RangeNet``), for
    ``optimizer.state.update``."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu = rangenet_state_from_flax({"params": adam.mu})
    nu = rangenet_state_from_flax({"params": adam.nu})
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    out = {}
    for name, p in model.named_parameters():
        out[p] = {"step": step.clone(),
                  "exp_avg": mu[name].to(p.device, p.dtype),
                  "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    return out


def sharded_state_from_jax(map_sh, rank: int, device=None) -> sm.MapState:
    """Rank ``rank``'s ``MapState`` from a JAX ``ShardedSurfelSLAM.map_sh``
    whose leaves (numpy, e.g. ``jax.tree.map(np.asarray, slam.map_sh)``)
    carry a leading ``[D]`` shard axis."""
    def take(tree):
        return type(tree)(*[take(x) if hasattr(x, "_fields")
                            else np.asarray(x)[rank] for x in tree])
    return map_state_from_numpy(take(map_sh), device)
