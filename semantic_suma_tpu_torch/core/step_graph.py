"""The odometry step's stages replayed as CUDA graphs (:class:`StepGraphs`).

Enqueued from Python, one scan of :func:`pipeline.odometry_step` is about
1,200 small launches, each costing the host more than the card takes to run
it, so the host's enqueueing, not the card, sets the pace. Here each stage of
the step is captured once into a CUDA graph and replayed on every later
scan, one launch a stage:

* ``preprocess``: :func:`pipeline.preprocess_stage`;
* ``gauss_newton``: :func:`pipeline.align_stage`, the stage up to the
  host's flag read (kernel F, the moved pose, the branch flags);
* ``fuse_render``: :func:`pipeline.fuse_stage`, one graph for each value of
  the refresh flag the host has read;
* ``pack``: the packing of the scan's results into one row.

The flag read, the host's SVD and a fallback scan's recovery solve run
between the replays, as they run between the stages without graphs. Every
kernel stays the hand-written one, launched from the graph.

A graph reads and writes fixed addresses, so the session's state lives in
buffers of the ``StepGraphs`` (:meth:`StepGraphs.enter`): the state's arena,
pose table and active view are taken over as they are, every other field is
copied into a buffer of its own. The stages write their results into buffers
as well: the data maps, Gauss-Newton's result with the increment, the moved
pose and the flag vector, the state itself (in place) with the creation
counts, and the packed row. Per-scan host values become device inputs: the
scan's arrays are copied into the graph's input buffers, the confidence
threshold into a float32 on the device, and the track-loss flag that
``pack`` writes is the device's own jump flag. A state that the host loop
replaces (a page-in, a spill, a compaction, a rebase, the loop closer's
model render, a resume) is copied into the buffers, so the graphs'
addresses hold; a state of other shapes gets new buffers, which the graphs
then do not read: they are captured again. A finished session hands its
graphs and buffers on to the next session of its configuration
(:meth:`StepGraphs.for_session`), whose first state takes over the arena
and the active view: a benchmark's or a batch's sessions capture once.

:func:`decide` says, for each stage and scan, whether its graph replays, is
captured, or the stage runs eagerly, from what it observes: the device, a
sharding group, a capture already in progress, whether the process has run
the stage's shapes before (a first call makes one-time allocations, such as
kernel B's key tables, that a capture cannot make), and the shapes and
buffer addresses against those of the graph. The counters that the stages'
Python bumps (kernel launches, ``gauss_newton`` calls) count once a replay.
The segmenter's network (``models/segmenter.py``) is replayed by the same
:func:`decide`, captured by :func:`capture` on the same stream.
"""

from __future__ import annotations

import time
import weakref
from collections import Counter
from typing import NamedTuple

import torch

from ..config import SumaConfig
from ..device import to_host
from ..ops import bilateral, icp, knn, zbuffer
from ..utils.timing import Stopwatch
from . import pipeline
from .preprocessing import empty_maps

# the stages, in the order a scan runs them
STAGES = ("preprocess", "gauss_newton", "fuse_render", "pack")

# the graphs and buffers of the last finished session, by (configuration,
# device): the next session of the configuration takes them, a session of
# another drops them
_SPARE: dict = {}

# the stream each device's graphs are captured on: one for the process, so
# that the libraries' per-stream state (cuBLAS's workspace) is made once
_STREAMS: dict = {}

# (device, stage, variant, input shapes, the buffers' layout) of the stage
# calls this process has made eagerly: only those may be captured
_SEEN: set = set()


def decide(*, device_type: str, grouped: bool, capturing: bool, seen: bool,
           signature, captured, last) -> tuple:
    """``(action, reason)`` for one call of a stage: ``"replay"`` its graph,
    ``"capture"`` one (and replay it), or ``"eager"``, with the reason the
    graph does not run: ``"cpu"`` (no CUDA device), ``"group"`` (the
    sharded step), ``"capturing"`` (the caller's stream is being captured
    already), ``"first call"`` (the process has not run these shapes),
    ``"shape"`` or ``"pointer"`` (the inputs' shapes, or the buffers'
    addresses, differ from the graph's). ``signature`` is ``(shapes,
    addresses)`` of this call, ``captured`` the graph's (None: no graph)
    and ``last`` the previous call's: a signature that differs from the
    graph's runs eagerly once and is captured when the next call repeats
    it, so that inputs that change every call (KITTI scans of varying
    length) never capture."""
    if device_type != "cuda":
        return "eager", "cpu"
    if grouped:
        return "eager", "group"
    if capturing:
        return "eager", "capturing"
    if not seen:
        return "eager", "first call"
    if captured is None:
        return "capture", None
    if signature == captured:
        return "replay", None
    if signature != last:
        return "eager", ("shape" if signature[0] != captured[0]
                         else "pointer")
    return "capture", None


def capture(graph, pool, device, body):
    """Capture ``body()`` into ``graph``, its memory from ``pool``, on
    ``device``'s capture stream (:data:`_STREAMS`), which first waits for
    the current stream, and the current stream for it after; returns what
    ``body`` returned (tensors the replays write)."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        # thread-local: a background thread's CUDA calls (the pose graph's
        # solve) do not break the capture
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = body()
        except BaseException:
            try:
                graph.capture_end()
            except Exception:  # the capture failed with the body
                pass
            raise
        graph.capture_end()
    cur.wait_stream(stream)
    return out


# -- the counters a stage's Python bumps ---------------------------------

def _slots():
    """``(name, owner, key)`` of every counter that the stages' code bumps:
    an attribute of a function, or an entry of a dict."""
    return [("bilateral_filter", bilateral.bilateral_filter, "launches"),
            ("zbuffer_cells", zbuffer.zbuffer_cells, "launches"),
            ("knn_clean_image", knn.knn_clean_image, "launches"),
            ("icp_products", icp.icp_products, "launches"),
            ("gn_update", icp.gn_update, "launches"),
            ("gn_loop", icp.gn_loop, "launches"),
            ("evaluate", icp.evaluate, "calls"),
            ("gn_calls", icp.gn_counts, "calls"),
            ("gn_iterations", icp.gn_counts, "iterations"),
            ("build_rows", icp.plain_on_cuda, "build_rows"),
            ("to_host", to_host, "count")]


def _get(owner, key):
    return owner[key] if isinstance(owner, dict) else getattr(owner, key)


def _set(owner, key, value) -> None:
    if isinstance(owner, dict):
        owner[key] = value
    else:
        setattr(owner, key, value)


def counter_values() -> dict:
    """The counters' values by name; kernel B's launches by shape under
    ``("zbuffer_cells_by_shape", shape)``."""
    vals = {name: _get(owner, key) for name, owner, key in _slots()}
    for shape, n in zbuffer.zbuffer_cells.launches_by_shape.items():
        vals[("zbuffer_cells_by_shape", shape)] = n
    return vals


def counter_delta(before: dict, after: dict) -> dict:
    """What changed from ``before`` to ``after``."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def counter_add(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` to the counters, as they stand now (a caller
    may have replaced an owner's dict or attribute since ``delta`` was
    taken)."""
    slots = {name: (owner, key) for name, owner, key in _slots()}
    by_shape = zbuffer.zbuffer_cells.launches_by_shape
    for name, d in delta.items():
        if isinstance(name, tuple):
            by_shape[name[1]] = by_shape.get(name[1], 0) + sign * d
        else:
            owner, key = slots[name]
            _set(owner, key, _get(owner, key) + sign * d)


# -- trees of tensors ----------------------------------------------------

def _leaves(tree):
    """The tensors of a tensor or of nested tuples of them, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def _layout(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(tree))


def _put(dst, src) -> None:
    """Copy each tensor of ``src`` into the tensor at its place in ``dst``,
    where it is not that tensor already; shapes and types must agree."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"step graphs: a {tuple(s.shape)} {s.dtype} "
                             f"value for a {tuple(d.shape)} {d.dtype} buffer")
        if d.data_ptr() == s.data_ptr() and d.stride() == s.stride():
            continue
        d.copy_(s)


def _rebuild(tree, fn):
    """``tree`` with each tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_rebuild(x, fn) for x in tree))


def _adopt(state: pipeline.SlamState) -> pipeline.SlamState:
    """The buffers of a session's state: the arena, the pose table and the
    active view as they are (the step writes them in place already; no
    second copy of them is kept), every other field a copy of its own (a
    field may be a view of another, or a tensor someone else holds)."""
    m = state.map
    big = {id(t) for t in (m.data.f, m.data.i, m.poses, m.active.f,
                           m.active.i)}
    return _rebuild(state, lambda t: t if id(t) in big else t.clone())


def _keep(key, graphs) -> None:
    """A session ended: its graphs become the spare."""
    _SPARE.clear()
    _SPARE[key] = graphs


class _Graph(NamedTuple):
    graph: object       # torch.cuda.CUDAGraph
    signature: tuple
    counts: dict        # the counters' increments of one run
    inputs: tuple       # the input buffers it reads (preprocess)


class StepGraphs:
    """CUDA graphs of one session's odometry step, with the buffers they
    read and write; the stages' methods have the signatures of the plain
    calls they replace (``pipeline._Eager``). On a CPU every call runs the
    stage eagerly on the buffers (:func:`decide`'s ``"cpu"``).

    ``counts[stage]`` counts the calls of each stage by what they did
    (``capture``, ``replay``, ``eager``: a capture's call replays the new
    graph once and counts as a capture), ``invalidations`` the eager calls
    by :func:`decide`'s reason, and ``capture_s`` the host seconds of the
    captures; with a ``stopwatch`` each call is also its lap
    ``graph/<stage>/<action>``, an eager one ``graph/<stage>/eager/<reason>``
    (the session's stopwatch: the CLI's ``--verbose`` and ``--stats-json``
    report it)."""

    def __init__(self, cfg: SumaConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.stopwatch: Stopwatch | None = None
        self.state: pipeline.SlamState | None = None
        self.counts = {s: Counter() for s in STAGES}
        self.invalidations: Counter = Counter()
        self.capture_s = 0.0
        self._graphs: dict = {}   # (stage, variant) -> _Graph
        self._last: dict = {}     # (stage, variant) -> last call's signature
        self._pool = None
        self._conf_value = None

    @classmethod
    def for_session(cls, session) -> "StepGraphs":
        """The step graphs of a new session (its ``cfg``, ``device`` and
        ``stopwatch``): a finished session's of the same configuration and
        device, or new ones (the spare of another is dropped). When the
        session is collected they become the spare: the next session's
        first state takes their state's arena and active view
        (``pipeline.init_state``'s ``reuse``) and copies the rest into their
        buffers, and its stages replay from its first scan, with no
        capture."""
        key = (session.cfg, session.device)
        graphs = _SPARE.pop(key, None)
        _SPARE.clear()
        if graphs is None:
            graphs = cls(session.cfg, session.device)
        graphs.stopwatch = session.stopwatch
        graphs.counts = {s: Counter() for s in STAGES}
        graphs.invalidations = Counter()
        graphs.capture_s = 0.0
        done = weakref.finalize(session, _keep, key, graphs)
        done.atexit = False
        return graphs

    # -- buffers ---------------------------------------------------------
    def _allocate(self) -> None:
        """The stages' result buffers (the state's are :meth:`enter`'s)."""
        dev = self.device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        self._maps = empty_maps(self.cfg, dev)
        self._aligned = pipeline.Aligned(
            result=icp.gn_result(*icp.gn_state(eye)), increment=eye.clone(),
            moved=eye.clone(),
            flags=torch.zeros(11, dtype=torch.float32, device=dev))
        self._created = tuple(torch.zeros((), dtype=torch.int64, device=dev)
                              for _ in range(2))
        self._packed = torch.zeros(50, dtype=torch.float32, device=dev)
        self._conf = torch.zeros((), dtype=torch.float32, device=dev)

    def enter(self, state: pipeline.SlamState) -> pipeline.SlamState:
        """The step's state in the graphs' buffers: ``state`` copied into
        them where it differs from them (nothing is copied where it is
        their own state), or, for a first state or one of other shapes, new
        buffers made from it (:func:`_adopt`). Returns the buffers' state,
        which the stages then read and update."""
        if state is self.state:
            return state
        if self.state is not None and _layout(self.state) == _layout(state):
            _put(self.state, state)
            return self.state
        if self.state is None:
            self._allocate()
        self.state = _adopt(state)
        buffers = (self.state, self._maps, self._aligned, self._created,
                   self._packed, self._conf)
        self._addresses = tuple(t.data_ptr() for t in _leaves(buffers))
        self._layout_id = hash(_layout(buffers))
        return self.state

    # -- one call of a stage ---------------------------------------------
    def _run(self, stage: str, variant, body, stopwatch=None,
             inputs: tuple = ()) -> None:
        """Run ``body(stopwatch, inputs)`` (the stage, writing into the
        buffers) as :func:`decide` says: eagerly on ``inputs``, or from a
        graph that reads buffers of their shapes, into which they are
        copied first."""
        key = (stage, variant)
        dev = self.device
        shapes = _layout(inputs)
        sig = (shapes, self._addresses)
        first = (dev, stage, variant, shapes, self._layout_id)
        graph = self._graphs.get(key)
        action, why = decide(
            device_type=dev.type, grouped=False,
            capturing=(dev.type == "cuda"
                       and torch.cuda.is_current_stream_capturing()),
            seen=first in _SEEN, signature=sig,
            captured=None if graph is None else graph.signature,
            last=self._last.get(key))
        self._last[key] = sig
        t0 = time.perf_counter()
        if action == "capture":
            try:
                graph = self._capture(body, sig, inputs)
            except zbuffer.FirstCallUnderCapture:
                action, why = "eager", "first call"
            else:
                self._graphs[key] = graph
        if action == "eager":
            body(stopwatch, inputs)
            _SEEN.add(first)
            self.invalidations[why] += 1
        else:
            _put(graph.inputs, inputs)
            graph.graph.replay()
            counter_add(graph.counts)
        self.counts[stage][action] += 1
        sw = self.stopwatch
        if sw is not None:
            label = f"graph/{stage}/{action}"
            sw.record(label if why is None else f"{label}/{why}",
                      time.perf_counter() - t0)

    def _capture(self, body, sig, inputs) -> _Graph:
        """Capture ``body`` on buffers like ``inputs`` into a graph of the
        graphs' memory pool, on the device's capture stream. The counters
        the capture bumped are taken back: each replay adds them."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        buffers = tuple(torch.empty_like(t) for t in inputs)
        graph = torch.cuda.CUDAGraph()
        before = counter_values()
        t0 = time.perf_counter()
        try:
            capture(graph, self._pool, self.device,
                    lambda: body(None, buffers))
        finally:
            delta = counter_delta(before, counter_values())
            counter_add(delta, -1)
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, sig, delta, buffers)

    # -- the stages (pipeline._Eager's methods) ---------------------------
    def preprocess(self, state, points, labels, probs, point_valid, cfg):
        def body(sw, scan):
            _put(self._maps, pipeline.preprocess_stage(self.state, *scan,
                                                       cfg))
        self._run("preprocess", None, body,
                  inputs=(points, labels, probs, point_valid))
        return self._maps

    def align(self, state, data_maps, cfg) -> pipeline.Aligned:
        def body(sw, _):
            _put(self._aligned, pipeline.align_stage(self.state, self._maps,
                                                     cfg))
        self._run("gauss_newton", None, body)
        return self._aligned

    def fuse(self, state, data_maps, new_pose, increment, refresh,
             conf_threshold, cfg, stopwatch=None):
        st = self.state
        # the new pose and increment go into the state's own fields: the
        # stages before have read the old ones already
        _put(st.pose, new_pose)
        _put(st.last_increment, increment)
        if conf_threshold != self._conf_value:
            self._conf.fill_(conf_threshold)
            self._conf_value = conf_threshold

        def body(sw, _):
            new_state, n_created, n_dropped = pipeline.fuse_stage(
                st, self._maps, st.pose, st.last_increment, refresh,
                self._conf, cfg, sw)
            _put(st, new_state)
            _put(self._created, (n_created, n_dropped))
        self._run("fuse_render", refresh, body, stopwatch)
        return (st, *self._created)

    def pack(self, info: pipeline.StepInfo, block_count) -> torch.Tensor:
        # the track-loss flag as the device has it: the jump flag that the
        # host read
        info = info._replace(track_loss=self._aligned.flags[0])

        def body(sw, _):
            _put(self._packed, pipeline._pack_step_info(info, block_count))
        self._run("pack", None, body)
        return self._packed

    # -- the report ------------------------------------------------------
    def summary(self) -> dict:
        """The calls of each stage by what they did, the eager calls by
        reason, and the captures' host milliseconds."""
        return {"captures": {s: self.counts[s]["capture"] for s in STAGES},
                "replays": {s: self.counts[s]["replay"] for s in STAGES},
                "eager": {s: self.counts[s]["eager"] for s in STAGES},
                "invalidations": dict(self.invalidations),
                "capture_ms": self.capture_s * 1e3}
