"""The odometry step's stages replayed as CUDA graphs (:class:`StepGraphs`).

Enqueued from Python, one scan of :func:`pipeline.odometry_step` is about
1,200 small launches, so the host's enqueueing, not the card, sets the pace.
Here each stage of the step is captured once into a CUDA graph and replayed
on every later scan, one launch a stage, by the session's
:class:`graphs.Replayer` (which decides, captures and counts):

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
The graphs' signature holds the buffers' addresses, and a first call is
one of the buffers' layout.
"""

from __future__ import annotations

import weakref

import torch

from ..config import SumaConfig
from ..graphs import Replayer
from ..ops import icp
from . import pipeline
from .preprocessing import empty_maps

# the stages, in the order a scan runs them
STAGES = ("preprocess", "gauss_newton", "fuse_render", "pack")

# the graphs and buffers of the last finished session, by (configuration,
# device): the next session of the configuration takes them, a session of
# another drops them
_SPARE: dict = {}


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


class StepGraphs:
    """CUDA graphs of one session's odometry step, with the buffers they
    read and write; the stages' methods have the signatures of the plain
    calls they replace (``pipeline._Eager``). On a CPU every call runs the
    stage eagerly on the buffers (``graphs.decide``'s ``"cpu"``).

    ``replayer`` runs the stages, one slot a stage and variant, and counts
    their calls for the session (``replayer.summary()``), each one also a
    lap ``graph/<stage>/...`` on the session's stopwatch (the CLI's
    ``--verbose`` and ``--stats-json`` report it)."""

    def __init__(self, cfg: SumaConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state: pipeline.SlamState | None = None
        self.replayer = Replayer(self.device, STAGES)
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
        graphs.replayer.reset(session.stopwatch)
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

    # -- the stages (pipeline._Eager's methods) ---------------------------
    def _run(self, stage: str, body, inputs: tuple = (), **kw) -> None:
        """One call of ``stage`` through the replayer: ``body`` writes into
        the buffers, whose addresses the graphs' signature holds."""
        self.replayer.run(stage, inputs, body, addresses=self._addresses,
                          context=self._layout_id, **kw)

    def preprocess(self, state, points, labels, probs, point_valid, cfg):
        def body(sw, scan):
            _put(self._maps, pipeline.preprocess_stage(self.state, *scan,
                                                       cfg))
        self._run("preprocess", body, (points, labels, probs, point_valid))
        return self._maps

    def align(self, state, data_maps, cfg) -> pipeline.Aligned:
        def body(sw, _):
            _put(self._aligned, pipeline.align_stage(self.state, self._maps,
                                                     cfg))
        self._run("gauss_newton", body)
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
        self._run("fuse_render", body, variant=refresh, stopwatch=stopwatch)
        return (st, *self._created)

    def pack(self, info: pipeline.StepInfo, block_count) -> torch.Tensor:
        # the track-loss flag as the device has it: the jump flag that the
        # host read
        info = info._replace(track_loss=self._aligned.flags[0])

        def body(sw, _):
            _put(self._packed, pipeline._pack_step_info(info, block_count))
        self._run("pack", body)
        return self._packed
