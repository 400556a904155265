"""Calls replayed as CUDA graphs: the odometry step's stages
(``core/step_graph.py``) and the segmenter's network
(``models/segmenter.py``), each through a :class:`Replayer` of its owner's.

A call of many small kernels enqueued from Python costs the host more than
the card takes to run it. A replayer captures the call once into a CUDA
graph and replays it on every later call of the same signature, one launch
instead of one a kernel. :meth:`Replayer.run` is the one place that
decides, by :func:`decide`, whether a call replays, captures or runs
eagerly, and accounts for it. A capture runs on the device's capture stream
(one for the process, so that the libraries' per-stream state is made
once), in the owner's memory pool, on input buffers that the replays copy
the inputs into; a replay hands on what the capture's body returned. The
counters that the body's Python bumps (kernel launches, ``gauss_newton``
calls) are taken back after a capture and added once a replay, so they
count as if the call ran eagerly.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import NamedTuple

import torch

from .device import to_host
from .ops import bilateral, epilogue, icp, knn, sac, zbuffer
from .utils.timing import Stopwatch

# the stream each device's graphs are captured on: one for the process, so
# that the libraries' per-stream state (cuBLAS's workspace) is made once
_STREAMS: dict = {}

# (device, key, input shapes, the owner's context) of the calls this
# process has made eagerly: only those may be captured
_SEEN: set = set()


def decide(*, device_type: str, grouped: bool, capturing: bool, seen: bool,
           signature, captured, last) -> tuple:
    """``(action, reason)`` for one call: ``"replay"`` its graph,
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


def capture(pool, device, body) -> tuple:
    """Capture ``body()`` into a new CUDA graph, its memory from ``pool``
    (None: a new pool, the graph's ``pool()``), on ``device``'s capture
    stream (:data:`_STREAMS`), which first waits for the current stream,
    and the current stream for it after. Returns the graph and what
    ``body`` returned (tensors the replays write)."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
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
    return graph, out


# -- the counters a call's Python bumps ----------------------------------

def _slots():
    """``(name, owner, key)`` of every counter that the graphed code bumps:
    an attribute of a function, or an entry of a dict."""
    return [("bilateral_filter", bilateral.bilateral_filter, "launches"),
            ("zbuffer_cells", zbuffer.zbuffer_cells, "launches"),
            ("knn_clean_image", knn.knn_clean_image, "launches"),
            ("bn_act", epilogue.bn_act, "launches"),
            ("sac_modulate", sac.sac_modulate, "launches"),
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


# -- the replayer --------------------------------------------------------

class _Graph(NamedTuple):
    graph: object       # torch.cuda.CUDAGraph
    signature: tuple
    counts: dict        # the counters' increments of one run
    inputs: tuple       # the input buffers it reads
    out: object         # what the captured body returned


class Replayer:
    """CUDA graphs of one owner's calls, a slot per key ``(name,
    variant)``, in one memory pool. ``counts[name]`` counts the calls by
    what they did (``capture``, ``replay``, ``eager``: a capture's call
    replays the new graph once and counts as a capture), ``invalidations``
    the eager calls by :func:`decide`'s reason, ``capture_s`` the captures'
    host seconds; with a ``stopwatch`` each call is also a lap
    ``graph/<name>/<action>``, an eager one ``graph/<name>/eager/<reason>``.
    """

    def __init__(self, device, names: tuple,
                 stopwatch: Stopwatch | None = None):
        self.device = torch.device(device)
        self.names = names
        self._graphs: dict = {}   # key -> _Graph
        self._last: dict = {}     # key -> the last call's signature
        self._pool = None
        self.reset(stopwatch)

    def reset(self, stopwatch: Stopwatch | None = None) -> None:
        """Count afresh, with the laps on ``stopwatch``; the graphs stay."""
        self.stopwatch = stopwatch
        self.counts = {n: Counter() for n in self.names}
        self.invalidations: Counter = Counter()
        self.capture_s = 0.0

    def run(self, name: str, inputs: tuple, body, *, variant=None,
            addresses: tuple = (), context=(), stopwatch=None):
        """``body(stopwatch, inputs)`` as :func:`decide` says: eagerly, or
        as the slot's graph of ``body(None, buffers)``, its input buffers
        holding ``inputs``. ``addresses`` (of the owner's buffers that the
        body reads and writes) are part of the graph's signature;
        ``context`` is what, besides the inputs' shapes, makes a call a
        first one (the owner's layout or network). Returns what ``body``
        returned; from a graph, what its capture's body returned."""
        key = (name, variant)
        dev = self.device
        shapes = tuple((tuple(t.shape), t.dtype) for t in inputs)
        sig = (shapes, addresses)
        first = (dev, key, shapes, context)
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
                # the old graph goes only now: the pool stays in use
                self._graphs[key] = graph
        if action == "eager":
            out = body(stopwatch, inputs)
            _SEEN.add(first)
            self.invalidations[why] += 1
        else:
            if action == "replay":
                for buf, x in zip(graph.inputs, inputs, strict=True):
                    buf.copy_(x)
            graph.graph.replay()
            if graph.counts:
                counter_add(graph.counts)
            out = graph.out
        self.counts[name][action] += 1
        if self.stopwatch is not None:
            label = f"graph/{name}/{action}"
            self.stopwatch.record(label if why is None else f"{label}/{why}",
                                  time.perf_counter() - t0)
        return out

    def _capture(self, body, sig, inputs) -> _Graph:
        """``body`` captured on input buffers that hold ``inputs`` into a
        graph of the owner's pool. The counters the capture bumped are taken
        back: each replay adds them."""
        buffers = tuple(t.clone() for t in inputs)
        before = counter_values()
        t0 = time.perf_counter()
        try:
            graph, out = capture(self._pool, self.device,
                                 lambda: body(None, buffers))
        finally:
            delta = counter_delta(before, counter_values())
            counter_add(delta, -1)
        self.capture_s += time.perf_counter() - t0
        self._pool = graph.pool()
        return _Graph(graph, sig, delta, buffers, out)

    def summary(self) -> dict:
        """The calls of each name by what they did, the eager calls by
        reason, and the captures' host milliseconds."""
        return {"captures": {n: self.counts[n]["capture"] for n in self.names},
                "replays": {n: self.counts[n]["replay"] for n in self.names},
                "eager": {n: self.counts[n]["eager"] for n in self.names},
                "invalidations": dict(self.invalidations),
                "capture_ms": self.capture_s * 1e3}
