"""Process groups of the sharded pipeline (counterpart of
``semantic_suma_tpu/parallel/distributed.py``).

The JAX package runs one program over a device mesh; the port runs one
process ("rank") per shard over ``torch.distributed``. :func:`initialize`
brings a rank up with a fixed backend rule, printed once and never retried:

* ``nccl`` when every rank of the host has a card of its own;
* ``gloo`` with CUDA tensors when ranks share a card (NCCL refuses two ranks
  on one device; gloo stages CUDA tensors through pinned host memory);
* ``gloo`` with CPU tensors for ranks on the CPU (``cpu=True``).

Rank ``r`` computes on ``cuda:(r % device_count)``. Every group has a
timeout, so a rank left waiting in a collective raises instead of hanging.

:class:`Group` is what the pipeline's collectives go through: sums,
maxima, gathers and broadcasts over the ranks, each counted (and timed with
CUDA events when ``timing`` is on). A ``Group`` of one rank and no process
group does nothing but return its input. :func:`launch` starts ``N`` ranks
on this host with a ``file://`` rendezvous under a temporary directory,
joins them with a deadline and returns what each rank's function returned.
"""

from __future__ import annotations

import datetime
import gc
import os
import pickle
import sys
import tempfile
import time

import torch
import torch.distributed as dist

_state = {"device": None, "backend": None, "timeout": None}


def backend_rule(ranks_on_host: int, cpu: bool = False) -> str:
    """The backend of a group with ``ranks_on_host`` ranks on this host."""
    if cpu:
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass cpu=True to run "
                           "the ranks on the CPU")
    return "nccl" if ranks_on_host <= torch.cuda.device_count() else "gloo"


def _init_method(coordinator: str) -> str:
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def initialize(coordinator: str = "localhost:12355",
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout_s: float = 300.0, cpu: bool = False) -> torch.device:
    """Bring up this rank's process group and return its device.

    ``coordinator`` is ``host:port`` (a TCP rendezvous, rank 0 listens) or a
    ``file://`` / ``tcp://`` URL. ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``; the ranks on this host to
    ``LOCAL_WORLD_SIZE`` or ``num_processes``. ``backend=None`` applies the
    rule of the module docstring."""
    n = int(os.environ["WORLD_SIZE"]) if num_processes is None \
        else num_processes
    r = int(os.environ["RANK"]) if process_id is None else process_id
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    rule = backend_rule(local, cpu)
    chosen = rule if backend is None else backend
    if cpu:
        device = torch.device("cpu")
        if chosen != "gloo":
            raise ValueError(f"ranks on the CPU need gloo, not {chosen}")
    else:
        device = torch.device("cuda", r % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        chosen, init_method=_init_method(coordinator), world_size=n, rank=r,
        timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(device=device, backend=chosen,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if r == 0:
        why = ("asked for" if backend is not None else
               "CPU ranks" if cpu else
               "a card a rank" if chosen == "nccl" else
               f"{local} ranks share {torch.cuda.device_count()} card(s)")
        print(f"distributed: {n} ranks, backend {chosen} ({why}), rank 0 on "
              f"{device}", file=sys.stderr, flush=True)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device() -> torch.device | None:
    """The device :func:`initialize` gave this rank (None before)."""
    return _state["device"]


def backend() -> str | None:
    return _state["backend"]


class Group:
    """The collectives of one rank over a process group (``pg=None`` with
    ``size == 1``: no process group, every collective returns its input).
    ``rank`` is this rank's place in the group and ``ranks`` the group's
    members by their world rank. Each call adds one to ``counts[kind]``;
    with ``timing`` on, its span on the current stream is recorded with CUDA
    events (host clock on the CPU) and :meth:`summary` reports the ms."""

    def __init__(self, pg=None, rank: int = 0, size: int = 1, ranks=None):
        if pg is None and size != 1:
            raise ValueError("a group of several ranks needs a process group")
        self.pg = pg
        self.rank = rank
        self.size = size
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        self.timing = False
        self.counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
        self._spans: list = []

    @classmethod
    def world(cls) -> "Group":
        """The default group of an initialized process (rank, size), or the
        group of one rank when no process group is up."""
        if not is_initialized():
            return cls()
        return cls(dist.group.WORLD, dist.get_rank(), dist.get_world_size())

    @classmethod
    def subgroups(cls, members) -> "Group":
        """Create a process group for each list of world ranks in
        ``members`` (collective over the world: every rank creates every
        subgroup, in the same order) and return this rank's, the one that
        holds it."""
        mine = None
        for ranks in members:
            pg = dist.new_group(list(ranks), timeout=_state["timeout"])
            if dist.get_rank() in ranks:
                mine = cls(pg, list(ranks).index(dist.get_rank()), len(ranks),
                           ranks)
        if mine is None:
            raise ValueError(f"rank {dist.get_rank()} is in no group of "
                             f"{members}")
        return mine

    def _run(self, kind: str, t: torch.Tensor, op):
        self.counts[kind] += 1
        if not self.timing:
            return op()
        if t.is_cuda:
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            out = op()
            b.record()
            self._spans.append((kind, a, b))
        else:
            t0 = time.perf_counter()
            out = op()
            self._spans.append((kind, t0, time.perf_counter()))
        return out

    def summary(self) -> dict:
        """``{kind: {"calls": n, "ms": total}}`` over the timed calls."""
        if any(not isinstance(a, float) for _, a, _ in self._spans):
            torch.cuda.synchronize()
        out = {k: {"calls": 0, "ms": 0.0} for k in self.counts}
        for kind, a, b in self._spans:
            out[kind]["calls"] += 1
            out[kind]["ms"] += (b - a) * 1e3 if isinstance(a, float) \
                else a.elapsed_time(b)
        return out

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.pg is None:
            return t
        t = t.contiguous().clone()
        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.int32)

        def go():
            dist.all_reduce(t, op=op, group=self.pg)
            return t
        out = self._run("all_reduce", t, go)
        return out.to(dtype) if dtype == torch.bool else out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce sum (a new tensor, the same on every rank)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce sum that autograd differentiates (its backward is the
        all-reduce sum of the incoming gradients)."""
        if self.pg is None:
            return t
        return _SumOverRanks.apply(t, self)

    def sum_in_place(self, tensors) -> None:
        """Sum each of ``tensors`` over the ranks in place, with one
        all-reduce of them all."""
        if self.pg is None or not tensors:
            return
        flat = self.sum(torch.cat([t.reshape(-1) for t in tensors]))
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """All-gather: ``[size, *t.shape]``, row ``r`` from rank ``r``."""
        if self.pg is None:
            return t[None]
        t = t.contiguous()
        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.uint8)
        parts = [torch.empty_like(t) for _ in range(self.size)]

        def go():
            dist.all_gather(parts, t, group=self.pg)
            return torch.stack(parts)
        out = self._run("all_gather", t, go)
        return out.to(dtype) if dtype == torch.bool else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The tensor of the group's rank ``src`` on every rank (a new
        tensor)."""
        if self.pg is None:
            return t
        t = t.contiguous().clone()

        def go():
            dist.broadcast(t, self.ranks[src], group=self.pg)
            return t
        return self._run("broadcast", t, go)

    def copy_in(self, t: torch.Tensor) -> torch.Tensor:
        """Identity that autograd differentiates as a sum over the ranks:
        the input of a layer whose output channels the ranks split, where
        each rank's gradient holds its channels' part only."""
        if self.pg is None:
            return t
        return _CopyIn.apply(t, self)

    def gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather concatenated along ``dim`` (rank order); its backward
        gives each rank its own slice of the gradient."""
        if self.pg is None:
            return t
        return _GatherCat.apply(t, self, dim)

    def objects(self, obj) -> list:
        """All-gather of a picklable host object: one entry per rank."""
        if self.pg is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


class _SumOverRanks(torch.autograd.Function):
    """y = sum over the ranks of x; dL/dx = sum over the ranks of dL/dy
    (every rank's loss depends on y)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.sum(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.sum(grad), None


class _CopyIn(torch.autograd.Function):
    """y = x; dL/dx = sum over the ranks of dL/dy."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.sum(grad), None


class _GatherCat(torch.autograd.Function):
    """y = the ranks' x concatenated along ``dim``; dL/dx = this rank's
    slice of dL/dy (every rank's loss is the same function of y)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return torch.cat(group.gather(t).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.group.rank * ctx.n
        return grad.narrow(ctx.dim, lo, ctx.n), None, None


def _rank_entry(rank: int, nprocs: int, init: str, fn, args, cpu: bool,
                backend_name, timeout_s: float, threads, build_dir,
                result_dir: str) -> None:
    if threads:
        torch.set_num_threads(threads)
    if build_dir is not None:
        from ..ops import cuda_build
        cuda_build.set_build_dir(build_dir)
    device = initialize(init, nprocs, rank, backend=backend_name,
                        timeout_s=timeout_s, cpu=cpu)
    try:
        out = fn(rank, device, *args)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        del out
    finally:
        # the rank's sessions hold the process group in reference cycles:
        # free them first, so that the group's threads end inside
        # destroy_process_group and not in the interpreter's teardown
        gc.collect()
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the teardown (the rank's result is written): a thread
    # that a library leaves to the teardown can abort a finished rank
    os._exit(0)


def launch(fn, nprocs: int, args=(), *, cpu: bool = False,
           backend: str | None = None, timeout_s: float = 300.0,
           join_timeout_s: float | None = None, threads: int | None = None,
           build_dir=None) -> list:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes (spawned,
    one rank each, a ``file://`` rendezvous under a temporary directory) and
    return the list of their return values, by rank. ``fn`` must be a
    module-level function. Raises if a rank fails (the others are stopped)
    or if the ranks have not all ended after ``join_timeout_s`` (then every
    rank still running is killed). ``timeout_s`` is each collective's
    timeout; ``threads`` the intra-op threads of each rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="suma-ranks-") as td:
        init = "file://" + os.path.join(td, "rendezvous")
        ctx = mp.start_processes(
            _rank_entry, args=(nprocs, init, fn, tuple(args), cpu, backend,
                               timeout_s, threads,
                               None if build_dir is None else str(build_dir),
                               td),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if join_timeout_s is None \
            else time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks did not end within {join_timeout_s} s"
                        "; killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        out = []
        for r in range(nprocs):
            with open(os.path.join(td, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
