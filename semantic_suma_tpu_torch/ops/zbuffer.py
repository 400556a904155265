"""Per-pixel nearest-candidate z-buffer (counterpart of
``semantic_suma_tpu/ops/zbuffer.py``).

The JAX package resolves depth contention with sorts, because a TPU has no
atomic scatter. Here every query is a 64-bit atomic minimum per cell over
``depth_key * 2^32 + candidate_index`` (``csrc/zbuffer.cu``); the minimum is
the lowest depth bucket, then the lowest input index, which is exactly the
winner of the JAX stable sort. :func:`zbuffer_cells` is the kernel's wrapper
and returns the finished answer of :func:`zbuffer_argmin` and
:func:`zbuffer_runs` (winners and winner depths); :func:`zbuffer_cells_plain`
computes the same with ``scatter_reduce_(..., "amin")`` and tensor code and is
what runs on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

_EMPTY = torch.iinfo(torch.int64).max


def _quantization(num_cells: int, depth_bound: float):
    """(exact, f32 scale, qmax) of the JAX packed-key quantization: exact
    (two-key) comparison when fewer than 12 depth bits remain."""
    depth_bits = 31 - int(num_cells).bit_length()
    if depth_bits < 12:
        return True, 1.0, 0
    scale = float(np.float32((1 << depth_bits) / depth_bound))
    return False, scale, (1 << depth_bits) - 1


def depth_keys(depth: torch.Tensor, exact: bool, scale: float, qclip: int,
               qoff: int) -> torch.Tensor:
    """int32 depth key per candidate, ordered like the JAX sort key."""
    if exact:
        # the JAX sort's float order: -0 == +0, every NaN equal and last
        d = torch.where(depth == 0, torch.zeros_like(depth), depth)
        d = torch.where(torch.isnan(d), torch.full_like(d, torch.nan), d)
        b = d.contiguous().view(torch.int32)
        return torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    s = depth * torch.full((), scale, dtype=torch.float32,
                           device=depth.device)
    s = torch.nan_to_num(s, nan=0.0).clamp(0.0, float(qclip))
    return s.to(torch.int32) + qoff


def zbuffer_cells_plain(ids, depth, flags, num_cells: int, *, exact: bool,
                        scale: float, qclip: int, qoff: int, payloads=None):
    """Plain PyTorch version of the kernel, same contract as
    :func:`zbuffer_cells`."""
    n = ids.shape[0]
    dev = ids.device
    flags = tuple(flags)
    if payloads is None:
        payloads = (True,) * len(flags)
    depth = depth.to(torch.float32)
    valid = (ids >= 0) & (ids < num_cells)
    key = depth_keys(depth, exact, scale, qclip, qoff).to(torch.int64) \
        * (1 << 32) + torch.arange(n, dtype=torch.int64, device=dev)
    masks = [valid] + [valid & f.to(torch.bool) for f in flags]
    cells = torch.full((len(masks), num_cells), _EMPTY, dtype=torch.int64,
                       device=dev)
    safe = torch.where(valid, ids, 0).to(torch.int64)
    for q, m in enumerate(masks):
        cells[q].scatter_reduce_(0, safe, torch.where(m, key, _EMPTY),
                                 "amin", include_self=True)
    empty = cells == _EMPTY
    winner = torch.where(empty, -1, cells & 0xFFFFFFFF)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    if n:
        wdepth = torch.where(empty, inf, depth[winner.clamp_min(0)])
    else:
        wdepth = inf.expand(winner.shape).clone()
    for k, payload in enumerate(payloads):
        q = 1 + k
        if not payload:
            # existence only: winner 0 and depth 0 where a candidate exists
            winner[q] = torch.where(empty[q], -1, 0)
            wdepth[q] = torch.where(empty[q], inf, 0.0)
        elif not exact:
            # the bucket floor, decoded from the quantized key
            floor = ((cells[q] >> 32) - qoff).to(torch.float32) / torch.full(
                (), scale, dtype=torch.float32, device=dev)
            wdepth[q] = torch.where(empty[q], inf, floor)
    return winner, wdepth


class FirstCallUnderCapture(RuntimeError):
    """The first call of a table size, made while a CUDA graph is being
    captured (the caller runs it outside the capture instead)."""


def _empty_table(dev: torch.device, size: int) -> torch.Tensor:
    """The key table of (device, size), every cell the empty key. The kernel
    leaves it so after each call. Tables are never released."""
    table = _tables.get((dev, size))
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            # the fill would be captured, not run, and the table would live
            # in the graph's private pool
            raise FirstCallUnderCapture("zbuffer: the first call of a table "
                                        "size must be made outside CUDA-"
                                        "graph capture")
        table = torch.full((size,), _EMPTY, dtype=torch.int64, device=dev)
        _tables[(dev, size)] = table
    return table


_tables: dict = {}


def zbuffer_cells(ids, depth, flags, num_cells: int, *, exact: bool,
                  scale: float, qclip: int, qoff: int, payloads=None):
    """Kernel B's wrapper: nearest candidate per cell for query 0 (every
    candidate with an id in [0, num_cells)) and for query 1 + k (candidates
    whose flag k is set), for up to 3 flags.

    Returns ``(winner i64[1+K, C], wdepth f32[1+K, C])``: the winner's input
    index, -1 where the cell has none, and its depth, +inf where it has none.
    The depth is ``depth[winner]`` for query 0 and with ``exact`` keys, and
    the floor of the winner's bucket, ``(key - qoff) / scale``, for a flag
    with packed keys. For a flag with ``payloads[k]`` false only existence is
    reported: winner 0 and depth 0.0 where a flagged candidate exists.

    ``ids`` may be int32 or int64 and flags bool or uint8; they are passed as
    they are. CPU tensors take the plain version; CUDA tensors launch the
    kernel (two launches, nothing after them). The kernel works on a key
    table kept per (device, table size) between calls, so calls of one size
    on one device must come from one stream at a time. The tables are kept
    for the life of the process (8 bytes a cell and query). The first call
    of a size fills its table, so it must not be made while a CUDA graph is
    being captured: the wrapper raises there."""
    flags = tuple(flags)
    if payloads is None:
        payloads = (True,) * len(flags)
    if ids.device.type == "cpu":
        return zbuffer_cells_plain(ids, depth, flags, num_cells, exact=exact,
                                   scale=scale, qclip=qclip, qoff=qoff,
                                   payloads=payloads)
    if ids.device.type != "cuda":
        raise ValueError(f"zbuffer: unsupported device {ids.device}")
    n = ids.shape[0]
    if ids.dim() != 1 or n >= 1 << 31 or len(flags) > 3 \
            or len(payloads) != len(flags):
        raise ValueError("zbuffer: ids must be [N] with N < 2^31, and at "
                         "most 3 flags with one payload switch each")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"zbuffer: ids must be int32 or int64, "
                         f"not {ids.dtype}")
    dev = ids.device
    ids = ids.contiguous()
    depth = depth.to(torch.float32).contiguous()
    if depth.device != dev or depth.shape != (n,):
        raise ValueError("zbuffer: depth must match ids")
    fptr = [None, None, None]
    keep = []
    for k, f in enumerate(flags):
        if f.device != dev or f.shape != (n,):
            raise ValueError("zbuffer: every flag must match ids")
        if f.dtype == torch.bool:
            f = f.contiguous().view(torch.uint8)   # one byte each: no copy
        elif f.dtype != torch.uint8:
            f = (f != 0).view(torch.uint8)
        else:
            f = f.contiguous()
        keep.append(f)
        fptr[k] = f.data_ptr()
    nq = 1 + len(flags)
    mask = sum(1 << k for k, p in enumerate(payloads) if p)
    table = _empty_table(dev, nq * num_cells)
    winner = torch.empty((nq, num_cells), dtype=torch.int64, device=dev)
    wdepth = torch.empty((nq, num_cells), dtype=torch.float32, device=dev)
    rc = _zbuffer_lib().zbuffer_cells(
        ids.data_ptr(), ids.dtype == torch.int64, depth.data_ptr(), *fptr, n,
        len(flags), mask, num_cells, exact, scale, qclip, qoff,
        table.data_ptr(), winner.data_ptr(), wdepth.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        # the first launch may have run: the next call gets a new table
        del _tables[(dev, nq * num_cells)]
        cuda_build.check(rc, "zbuffer_cells")
    zbuffer_cells.launches += 1
    shape = (n, len(flags))
    zbuffer_cells.launches_by_shape[shape] = \
        zbuffer_cells.launches_by_shape.get(shape, 0) + 1
    return winner, wdepth


zbuffer_cells.launches = 0
zbuffer_cells.launches_by_shape = {}  # the same calls by (candidates, flags)


def _zbuffer_lib():
    lib = cuda_build.library("zbuffer")
    fn = lib.zbuffer_cells
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, ctypes.c_longlong, i,
                       ctypes.c_float, i, i, p, p, p, p]
        fn.restype = i
    return lib


def zbuffer_argmin(ids: torch.Tensor, depth: torch.Tensor, num_cells: int,
                   depth_bound: float = 100.0):
    """Nearest element per cell. Returns (winner i64[num_cells], the input
    index or -1; winner_depth f32[num_cells], the winner's exact depth or
    +inf). Depths compare after the JAX quantization to
    ``depth_bound / 2**depth_bits`` buckets; ties go to the lowest index."""
    exact, scale, qmax = _quantization(num_cells, depth_bound)
    winners, wdepths = zbuffer_cells(ids, depth, (), num_cells, exact=exact,
                                     scale=scale, qclip=qmax, qoff=0)
    return winners[0], wdepths[0]


def zbuffer_runs(ids: torch.Tensor, depth: torch.Tensor, flags, num_cells: int,
                 depth_bound: float = 100.0, flag_payloads=None):
    """Nearest candidate per cell plus the nearest FLAGGED candidate per cell
    for each of up to 3 flags, with the quantization of the JAX
    ``zbuffer_runs`` (real buckets shifted to [1, qmax]).

    Returns ``(winner_all, winners, winner_depths)``; each winner is -1 (depth
    +inf) where the cell has none. Flagged winner depths are decoded from the
    quantized key (bucket floor) in the packed case, exact otherwise. For a
    flag with ``flag_payloads[k] = False`` only existence is reported: the
    winner is 0 and its depth 0.0 where one exists."""
    exact, scale, qmax = _quantization(num_cells, depth_bound)
    winners, wdepths = zbuffer_cells(
        ids, depth, flags, num_cells, exact=exact, scale=scale,
        qclip=max(qmax - 1, 0), qoff=0 if exact else 1,
        payloads=flag_payloads)
    winners, wdepths = winners.unbind(0), wdepths.unbind(0)
    return winners[0], winners[1:], wdepths[1:]


def scatter_reduce_sum(ids: torch.Tensor, values: torch.Tensor,
                       num_cells: int) -> torch.Tensor:
    """Segment sum per cell; ids outside [0, num_cells) are dropped. values
    may be [N] or [N, C]."""
    valid = (ids >= 0) & (ids < num_cells)
    safe = torch.where(valid, ids, num_cells).to(torch.int64)
    out = torch.zeros((num_cells + 1,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, safe, values)
    return out[:num_cells]


def gather_or(winner: torch.Tensor, values: torch.Tensor, fill):
    """``values[winner]`` with ``fill`` where winner == -1."""
    out = values[winner.clamp_min(0)]
    mask = winner >= 0
    if out.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, out, fill)
