"""Per-pixel nearest-candidate z-buffer (counterpart of
``semantic_suma_tpu/ops/zbuffer.py``).

The JAX package resolves depth contention with sorts, because a TPU has no
atomic scatter. Here every query is a 64-bit atomic minimum per cell over
``depth_key * 2^32 + candidate_index`` (``csrc/zbuffer.cu``); the minimum is
the lowest depth bucket, then the lowest input index, which is exactly the
winner of the JAX stable sort. :func:`zbuffer_cells` is the kernel's wrapper;
:func:`zbuffer_cells_plain` computes the same keys with
``scatter_reduce_(..., "amin")`` and is what runs on the CPU.
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
                        scale: float, qclip: int, qoff: int):
    """Plain PyTorch version of the kernel: (winner i64[1+K, C], -1 where
    empty; depth key i32[1+K, C])."""
    n = ids.shape[0]
    dev = ids.device
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
    dkey = torch.where(empty, 0, cells >> 32).to(torch.int32)
    return winner, dkey


def zbuffer_cells(ids, depth, flags, num_cells: int, *, exact: bool,
                  scale: float, qclip: int, qoff: int):
    """Kernel B's wrapper: nearest candidate per cell for query 0 (every
    candidate with an id in [0, num_cells)) and for each flag (candidates whose
    flag is set). Returns (winner i64[1+K, C], -1 where empty; depth key
    i32[1+K, C]). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    flags = tuple(flags)
    if ids.device.type == "cpu":
        return zbuffer_cells_plain(ids, depth, flags, num_cells, exact=exact,
                                   scale=scale, qclip=qclip, qoff=qoff)
    if ids.device.type != "cuda":
        raise ValueError(f"zbuffer: unsupported device {ids.device}")
    n = ids.shape[0]
    if ids.dim() != 1 or n >= 1 << 31 or len(flags) > 3:
        raise ValueError("zbuffer: ids must be [N] with N < 2^31, and at "
                         "most 3 flags")
    dev = ids.device
    ids = ids.to(torch.int64).contiguous()
    depth = depth.to(torch.float32).contiguous()
    if depth.device != dev or depth.shape != (n,):
        raise ValueError("zbuffer: depth must match ids")
    if flags:
        if any(f.device != dev or f.shape != (n,) for f in flags):
            raise ValueError("zbuffer: every flag must match ids")
        fl = torch.stack([f.to(torch.uint8) for f in flags]).contiguous()
        fptr = fl.data_ptr()
    else:
        fl, fptr = None, None
    nq = 1 + len(flags)
    cells = torch.empty((nq, num_cells), dtype=torch.int64, device=dev)
    winner = torch.empty((nq, num_cells), dtype=torch.int64, device=dev)
    dkey = torch.empty((nq, num_cells), dtype=torch.int32, device=dev)
    lib = _zbuffer_lib()
    rc = lib.zbuffer_cells(
        ids.data_ptr(), depth.data_ptr(), fptr, n, len(flags), num_cells,
        int(exact), scale, qclip, qoff, cells.data_ptr(), winner.data_ptr(),
        dkey.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "zbuffer_cells")
    zbuffer_cells.launches += 1
    del fl
    return winner, dkey


zbuffer_cells.launches = 0


def _zbuffer_lib():
    lib = cuda_build.library("zbuffer")
    fn = lib.zbuffer_cells
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_longlong, i, ctypes.c_float,
                       i, i, p, p, p, p]
        fn.restype = i
    return lib


def zbuffer_argmin(ids: torch.Tensor, depth: torch.Tensor, num_cells: int,
                   depth_bound: float = 100.0):
    """Nearest element per cell. Returns (winner i64[num_cells], the input
    index or -1; winner_depth f32[num_cells], the winner's exact depth or
    +inf). Depths compare after the JAX quantization to
    ``depth_bound / 2**depth_bits`` buckets; ties go to the lowest index."""
    exact, scale, qmax = _quantization(num_cells, depth_bound)
    winners, _ = zbuffer_cells(ids, depth, (), num_cells, exact=exact,
                               scale=scale, qclip=qmax, qoff=0)
    winner = winners[0]
    winner_depth = torch.where(winner >= 0, depth[winner.clamp_min(0)],
                               torch.inf)
    return winner, winner_depth


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
    flags = tuple(flags)
    exact, scale, qmax = _quantization(num_cells, depth_bound)
    winners, dkeys = zbuffer_cells(ids, depth, flags, num_cells, exact=exact,
                                   scale=scale, qclip=max(qmax - 1, 0),
                                   qoff=0 if exact else 1)
    if flag_payloads is None:
        flag_payloads = tuple(True for _ in flags)
    out_w, out_d = [], []
    for k in range(len(flags)):
        w = winners[1 + k]
        ok = w >= 0
        if not flag_payloads[k]:
            out_w.append(torch.where(ok, 0, -1))
            out_d.append(torch.where(ok, 0.0, torch.inf))
            continue
        out_w.append(w)
        if exact:
            wd = depth[w.clamp_min(0)]
        else:
            wd = (dkeys[1 + k] - 1).to(torch.float32) / torch.full(
                (), scale, dtype=torch.float32, device=depth.device)
        out_d.append(torch.where(ok, wd, torch.inf))
    return winners[0], tuple(out_w), tuple(out_d)


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
