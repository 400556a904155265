"""Frame-to-model projective ICP: weighted Jacobian rows, their products
per linearization, and the Gauss-Newton loop (counterpart of
``semantic_suma_tpu/ops/icp.py``).

The JAX package runs the whole loop as one device ``while_loop``. Here
:func:`gauss_newton` runs it as one launch with no host read: kernel F
(:func:`gn_loop`, ``csrc/icp.cu``), a cooperative kernel whose blocks each
linearize their slots of the data pixels, meet at one grid barrier an
iteration, and each sum all the slots, solve, run the stop test and update
the pose, so that every block holds the same state and all stop together.
The loop's state (:func:`gn_state`) lives in two small device tensors.
Kernels D (:func:`icp_products`: one linearization, each block's partial
sums) and E (:func:`gn_update`: the sum, the solve, the stop test, the
update and the latch ``done``) are one iteration's two halves, which F
computes bit for bit; ``gauss_newton_latched`` runs them (or their plain
versions) on the latch when they are passed, and the card's checks hold F
against them. On a CPU tensor :func:`gn_loop` runs the plain versions
(:func:`icp_products_plain`, :func:`gn_update_plain`) on the same latch and
ends there (reading a CPU tensor waits for nothing).

With a ``group`` (the sharded pipeline, ``parallel/``),
:func:`gauss_newton_sharded` runs kernels D and E on one state: each rank
linearizes its slice of the image rows with D, the partial sums are added
elementwise over the ranks once per iteration, E updates every rank's state
from the same bits, and every rank reads ``done`` (one host read an
iteration), so that the ranks stay in lockstep. :func:`evaluate` is kernel
F's first iteration. :func:`gauss_newton_host`, the loop on the host over
:func:`build_rows`, is kept for ``tools/gn_trace`` and the card's timings;
``plain_on_cuda`` counts the calls of :func:`build_rows` on CUDA tensors,
which no path of the card makes.

Twist convention ``x = [v, omega]``, increment applied on the left:
``pose <- exp(x) @ pose``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import DataConfig, IcpConfig
from ..device import to_host
from ..models.labels import _MOVABLE_MASK, is_movable
from ..utils import lie
from . import cuda_build
from .projection import INV_PI

_DEG = 180.0 / math.pi


class Maps(NamedTuple):
    """Dense per-frame maps."""

    vertex: torch.Tensor        # [H, W, 3]
    normal: torch.Tensor        # [H, W, 3]
    vertex_valid: torch.Tensor  # [H, W] bool
    normal_valid: torch.Tensor  # [H, W] bool
    sem_label: torch.Tensor     # [H, W] int32
    sem_prob: torch.Tensor      # [H, W] float32

    @property
    def valid(self):
        return self.vertex_valid & self.normal_valid


class IcpStats(NamedTuple):
    error: torch.Tensor            # sum of weighted squared residuals
    valid: torch.Tensor            # associated terms (inlier + outlier)
    inlier: torch.Tensor
    outlier: torch.Tensor
    inlier_residual: torch.Tensor
    invalid: torch.Tensor          # data pixels with no model association


class IcpResult(NamedTuple):
    pose: torch.Tensor        # [4,4] final increment estimate
    stats: IcpStats           # stats at the last evaluated linearization
    iterations: torch.Tensor  # int32 on the device (with a group: an int)


def _pack_model_image(model: Maps) -> torch.Tensor:
    """Loop-invariant flat model image [H*W, 8]: vertex 0:3, normal 3:6,
    valid 6, label 7."""
    return torch.cat([
        model.vertex.reshape(-1, 3),
        model.normal.reshape(-1, 3),
        model.valid.reshape(-1, 1).to(torch.float32),
        model.sem_label.reshape(-1, 1).to(torch.float32),
    ], dim=-1)


def _sample_model(model_img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  h: int, w: int, bilinear: bool):
    """(v_m, n_m, m_valid, m_label) at continuous image coordinates: nearest
    tap, or bilinear geometry (horizontal wrap, vertical clamp) with the
    nearest tap's label."""
    if not bilinear:
        xi = torch.clamp(u.to(torch.int64), 0, w - 1)
        yi = torch.clamp(v.to(torch.int64), 0, h - 1)
        g = model_img[yi * w + xi]
        n_m = g[..., 3:6]
        n_m = n_m / torch.clamp_min(
            torch.linalg.norm(n_m, dim=-1, keepdim=True), 1e-12)
        return g[..., 0:3], n_m, g[..., 6] > 0.5, g[..., 7].to(torch.int32)
    xf = u - 0.5
    yf = v - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    ax = (xf - x0)[..., None]
    ay = (yf - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    g00 = model_img[y0i * w + x0i]
    g10 = model_img[y0i * w + x1i]
    g01 = model_img[y1i * w + x0i]
    g11 = model_img[y1i * w + x1i]
    top = g00 * (1 - ax) + g10 * ax
    bot = g01 * (1 - ax) + g11 * ax
    samp = top * (1 - ay) + bot * ay
    n_m_raw = samp[..., 3:6]
    m_valid = samp[..., 6] > 0.999  # all 4 taps valid
    n_m = n_m_raw / torch.clamp_min(
        torch.linalg.norm(n_m_raw, dim=-1, keepdim=True), 1e-12)
    right = ax[..., 0] > 0.5
    down = ay[..., 0] > 0.5
    lab_top = torch.where(right, g10[..., 7], g00[..., 7])
    lab_bot = torch.where(right, g11[..., 7], g01[..., 7])
    m_label = torch.where(down, lab_bot, lab_top).to(torch.int32)
    return samp[..., 0:3], n_m, m_valid, m_label


def _project_to_model(pts: torch.Tensor, model_cfg: DataConfig):
    """Continuous model-image coordinates of points."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    yaw = torch.atan2(y, x)
    pitch = -torch.asin(torch.clamp(z / torch.clamp_min(depth, 1e-12),
                                    -1.0, 1.0))
    u = 0.5 * (-yaw * INV_PI + 1.0) * model_cfg.width
    v = (1.0 - (pitch * _DEG + model_cfg.fov_up) / model_cfg.fov) \
        * model_cfg.height
    return u, v


def build_rows(pose: torch.Tensor, data: Maps, model: Maps, icp: IcpConfig,
               model_cfg: DataConfig, iteration, semantic: bool = True,
               model_img: torch.Tensor | None = None):
    """Weighted Jacobian rows A [P, 8] and the per-pixel stats
    (``iteration``: an int, or a 0-dim device tensor). Row layout:
    0:3 = sqrt(w) n_m, 3:6 = sqrt(w) (v_d x n_m), 6 = sqrt(w) r, 7 = 0; then
    A^T A[0:6,0:6] = J^T W J and A^T A[0:6,6] = J^T W f."""
    h, w = data.vertex.shape[:2]
    p = h * w
    if data.vertex.is_cuda:
        plain_on_cuda["build_rows"] += 1
    v_data = data.vertex.reshape(p, 3)
    n_data = data.normal.reshape(p, 3)
    d_valid = (data.vertex_valid & data.normal_valid).reshape(p)

    r = pose[:3, :3]
    t = pose[:3, 3]
    v_d = v_data @ r.T + t
    n_d = n_data @ r.T

    u, v = _project_to_model(v_d, model_cfg)
    inside = (u >= 0) & (u < model_cfg.width) & (v >= 0) \
        & (v < model_cfg.height)

    if model_img is None:
        model_img = _pack_model_image(model)
    v_m, n_m, m_valid, m_label = _sample_model(
        model_img, u, v, model_cfg.height, model_cfg.width,
        icp.sampling == "bilinear")

    assoc = d_valid & inside & m_valid

    diff = v_d - v_m
    residual = torch.sum(n_m * diff, dim=-1)
    dist = torch.linalg.norm(diff, dim=-1)
    ndot = torch.sum(n_m * n_d, dim=-1)

    angle_thresh = math.cos(math.radians(icp.max_angle))
    inlier = assoc & (dist <= icp.max_distance) & (ndot >= angle_thresh)

    absr = torch.abs(residual)
    if icp.weighting == "huber":
        weight = torch.where(absr > icp.factor,
                             icp.factor / torch.clamp_min(absr, 1e-12), 1.0)
    elif icp.weighting == "turkey":
        alpha = residual / icp.factor
        turkey = torch.square(1.0 - alpha * alpha)
        if isinstance(iteration, torch.Tensor):  # a device counter: no read
            turkey = torch.where(iteration > 0, turkey, 1.0)
        elif iteration <= 0:
            turkey = torch.ones_like(turkey)
        weight = torch.where(absr > icp.factor, 0.0, turkey)
    else:
        weight = torch.ones_like(residual)

    if semantic:
        d_label = data.sem_label.reshape(p)
        d_prob = data.sem_prob.reshape(p)
        movable = is_movable(m_label)
        agree = d_label == m_label
        sem_w = torch.where(movable, torch.where(agree, d_prob, 1.0 - d_prob),
                            1.0)
        weight = weight * sem_w

    cp = torch.linalg.cross(v_d, n_m, dim=-1)
    sw = torch.sqrt(torch.clamp_min(weight, 0.0))
    row_mask = inlier.to(torch.float32)[:, None]
    rows = torch.cat([sw[:, None] * n_m, sw[:, None] * cp,
                      (sw * residual)[:, None],
                      torch.zeros((p, 1), dtype=torch.float32,
                                  device=v_d.device)], dim=-1) * row_mask

    wr2 = weight * residual * residual
    stats = IcpStats(
        error=torch.sum(torch.where(assoc, wr2, 0.0)),
        valid=torch.sum(assoc).to(torch.int32),
        inlier=torch.sum(inlier).to(torch.int32),
        outlier=torch.sum(assoc & ~inlier).to(torch.int32),
        inlier_residual=torch.sum(torch.where(inlier, wr2, 0.0)),
        invalid=torch.sum(d_valid & ~assoc).to(torch.int32),
    )
    return rows, stats


# calls of build_rows on CUDA tensors since the process began: kernel D's
# plain version, which no path of the card runs (the card's checks call it
# on purpose, and count those calls apart)
plain_on_cuda = {"build_rows": 0}


def jacobian_products(pose: torch.Tensor, data: Maps, model: Maps,
                      icp: IcpConfig, model_cfg: DataConfig, iteration=0,
                      semantic: bool = True):
    """One linearization: (J^T W J [6,6], J^T W f [6], stats)."""
    rows, stats = build_rows(pose, data, model, icp, model_cfg, iteration,
                             semantic)
    ata = rows.T @ rows
    return ata[:6, :6], ata[:6, 6], stats


# calls of gauss_newton and, where they are counted on the host (the CPU,
# the sharded and the host loops), the iterations they ran, since the
# process began; a card's latched loop leaves its count on the card, in its
# result's ``iterations``
gn_counts = {"calls": 0, "iterations": 0}


def _count_call(k) -> None:
    gn_counts["calls"] += 1
    if not isinstance(k, torch.Tensor) or k.device.type == "cpu":
        gn_counts["iterations"] += int(k)


def _solve_spd(jtj: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve by Cholesky with a tiny Tikhonov floor; NaN where the
    factorization fails (as the JAX Cholesky does)."""
    eye = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    a = jtj + 1e-8 * eye * torch.clamp_min(torch.trace(jtj) / 6.0, 1.0)
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan)


# --- the loop's state, kernel F and its two halves (kernels D and E) -----

# One linearization's sums, a row per block of kernel D: the lower triangle
# of A^T A[0:6, 0:6] by rows (21), A^T A[0:6, 6] (6), then error,
# inlier_residual, valid, inlier, outlier, invalid (the counts as float32,
# exact below 2^24).
NPART = 33
_NTRI = 21
# state_f [20] float32: pose [0:16], last_err 16, error 17,
# inlier_residual 18; state_i [8] int32: k 0, done 1, valid 2, inlier 3,
# outlier 4, invalid 5 (csrc/icp.cu)
_SF, _SI = 20, 8
_THREADS = 256        # kernels D and F: one thread a data pixel
_MAX_BLOCKS = 1024


def gn_state(t0: torch.Tensor, k=0):
    """The loop's device state ``(state_f, state_i)`` at pose ``t0``:
    last_err +inf, iteration ``k``, not done, statistics 0. Fills and one
    device copy: assigning a number to an element would upload it from
    pageable memory, which waits for the device."""
    dev = t0.device
    state_f = torch.zeros(_SF, dtype=torch.float32, device=dev)
    state_f[:16].copy_(t0.to(torch.float32).reshape(-1))
    state_f[16:17].fill_(math.inf)
    state_i = torch.zeros(_SI, dtype=torch.int32, device=dev)
    state_i[0:1].fill_(k)
    return state_f, state_i


def gn_result(state_f: torch.Tensor, state_i: torch.Tensor) -> IcpResult:
    """The loop's result as views of its state: the pose, the statistics of
    the last live linearization and the iterations, on the device."""
    return IcpResult(
        pose=state_f[:16].view(4, 4),
        stats=IcpStats(error=state_f[17], valid=state_i[2],
                       inlier=state_i[3], outlier=state_i[4],
                       inlier_residual=state_f[18], invalid=state_i[5]),
        iterations=state_i[0])


def _pack_products(ata: torch.Tensor, stats: IcpStats) -> torch.Tensor:
    """``A^T A`` [8, 8] and the statistics -> one ``[1, NPART]`` row."""
    il = torch.tril_indices(6, 6, device=ata.device)
    counts = torch.stack([stats.valid, stats.inlier, stats.outlier,
                          stats.invalid]).to(torch.float32)
    return torch.cat([ata[il[0], il[1]], ata[:6, 6],
                      torch.stack([stats.error, stats.inlier_residual]),
                      counts])[None]


def icp_products_plain(state_f: torch.Tensor, state_i: torch.Tensor,
                       data: Maps, model_img: torch.Tensor, icp: IcpConfig,
                       model_cfg: DataConfig, semantic: bool = True,
                       out=None) -> torch.Tensor:
    """Kernel D's plain version: :func:`build_rows` at the state's pose and
    iteration and ``rows.T @ rows``, as one ``[1, NPART]`` row (``out`` is
    not used)."""
    rows, stats = build_rows(state_f[:16].view(4, 4), data, None, icp,
                             model_cfg, state_i[0], semantic,
                             model_img=model_img)
    return _pack_products(rows.T @ rows, stats)


def gn_update_plain(partials: torch.Tensor, state_f: torch.Tensor,
                    state_i: torch.Tensor, icp: IcpConfig) -> None:
    """Kernel E's plain version, in place on the state: the partial sums
    summed over the blocks (in float64), the solve, the stop test and the
    pose update of the JAX loop's body; nothing changes once ``done`` is
    set."""
    tot = partials.to(torch.float64).sum(0).to(torch.float32)
    il = torch.tril_indices(6, 6, device=tot.device)
    low = torch.zeros((6, 6), dtype=torch.float32, device=tot.device)
    low[il[0], il[1]] = tot[:_NTRI]
    jtj = low + torch.tril(low, -1).T
    jtf = tot[_NTRI:_NTRI + 6]
    err = tot[27]
    counts = torch.round(tot[29:33]).to(torch.int32)
    delta = _solve_spd(jtj, -jtf)
    last_err = state_f[16]
    finite = torch.all(torch.isfinite(delta))
    stop = (torch.max(torch.abs(delta)) < icp.delta) \
        | (torch.abs(torch.max(jtf)) < icp.stopping_threshold) \
        | ((err < last_err)
           & (torch.abs(err - last_err) < icp.stopping_threshold)) \
        | ~finite
    pose = state_f[:16].view(4, 4)
    new_pose = lie.se3_exp(torch.nan_to_num(delta)) @ pose
    new_f = torch.cat([torch.where(finite, new_pose, pose).reshape(-1),
                       torch.stack([err, err, tot[28]]), state_f[19:]])
    new_i = torch.cat([(state_i[0] + 1).reshape(1),
                       stop.to(torch.int32).reshape(1), counts,
                       state_i[6:]])
    live = state_i[1] == 0
    state_f.copy_(torch.where(live, new_f, state_f))
    state_i.copy_(torch.where(live, new_i, state_i))


def _lib():
    lib = cuda_build.library("icp")
    if lib.icp_products.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.icp_products.argtypes = ([p] * 10 + [i] * 7
                                     + [ctypes.c_ulonglong] + [f] * 8 + [p])
        lib.icp_products.restype = i
        lib.gn_update.argtypes = [p, i, p, p, f, f, p]
        lib.gn_update.restype = i
        lib.gn_loop.argtypes = (lib.icp_products.argtypes[:-1]
                                + [i, i, f, f, p])
        lib.gn_loop.restype = i
        lib.gn_loop_occupancy.argtypes = [ctypes.POINTER(i)] * 2
        lib.gn_loop_occupancy.restype = i
    return lib


def _blocks(p: int) -> int:
    """Kernel D's grid for ``p`` data pixels (its rows of partial sums),
    and kernel F's slots: slot ``s`` is D's block ``s``."""
    return max(1, min(_MAX_BLOCKS, -(-p // _THREADS)))


@functools.lru_cache(maxsize=64)
def _products_consts(icp: IcpConfig, model_cfg: DataConfig) -> tuple:
    """Kernel D's scalar arguments after the partial sums' count: each float
    rounded to float32 as the plain version's tensor ops round it on the
    card (a tensor divided by a number is multiplied by its float32
    reciprocal there)."""
    if icp.weighting not in ("none", "huber", "turkey"):
        raise ValueError(f"icp: unknown weighting {icp.weighting!r}")
    if icp.sampling not in ("nearest", "bilinear"):
        raise ValueError(f"icp: unknown sampling {icp.sampling!r}")
    f32 = np.float32
    return (("none", "huber", "turkey").index(icp.weighting),
            int(icp.sampling == "bilinear"),
            float(f32(model_cfg.fov_up)), float(f32(1.0) / f32(model_cfg.fov)),
            float(f32(_DEG)), float(f32(INV_PI)),
            float(f32(icp.max_distance)),
            float(f32(math.cos(math.radians(icp.max_angle)))),
            float(f32(icp.factor)), float(f32(1.0) / f32(icp.factor)))


def _u8(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool \
        else (t != 0).view(torch.uint8)


def _check_state(state_f: torch.Tensor, state_i: torch.Tensor,
                 what: str) -> None:
    if state_f.shape != (_SF,) or state_i.shape != (_SI,) \
            or state_f.dtype != torch.float32 or state_i.dtype != torch.int32 \
            or not state_f.is_contiguous() or not state_i.is_contiguous():
        raise ValueError(f"{what}: not a gn_state")


def _kernel_args(state_f: torch.Tensor, state_i: torch.Tensor, data: Maps,
                 model_img: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool,
                 partials: torch.Tensor, what: str):
    """The checks of kernels D and F on one device and their shared leading
    arguments, up to the scalar floats: ``(args, keep)``, ``keep`` holding
    the converted tensors alive while the launch is queued. ``partials``,
    the kernel's buffer of partial sums, is the caller's to shape."""
    dev = state_f.device
    h, w = data.vertex.shape[:2]
    p = h * w
    mh, mw = model_cfg.height, model_cfg.width
    if model_img.shape != (mh * mw, 8) or model_img.dtype != torch.float32 \
            or not model_img.is_contiguous():
        raise ValueError(f"{what}: model image {tuple(model_img.shape)}"
                         f" is not a contiguous float32 [{mh * mw}, 8]")
    _check_state(state_f, state_i, what)
    tensors = (data.vertex, data.normal, data.vertex_valid, data.normal_valid,
               data.sem_label, data.sem_prob, model_img, state_i, partials)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    keep = (data.vertex.to(torch.float32).contiguous(),
            data.normal.to(torch.float32).contiguous(),
            _u8(data.vertex_valid), _u8(data.normal_valid),
            data.sem_label.to(torch.int32).contiguous(),
            data.sem_prob.to(torch.float32).contiguous())
    weighting, bilinear, *floats = _products_consts(icp, model_cfg)
    args = (*(t.data_ptr() for t in keep), model_img.data_ptr(),
            state_f.data_ptr(), state_i.data_ptr(), partials.data_ptr(), p,
            mh, mw, _blocks(p), weighting, bilinear, int(semantic),
            _MOVABLE_MASK, *floats)
    return args, keep


def icp_products(state_f: torch.Tensor, state_i: torch.Tensor, data: Maps,
                 model_img: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool = True,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One linearization at the state's pose and iteration: the partial sums
    ``[blocks, NPART]`` (``out`` if given). On a CPU tensor it runs
    :func:`icp_products_plain` (one row); on a CUDA tensor it launches
    kernel D or raises. Kernel D returns at once when the state is done."""
    dev = state_f.device
    if dev.type == "cpu":
        return icp_products_plain(state_f, state_i, data, model_img, icp,
                                  model_cfg, semantic)
    if dev.type != "cuda":
        raise ValueError(f"icp_products: unsupported device {dev}")
    h, w = data.vertex.shape[:2]
    nb = _blocks(h * w)
    if out is None:
        out = torch.empty((nb, NPART), dtype=torch.float32, device=dev)
    elif out.shape != (nb, NPART) or out.dtype != torch.float32 \
            or not out.is_contiguous():
        raise ValueError("icp_products: out is not a [blocks, NPART] buffer")
    args, _keep = _kernel_args(state_f, state_i, data, model_img, icp,
                               model_cfg, semantic, out, "icp_products")
    rc = _lib().icp_products(*args,
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "icp_products")
    icp_products.launches += 1
    return out


icp_products.launches = 0


def gn_update(partials: torch.Tensor, state_f: torch.Tensor,
              state_i: torch.Tensor, icp: IcpConfig) -> None:
    """Sum the partial sums, solve, test and update the state in place. On a
    CPU tensor it runs :func:`gn_update_plain`; on a CUDA tensor it
    launches kernel E or raises. Kernel E returns at once when the state is
    done."""
    dev = state_f.device
    if dev.type == "cpu":
        return gn_update_plain(partials, state_f, state_i, icp)
    if dev.type != "cuda":
        raise ValueError(f"gn_update: unsupported device {dev}")
    if partials.dim() != 2 or partials.shape[1] != NPART \
            or partials.dtype != torch.float32 \
            or not partials.is_contiguous() or partials.device != dev \
            or state_i.device != dev or state_f.shape != (_SF,) \
            or state_i.shape != (_SI,):
        raise ValueError("gn_update: expects float32 partials [blocks, "
                         f"{NPART}] and a gn_state on one device")
    rc = _lib().gn_update(partials.data_ptr(), partials.shape[0],
                          state_f.data_ptr(), state_i.data_ptr(),
                          icp.delta, icp.stopping_threshold,
                          torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "gn_update")
    gn_update.launches += 1


gn_update.launches = 0


def gn_loop_plain(state_f: torch.Tensor, state_i: torch.Tensor, data: Maps,
                  model_img: torch.Tensor, icp: IcpConfig,
                  model_cfg: DataConfig, semantic: bool = True,
                  max_iterations: int | None = None) -> None:
    """Kernel F's plain version, in place on the state: up to
    ``max_iterations`` (default ``icp.max_iterations``) trips of
    :func:`icp_products_plain` and :func:`gn_update_plain`, ending at the
    latch (a read of ``done`` a trip: on a CPU tensor it waits for
    nothing)."""
    if max_iterations is None:
        max_iterations = icp.max_iterations
    for _ in range(max_iterations):
        if bool(state_i[1]):
            break
        row = icp_products_plain(state_f, state_i, data, model_img, icp,
                                 model_cfg, semantic)
        gn_update_plain(row, state_f, state_i, icp)


@functools.lru_cache(maxsize=8)
def gn_loop_residency(device_index: int) -> tuple:
    """``(blocks a SM, SMs)``: how many blocks of kernel F the card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), queried once
    a device; raises where the card has no cooperative launch."""
    blocks, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().gn_loop_occupancy(ctypes.byref(blocks), ctypes.byref(sms))
    cuda_build.check(rc, "gn_loop_occupancy")
    return blocks.value, sms.value


def gn_loop_grid(nslots: int, blocks_per_sm: int, sms: int) -> int:
    """Kernel F's blocks: one a slot, at most what the card holds at once
    (a cooperative launch needs every block resident)."""
    return max(1, min(nslots, blocks_per_sm * sms))


def gn_loop(state_f: torch.Tensor, state_i: torch.Tensor, data: Maps,
            model_img: torch.Tensor, icp: IcpConfig, model_cfg: DataConfig,
            semantic: bool = True,
            max_iterations: int | None = None) -> None:
    """Up to ``max_iterations`` (default ``icp.max_iterations``)
    Gauss-Newton iterations on the state, in place, ending at the stop
    test: what ``max_iterations`` trips of
    :func:`icp_products` and :func:`gn_update` leave, bit for bit. On a CPU
    tensor it runs :func:`gn_loop_plain`; on a CUDA tensor it launches
    kernel F once (a cooperative launch: every block of the grid resident)
    or raises, also when the card refuses the cooperative launch."""
    dev = state_f.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_loop: unsupported device {dev}")
    _check_state(state_f, state_i, "gn_loop")
    if max_iterations is None:
        max_iterations = icp.max_iterations
    if not 0 <= int(max_iterations) == max_iterations:
        raise ValueError(f"gn_loop: max_iterations {max_iterations!r} is not "
                         "a whole number >= 0")
    max_iterations = int(max_iterations)
    if dev.type == "cpu":
        return gn_loop_plain(state_f, state_i, data, model_img, icp,
                             model_cfg, semantic, max_iterations)
    h, w = data.vertex.shape[:2]
    nslots = _blocks(h * w)
    halves = torch.empty((2, NPART, nslots), dtype=torch.float32, device=dev)
    args, _keep = _kernel_args(state_f, state_i, data, model_img, icp,
                               model_cfg, semantic, halves, "gn_loop")
    grid = gn_loop_grid(nslots, *gn_loop_residency(dev.index))
    rc = _lib().gn_loop(*args, grid, max_iterations, icp.delta,
                        icp.stopping_threshold,
                        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "gn_loop")
    gn_loop.launches += 1


gn_loop.launches = 0


def gauss_newton_latched(data: Maps, model: Maps, t0: torch.Tensor,
                         icp: IcpConfig, model_cfg: DataConfig,
                         semantic: bool = True,
                         max_iterations: int | None = None,
                         early_exit: bool = True, products=None,
                         update=None) -> IcpResult:
    """The loop on one :func:`gn_state` with no host read: :func:`gn_loop`
    (kernel F, one launch, on a card). Given ``products`` and ``update``
    (:func:`icp_products` and :func:`gn_update`, kernels D and E, or their
    plain versions) it runs ``max_iterations`` trips of them on the latch
    instead, which the card's checks hold kernel F against; on the CPU
    ``early_exit`` ends those trips at the latch, which changes no value.
    Returns :func:`gn_result` of the state."""
    max_iter = icp.max_iterations if max_iterations is None else max_iterations
    model_img = _pack_model_image(model)
    state_f, state_i = gn_state(t0)
    if products is None and update is None:
        gn_loop(state_f, state_i, data, model_img, icp, model_cfg, semantic,
                max_iter)
    else:
        products = icp_products if products is None else products
        update = gn_update if update is None else update
        stop_early = early_exit and state_f.device.type == "cpu"
        buf = None
        for _ in range(max_iter):
            buf = products(state_f, state_i, data, model_img, icp, model_cfg,
                           semantic, out=buf)
            update(buf, state_f, state_i, icp)
            if stop_early and bool(state_i[1]):
                break
    result = gn_result(state_f, state_i)
    _count_call(result.iterations)
    return result


def gauss_newton(data: Maps, model: Maps, t0: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool = True,
                 max_iterations: int | None = None,
                 group=None) -> IcpResult:
    """Gauss-Newton alignment. Stops on a minimal step (||delta||_inf <
    delta), a vanishing gradient, a converged error change, or a non-finite
    step, checked after applying the increment; at most ``max_iterations``
    (default ``icp.max_iterations``) linearizations. Without ``group`` it
    is :func:`gauss_newton_latched`: no host read, one launch of kernel F
    on a card, ``iterations`` a device int32. ``gn_counts`` counts the
    calls and their iterations for the run reports.

    ``group`` (a ``parallel.distributed.Group``): ``data`` holds this rank's
    rows only, and :func:`gauss_newton_sharded` sums the linearization over
    the ranks before the solve and the stopping test (the JAX package's
    ``psum`` over ``axis``)."""
    if group is not None:
        return gauss_newton_sharded(data, model, t0, icp, model_cfg, semantic,
                                    max_iterations, group)
    return gauss_newton_latched(data, model, t0, icp, model_cfg, semantic,
                                max_iterations)


def gauss_newton_sharded(data: Maps, model: Maps, t0: torch.Tensor,
                         icp: IcpConfig, model_cfg: DataConfig,
                         semantic: bool, max_iterations: int | None,
                         group) -> IcpResult:
    """The loop over the ranks of ``group`` on one :func:`gn_state`: each
    iteration kernel D (:func:`icp_products`) linearizes this rank's rows
    into its partial sums, ``group.sum`` adds the buffers elementwise over
    the ranks (every rank's buffer has the same slots: the ranks hold equal
    rows), and kernel E (:func:`gn_update`) sums the slots, solves, tests
    and updates the state; then the host reads ``done`` (one ``to_host`` an
    iteration) and stops on it. Every rank runs E on the same bits, so every
    rank holds the same state and leaves at the same iteration, and the
    next ``group.sum`` finds them all. On a CPU tensor D's plain version
    gives one row a rank and E's plain version the rest. ``iterations`` is
    a Python int: the host counts the reads."""
    max_iter = icp.max_iterations if max_iterations is None else max_iterations
    model_img = _pack_model_image(model)
    state_f, state_i = gn_state(t0)
    buf = None
    k = 0
    while k < max_iter:
        buf = icp_products(state_f, state_i, data, model_img, icp, model_cfg,
                           semantic, out=buf)
        gn_update(group.sum(buf), state_f, state_i, icp)
        k += 1
        if to_host(state_i[1]):
            break
    _count_call(k)
    return gn_result(state_f, state_i)._replace(iterations=k)


def gauss_newton_host(data: Maps, model: Maps, t0: torch.Tensor,
                      icp: IcpConfig, model_cfg: DataConfig,
                      semantic: bool = True,
                      max_iterations: int | None = None) -> IcpResult:
    """The loop on the host: each iteration builds the rows
    (:func:`build_rows`), reduces them with ``rows.T @ rows``, solves
    (:func:`_solve_spd`) and reads its stopping test to the host (one
    ``to_host`` an iteration). ``tools/gn_trace`` runs it to record each
    iteration, and the card's checks time it beside kernel F; no path runs
    it. ``iterations`` is a Python int."""
    max_iter = icp.max_iterations if max_iterations is None else max_iterations
    model_img = _pack_model_image(model)
    pose = t0.to(torch.float32)
    last_err = torch.full((), torch.inf, dtype=torch.float32,
                          device=pose.device)
    stats = IcpStats(*(torch.zeros((), dtype=dt, device=pose.device)
                       for dt in (torch.float32, torch.int32, torch.int32,
                                  torch.int32, torch.float32, torch.int32)))
    k = 0
    done = False
    while k < max_iter and not done:
        rows, stats = build_rows(pose, data, model, icp, model_cfg, k,
                                 semantic, model_img=model_img)
        ata = rows.T @ rows
        jtj, jtf = ata[:6, :6], ata[:6, 6]
        delta = _solve_spd(jtj, -jtf)
        err = stats.error
        finite = torch.all(torch.isfinite(delta))
        stop = (torch.max(torch.abs(delta)) < icp.delta) \
            | (torch.abs(torch.max(jtf)) < icp.stopping_threshold) \
            | ((err < last_err)
               & (torch.abs(err - last_err) < icp.stopping_threshold)) \
            | ~finite
        new_pose = lie.se3_exp(torch.nan_to_num(delta)) @ pose
        pose = torch.where(finite, new_pose, pose)
        last_err = err
        k += 1
        done = to_host(stop)
    _count_call(k)
    return IcpResult(pose=pose, stats=stats, iterations=k)


def evaluate(pose: torch.Tensor, data: Maps, model: Maps, icp: IcpConfig,
             model_cfg: DataConfig, semantic: bool = True) -> IcpStats:
    """Residual statistics at a fixed pose (loop-closure verification): the
    JAX package's one linearization at iteration 0, run as kernel F's first
    iteration (:func:`gn_loop` with ``max_iterations=1``: on a card one
    launch), whose update writes the statistics of the linearization it
    consumed into the state. Returned as views of the state on the device,
    with no host read; ``evaluate.calls`` counts the calls."""
    state_f, state_i = gn_state(pose)
    gn_loop(state_f, state_i, data, _pack_model_image(model), icp, model_cfg,
            semantic, 1)
    evaluate.calls += 1
    return gn_result(state_f, state_i).stats


evaluate.calls = 0
