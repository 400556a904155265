"""Pose-graph optimization on SE(3): Gauss-Newton with block-Jacobi
preconditioned conjugate gradient on the normal equations (counterpart of
``semantic_suma_tpu/core/posegraph.py``).

* Factors: odometry/loop between-factor residuals
  ``r = log(Z^-1 (X_i^-1 X_j))`` with diagonal information, plus a prior on
  the first pose.
* Linearization uses right-perturbations ``X exp(d)``; the edge Jacobians are
  forward-mode derivatives of the exact residual (``torch.func.jvp``). The normal
  equations are solved matrix-free; the matvec is an edge-wise gather and
  ``index_add_``.
* Levenberg damping on the diagonal; optional IRLS reweighting of flagged
  (loop) edges with ``huber`` or ``dcs``.

:func:`optimize` runs where its data's tensors live. On CUDA ``index_add_``
sums float32 contributions in no fixed order, so a card result equals the
CPU's only within a tolerance (the smoke run states it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device, to_host
from ..utils import lie


class PoseGraphData(NamedTuple):
    """Problem description as tensors on one device."""

    poses: torch.Tensor        # [N, 4, 4] current estimates
    edge_i: torch.Tensor       # [E] int64 source index
    edge_j: torch.Tensor       # [E] int64 target index
    edge_z: torch.Tensor       # [E, 4, 4] measured relative pose i->j
    edge_info: torch.Tensor    # [E, 6] diagonal information
    edge_valid: torch.Tensor   # [E] bool
    edge_robust: torch.Tensor  # [E] bool: apply the robust m-estimator
    n_poses: torch.Tensor      # int32 (poses beyond are ignored)


def _between_residual(xi, xj, z):
    """r = log(Z^-1 X_i^-1 X_j) in [v, omega] order."""
    rel = lie.se3_inverse(z) @ (lie.se3_inverse(xi) @ xj)
    return lie.se3_log(rel)


def _residuals(poses, data: PoseGraphData):
    r = _between_residual(poses[data.edge_i], poses[data.edge_j], data.edge_z)
    return torch.where(data.edge_valid[:, None], r, 0.0)


def _edge_jacobians(poses, data: PoseGraphData):
    """Jacobians of each edge residual w.r.t. right-perturbations of X_i and
    X_j (6x6 each), by forward-mode differentiation of the exact residual:
    an edge's residual depends on its own perturbation only, so column k of
    every edge's Jacobian is one JVP along basis twist k for all edges, and
    the six columns are one ``vmap`` over the basis."""
    e = data.edge_i.shape[0]
    zeros = torch.zeros((e, 6), dtype=poses.dtype, device=poses.device)
    xi = poses[data.edge_i]
    xj = poses[data.edge_j]
    basis = torch.eye(6, dtype=poses.dtype, device=poses.device)[
        :, None, :].expand(6, e, 6)

    def columns(fn):
        cols = torch.func.vmap(
            lambda tan: torch.func.jvp(fn, (zeros,), (tan,))[1])(basis)
        return cols.permute(1, 2, 0)          # [k, E, a] -> [E, a, k]

    ji = columns(lambda d: _between_residual(xi @ lie.se3_exp(d), xj,
                                             data.edge_z))
    jj = columns(lambda d: _between_residual(xi, xj @ lie.se3_exp(d),
                                             data.edge_z))
    mask = data.edge_valid[:, None, None]
    return torch.where(mask, ji, 0.0), torch.where(mask, jj, 0.0)


def _normal_matvec(x, ji, jj, data: PoseGraphData, lam, jtj_diag):
    """(J^T W J + lam*diag) @ x without materializing the matrix."""
    xi = x[data.edge_i]
    xj = x[data.edge_j]
    ri = torch.einsum("eab,eb->ea", ji, xi) + torch.einsum("eab,eb->ea", jj, xj)
    ri = ri * data.edge_info
    out = torch.zeros_like(x)
    out.index_add_(0, data.edge_i, torch.einsum("eba,eb->ea", ji, ri))
    out.index_add_(0, data.edge_j, torch.einsum("eba,eb->ea", jj, ri))
    out[0] += 1e6 * x[0]  # prior on pose 0 (large fixed information)
    return out + lam * jtj_diag * x


def _block_diag(ji, jj, data: PoseGraphData, n):
    """6x6 diagonal blocks of J^T W J for the block-Jacobi preconditioner."""
    wi = ji * data.edge_info[:, :, None]
    wj = jj * data.edge_info[:, :, None]
    bi = torch.einsum("eba,ebc->eac", ji, wi)
    bj = torch.einsum("eba,ebc->eac", jj, wj)
    blocks = torch.zeros((n, 6, 6), dtype=ji.dtype, device=ji.device)
    blocks.index_add_(0, data.edge_i, bi)
    blocks.index_add_(0, data.edge_j, bj)
    blocks[0] += 1e6 * torch.eye(6, dtype=ji.dtype, device=ji.device)
    return blocks


def _robust_weights(r, data: PoseGraphData, kernel: str, delta: float):
    """IRLS weight per edge from the whitened squared residual. Edges with
    ``edge_robust`` get the m-estimator weight, the rest keep weight 1.
    ``huber``: w = min(1, delta/|r|); ``dcs`` (dynamic covariance scaling):
    w = min(1, 2*delta^2/(delta^2+s))^2."""
    s = torch.sum(r * r * data.edge_info, dim=-1)      # whitened chi^2
    if kernel == "huber":
        w = torch.clamp_max(delta * torch.rsqrt(torch.clamp_min(s, 1e-30)),
                            1.0)
    elif kernel == "dcs":
        w = torch.clamp_max(2.0 * delta * delta / (delta * delta + s),
                            1.0) ** 2
    else:
        return torch.ones_like(s)
    return torch.where(data.edge_robust, w, 1.0)


def _robust_cost(r, data: PoseGraphData, kernel: str, delta: float):
    """Total robust cost rho(s) summed over edges (the objective whose
    decrease gates step acceptance)."""
    s = torch.sum(r * r * data.edge_info, dim=-1)
    if kernel == "huber":
        rho = torch.where(s <= delta * delta, s,
                          2.0 * delta * torch.sqrt(torch.clamp_min(s, 1e-30))
                          - delta * delta)
    elif kernel == "dcs":
        rho = torch.minimum(s, 4.0 * delta * delta * s / (delta * delta + s))
    else:
        rho = s
    return torch.sum(torch.where(data.edge_robust, rho, s))


# conjugate-gradient iterations between two reads of the stopping test on a
# CUDA device (on the CPU the test is read every iteration: it is free there)
_CG_CHECK_EVERY = 8


def optimize(data: PoseGraphData, max_gn_iters: int = 10,
             max_cg_iters: int = 64, lam: float = 1e-6, tol: float = 1e-6,
             robust_kernel: str = "none", robust_delta: float = 1.0):
    """Gauss-Newton with block-Jacobi PCG inner solves and optional IRLS
    reweighting of flagged edges. Returns (poses, error) on the device of
    ``data``.

    Both loops are Python loops. The Gauss-Newton test (step accepted,
    error change) is one host read per outer iteration. The CG loop keeps a
    device-side "still running" flag that freezes the iterate once the
    residual is under ``tol``, so the iterates are those of a loop that
    stops there; the flag is read to the host every iteration on the CPU and
    every ``_CG_CHECK_EVERY`` iterations on CUDA, only to leave early. Only
    reads of a device count in ``to_host.count``."""
    n = data.poses.shape[0]
    dev = data.poses.device
    mask = (torch.arange(n, device=dev) < data.n_poses)[:, None]
    check_every = 1 if dev.type == "cpu" else _CG_CHECK_EVERY
    read = torch.Tensor.tolist if dev.type == "cpu" else to_host
    eye6 = torch.eye(6, dtype=data.poses.dtype, device=dev)

    def error_of(poses):
        return _robust_cost(_residuals(poses, data), data, robust_kernel,
                            robust_delta)

    poses = data.poses
    err = error_of(poses)
    for _ in range(max_gn_iters):
        r = _residuals(poses, data)
        ji, jj = _edge_jacobians(poses, data)

        # IRLS: scale each robust edge's information by its current weight
        w = _robust_weights(r, data, robust_kernel, robust_delta)
        data_w = data._replace(edge_info=data.edge_info * w[:, None])

        wr = r * data_w.edge_info
        g = torch.zeros((n, 6), dtype=poses.dtype, device=dev)
        g.index_add_(0, data.edge_i, torch.einsum("eba,eb->ea", ji, wr))
        g.index_add_(0, data.edge_j, torch.einsum("eba,eb->ea", jj, wr))

        blocks = _block_diag(ji, jj, data_w, n)
        chol = torch.linalg.cholesky(blocks + 1e-6 * eye6)
        jtj_diag = torch.diagonal(blocks, dim1=-2, dim2=-1)

        def precond(v):
            return torch.cholesky_solve(v[..., None], chol)[..., 0]

        def matvec(v):
            return _normal_matvec(v * mask, ji, jj, data_w, lam,
                                  jtj_diag) * mask

        b = -g * mask
        x = torch.zeros_like(b)
        rr = b
        p = precond(b)
        rz = torch.sum(b * p)
        for k in range(max_cg_iters):
            running = torch.sum(rr * rr) > tol * tol
            if k % check_every == 0 and not read(running):
                break
            ap = matvec(p)
            alpha = rz / torch.clamp_min(torch.sum(p * ap), 1e-30)
            x = torch.where(running, x + alpha * p, x)
            rr = torch.where(running, rr - alpha * ap, rr)
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp_min(rz, 1e-30)
            p = torch.where(running, z + beta * p, p)
            rz = torch.where(running, rz_new, rz)

        new_poses = poses @ lie.se3_exp(x * mask)
        new_poses = torch.where(mask[:, :, None], new_poses, poses)

        err_old = err
        err_new = error_of(new_poses)
        improved = err_new < err_old
        done = ~improved | (torch.abs(err_old - err_new)
                            < 1e-9 * torch.clamp_min(err_old, 1.0))
        improved, done = read(torch.stack([improved, done]))
        if improved:
            poses, err = new_poses, err_new
        if done:
            break
    return poses, err


class Posegraph:
    """Host-side incremental pose-graph container (set_initial / add_edge /
    optimize / poses) with numpy mirrors of the edge list."""

    def __init__(self, edge_capacity: int = 16384):
        self._poses: list[np.ndarray] = []
        self._edges: list[tuple] = []
        self.edge_capacity = edge_capacity
        self._alloc_buffers(edge_capacity)
        self._cached = 0
        # identity of the list the mirror was filled from: replacing _edges
        # wholesale with a list of equal or greater length must invalidate
        # the mirror too, not only a shrink
        self._edges_id = id(self._edges)

    def _alloc_buffers(self, cap: int) -> None:
        self._buf_i = np.zeros(cap, np.int32)
        self._buf_j = np.zeros(cap, np.int32)
        self._buf_z = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        self._buf_info = np.zeros((cap, 6), np.float32)
        self._buf_robust = np.zeros(cap, bool)

    def _edge_arrays(self):
        e = len(self._edges)
        if self._cached > e or self._edges_id != id(self._edges):
            self._cached = 0
            self._edges_id = id(self._edges)
        if e > self.edge_capacity:
            # grow (x2) instead of failing
            while self.edge_capacity < e:
                self.edge_capacity *= 2
            old = (self._buf_i, self._buf_j, self._buf_z, self._buf_info,
                   self._buf_robust)
            n_old = old[0].shape[0]
            self._alloc_buffers(self.edge_capacity)
            for buf, prev in zip((self._buf_i, self._buf_j, self._buf_z,
                                  self._buf_info, self._buf_robust), old):
                buf[:n_old] = prev
        for k in range(self._cached, e):
            i, j, z, info, *rest = self._edges[k]
            self._buf_i[k] = i
            self._buf_j[k] = j
            self._buf_z[k] = z
            self._buf_info[k] = info
            self._buf_robust[k] = bool(rest[0]) if rest else False
        self._cached = e
        return (self._buf_i, self._buf_j, self._buf_z, self._buf_info,
                self._buf_robust)

    def set_initial(self, idx: int, pose) -> None:
        pose = np.asarray(pose, np.float32)
        while len(self._poses) <= idx:
            self._poses.append(np.eye(4, dtype=np.float32))
        self._poses[idx] = pose

    def add_edge(self, i: int, j: int, z, info=None,
                 robust: bool = False) -> None:
        """``robust=True`` marks the edge for the m-estimator during
        optimization (loop-closure edges)."""
        if info is None:
            info = np.ones(6, np.float32)
        self._edges.append((i, j, np.asarray(z, np.float32),
                            np.asarray(info, np.float32), bool(robust)))

    def pose(self, idx: int) -> np.ndarray:
        return self._poses[idx]

    def poses(self) -> list[np.ndarray]:
        return list(self._poses)

    def translations(self, n: int | None = None) -> np.ndarray:
        """[n, 3] pose translations (vectorized candidate search)."""
        n = len(self._poses) if n is None else min(n, len(self._poses))
        if n == 0:
            return np.zeros((0, 3), np.float32)
        return np.stack([p[:3, 3] for p in self._poses[:n]])

    def size(self) -> int:
        return len(self._poses)

    def clone(self) -> "Posegraph":
        g = Posegraph(self.edge_capacity)
        g._poses = [p.copy() for p in self._poses]
        g._edges = list(self._edges)
        return g

    def to_device(self, pose_capacity: int | None = None,
                  device=None) -> PoseGraphData:
        """The problem as tensors on ``device`` (the card unless named).
        Sized to the exact pose and edge counts (the JAX package pads both
        to power-of-two tiers to bound its compiled signatures; nothing is
        compiled here), or to ``pose_capacity`` poses; ``edge_valid`` and
        ``n_poses`` mask as they do there."""
        dev = resolve_device(device)
        n = len(self._poses)
        e = len(self._edges)
        cap_n = pose_capacity or n
        bi, bj, bz, binfo, brob = self._edge_arrays()  # grows capacity
        poses = np.tile(np.eye(4, dtype=np.float32), (cap_n, 1, 1))
        poses[:n] = np.stack(self._poses) if n else poses[:0]

        def put(a, dtype=None):
            return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

        return PoseGraphData(
            poses=put(poses), edge_i=put(bi[:e], torch.int64),
            edge_j=put(bj[:e], torch.int64), edge_z=put(bz[:e]),
            edge_info=put(binfo[:e]), edge_valid=put(np.ones(e, bool)),
            edge_robust=put(brob[:e]), n_poses=put(np.asarray(n, np.int32)))

    def optimize(self, max_iterations: int = 10,
                 robust_kernel: str = "none", robust_delta: float = 1.0,
                 device=None) -> float:
        """Run GN+PCG on ``device`` (the card unless the caller names
        another); writes the result back. Returns the final error."""
        if len(self._poses) < 2 or not self._edges:
            return 0.0
        data = self.to_device(device=device)
        poses, err = optimize(data, max_gn_iters=max_iterations,
                              robust_kernel=robust_kernel,
                              robust_delta=float(robust_delta))
        n = len(self._poses)
        packed = torch.cat([poses[:n].reshape(-1), err.reshape(1)])
        out = np.asarray(packed.tolist() if packed.device.type == "cpu"
                         else to_host(packed), np.float32)
        for i in range(n):
            self._poses[i] = out[16 * i:16 * i + 16].reshape(4, 4).copy()
        return float(out[-1])
