"""SE(3)/SO(3) Lie-group operations in PyTorch.

Counterpart of ``semantic_suma_tpu/utils/lie.py`` (Strasdat closed forms),
branch-free with Taylor fallbacks near theta=0 and a symmetric-axis fallback
near theta=pi. Twist convention: ``x = [v (translation); omega (rotation)]``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [...,3] -> [...,3,3] skew-symmetric matrix."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(ox)
    return torch.stack([
        torch.stack([zero, -oz, oy], -1),
        torch.stack([oz, zero, -ox], -1),
        torch.stack([-oy, ox, zero], -1),
    ], -2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [...,3,3] -> [...,3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3))


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor fallback: [...,3] -> [...,3,3]."""
    theta2 = torch.sum(omega * omega, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    k = hat(omega)
    k2 = k @ k
    return _eye3(omega) + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """SO(3) log: [...,3,3] -> [...,3] (angle-axis * angle), safe at theta ~ 0
    and theta ~ pi."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp(0.5 * (trace - 1.0), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)

    w = vee(r - r.transpose(-1, -2))  # = 2 sin(theta) * axis
    tiny = torch.abs(sin_t) < 1e-5
    scale = torch.where(tiny, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(tiny, 1.0, sin_t)))
    generic = scale[..., None] * w

    # near pi: R + I = 2 axis axis^T; take the column with the largest diagonal
    rp = r + torch.eye(3, dtype=r.dtype, device=r.device)
    diag = torch.stack([rp[..., 0, 0], rp[..., 1, 1], rp[..., 2, 2]], -1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(r.shape[:-2] + (3, 1))
    col = torch.gather(rp, -1, idx)[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    sign = torch.where(torch.sum(axis * w, -1, keepdim=True) < 0, -1.0, 1.0)
    near_pi = (theta > math.pi - 1e-3)[..., None]
    return torch.where(near_pi, sign * axis * theta[..., None], generic)


def _v_matrix(omega: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SE(3) exp (translation coupling)."""
    theta2 = torch.sum(omega * omega, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    gamma = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2)
    delta = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2 * theta))
    k = hat(omega)
    k2 = k @ k
    return _eye3(omega) + gamma[..., None, None] * k \
        + delta[..., None, None] * k2


def _v_inv_matrix(omega: torch.Tensor) -> torch.Tensor:
    """Inverse of the left Jacobian."""
    theta2 = torch.sum(omega * omega, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half)))
        / torch.where(small, 1.0, theta2))
    k = hat(omega)
    k2 = k @ k
    return _eye3(omega) - 0.5 * k + cot_term[..., None, None] * k2


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: twist [...,6] = [v, omega] -> [...,4,4]."""
    v, omega = x[..., :3], x[..., 3:]
    r = so3_exp(omega)
    t = torch.einsum("...ij,...j->...i", _v_matrix(omega), v)
    return rt_to_mat(r, t)


def se3_log(m: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: [...,4,4] -> twist [...,6] = [v, omega]."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    omega = so3_log(r)
    v = torch.einsum("...ij,...j->...i", _v_inv_matrix(omega), t)
    return torch.cat([v, omega], -1)


def rt_to_mat(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [...,4,4] from rotation [...,3,3] and translation [...,3]."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., None]], -1)
    # the last row of the identity (a fill kernel: an upload of constants
    # from pageable memory would wait for the device)
    bottom = torch.eye(4, dtype=r.dtype, device=r.device)[3].expand(
        batch + (4,))[..., None, :]
    return torch.cat([top, bottom], -2)


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Fast inverse of a rigid transform."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    rt = r.transpose(-1, -2)
    return rt_to_mat(rt, -torch.einsum("...ij,...j->...i", rt, t))


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] to points [...,N,3] (or [...,3])."""
    pts = pts if pts.dim() >= 2 else pts[None]
    return torch.einsum("...ij,...nj->...ni", m[..., :3, :3], pts) \
        + m[..., None, :3, 3]


def transform_normals(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate normals (rigid transform)."""
    n = n if n.dim() >= 2 else n[None]
    return torch.einsum("...ij,...nj->...ni", m[..., :3, :3], n)


def pose_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean translation distance."""
    return torch.linalg.norm(a[..., :3, 3] - b[..., :3, 3], dim=-1)


def rotation_angle(m: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a transform."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))


def orthonormalize(m: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) via SVD (drift cleanup)."""
    r = m[..., :3, :3]
    u, _, vt = torch.linalg.svd(r)
    det = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=m.dtype,
                                device=m.device), det[..., None]], -1)
    r_fixed = (u * fix[..., None, :]) @ vt
    return rt_to_mat(r_fixed, m[..., :3, 3])
