"""Range-image filters: normal map, semantic erosion, flood fill and the
plain bilateral filter (counterpart of ``semantic_suma_tpu/ops/filters.py``).
The horizontal axis wraps (the range image covers 360 degrees); rows shifted
in from outside the image take a fill value."""

from __future__ import annotations

import torch


def _shift_x(a: torch.Tensor, off: int) -> torch.Tensor:
    """Horizontal shift with wrap-around: out[:, x] = a[:, x + off]."""
    return torch.roll(a, -off, dims=1)


def _shift_y(a: torch.Tensor, off: int, fill) -> torch.Tensor:
    """Vertical shift out[y] = a[y + off]; rows from outside are ``fill``."""
    if off == 0:
        return a
    moved = torch.roll(a, -off, dims=0)
    h = a.shape[0]
    rows = torch.arange(h, device=a.device)
    inside = (rows + off >= 0) & (rows + off < h)
    return torch.where(inside.reshape([h] + [1] * (a.dim() - 1)), moved, fill)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def compute_normals(vertex_map: torch.Tensor, vertex_valid: torch.Tensor):
    """Cross-product normal map: normalize(cross(normalize(v(x+1,y)-v),
    normalize(v(x,y+1)-v))). Invalid where the pixel or either forward
    neighbour is invalid, both backward neighbours are invalid, or the cross
    product degenerates. Returns (normal [H,W,3], normal_valid [H,W])."""
    p = vertex_map
    pv = vertex_valid
    u = _shift_x(p, 1)
    uv = _shift_x(pv, 1)
    v = _shift_y(p, 1, 0.0)
    vv = _shift_y(pv, 1, False)
    sv = _shift_x(pv, -1)
    tv = _shift_y(pv, -1, False)

    du = _normalize(u - p)
    dv = _normalize(v - p)
    w = torch.linalg.cross(du, dv, dim=-1)
    wlen = torch.linalg.norm(w, dim=-1)

    valid = pv & uv & vv & ~(~sv & ~tv) & (wlen > 1e-7)
    normal = torch.where(valid[..., None],
                         w / torch.clamp_min(wlen, 1e-12)[..., None], 0.0)
    return normal, valid


def erode_semantics(sem_label: torch.Tensor, sem_prob: torch.Tensor,
                    vertex_valid: torch.Tensor):
    """A pixel keeps its label only if no 4-neighbour carries a different
    non-zero label; otherwise (and on invalid pixels) it becomes unlabeled."""
    p = sem_label
    conflict = torch.zeros_like(p, dtype=torch.bool)
    for nb in (_shift_x(p, 1), _shift_x(p, -1),
               _shift_y(p, 1, 0), _shift_y(p, -1, 0)):
        conflict = conflict | ((nb != p) & (nb != 0))
    keep = vertex_valid & ~conflict
    return torch.where(keep, p, 0), torch.where(keep, sem_prob, 1.0)


def flood_fill(sem_label: torch.Tensor, sem_prob: torch.Tensor,
               vertex_map: torch.Tensor, kernel_size: int = 3):
    """Fill unlabeled pixels from depth-consistent neighbours: for offsets
    1..kernel_size-1 and directions (+x, +y, -x, -y) in priority order, take
    the first neighbour with a non-zero label whose range differs by less than
    0.007 * range; the adopted probability decays as prob / (offset + 1)."""
    depth = torch.linalg.norm(vertex_map, dim=-1)
    out_label = sem_label
    out_prob = sem_prob
    taken = sem_label != 0
    for off in range(1, kernel_size):
        for shift in (lambda a, f: _shift_x(a, off),
                      lambda a, f: _shift_y(a, off, f),
                      lambda a, f: _shift_x(a, -off),
                      lambda a, f: _shift_y(a, -off, f)):
            # neighbours are read from the original maps (single pass)
            n_label = shift(sem_label, 0)
            n_prob = shift(sem_prob, 0.0)
            n_depth = shift(depth, 0.0)
            ok = (~taken) & (n_label != 0) & (
                torch.abs(depth - n_depth) < 0.007 * depth)
            out_label = torch.where(ok, n_label, out_label)
            out_prob = torch.where(ok, n_prob / (off + 1.0), out_prob)
            taken = taken | ok
    return out_label, out_prob


def bilateral_filter(vertex_map: torch.Tensor, vertex_valid: torch.Tensor,
                     sigma_space: float = 4.5, sigma_range: float = 30.0,
                     radius: int = 6) -> torch.Tensor:
    """Range bilateral filter as plain tensor code, tap by tap: smooth each
    pixel's range over a (2R+1)^2 window with Gaussian weights in pixel
    distance and range difference, then re-project along the view ray. This is
    the plain version of the CUDA kernel in :mod:`.bilateral`."""
    rng = torch.linalg.norm(vertex_map, dim=-1)
    ray = vertex_map / torch.clamp_min(rng, 1e-12)[..., None]
    ssf = -0.5 / (sigma_space * sigma_space)
    srf = -0.5 / (sigma_range * sigma_range)

    sum_wr = torch.zeros_like(rng)
    sum_w = torch.zeros_like(rng)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb_r = _shift_y(_shift_x(rng, dx), dy, 0.0)
            nb_v = _shift_y(_shift_x(vertex_valid, dx), dy, False)
            dr = rng - nb_r
            wgt = torch.where(nb_v,
                              torch.exp((dx * dx + dy * dy) * ssf
                                        + dr * dr * srf), 0.0)
            sum_wr = sum_wr + wgt * nb_r
            sum_w = sum_w + wgt
    filtered = torch.where(sum_w > 0, sum_wr / torch.clamp_min(sum_w, 1e-12),
                           rng)
    return torch.where(vertex_valid[..., None], filtered[..., None] * ray,
                       vertex_map)
