"""Range-image pyramids and coarse-to-fine ICP (counterpart of
``semantic_suma_tpu/ops/pyramid.py``).

Level ``l`` keeps, for every ``1 x 2^l`` column bin, the pixel with the
smallest range (the z-buffer winner of drawing the same points into a
``W / 2^l`` image); heights stay. :func:`gauss_newton_pyramid` solves at the
coarsest level first and seeds each finer level with the estimate.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch

from ..config import DataConfig, IcpConfig
from .icp import IcpResult, Maps, gauss_newton

# per-level iteration budget, fine -> coarse
DEFAULT_LEVEL_ITERATIONS = (33, 33, 33, 3, 3, 3)


def downsample_maps(maps: Maps, factor: int = 2) -> Maps:
    """One pyramid level: per ``1 x factor`` column bin keep the nearest
    (min range) valid pixel; the lowest in-bin offset wins ties and all-
    invalid bins."""
    h, w = maps.vertex.shape[:2]
    assert w % factor == 0, (w, factor)
    wl = w // factor

    depth = torch.linalg.norm(maps.vertex, dim=-1)
    depth = torch.where(maps.vertex_valid, depth, torch.inf)
    binned = depth.reshape(h, wl, factor)
    # the first offset that holds the minimum: torch.argmin does not promise
    # which of several equal entries it returns
    offsets = torch.arange(factor, device=depth.device)
    is_min = binned == torch.amin(binned, dim=-1, keepdim=True)
    sel = torch.amin(torch.where(is_min, offsets, factor), dim=-1)
    sel = torch.clamp_max(sel, factor - 1)  # a bin holding a NaN range

    def pick(img):
        if img.dim() == 3:
            r = img.reshape(h, wl, factor, img.shape[-1])
            idx = sel[..., None, None].expand(h, wl, 1, img.shape[-1])
            return torch.gather(r, 2, idx)[:, :, 0]
        r = img.reshape(h, wl, factor)
        return torch.gather(r, 2, sel[..., None])[:, :, 0]

    return Maps(vertex=pick(maps.vertex), normal=pick(maps.normal),
                vertex_valid=pick(maps.vertex_valid),
                normal_valid=pick(maps.normal_valid),
                sem_label=pick(maps.sem_label), sem_prob=pick(maps.sem_prob))


def build_pyramid(maps: Maps, levels: int) -> list[Maps]:
    """Levels fine -> coarse: ``[maps, W/2, W/4, ...]`` (length ``levels``)."""
    out = [maps]
    for _ in range(levels - 1):
        out.append(downsample_maps(out[-1], 2))
    return out


def level_config(cfg: DataConfig, level: int) -> DataConfig:
    """DataConfig for a width-halved level (same FOV, same height)."""
    return replace(cfg, width=cfg.width >> level)


def gauss_newton_pyramid(data: Maps, model: Maps, t0: torch.Tensor,
                         icp: IcpConfig, model_cfg: DataConfig,
                         levels: int = 3, semantic: bool = True,
                         level_iterations: Sequence[int] | None = None
                         ) -> IcpResult:
    """Coarse-to-fine projective ICP: solve at ``W / 2^(levels-1)`` first and
    feed the estimate down. Returns the finest level's pose and stats, the
    iteration counts summed over levels on the device (no host read). The
    association gates are the same at every level."""
    if level_iterations is None:
        level_iterations = DEFAULT_LEVEL_ITERATIONS
    data_pyr = build_pyramid(data, levels)
    model_pyr = build_pyramid(model, levels)

    pose = t0.to(torch.float32)
    total_iters = 0
    result = None
    for lvl in range(levels - 1, -1, -1):
        it = level_iterations[min(lvl, len(level_iterations) - 1)]
        result = gauss_newton(data_pyr[lvl], model_pyr[lvl], pose, icp,
                              level_config(model_cfg, lvl),
                              semantic=semantic, max_iterations=it)
        pose = result.pose
        total_iters += result.iterations
    return IcpResult(pose=pose, stats=result.stats, iterations=total_iters)
