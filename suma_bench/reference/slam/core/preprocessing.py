"""Per-scan preprocessing: raw points -> vertex/normal/semantic maps
(counterpart of ``semantic_suma_tpu/core/preprocessing.py``): projection
through the z-buffer kernel, the bilateral kernel when
``use_filtered_vertexmap`` is set, normals, semantic erosion, flood fill."""

from __future__ import annotations

import torch

from ..config import SumaConfig
from ..models.labels import is_movable
from ..ops.filters import bilateral_filter
from ..ops.filters import compute_normals, erode_semantics, flood_fill
from ..ops.icp import Maps
from ..ops.projection import project_scan


def preprocess_scan(points: torch.Tensor, labels: torch.Tensor,
                    probs: torch.Tensor, point_valid: torch.Tensor,
                    is_first, cfg: SumaConfig) -> Maps:
    """Build the per-frame maps from a raw labeled scan. ``is_first`` (a bool
    or bool tensor) suppresses movable-class points during initialization."""
    pv = point_valid
    if cfg.semantic.enabled and cfg.semantic.remove_movable_on_init:
        pv = pv & ~(is_movable(labels) & is_first)

    res = project_scan(points, labels, probs, cfg=cfg.data, point_valid=pv,
                       averaging=cfg.preprocess.averaging_scheme == 1)

    vertex = res.vertex_map
    if cfg.preprocess.use_filtered_vertexmap:
        vertex = bilateral_filter(
            vertex, res.vertex_valid,
            sigma_space=cfg.preprocess.bilateral_sigma_space * 9.0,
            sigma_range=cfg.preprocess.bilateral_sigma_range)

    normal, nvalid = compute_normals(vertex, res.vertex_valid)

    sem_label, sem_prob = res.sem_label, res.sem_prob
    if cfg.semantic.enabled:
        if cfg.preprocess.semantic_erosion:
            sem_label, sem_prob = erode_semantics(sem_label, sem_prob,
                                                  res.vertex_valid)
        if cfg.preprocess.flood_fill:
            sem_label, sem_prob = flood_fill(sem_label, sem_prob, vertex)

    return Maps(vertex=vertex, normal=normal, vertex_valid=res.vertex_valid,
                normal_valid=nvalid, sem_label=sem_label, sem_prob=sem_prob)


def empty_maps(cfg: SumaConfig, device) -> Maps:
    h, w = cfg.data.height, cfg.data.width
    return Maps(
        vertex=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        normal=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        vertex_valid=torch.zeros((h, w), dtype=torch.bool, device=device),
        normal_valid=torch.zeros((h, w), dtype=torch.bool, device=device),
        sem_label=torch.zeros((h, w), dtype=torch.int32, device=device),
        sem_prob=torch.zeros((h, w), dtype=torch.float32, device=device))
