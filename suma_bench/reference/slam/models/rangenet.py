"""The segmentation network's input (counterpart of
``semantic_suma_tpu/models/rangenet.py``'s ``make_input``), the same for
every architecture; the networks themselves are ``suma_bench/nets/<arch>.py``.
The KNN label vote and ``labels_for_points`` live in ``ops/knn.py``."""

from __future__ import annotations

import torch


def make_input(vertex_map: torch.Tensor, depth_map: torch.Tensor,
               remission: torch.Tensor,
               vertex_valid: torch.Tensor) -> torch.Tensor:
    """The 5-channel network input (range, x, y, z, remission), ``[..., H,
    W, 5]``, zero on invalid pixels, as RangeNet++ stacks it."""
    depth = torch.where(torch.isfinite(depth_map), depth_map, 0.0)
    feats = torch.cat([depth[..., None], vertex_map, remission[..., None]],
                      dim=-1)
    return torch.where(vertex_valid[..., None], feats, 0.0)
