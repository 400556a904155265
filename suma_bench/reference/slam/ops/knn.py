"""The segmenter's KNN post-processing (counterpart of
``semantic_suma_tpu/models/rangenet.py:162-277``): rangenet_lib's KNN label
vote over the range image, and the reduction of per-pixel logits to the
per-point ``(raw label, probability)`` that the SLAM pipeline consumes
(``KITTIReader.cpp:183-200``).

:func:`knn_clean_image` is the plain version of the port's kernel C
(``csrc/knn.cu``).
"""

from __future__ import annotations

import torch

from ..models.labels import train_to_raw



def _top_k_nearest(diffs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest ``diffs`` along the last axis, the
    lower index first among equal values (``lax.top_k`` of ``-diffs``)."""
    return torch.sort(diffs, dim=-1, stable=True).indices[..., :k]


def knn_clean_image(class_image: torch.Tensor,
                    depth_image: torch.Tensor, k: int = 5, window: int = 5,
                    cutoff: float = 1.0) -> torch.Tensor:
    """Per-pixel KNN label vote, the plain version of kernel C: over the
    ``window x window`` neighbourhood (columns wrap, rows past the edges are
    no candidates) keep the neighbours whose range differs from the
    centre's by less than ``cutoff``; among the ``k`` nearest the label
    held by the most wins, the nearest on a tie; a pixel with no kept
    neighbour keeps its class. int32 ``[H, W]``."""
    h, _ = class_image.shape
    r = window // 2
    depth = depth_image.to(torch.float32)
    cls = class_image.to(torch.int32)
    rows = torch.arange(h, device=depth.device)
    cut = torch.full((), cutoff, dtype=torch.float32, device=depth.device)
    diffs, labels = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb_d = torch.roll(depth, (-dy, -dx), dims=(0, 1))
            nb_l = torch.roll(cls, (-dy, -dx), dims=(0, 1))
            if dy:  # vertical wrap is not adjacency (the yaw wrap is real)
                inside = (rows + dy >= 0) & (rows + dy < h)
                nb_d = torch.where(inside[:, None], nb_d, torch.inf)
            d = torch.abs(depth - nb_d)
            ok = torch.isfinite(nb_d) & (d < cut)
            diffs.append(torch.where(ok, d, torch.inf))
            labels.append(nb_l)
    diffs = torch.stack(diffs, dim=-1)      # [H, W, window^2]
    labels = torch.stack(labels, dim=-1)
    top = _top_k_nearest(diffs, k)
    top_labels = torch.gather(labels, -1, top)
    top_ok = torch.isfinite(torch.gather(diffs, -1, top))
    eq = (top_labels[..., :, None] == top_labels[..., None, :]) \
        & top_ok[..., None, :]
    counts = torch.where(top_ok, eq.sum(-1), -1)
    # the first maximum: the candidates are sorted nearest first
    voted = top_labels[..., 0]
    best = counts[..., 0]
    for j in range(1, k):
        better = counts[..., j] > best
        voted = torch.where(better, top_labels[..., j], voted)
        best = torch.where(better, counts[..., j], best)
    return torch.where(top_ok.any(-1), voted, cls)


def labels_for_points(logits: torch.Tensor, point_px: torch.Tensor,
                      point_py: torch.Tensor, point_depth: torch.Tensor,
                      point_valid: torch.Tensor, depth_image: torch.Tensor,
                      use_knn: bool = True):
    """Per-pixel logits ``[H, W, C]`` -> per-point ``(raw label id int32,
    probability float32)``, both 0 for invalid points: the vote runs once
    per pixel (kernel C's) and each point reads its pixel's vote."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    class_img = probs.argmax(dim=-1).to(torch.int32)   # the first maximum
    prob_img = probs.amax(dim=-1)
    h, w = class_img.shape
    qy = torch.clamp(point_py.to(torch.int64), 0, h - 1)
    qx = torch.remainder(point_px.to(torch.int64), w)
    img = knn_clean_image(class_img, depth_image) if use_knn else class_img
    train_ids = img[qy, qx]
    raw = train_to_raw(train_ids)
    valid = point_valid.to(torch.bool)
    return (torch.where(valid, raw, 0).to(torch.int32),
            torch.where(valid, prob_img[qy, qx], 0.0))
