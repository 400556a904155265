"""The segmenter's KNN post-processing (counterpart of
``semantic_suma_tpu/models/rangenet.py:162-277``): rangenet_lib's KNN label
vote over the range image, and the reduction of per-pixel logits to the
per-point ``(raw label, probability)`` that the SLAM pipeline consumes
(``KITTIReader.cpp:183-200``).

:func:`knn_clean_image` is kernel C's wrapper (``csrc/knn.cu``): on a CPU
tensor it runs :func:`knn_clean_image_plain`; on a CUDA tensor it launches
the kernel or raises. :func:`knn_clean` is the per-point vote of
``knn_mode="point"``, off the default path, in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.labels import train_to_raw
from . import cuda_build


def _top_k_nearest(diffs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest ``diffs`` along the last axis, the
    lower index first among equal values (``lax.top_k`` of ``-diffs``)."""
    return torch.sort(diffs, dim=-1, stable=True).indices[..., :k]


def knn_clean_image_plain(class_image: torch.Tensor,
                          depth_image: torch.Tensor, k: int = 5,
                          window: int = 5,
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


def _lib():
    lib = cuda_build.library("knn")
    if lib.knn_vote.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.knn_vote.argtypes = [p, p, p, i, i, ctypes.c_float, p]
        lib.knn_vote.restype = i
    return lib


def knn_clean_image(class_image: torch.Tensor, depth_image: torch.Tensor,
                    k: int = 5, window: int = 5,
                    cutoff: float = 1.0) -> torch.Tensor:
    """Kernel C's wrapper: the contract of :func:`knn_clean_image_plain`.
    The kernel takes ``k = 5``, ``window = 5`` and ``[H, W]`` images of at
    least 1x1; a CUDA call with anything else raises."""
    if class_image.device.type == "cpu":
        return knn_clean_image_plain(class_image, depth_image, k, window,
                                     cutoff)
    if class_image.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {class_image.device}")
    if (k, window) != (5, 5):
        raise ValueError(f"knn: the kernel takes k = 5 and window = 5, not "
                         f"k = {k}, window = {window}")
    if class_image.dim() != 2 or depth_image.shape != class_image.shape \
            or depth_image.device != class_image.device \
            or class_image.numel() == 0:
        raise ValueError("knn: expects non-empty class and depth images of "
                         "one [H, W] shape on one device")
    h, w = class_image.shape
    cls = class_image.to(torch.int32).contiguous()
    depth = depth_image.to(torch.float32).contiguous()
    out = torch.empty_like(cls)
    rc = _lib().knn_vote(cls.data_ptr(), depth.data_ptr(), out.data_ptr(), h,
                         w, cutoff,
                         torch.cuda.current_stream(cls.device).cuda_stream)
    cuda_build.check(rc, "knn_vote")
    knn_clean_image.launches += 1
    return out


knn_clean_image.launches = 0


def knn_clean(point_px: torch.Tensor, point_py: torch.Tensor,
              point_depth: torch.Tensor, point_valid: torch.Tensor,
              class_image: torch.Tensor, depth_image: torch.Tensor,
              k: int = 5, window: int = 5,
              cutoff: float = 1.0) -> torch.Tensor:
    """Per-POINT KNN label vote (``knn_mode="point"``): each point's own
    range against its pixel's window (rows clamped, columns wrapped); the
    majority among the ``k`` nearest kept neighbours, the lowest train id
    on a tie; the pixel's class where none is kept; 0 for invalid points."""
    h, w = class_image.shape
    r = window // 2
    px = point_px.to(torch.int64)
    py = point_py.to(torch.int64)
    pd = point_depth.to(torch.float32)
    cut = torch.full((), cutoff, dtype=torch.float32, device=pd.device)
    diffs, labels = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            qx = torch.remainder(px + dx, w)
            qy = torch.clamp(py + dy, 0, h - 1)
            nb_d = depth_image[qy, qx]
            d = torch.abs(pd - nb_d)
            ok = torch.isfinite(nb_d) & (d < cut)
            diffs.append(torch.where(ok, d, torch.inf))
            labels.append(class_image[qy, qx].to(torch.int64))
    diffs = torch.stack(diffs, dim=1)       # [N, window^2]
    labels = torch.stack(labels, dim=1)
    top = _top_k_nearest(diffs, k)
    top_labels = torch.gather(labels, 1, top)
    top_ok = torch.isfinite(torch.gather(diffs, 1, top))
    # one-hot over 32 classes: an id outside [0, 32) casts no vote
    member = top_ok & (top_labels >= 0) & (top_labels < 32)
    votes = torch.zeros((px.shape[0], 32), dtype=torch.int32,
                        device=pd.device)
    votes.scatter_add_(1, torch.where(member, top_labels, 0),
                       member.to(torch.int32))
    # the first maximum over the classes
    top_count = votes.max(dim=1, keepdim=True).values
    ids = torch.arange(32, device=pd.device).expand_as(votes)
    voted = torch.where(votes == top_count, ids, 32).amin(dim=1)
    fallback = class_image[torch.clamp(py, 0, h - 1),
                           torch.remainder(px, w)].to(torch.int64)
    valid = point_valid.to(torch.bool)
    out = torch.where(valid & top_ok.any(1), voted,
                      torch.where(valid, fallback, 0))
    return out.to(torch.int32)


def labels_for_points(logits: torch.Tensor, point_px: torch.Tensor,
                      point_py: torch.Tensor, point_depth: torch.Tensor,
                      point_valid: torch.Tensor, depth_image: torch.Tensor,
                      use_knn: bool = True, knn_mode: str = "image"):
    """Per-pixel logits ``[H, W, C]`` -> per-point ``(raw label id int32,
    probability float32)``, both 0 for invalid points. ``knn_mode="image"``
    (the default) votes once per pixel (kernel C) and each point reads its
    pixel's vote; ``"point"`` is the per-point formulation."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    class_img = probs.argmax(dim=-1).to(torch.int32)   # the first maximum
    prob_img = probs.amax(dim=-1)
    h, w = class_img.shape
    qy = torch.clamp(point_py.to(torch.int64), 0, h - 1)
    qx = torch.remainder(point_px.to(torch.int64), w)
    if use_knn and knn_mode == "point":
        train_ids = knn_clean(point_px, point_py, point_depth, point_valid,
                              class_img, depth_image)
    else:
        img = knn_clean_image(class_img, depth_image) if use_knn \
            else class_img
        train_ids = img[qy, qx]
    raw = train_to_raw(train_ids)
    valid = point_valid.to(torch.bool)
    return (torch.where(valid, raw, 0).to(torch.int32),
            torch.where(valid, prob_img[qy, qx], 0.0))
