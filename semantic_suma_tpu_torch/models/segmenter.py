"""Segmenter inference and evaluation (counterpart of the serving half of
``semantic_suma_tpu/models/segmenter.py``).

* :class:`Segmenter`: scan points -> per-point ``(raw label, probability)``,
  the role of ``RangenetAPI::infer`` and the argmax in ``KITTIReader::read``
  (reference ``KITTIReader.cpp:173-200``). Weights load from the JAX
  package's blob format (``weights/segmenter_synth_*.pkl``) and are written
  back in it.
* The evaluation helpers (confusion matrix, mIoU, class weights) and the
  datasets of range images with train-class labels, from the synthetic
  world or from a KITTI reader.

Training (``create_train_state``, ``loss_fn``, ``make_train_step``,
``train_synthetic``, ``train_kitti``) is not ported yet.
"""

from __future__ import annotations

import copy
import pickle

import numpy as np
import torch

from ..config import DataConfig
from ..device import resolve_device
from ..ops.knn import labels_for_points
from ..ops.projection import project_scan
from .labels import raw_to_train
from .rangenet import Conv, ConvTranspose, RangeNet, make_input, small_rangenet


def _inference_copy(model: RangeNet, device: torch.device) -> RangeNet:
    """A copy of ``model`` whose convolution weights are stored in their
    compute type (bfloat16), so that no forward casts them again; on the GPU
    in ``channels_last`` memory, the layout of the network's input."""
    net = copy.deepcopy(model).eval().requires_grad_(False)
    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            w = m.weight.data.to(m.dtype)
            if device.type == "cuda":
                w = w.contiguous(memory_format=torch.channels_last)
            m.weight.data = w
            if getattr(m, "bias", None) is not None:
                m.bias.data = m.bias.data.to(m.dtype)
    return net


class Segmenter:
    """Inference facade: scan points -> (raw labels, probabilities), both on
    the segmenter's device.

    The weights are staged on the device once (an upload per call would move
    the whole network every scan) and kept twice: ``model``, the float32
    master that :meth:`save` writes, and a copy with bfloat16 convolution
    weights that the call runs. A call reads nothing back to the host: its
    outputs go straight into ``SurfelSLAM.process_scan_async``."""

    def __init__(self, cfg: DataConfig, model: RangeNet | None = None,
                 variables=None, rng_seed: int = 0, use_knn: bool = True,
                 device=None):
        from ..convert import rangenet_state_from_flax
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else small_rangenet()
        if variables is None:
            self.model.reset_parameters(rng_seed)
        else:
            self.model.load_state_dict(rangenet_state_from_flax(variables))
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.net = _inference_copy(self.model, self.device)
        self.use_knn = use_knn

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 5]`` network inputs -> ``[B, H, W, C]`` logits."""
        return self.net(images.to(self.device, torch.float32))

    @torch.no_grad()
    def __call__(self, points, remissions=None):
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        if remissions is None:
            rem = torch.zeros(pts.shape[:1], dtype=torch.float32,
                              device=self.device)
        else:
            rem = torch.as_tensor(remissions, dtype=torch.float32,
                                  device=self.device)
        res = project_scan(pts, remissions=rem, cfg=self.cfg)
        net_in = make_input(res.vertex_map, res.depth_map, res.remission,
                            res.vertex_valid)[None]
        logits = self.net(net_in)[0]
        depth = torch.linalg.vector_norm(pts, dim=-1)
        return labels_for_points(
            logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0),
            depth, res.point_px >= 0, res.depth_map, use_knn=self.use_knn)

    def save(self, path: str, half: bool = True) -> None:
        """Pickle the weights in the JAX package's blob format (nested numpy
        dicts under ``variables``, the architecture under ``model``);
        ``half`` stores float32 leaves as float16."""
        from ..convert import flax_variables_from_rangenet

        def shrink(tree):
            if isinstance(tree, dict):
                return {k: shrink(v) for k, v in tree.items()}
            return tree.astype(np.float16) if half \
                and tree.dtype == np.float32 else tree

        blob = {"variables": shrink(flax_variables_from_rangenet(
                    self.model.state_dict())),
                "model": {"num_classes": self.model.num_classes,
                          "stage_blocks": tuple(self.model.stage_blocks),
                          "widths": tuple(self.model.widths)}}
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    @classmethod
    def load(cls, path: str, cfg: DataConfig, model: RangeNet | None = None,
             use_knn: bool = True, device=None) -> "Segmenter":
        """A segmenter from a blob written by either package (or a bare
        variables tree, the legacy format); float16 leaves load as
        float32."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict) and "variables" in blob:
            variables = blob["variables"]
            if model is None:
                m = blob["model"]
                model = RangeNet(num_classes=m["num_classes"],
                                 stage_blocks=tuple(m["stage_blocks"]),
                                 widths=tuple(m["widths"]))
        else:
            variables = blob

        def widen(tree):
            if isinstance(tree, dict):
                return {k: widen(v) for k, v in tree.items()}
            a = np.asarray(tree)
            return a.astype(np.float32) if a.dtype == np.float16 else a

        return cls(cfg, model=model, variables=widen(variables),
                   use_knn=use_knn, device=device)


def labels_from_projection(points, gt_labels, gt_probs, cfg: DataConfig):
    """Ground-truth label passthrough (SemanticKITTI ``.label`` files) shaped
    like the segmenter output."""
    return (torch.as_tensor(np.asarray(gt_labels), dtype=torch.int32),
            torch.as_tensor(np.asarray(gt_probs), dtype=torch.float32))


# ---------------------------------------------------------------------------
# evaluation (host numpy)
# ---------------------------------------------------------------------------

def confusion_matrix(pred, gt, valid, num_classes: int) -> np.ndarray:
    """[C, C] confusion counts over valid pixels (rows = gt, cols = pred)."""
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    valid = np.asarray(valid).reshape(-1)
    idx = gt[valid] * num_classes + pred[valid]
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray):
    """(mIoU over the classes present in the ground truth, per-class IoU)."""
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    present = (tp + fn) > 0
    iou = tp / np.maximum(tp + fp + fn, 1.0)
    per_class = {int(c): float(iou[c]) for c in np.nonzero(present)[0]}
    m = float(iou[present].mean()) if present.any() else 0.0
    return m, per_class


def class_weights_from_freq(labels, valid, num_classes: int) -> np.ndarray:
    """RangeNet++-style inverse-log-frequency class weights
    ``w_c = 1 / ln(1.02 + freq_c)``, normalised to mean 1."""
    lab = np.asarray(labels).reshape(-1)[np.asarray(valid).reshape(-1)]
    counts = np.bincount(lab, minlength=num_classes).astype(np.float64)
    freq = counts / max(counts.sum(), 1.0)
    w = 1.0 / np.log(1.02 + freq)
    return (w / w.mean()).astype(np.float32)


def evaluate_miou(seg: Segmenter, images, labels, valid, batch: int = 4):
    """mIoU of a segmenter over a stack of range images (train-class
    ids)."""
    n_cls = seg.model.num_classes
    cm = np.zeros((n_cls, n_cls), np.int64)
    for lo in range(0, images.shape[0], batch):
        imgs = torch.as_tensor(np.asarray(images[lo:lo + batch]))
        pred = seg.logits(imgs).argmax(dim=-1).cpu().numpy()
        cm += confusion_matrix(pred, labels[lo:lo + batch],
                               valid[lo:lo + batch], n_cls)
    return miou_from_confusion(cm)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _render_project(world, pose, cfg: DataConfig, generator, noise_sigma):
    """One scan of the synthetic world as (network input, train ids,
    labelled-pixel mask)."""
    from ..io.simulation import render_scan
    scan = render_scan(world, pose, cfg, noise_sigma=noise_sigma,
                       generator=generator)
    res = project_scan(scan.points, scan.labels, scan.probs, cfg=cfg,
                       point_valid=scan.valid)
    img = make_input(res.vertex_map, res.depth_map, res.remission,
                     res.vertex_valid)
    return (img, raw_to_train(res.sem_label),
            res.vertex_valid & (res.sem_label > 0))


def synthetic_dataset(cfg: DataConfig, n_scans: int, seed: int = 0,
                      movable_fraction: float = 0.3,
                      noise_sigma: float = 0.03, device=None):
    """Range images + train-class labels from the synthetic world: poses on
    rings of several radii and headings (the JAX package's draws from
    ``np.random.default_rng(seed)``); scan ``i``'s range noise comes from a
    ``torch.Generator`` seeded with ``seed * 1_000_003 + i``, so it does not
    equal the JAX package's. Returns numpy ``(images [N, H, W, 5], labels
    [N, H, W] int32, valid [N, H, W] bool)``."""
    from ..io.simulation import default_world
    dev = resolve_device(device)
    world = default_world(seed=seed, movable_fraction=movable_fraction)
    rng = np.random.default_rng(seed)
    radii = rng.uniform(10.0, 26.0, size=n_scans)
    angles = rng.uniform(0, 2 * np.pi, size=n_scans)
    imgs, labs, vals = [], [], []
    for i in range(n_scans):
        r, a = radii[i], angles[i]
        cy, sy = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        pose[:3, 3] = [r * np.cos(a), r * np.sin(a), 0.0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + i)
        img, lab, val = _render_project(
            world, torch.as_tensor(pose, device=dev), cfg, gen, noise_sigma)
        imgs.append(img.cpu().numpy())
        labs.append(lab.cpu().numpy())
        vals.append(val.cpu().numpy())
    return np.stack(imgs), np.stack(labs), np.stack(vals)


def kitti_dataset(reader, cfg: DataConfig, indices, device=None):
    """Project a set of reader scans into (images, train labels, valid)
    stacks: the KITTI analogue of :func:`synthetic_dataset`."""
    dev = resolve_device(device)
    imgs, labs, vals = [], [], []
    for j in indices:
        scan = reader.read(int(j))
        res = project_scan(
            torch.as_tensor(scan.points, device=dev),
            torch.as_tensor(np.asarray(scan.labels), device=dev),
            remissions=torch.as_tensor(scan.remissions, device=dev), cfg=cfg)
        img = make_input(res.vertex_map, res.depth_map, res.remission,
                         res.vertex_valid)
        imgs.append(img.cpu().numpy())
        labs.append(raw_to_train(res.sem_label).cpu().numpy())
        vals.append((res.vertex_valid & (res.sem_label > 0)).cpu().numpy())
    return np.stack(imgs), np.stack(labs), np.stack(vals)
