"""Segmenter training, inference and evaluation (counterpart of
``semantic_suma_tpu/models/segmenter.py``).

* :class:`Segmenter`: scan points -> per-point ``(raw label, probability)``,
  the role of ``RangenetAPI::infer`` and the argmax in ``KITTIReader::read``
  (reference ``KITTIReader.cpp:173-200``). The network is the one the
  weights file's ``model["arch"]`` names (:data:`ARCHS`): the darknet
  ``RangeNet`` (``"rangenet_darknet"``, also where the key is absent, as in
  every blob the JAX package writes; its weights in the JAX package's blob
  format, ``weights/segmenter_synth_*.pkl``, read and written back in it),
  ``SalsaNext`` (``"salsanext"``) or ``SqueezeSegV3`` (``"squeezesegv3"``),
  networks the JAX package does not have, their weights the module's own
  state dict (``convert.arrays_from_state``).
* The evaluation helpers (confusion matrix, mIoU, class weights) and the
  datasets of range images with train-class labels, from the synthetic
  world or from a KITTI reader.

* Training, of any of the networks: :class:`TrainState` (the module with its
  float32 master weights and batch-statistics buffers, its AdamW and the
  step),
  :func:`loss_fn` (pixel-weighted cross entropy), :func:`make_train_step`,
  and the two drivers :func:`train_synthetic` and :func:`train_kitti`. They
  compute what the JAX package's ``optax.adamw`` with a warmup + cosine
  schedule computes (``torch.optim.AdamW`` with the same settings, the
  schedule read at the step *before* it, as optax reads it), draw their
  batches from the same ``np.random.default_rng(seed)`` calls in the same
  order, and run the forward in bfloat16 on float32 master weights.
"""

from __future__ import annotations

import copy
import math
import pickle
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DataConfig
from ..device import resolve_device, to_host
from ..graphs import Replayer
from ..ops.knn import labels_for_points
from ..ops.projection import project_scan
from ..parallel.distributed import Group
from ..utils.timing import Stopwatch
from .labels import raw_to_train
from .rangenet import (Conv, ConvTranspose, RangeNet, batch_norm_constants,
                       make_input, small_rangenet)
from .salsanext import SalsaNext
from .squeezesegv3 import SqueezeSegV3

DARKNET, SALSANEXT, SQUEEZESEGV3 = ("rangenet_darknet", "salsanext",
                                    "squeezesegv3")
ARCHS = (DARKNET, SALSANEXT, SQUEEZESEGV3)
# a segmentation network the port builds: any of the modules
Network = RangeNet | SalsaNext | SqueezeSegV3


def build_network(spec: dict) -> Network:
    """The network of a weights file's ``model`` group, by its ``arch``
    (``"rangenet_darknet"`` where it has none)."""
    arch = spec.get("arch", DARKNET)
    if arch == SALSANEXT:
        return SalsaNext(num_classes=spec["num_classes"], base=spec["base"])
    if arch == SQUEEZESEGV3:
        return SqueezeSegV3(num_classes=spec["num_classes"],
                            stage_blocks=tuple(spec["stage_blocks"]),
                            widths=tuple(spec["widths"]))
    if arch == DARKNET:
        return RangeNet(num_classes=spec["num_classes"],
                        stage_blocks=tuple(spec["stage_blocks"]),
                        widths=tuple(spec["widths"]))
    raise ValueError(f"unknown segmentation network arch {arch!r}; the port "
                     f"builds {ARCHS}")


def network_spec(model: Network) -> dict:
    """The weights file's ``model`` group of ``model``."""
    if isinstance(model, SalsaNext):
        return {"arch": SALSANEXT, "num_classes": model.num_classes,
                "base": model.base}
    arch = SQUEEZESEGV3 if isinstance(model, SqueezeSegV3) else DARKNET
    return {"arch": arch, "num_classes": model.num_classes,
            "stage_blocks": tuple(model.stage_blocks),
            "widths": tuple(model.widths)}


def _variables_of(model: Network) -> dict:
    """The weights file's ``variables`` of ``model``: flax variables for the
    darknet RangeNet, the state dict's arrays for the others."""
    from ..convert import arrays_from_state, flax_variables_from_rangenet
    if not isinstance(model, RangeNet):
        return arrays_from_state(model.state_dict())
    return flax_variables_from_rangenet(model.state_dict())


def _state_of(model: Network, variables) -> dict:
    """The reverse of :func:`_variables_of`: ``model``'s state dict."""
    from ..convert import rangenet_state_from_flax, state_from_arrays
    if not isinstance(model, RangeNet):
        return state_from_arrays(variables)
    return rangenet_state_from_flax(variables)


class TrainState(NamedTuple):
    """A network in training: ``model`` holds the float32 master weights and
    the batch-statistics buffers (updated in place by each step),
    ``optimizer`` its AdamW, ``step`` the number of steps taken."""

    model: Network
    optimizer: torch.optim.Optimizer
    step: int


def warmup_cosine_decay(learning_rate: float, total_steps: int):
    """``optax.warmup_cosine_decay_schedule`` as the JAX package builds it:
    a linear warmup from 0.1 lr to lr over ``max(1, total // 20)`` steps,
    then a cosine from lr to 0.01 lr over the ``total - warmup`` steps left.
    Returns a function of the step count (the count before the step, as
    optax reads it)."""
    init, peak, end = 0.1 * learning_rate, learning_rate, 0.01 * learning_rate
    warmup = max(1, total_steps // 20)
    decay = total_steps - warmup
    if not decay > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay}.")
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(step: int) -> float:
        if step < warmup:
            frac = 1.0 - max(step, 0) / warmup
            return (init - peak) * frac + peak
        c = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def create_train_state(model: Network, seed: int = 0,
                       learning_rate=1e-3, weight_decay: float = 1e-4,
                       total_steps: int | None = None, device=None):
    """Initialise ``model`` from ``seed`` (its ``reset_parameters``: flax's
    initialisation for the darknet RangeNet, PyTorch's for SalsaNext and
    SqueezeSegV3, drawn from a ``torch.Generator``), move it to the device
    in training mode, and give it ``optax.adamw``'s optimizer: AdamW with b1 0.9, b2 0.999, eps 1e-8
    outside the square root and a decoupled weight decay scaled by the
    learning rate, on every parameter (the batch-norm scales and biases
    too; the running statistics are buffers). ``learning_rate`` may be a
    float or a function of the step; with ``total_steps`` a float becomes
    :func:`warmup_cosine_decay`. Returns ``(schedule, TrainState)``."""
    dev = resolve_device(device)
    model = model.reset_parameters(seed).to(dev).train()
    if total_steps is not None and not callable(learning_rate):
        learning_rate = warmup_cosine_decay(learning_rate, total_steps)
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.AdamW(model.parameters(), lr=lr0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return learning_rate, TrainState(model=model, optimizer=opt, step=0)


def loss_fn(model: Network, images, labels, valid, class_weights=None,
            train: bool = True, group: Group | None = None):
    """Pixel-weighted cross entropy over ``[B, H, W, 5]`` images; ``labels``
    are train-class ids, ``valid`` masks unlabelled and invalid pixels.
    Returns ``(loss, accuracy)``, both 0-dim float32 tensors; in training
    mode the forward also moves the batch-statistics buffers.

    With ``group`` (data-parallel ranks, each with its part of the batch)
    the weight sum, the hits and the valid count are summed over the ranks,
    so the sum over the ranks of each rank's loss is the loss of the global
    batch and the accuracy is the global one."""
    group = Group() if group is None else group
    model.train(train)
    logits = model(images)
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    w = valid.float()
    if class_weights is not None:
        w = w * class_weights[labels]
    hits = (logits.argmax(dim=-1) == labels) & valid
    sums = group.sum(torch.stack([w.sum(), hits.sum().float(),
                                  valid.sum().float()]))
    loss = -(ll * w).sum() / sums[0].clamp_min(1.0)
    acc = sums[1] / sums[2].clamp_min(1.0)
    return loss, acc


def make_train_step(schedule, class_weights=None, group: Group | None = None):
    """Returns ``train_step(state, images, labels, valid) -> (state,
    metrics)``: one AdamW step at the learning rate ``schedule(state.step)``
    (or the float ``schedule``). The module and its optimizer are updated in
    place; ``metrics`` holds the loss and accuracy as device tensors, so a
    step reads nothing back to the host.

    With ``group`` each rank passes its part of the global batch (every rank
    the same size) and the step computes the single-device step of the
    global batch: :func:`loss_fn` over the global weight sum, the gradients
    summed over the ranks before the update (batch norm takes the global
    statistics once ``parallel.sharding.shard_train_state`` gave the network
    the group)."""
    group = Group() if group is None else group

    def train_step(state: TrainState, images, labels, valid):
        lr = schedule(state.step) if callable(schedule) else schedule
        for pg in state.optimizer.param_groups:
            pg["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(state.model, images, labels, valid,
                            class_weights, train=True, group=group)
        loss.backward()
        group.sum_in_place([p.grad for p in state.model.parameters()
                            if p.grad is not None])
        state.optimizer.step()
        return (state._replace(step=state.step + 1),
                {"loss": group.sum(loss.detach()), "accuracy": acc})

    return train_step


def _trained_segmenter(cfg: DataConfig, model: Network, device):
    """A :class:`Segmenter` of the trained module's weights (any
    network)."""
    return Segmenter(cfg, model=model, variables=_variables_of(model),
                     device=device)


def _inference_copy(model: Network, device: torch.device) -> Network:
    """A copy of ``model`` whose convolution weights are stored in their
    compute type (bfloat16), so that no forward casts them again; on the GPU
    in ``channels_last`` memory, the layout of the network's input. A
    darknet or SqueezeSegV3 copy holds its walk's batch-norm constants,
    computed once."""
    net = copy.deepcopy(model).eval().requires_grad_(False)
    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            w = m.weight.data.to(m.dtype)
            if device.type == "cuda":
                w = w.contiguous(memory_format=torch.channels_last)
            m.weight.data = w
            if getattr(m, "bias", None) is not None:
                m.bias.data = m.bias.data.to(m.dtype)
    if isinstance(net, (RangeNet, SqueezeSegV3)):
        net.walk_constants = batch_norm_constants(net)
    return net


class Segmenter:
    """Inference facade: scan points -> (raw labels, probabilities), both on
    the segmenter's device.

    The weights are staged on the device once (an upload per call would move
    the whole network every scan) and kept twice: ``model``, the float32
    master that :meth:`save` writes, and a copy with bfloat16 convolution
    weights that the call runs. A call reads nothing back to the host: its
    outputs go straight into ``SurfelSLAM.process_scan_async``.

    On a card, a call (not :meth:`logits`) runs the network as one CUDA
    graph through ``replayer`` (``graphs.Replayer``, as the odometry step's
    stages run): the network's input is ``[1, H, W, 5]`` whatever the
    scan's point count, so it is captured once and replayed, one launch
    instead of one per layer. A replay hands on the graph's logits buffer,
    which the next call overwrites: only the call, which votes on the
    logits before it returns, takes that path. ``net`` stays the network
    module and its forward the way in, so a hook on ``net`` sees the logits
    on every path. ``replayer.counts["segmenter"]`` counts the calls by what
    they did, ``replayer.invalidations`` the eager ones by reason, and each
    call is a lap ``graph/segmenter/...`` on ``stopwatch``.

    ``model`` is any network (:data:`Network`; a small darknet where it
    is None); ``variables`` its weights as the weights file keeps them
    (:func:`_variables_of`), or None for seeded random ones."""

    def __init__(self, cfg: DataConfig, model: Network | None = None,
                 variables=None, rng_seed: int = 0, use_knn: bool = True,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else small_rangenet()
        if variables is None:
            self.model.reset_parameters(rng_seed)
        else:
            self.model.load_state_dict(_state_of(self.model, variables))
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.net = _inference_copy(self.model, self.device)
        self.use_knn = use_knn
        # the host-clock laps of the calls; a network that opens spans of
        # its own (SalsaNext) opens them on it
        self.stopwatch = Stopwatch()
        if isinstance(self.net, SalsaNext):
            self.net.stopwatch = self.stopwatch
        self.replayer = Replayer(self.device, ("segmenter",), self.stopwatch)
        self._graphed = False    # inside __call__'s network
        # a first call is one of the network (by its spec) at a shape
        self._spec = tuple(sorted(network_spec(self.model).items()))
        # the forward on the instance, so that nn.Module.__call__ (and the
        # hooks on ``net``) wraps the graph's path too; weak references, so
        # that the network keeps neither itself nor its segmenter alive
        seg_ref, net_ref = weakref.ref(self), weakref.ref(self.net)

        def forward(x):
            seg = seg_ref()
            if seg is None:   # the network outlived its segmenter
                net = net_ref()
                return type(net).forward(net, x)
            return seg._forward(x)
        self.net.forward = forward

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 5]`` network inputs -> ``[B, H, W, C]`` logits (a
        tensor of their own: the network runs eagerly)."""
        return self.net(images.to(self.device, torch.float32))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """``net``'s forward: eagerly, or inside :meth:`__call__` through
        the replayer."""
        plain = type(self.net).forward
        if not self._graphed:
            return plain(self.net, x)
        return self.replayer.run(
            "segmenter", (x,), lambda sw, inputs: plain(self.net, *inputs),
            context=self._spec)

    @torch.no_grad()
    def __call__(self, points, remissions=None):
        """Raw labels and probabilities of ``points``; on ``stopwatch`` the
        spans ``segmenter/project`` (the projection and the network's
        input), ``segmenter/network`` (the network, a graph's replay on a
        card; with SalsaNext's ``segmenter/network/*`` inside where it runs
        eagerly) and ``segmenter/vote`` (kernel C's vote)."""
        sw = self.stopwatch
        with sw.span("segmenter/project"):
            pts = torch.as_tensor(points, dtype=torch.float32,
                                  device=self.device)
            if remissions is None:
                rem = torch.zeros(pts.shape[:1], dtype=torch.float32,
                                  device=self.device)
            else:
                rem = torch.as_tensor(remissions, dtype=torch.float32,
                                      device=self.device)
            res = project_scan(pts, remissions=rem, cfg=self.cfg)
            net_in = make_input(res.vertex_map, res.depth_map, res.remission,
                                res.vertex_valid)[None]
        with sw.span("segmenter/network"):
            self._graphed = True
            try:
                logits = self.net(net_in)[0]
            finally:
                self._graphed = False
        with sw.span("segmenter/vote"):
            depth = torch.linalg.vector_norm(pts, dim=-1)
            return labels_for_points(
                logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0),
                depth, res.point_px >= 0, res.depth_map, use_knn=self.use_knn)

    def save(self, path: str, half: bool = True) -> None:
        """Pickle the weights as ``{"variables", "model"}``: the
        architecture under ``model`` (:func:`network_spec`, with its
        ``arch``), the weights under ``variables`` (:func:`_variables_of`:
        for the darknet RangeNet the JAX package's blob format, nested numpy
        dicts); ``half`` stores float32 leaves as float16."""

        def shrink(tree):
            if isinstance(tree, dict):
                return {k: shrink(v) for k, v in tree.items()}
            return tree.astype(np.float16) if half \
                and tree.dtype == np.float32 else tree

        blob = {"variables": shrink(_variables_of(self.model)),
                "model": network_spec(self.model)}
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    @classmethod
    def load(cls, path: str, cfg: DataConfig, model: Network | None = None,
             use_knn: bool = True, device=None) -> "Segmenter":
        """A segmenter from a blob written by either package (or a bare
        variables tree, the legacy format, a darknet's); the module is the
        one the blob's ``model["arch"]`` names (:func:`build_network`; the
        darknet RangeNet where it names none) unless ``model`` is given;
        float16 leaves load as float32."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict) and "variables" in blob:
            variables = blob["variables"]
            if model is None:
                model = build_network(blob["model"])
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


# ---------------------------------------------------------------------------
# training drivers
# ---------------------------------------------------------------------------

def _log_metrics(m) -> tuple:
    """(loss, accuracy) read to the host in one transfer."""
    return tuple(to_host(torch.stack([m["loss"], m["accuracy"]])))


def train_synthetic(cfg: DataConfig, *, n_train: int = 48, n_val: int = 8,
                    steps: int = 300, batch: int = 4, lr: float = 2e-3,
                    seed: int = 0, model: Network | None = None,
                    movable_fraction: float = 0.3, log=None, device=None):
    """Train a segmenter on the synthetic world; returns (Segmenter, held-out
    mIoU). The training set goes to the device once and each step's batch is
    a gather there; the batch indices are the JAX package's draws
    (``rng.integers`` of ``np.random.default_rng(seed)``, one call a step),
    made before the loop and uploaded once. The loop reads the host only at
    its logging steps (every 50th and the last)."""
    log = log or (lambda *a: None)
    dev = resolve_device(device)
    model = model if model is not None else small_rangenet()
    imgs, labs, vals = synthetic_dataset(cfg, n_train + n_val, seed=seed,
                                         movable_fraction=movable_fraction,
                                         device=dev)
    tr_i, tr_l, tr_v = imgs[:n_train], labs[:n_train], vals[:n_train]
    va_i, va_l, va_v = imgs[n_train:], labs[n_train:], vals[n_train:]

    cw = torch.as_tensor(class_weights_from_freq(tr_l, tr_v,
                                                 model.num_classes),
                         device=dev)
    schedule, state = create_train_state(model, seed, learning_rate=lr,
                                         total_steps=steps, device=dev)
    step_fn = make_train_step(schedule, class_weights=cw)

    tr_i_d, tr_l_d, tr_v_d = (torch.as_tensor(a, device=dev)
                              for a in (tr_i, tr_l, tr_v))
    rng = np.random.default_rng(seed)
    sel_all = torch.as_tensor(
        np.stack([rng.integers(0, n_train, size=batch)
                  for _ in range(steps)]), device=dev)
    for it in range(steps):
        sel = sel_all[it]
        state, m = step_fn(state, tr_i_d[sel], tr_l_d[sel], tr_v_d[sel])
        if it % 50 == 0 or it == steps - 1:
            loss, acc = _log_metrics(m)
            log(f"step {it}: loss={loss:.3f} acc={acc:.3f}")

    seg = _trained_segmenter(cfg, state.model, dev)
    m, per_class = evaluate_miou(seg, va_i, va_l, va_v)
    log(f"val mIoU = {m:.3f}  per-class={per_class}")
    return seg, m


def train_kitti(reader, cfg: DataConfig, *, epochs: int = 1, batch: int = 4,
                lr: float = 1e-3, seed: int = 0,
                model: Network | None = None, val_fraction: float = 0.1,
                log=None, device=None):
    """Train a segmenter on SemanticKITTI ``.label`` supervision with the
    quality contract of :func:`train_synthetic`: a held-out split,
    inverse-log-frequency class weights from a sample of the training scans,
    the warmup + cosine schedule, and a final held-out mIoU. The split and
    each epoch's order are the JAX package's permutations of
    ``np.random.default_rng(seed)``. Returns (Segmenter, mIoU)."""
    log = log or (lambda *a: None)
    dev = resolve_device(device)
    model = model if model is not None else small_rangenet()
    n = reader.count()
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_val = max(1, int(round(n * val_fraction)))
    val_idx, train_idx = order[:n_val], order[n_val:]
    if len(train_idx) < batch:
        raise ValueError(f"need >= {batch + 1} scans, got {n}")

    # class weights from a sample of the training labels
    sample = train_idx[:min(len(train_idx), 32)]
    s_i, s_l, s_v = kitti_dataset(reader, cfg, sample, device=dev)
    cw = torch.as_tensor(class_weights_from_freq(s_l, s_v, model.num_classes),
                         device=dev)

    steps_per_epoch = len(train_idx) // batch
    total = max(1, epochs * steps_per_epoch)
    schedule, state = create_train_state(model, seed, learning_rate=lr,
                                         total_steps=total, device=dev)
    step_fn = make_train_step(schedule, class_weights=cw)

    cache = {int(j): (s_i[k], s_l[k], s_v[k]) for k, j in enumerate(sample)}

    def fetch(j):
        j = int(j)
        if j not in cache:
            i_, l_, v_ = kitti_dataset(reader, cfg, [j], device=dev)
            cache[j] = (i_[0], l_[0], v_[0])
        return cache[j]

    for epoch in range(epochs):
        ep_order = rng.permutation(train_idx)
        for bi in range(steps_per_epoch):
            rows = [fetch(j) for j in ep_order[bi * batch:(bi + 1) * batch]]
            state, m = step_fn(state, *(
                torch.as_tensor(np.stack([r[k] for r in rows]), device=dev)
                for k in range(3)))
            if bi % 10 == 0:
                loss, acc = _log_metrics(m)
                log(f"epoch {epoch} step {bi}/{steps_per_epoch}: "
                    f"loss={loss:.3f} acc={acc:.3f}")

    seg = _trained_segmenter(cfg, state.model, dev)
    va_i, va_l, va_v = kitti_dataset(reader, cfg, val_idx, device=dev)
    m, per_class = evaluate_miou(seg, va_i, va_l, va_v)
    log(f"val mIoU = {m:.3f}  per-class={per_class}")
    return seg, m
