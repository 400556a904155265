"""The plain reference of each segmentation network a configuration can
name: one module a network architecture, ``nets/<arch>.py``, found by the
name in the configuration's ``segmenter`` group (``"arch"``, required) with
``harness.net(arch)``, as ``metrics/<name>.py`` is with ``harness.reader``.
The modules are loaded from their files, not imported as this package's
submodules, and import nothing of the port or of JAX.

A module defines:

* ``build(seg, dtype)``: the reference network of the ``segmenter`` group
  ``seg``, a ``torch.nn.Module`` that takes ``[B, H, W, 5]`` float32 inputs
  (range, x, y, z, remission, as ``reference/slam/models/rangenet.make_input``
  stacks them) and returns ``[B, H, W, C]`` float32 logits, with its
  convolutions computed in ``dtype``: ``torch.float32`` for the reference,
  ``torch.float8_e4m3fn`` (emulated) for the control;
* ``state_dict(blob, seg)``: the reference's state dict from the weights
  file as the port writes it (``seg["weights"]``, unpickled); it raises
  ``ValueError`` where the blob is not of this architecture or its shapes
  differ from ``seg``'s;
* ``forward_flops(seg)``: the FLOPs of one forward of one
  ``seg["data"]["height"] x seg["data"]["width"]`` image, from the layer
  shapes (multiply-adds times two).

The program's side of the contract: ``Segmenter.load(weights, DataConfig,
use_knn, device)`` builds the port's network from the same weights file, a
call runs ``Segmenter.net`` once on the scan's ``[1, H, W, 5]`` projection,
and ``Segmenter.net``'s output (its first element a ``[H, W, C]`` logits
tensor) is what the benchmark's forward hook keeps for ``logit_gap`` and
``vote_mismatch``. The network's work sits in the span
``segmenter/network``. A new architecture meets that inside the port, and
brings to the benchmark only new files: ``nets/<arch>.py``, its
configuration, its cell's limits, its metric readers and its weights."""
