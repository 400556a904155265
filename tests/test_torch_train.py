"""The port's segmenter training (``models/rangenet.BatchNorm`` in training
mode, ``models/segmenter`` ``create_train_state`` / ``loss_fn`` /
``make_train_step`` / ``train_kitti``, ``convert.adamw_state_from_optax``
and ``cli train-segmenter``) against the JAX package on the CPU.

* Batch norm in training mode against flax ``nn.BatchNorm(
  use_running_average=False, dtype=float32)`` on one [2,16,96,32] input:
  the output and the new running statistics within 1e-6 of their largest
  magnitude.
* One float32 training step of ``small_rangenet`` (``dtype=float32`` in both
  packages) on converted random weights at 2x16x96, with class weights and
  a mask: the loss and the accuracy within 1e-5 relative, every gradient
  leaf within 1e-4 of that leaf's largest magnitude, the new batch
  statistics within 1e-5. ``leaky_relu``'s gradient jumps 10x at
  its kink, and of the ~10^6 inputs a few lie within float32 rounding
  (~3e-5) of it, where the two forwards may fall on either side (on this
  input one at 2.6e-6 does, in JAX against a float64 run of the port, and
  moves the leaves behind it by up to 8e-3 of their scale). So JAX's
  ``leaky_relu`` takes each input's side from the port's forward: at most
  4 inputs may change side, each within 1e-4 of the kink. The batch
  statistics are held leaf by leaf to 1e-5 of their largest magnitude.
* The optimizer alone: JAX's gradients fed to ``optax.adamw`` and to the
  port's AdamW for 3 steps from a mid-training state (5 optax steps in,
  converted by ``adamw_state_from_optax``) at the schedule's learning rate:
  every parameter leaf within 1e-6 of its largest magnitude. optax forms
  the bias correction ``1 - 0.999^t`` from float32's 0.999 (off by 1.3e-8),
  torch from the double, so an update differs by ~t·1e-5 relative; every
  leaf is ~0.1 in size (the head's bias too, zero at initialisation), so
  that this stays under 1e-6 of the leaf.
* The schedule at every step of a 200-step run (and of 3- and 2000-step
  runs) within 1e-7 of optax.
* ``train_kitti`` on a 7-scan sequence written by
  ``export_synthetic_sequence`` at ``SumaConfig().small()`` sizes: the JAX
  package's split, class-weight sample and per-epoch orders, index for
  index (the scans each package reads, in order, and the permutations they
  draw); the port's 6-step run writes a blob that JAX's ``Segmenter.load``
  reads.
* ``--cpu train-segmenter --synthetic 8 --small --steps 3``: the JAX JSON
  line, the exit code of the 0.5 rule, a blob both packages load; a dataset
  without labels exits 1 with the JAX message.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_suma_tpu.models import rangenet as jrn
from semantic_suma_tpu.models import segmenter as jseg
from semantic_suma_tpu_torch import cli as tcli
from semantic_suma_tpu_torch.convert import (adamw_state_from_optax,
                                             flax_variables_from_rangenet,
                                             rangenet_state_from_flax)
from semantic_suma_tpu_torch.models import rangenet as trn
from semantic_suma_tpu_torch.models import segmenter as tseg

SMALL = dict(stage_blocks=(1, 1, 2, 2, 1), widths=(16, 32, 64, 96, 128, 160))


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _close_to_scale(got, want, tol):
    """|got - want| <= tol * max|want|, leaf by leaf."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * scale,
                                   err_msg=str(k))


def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(0)
    c = 32
    x = rng.normal(0.3, 2.0, size=(2, 16, 96, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean, "var": var}},
                         jnp.asarray(x), mutable=["batch_stats"])

    port = trn.BatchNorm(c).train()
    with torch.no_grad():
        for t, v in ((port.scale, scale), (port.bias, bias),
                     (port.mean, mean), (port.var, var)):
            t.copy_(torch.from_numpy(v))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close_to_scale({"y": got.detach().numpy(),
                     "mean": port.mean.numpy(), "var": port.var.numpy()},
                    {"y": np.asarray(want),
                     "mean": np.asarray(upd["batch_stats"]["mean"]),
                     "var": np.asarray(upd["batch_stats"]["var"])}, 1e-6)
    # evaluation mode normalizes with the running statistics it now holds
    port.eval()
    want_eval = bn.clone(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    got_eval = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close_to_scale({"y": got_eval.permute(0, 2, 3, 1).detach().numpy()},
                    {"y": np.asarray(want_eval)}, 1e-6)


def _random_variables(seed):
    """flax variables of ``small_rangenet`` from the port's initialisation,
    with random norm parameters and running statistics."""
    net = trn.RangeNet(dtype=torch.float32, **SMALL).reset_parameters(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, trn.BatchNorm):
                for t, lo, hi in ((m.mean, -0.1, 0.1), (m.bias, -0.1, 0.1),
                                  (m.var, 0.5, 1.5), (m.scale, 0.5, 1.5)):
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape,
                                                        generator=gen))
    return flax_variables_from_rangenet(net.state_dict())


def _batch(seed, b=2, h=16, w=96):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, h, w, 5)).astype(np.float32)
    labels = rng.integers(0, 20, size=(b, h, w)).astype(np.int32)
    valid = rng.random((b, h, w)) < 0.8
    cw = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    return images, labels, valid, cw


def _grads_by_name(model):
    """The port's gradients in flax's layout (``params`` tree)."""
    return flax_variables_from_rangenet(
        {n: p.grad for n, p in model.named_parameters()})["params"]


class _RecordingF:
    """``torch.nn.functional`` whose ``leaky_relu`` records its inputs."""

    def __init__(self):
        self.inputs = []

    def leaky_relu(self, x, slope):
        self.inputs.append(x.detach().clone())
        return torch.nn.functional.leaky_relu(x, slope)

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


def test_train_step_f32_matches_flax(monkeypatch):
    variables = _random_variables(0)
    images, labels, valid, cw = _batch(1)

    # the port's step first, recording each leaky_relu input in call order
    rec = _RecordingF()
    monkeypatch.setattr(trn, "F", rec)
    model = trn.RangeNet(dtype=torch.float32, **SMALL)
    schedule, state = tseg.create_train_state(model, 0, learning_rate=1e-3,
                                              total_steps=20, device="cpu")
    state.model.load_state_dict(rangenet_state_from_flax(variables))
    step = tseg.make_train_step(schedule, class_weights=torch.from_numpy(cw))
    state, m = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                    torch.from_numpy(valid))
    assert state.step == 1

    # JAX's, with each leaky_relu input on the side the port's forward put
    # it (same call order: the same module traversal)
    sides = [x.permute(0, 2, 3, 1).numpy() > 0 for x in rec.inputs]
    seen = []

    def leaky_on_port_side(x, negative_slope=0.01):
        side = sides[len(seen)]
        assert side.shape == x.shape
        seen.append(x)
        return jnp.where(side, x, negative_slope * x)

    monkeypatch.setattr(fnn, "leaky_relu", leaky_on_port_side)
    jmodel = jrn.RangeNet(dtype=jnp.float32, **SMALL)

    def loss_and_inputs(params):
        del seen[:]
        loss, aux = jseg.loss_fn(params, variables["batch_stats"], jmodel,
                                 *(jnp.asarray(a) for a in
                                   (images, labels, valid, cw)), True)
        return loss, (aux, tuple(seen))

    (jloss, ((jacc, jstats), xs)), jgrads = jax.jit(jax.value_and_grad(
        loss_and_inputs, has_aux=True))(variables["params"])
    assert len(xs) == len(sides)
    # the inputs whose side JAX's own forward would choose otherwise
    moved = np.concatenate([np.abs(np.asarray(x))[(np.asarray(x) >= 0) != s]
                            for x, s in zip(xs, sides)])
    assert moved.size <= 4 and (moved < 1e-4).all(), moved

    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(jacc), rtol=1e-5)
    _close_to_scale(_leaves(_grads_by_name(state.model)), _leaves(jgrads),
                    1e-4)
    stats = flax_variables_from_rangenet(
        state.model.state_dict())["batch_stats"]
    _close_to_scale(_leaves(stats), _leaves(jstats), 1e-5)


def test_adamw_from_optax_state_matches_optax():
    variables = _random_variables(3)
    # a head bias of the size of the other leaves (the initialisation's is
    # zero; the module docstring says why the size matters)
    variables["params"]["Conv_0"]["bias"] = np.random.default_rng(5).uniform(
        -0.1, 0.1, 20).astype(np.float32)
    params = jax.tree.map(jnp.asarray, variables["params"])
    schedule_j = optax.warmup_cosine_decay_schedule(
        init_value=2e-4, peak_value=2e-3, warmup_steps=10, decay_steps=200,
        end_value=2e-5)
    tx = optax.adamw(schedule_j, weight_decay=1e-4)
    opt_state = tx.init(params)
    rng = np.random.default_rng(4)

    def grads():
        return jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32) * 0.01), params)

    update = jax.jit(tx.update)
    for _ in range(5):   # mid-training: Adam's update is no longer sign-like
        g = grads()
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)

    model = trn.RangeNet(dtype=torch.float32, **SMALL)
    schedule, state = tseg.create_train_state(model, 0, learning_rate=2e-3,
                                              total_steps=200, device="cpu")
    state.model.load_state_dict(rangenet_state_from_flax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": variables["batch_stats"]}))
    state.optimizer.state.update(adamw_state_from_optax(
        jax.tree.map(np.asarray, opt_state), state.model))
    state = state._replace(step=5)
    for _ in range(3):
        g = grads()
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        tg = rangenet_state_from_flax({"params": jax.tree.map(np.asarray,
                                                              g)})
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        for n, p in state.model.named_parameters():
            p.grad = tg[n]
        state.optimizer.step()
        state = state._replace(step=state.step + 1)
    got = _leaves(flax_variables_from_rangenet(
        state.model.state_dict())["params"])
    _close_to_scale(got, _leaves(jax.tree.map(np.asarray, params)), 1e-6)


@pytest.mark.parametrize("total", [3, 200, 2000])
def test_schedule_matches_optax(total):
    lr = 2e-3
    want = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=max(1, total // 20),
        decay_steps=total, end_value=lr * 0.01)
    steps = np.arange(total + 5)
    ref = np.asarray(want(jnp.asarray(steps)), np.float64)
    got = np.array([tseg.warmup_cosine_decay(lr, total)(int(s))
                    for s in steps])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


class _Recorder:
    """Wraps a ``np.random.Generator`` and records its permutations."""

    def __init__(self, gen, log):
        self._gen, self._log = gen, log

    def permutation(self, x):
        out = self._gen.permutation(x)
        self._log.append(np.array(out))
        return out

    def __getattr__(self, name):
        return getattr(self._gen, name)


def _recorded(monkeypatch, reader, fn):
    """Run ``fn()`` with the permutations of every new default_rng and the
    indices ``reader`` reads recorded."""
    perms, reads = [], []
    orig_rng, orig_read = np.random.default_rng, reader.read
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: _Recorder(orig_rng(*a, **k), perms))
    monkeypatch.setattr(reader, "read",
                        lambda j: (reads.append(int(j)), orig_read(j))[1])
    out = fn()
    monkeypatch.undo()
    return out, perms, reads


def test_train_kitti_order_and_blob_match_jax(tmp_path, monkeypatch):
    from semantic_suma_tpu.io.kitti import KITTIReader as JReader
    from semantic_suma_tpu.config import SumaConfig as JConfig
    from semantic_suma_tpu_torch.config import SumaConfig
    from semantic_suma_tpu_torch.io.kitti import KITTIReader
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence

    cfg = SumaConfig().small().data
    seq = str(tmp_path / "seq")
    export_synthetic_sequence(seq, 7, cfg, step=1.0, device="cpu")
    kw = dict(epochs=2, batch=2, lr=2e-3, seed=3)

    # the JAX driver with its training stubbed out: only its data order runs
    for name, stub in (
            ("create_train_state", lambda *a, **k: (
                None, jseg.TrainState(None, None, None, jnp.zeros(())))),
            ("make_train_step", lambda *a, **k: (
                lambda s, *b: (s, {"loss": 0.0, "accuracy": 0.0}))),
            ("evaluate_miou", lambda *a, **k: (0.0, {})),
            ("Segmenter", lambda *a, **k: None)):
        monkeypatch.setattr(jseg, name, stub)
    jreader = JReader(seq, use_gt_labels=True)
    _, jperms, jreads = _recorded(
        monkeypatch, jreader,
        lambda: jseg.train_kitti(jreader, JConfig().small().data,
                                 model=jrn.small_rangenet(), **kw))

    treader = KITTIReader(seq, use_gt_labels=True)
    (seg, miou), tperms, treads = _recorded(
        monkeypatch, treader,
        lambda: tseg.train_kitti(treader, cfg, model=trn.small_rangenet(),
                                 device="cpu", **kw))
    # the split, then one order per epoch; the scans read in the same order
    assert len(jperms) == len(tperms) == 1 + kw["epochs"]
    for a, b in zip(jperms, tperms):
        np.testing.assert_array_equal(a, b)
    assert treads == jreads
    assert 0.0 <= miou <= 1.0

    path = str(tmp_path / "w.pkl")
    seg.save(path)
    monkeypatch.undo()
    jloaded = jseg.Segmenter.load(path, JConfig().small().data)
    got = _leaves(jax.tree.map(np.asarray, jloaded.variables))
    want = _leaves(flax_variables_from_rangenet(seg.model.state_dict()))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(
            got[k], want[k].astype(np.float16).astype(np.float32)
            if want[k].dtype == np.float32 else want[k])


def test_cli_train_segmenter_synthetic(tmp_path, capsys):
    out = str(tmp_path / "w.pkl")
    rc = tcli.main(["--cpu", "train-segmenter", "--synthetic", "8",
                    "--small", "--steps", "3", "--out", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["val_miou", "weights"] and line["weights"] == out
    assert rc == (0 if line["val_miou"] > 0.5 else 1)
    from semantic_suma_tpu.config import DataConfig as JData
    from semantic_suma_tpu_torch.config import DataConfig
    jseg.Segmenter.load(out, JData())
    seg = tseg.Segmenter.load(out, DataConfig(), device="cpu")
    assert seg.model.widths == trn.small_rangenet().widths


def test_cli_train_segmenter_needs_labels(tmp_path, capsys):
    import shutil
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence
    seq = tmp_path / "seq"
    export_synthetic_sequence(str(seq), 3, DataConfig(width=96, height=16),
                              step=1.0, device="cpu")
    shutil.rmtree(seq / "labels")
    rc = tcli.main(["--cpu", "train-segmenter", "--dataset", str(seq),
                    "--out", str(tmp_path / "w.pkl")])
    assert rc == 1
    assert "ERROR: no SemanticKITTI labels found" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--cpu", "train-segmenter", "--out", "w.pkl"])
    assert exc.value.code == 2
