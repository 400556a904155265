"""The ``model`` axis of segmenter training in the port (``make_2d_mesh``,
``shard_train_state`` on a ``("data", "model")`` mesh, the column-parallel
convolutions, ``unshard_train_state``) against the JAX package and against
the port's single-device step.

* Four gloo ranks on the CPU as a 2 x 2 grid run one f32 step of
  ``small_rangenet`` at 16x96 on a seeded batch of 4 (each data row 2
  images), started once a run (``tests/torch_shared.py``). Against the
  single-device step of the 4 images from the same weights: the loss within
  1e-6 relative, the batch statistics within 1e-6 and every gathered
  gradient leaf within 1e-4 of its scale, with the ``leaky_relu`` kink rule
  of ``test_torch_sharded_session.py`` (the ranks take each input's side
  from the single-device forward; at most 4 inputs a rank may change side,
  each within 1e-4 of the kink); the gathered first moments within 1e-4 of
  their scale. AdamW's first step moves a weight by the learning rate
  times g / (|g| + eps), so a gradient element near zero moves its weight
  by up to twice the learning rate more or less: the updated weights
  differ from the single device's by what the two gradients give, within
  two float32 ulps of the weight.
* The layers the port splits are exactly the leaves to which JAX's
  ``shard_train_state(state, make_2d_mesh(2, 2))`` gives a ``"model"``
  spec, parameters and AdamW moments alike; each rank holds half of each
  such weight and of its moments.
* ``make_2d_mesh`` places rank r where JAX's row-major device grid places
  device r, with the data group its column and the model group its row; a
  width the model axis does not divide raises, naming the layer.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

import torch_ranks
import torch_shared
from semantic_suma_tpu_torch.parallel.distributed import launch


def _four_ranks(work):
    batch = torch_shared.write_train_batch(work / "batch.npz")
    single = torch_shared.single_device_step(batch, work / "sides.npz")
    ranks = launch(torch_ranks.model_axis_step, 4,
                   (str(batch), str(work / "sides.npz")), cpu=True,
                   threads=1, timeout_s=120, join_timeout_s=120)
    return {"single": single, "ranks": ranks}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return torch_shared.once(tmp_path_factory, "model-axis", _four_ranks)


def _close_to_scale(got, want, tol):
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= tol, (k, err)


def test_grid_step_matches_single_device(grid):
    single = grid["single"]
    for o in grid["ranks"]:
        assert o["moved"].size <= 4 and (o["moved"] < 1e-4).all(), \
            o["moved"]
        np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-6)
        np.testing.assert_allclose(o["accuracy"], single["accuracy"],
                                   rtol=1e-6)
        _close_to_scale(o["buffers"], single["buffers"], 1e-6)
        assert set(o["grads"]) == set(single["grads"])
        _close_to_scale(o["grads"], single["grads"], 1e-4)
        _close_to_scale(o["moments"], single["moments"], 1e-4)


def test_grid_update_matches_single_device(grid):
    lr, eps = 1e-3, 1e-8   # create_train_state's defaults
    single = grid["single"]

    def update(g):  # AdamW's first step, per unit of learning rate
        g = g.astype(np.float64)
        return g / (np.abs(g) + eps)

    for o in grid["ranks"]:
        for k, want in single["params"].items():
            d = o["params"][k].astype(np.float64) - want
            # the two steps start from the same weights: their updates
            # differ by what their gradients give
            explained = -lr * (update(o["grads"][k])
                               - update(single["grads"][k]))
            ulps = np.spacing(np.abs(want).astype(np.float32))
            assert (np.abs(d - explained) <= 2 * ulps + 1e-9).all(), k
            assert np.abs(d).max() <= 2 * lr, k


def _jax_model_leaves():
    """The flax parameter paths (as the port's names) of the leaves to
    which JAX's ``shard_train_state`` on ``make_2d_mesh(2, 2)`` gives a
    ``"model"`` spec, for the parameters and for each AdamW moment."""
    import jax

    from semantic_suma_tpu.models import rangenet as jrn
    from semantic_suma_tpu.models.segmenter import create_train_state
    from semantic_suma_tpu.parallel import sharding as jsh
    # the rule reads shapes only: the state's shapes, traced without a
    # compile, filled with zeros and laid out with a device_put
    shapes = jax.eval_shape(lambda: create_train_state(
        jrn.small_rangenet(), jax.random.PRNGKey(0), (1, 16, 96, 5))[1])
    state = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    state = jsh.shard_train_state(state, jsh.make_2d_mesh(2, 2))

    def cut(tree):
        out = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if "model" in tuple(leaf.sharding.spec):
                keys = [p.key for p in path]
                assert keys[-1] == "kernel", keys
                out.add(".".join(keys[:-1]) + ".weight")
        return out

    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return cut(state.params), cut(adam.mu), cut(adam.nu), \
        {k for k in cut(state.batch_stats)}


def test_split_layers_are_jax_model_leaves(grid):
    params, mu, nu, stats = _jax_model_leaves()
    assert params and params == mu == nu and not stats
    for o in grid["ranks"]:
        assert set(o["local"]) == params
        for name, (weight, moment) in o["local"].items():
            full = o["full_shapes"][name]
            d = 1 if "ConvTranspose" in name.split(".")[-2] else 0
            half = tuple(n // 2 if i == d else n for i, n in enumerate(full))
            assert weight == moment == half, (name, weight, moment, full)
            assert o["params"][name].shape == full


def test_2d_mesh_places_ranks_as_jax(grid):
    import jax

    from semantic_suma_tpu.parallel import sharding as jsh
    ids = np.vectorize(lambda d: d.id)(jsh.make_2d_mesh(2, 2).devices)
    order = [d.id for d in jax.devices()[:4]]  # rank r <-> the r-th device
    for r, o in enumerate(grid["ranks"]):
        (row, col), = np.argwhere(ids == order[r])
        assert o["place"] == (row, col)
        assert o["model_ranks"] == [order.index(i) for i in ids[row]]
        assert o["data_ranks"] == [order.index(i) for i in ids[:, col]]


def test_width_the_model_axis_does_not_divide_raises(grid):
    for o in grid["ranks"]:
        assert o["odd"] is not None
        assert "129 output channels" in o["odd"]
        assert o["odd"].startswith("Encoder_0.ConvBlock_")
