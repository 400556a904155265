"""Port's SE(3)/SO(3) maps against the JAX package near theta=0 and theta=pi
(atol 1e-5)."""
import torch_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from semantic_suma_tpu.utils import lie as jl
from semantic_suma_tpu_torch.utils import lie as tl

ATOL = 1e-5


def _twists(theta):
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    v = rng.normal(size=(16, 3))
    return np.concatenate([v, axis * theta], -1).astype(np.float32)


@pytest.mark.parametrize("theta", [0.0, 1e-6, 1e-3, 0.7, np.pi - 1e-4,
                                   np.pi - 1e-2])
def test_exp_log_match_jax(theta):
    x = _twists(theta)
    mj = np.asarray(jl.se3_exp(jnp.asarray(x)))
    mt = tl.se3_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mt, mj, atol=ATOL)
    # the JAX log is written for one pose (its scale does not broadcast
    # over a batch), so it is mapped over the batch
    lj = np.asarray(jax.vmap(jl.se3_log)(jnp.asarray(mj)))
    lt = tl.se3_log(torch.from_numpy(mj)).numpy()
    np.testing.assert_allclose(lt, lj, atol=ATOL)


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    m = np.asarray(jl.se3_exp(jnp.asarray(x)))
    m_noisy = (m + rng.normal(size=m.shape).astype(np.float32) * 1e-3)
    m_noisy[:, 3] = m[:, 3]
    mt = torch.from_numpy(m.copy())
    np.testing.assert_allclose(tl.se3_inverse(mt).numpy(),
                               np.asarray(jl.se3_inverse(jnp.asarray(m))),
                               atol=ATOL)
    np.testing.assert_allclose(tl.rotation_angle(mt).numpy(),
                               np.asarray(jl.rotation_angle(jnp.asarray(m))),
                               atol=1e-4)
    np.testing.assert_allclose(
        tl.orthonormalize(torch.from_numpy(m_noisy)).numpy(),
        np.asarray(jl.orthonormalize(jnp.asarray(m_noisy))), atol=ATOL)
