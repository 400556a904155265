"""The port's configuration equals the JAX package's, field for field."""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

from semantic_suma_tpu import config as jc
from semantic_suma_tpu_torch import config as tc


def _jax_odometry_config():
    return jc.SumaConfig(
        map=jc.MapConfig(surfel_capacity=1 << 21, active_capacity=1 << 18,
                         min_fresh_rows=2 * 64 * 900, max_poses=8192,
                         spill_enabled=False),
        loop=jc.LoopClosureConfig(enabled=False),
        preprocess=jc.PreprocessConfig(use_filtered_vertexmap=True))


def test_default_config_matches():
    assert dataclasses.asdict(tc.SumaConfig()) \
        == dataclasses.asdict(jc.SumaConfig())


def test_small_config_matches():
    assert dataclasses.asdict(tc.SumaConfig().small()) \
        == dataclasses.asdict(jc.SumaConfig().small())


def test_odometry_config_matches():
    a, b = tc.odometry_config(), _jax_odometry_config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    # derived quantities the map geometry reads
    for prop in ("log_prior", "log_unstable", "active_radius",
                 "effective_block_size"):
        assert getattr(a.map, prop) == getattr(b.map, prop)
    assert a.data.pixel_size == b.data.pixel_size
