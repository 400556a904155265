"""Typed configuration for the port: the same frozen dataclasses and code
defaults as ``semantic_suma_tpu/config.py`` (kept as a copy, because importing
that module would import JAX). The XML loader and ``sweep`` are not ported
yet."""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class DataConfig:
    """Sensor / range-image geometry."""

    width: int = 900
    height: int = 64
    fov_up: float = 3.0      # degrees above horizon
    fov_down: float = -25.0  # degrees below horizon (negative)
    min_depth: float = 2.0
    max_depth: float = 75.0

    @property
    def fov(self) -> float:
        return abs(self.fov_up) + abs(self.fov_down)

    @property
    def pixel_size(self) -> float:
        # vertical angular extent of one pixel in radians (surfel radii)
        return math.radians(self.fov) / self.height


@dataclass(frozen=True)
class IcpConfig:
    """Projective ICP settings."""

    max_iterations: int = 33
    stopping_threshold: float = 1e-4
    delta: float = 1e-4
    max_distance: float = 2.0
    max_angle: float = 30.0
    weighting: str = "huber"          # none | huber | turkey
    factor: float = 0.5
    sampling: str = "nearest"         # nearest | bilinear
    initialize_identity: bool = False
    fallback_mode: bool = True
    fallback_max_distance: float = 0.5
    fallback_max_angle: float = 30.0
    fallback_translation_jump: float = 0.4
    fallback_rotation_jump: float = 0.1


@dataclass(frozen=True)
class MapConfig:
    """Surfel map / fusion settings."""

    surfel_capacity: int = 1 << 22
    active_capacity: int = 1 << 19
    max_poses: int = 10000
    block_size: int = 2048
    min_fresh_rows: int = 0
    min_radius: float = 0.03
    max_radius: float = 1.00
    max_angle: float = 90.0
    max_distance: float = 0.2
    map_max_angle: float = 45.0
    unstable_age: int = 3
    confidence_mode: int = 3
    confidence_threshold: float = 0.0
    p_stable: float = 0.6
    p_prior: float = 0.5
    p_unstable: float = 0.1
    sigma_angle: float = 1.0
    sigma_distance: float = 1.0
    use_stability: bool = True
    update_always: bool = False
    weighting_scheme: int = 0
    averaging_scheme: int = 0
    max_weight: float = 20.0
    stability_upper_bound: float = 20.0
    submap_dimension: int = 4
    submap_extent: float = 10.0
    time_init: int = 30
    spill_enabled: bool = True
    spill_chunk_blocks: int = 8
    spill_margin: float = 25.0
    unspill_margin: float = 25.0
    splat_resolve_radius: int = 1

    @property
    def log_prior(self) -> float:
        return math.log(self.p_prior / (1.0 - self.p_prior))

    @property
    def log_unstable(self) -> float:
        return math.log(self.p_unstable / (1.0 - self.p_unstable))

    @property
    def active_radius(self) -> float:
        return (2 * self.submap_dimension + 1) * self.submap_extent / 2.0

    @property
    def effective_block_size(self) -> int:
        """Block size adapted so the active view holds >= 16 blocks and both
        capacities divide evenly."""
        bs = min(self.block_size, max(64, self.active_capacity // 16))
        while bs > 1 and (self.active_capacity % bs
                          or self.surfel_capacity % bs):
            bs //= 2
        return bs


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop closure settings. The default gates target KITTI-scale
    trajectories (200 m of travel before a revisit counts); a ~115 m
    synthetic lap needs them shrunk, as :func:`loop_config` does."""

    enabled: bool = True
    residual_threshold: float = 1.15
    valid_threshold: float = 0.95
    outlier_threshold: float = 1.1
    search_distance: float = 50.0
    min_verifications: int = 5
    min_trajectory_distance: float = 200.0
    delta_timestamp: int = 100
    max_loop_closure_distance: float = 8.0
    compose_rendering: bool = True
    min_valid_ratio: float = 0.2
    max_outlier_ratio: float = 0.85
    max_increment_difference: float = 0.1
    residual_margin: float = 0.1
    search_levels: int = 3
    robust_kernel: str = "dcs"
    robust_delta: float = 1.0
    pipelined_verification: bool = True
    async_optimize: bool = True
    rebase_gate_translation: float = 0.02
    rebase_gate_rotation: float = 0.002
    verify_view_fraction: float = 0.5


@dataclass(frozen=True)
class PreprocessConfig:
    """Vertex/normal map generation."""

    use_filtered_vertexmap: bool = False
    bilateral_sigma_space: float = 0.5
    bilateral_sigma_range: float = 2.5
    averaging_scheme: int = 0  # 0: z-buffer nearest, 1: blend average
    semantic_erosion: bool = True
    flood_fill: bool = True


@dataclass(frozen=True)
class SemanticConfig:
    """Semantic segmentation settings."""

    enabled: bool = True
    num_classes: int = 20
    model_path: str = ""
    prior_movable_penalty: float = 0.5
    remove_movable_on_init: bool = True
    init_scans: int = 10


@dataclass(frozen=True)
class SumaConfig:
    """Top-level configuration bundle."""

    data: DataConfig = field(default_factory=DataConfig)
    model: DataConfig = field(default_factory=DataConfig)
    icp: IcpConfig = field(default_factory=IcpConfig)
    map: MapConfig = field(default_factory=MapConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    approach: str = "frame-to-model"  # or "frame-to-frame"
    odometry_info_translation: float = 1.0
    odometry_info_rotation: float = 1.0

    def __post_init__(self):
        # the view's fresh region must hold one full image of creations
        hw = self.data.height * self.data.width
        if self.map.min_fresh_rows < hw:
            object.__setattr__(self, "map",
                               replace(self.map, min_fresh_rows=hw))

    def replace(self, **kw) -> "SumaConfig":
        return replace(self, **kw)

    def small(self) -> "SumaConfig":
        """A downsized config for fast tests."""
        d = replace(self.data, width=180, height=32)
        return replace(
            self,
            data=d,
            model=d,
            map=replace(self.map, surfel_capacity=1 << 16,
                        active_capacity=1 << 15, max_poses=512),
        )


def odometry_config() -> SumaConfig:
    """The odometry path at full width: the map sizing of ``bench.py`` (a
    2^21-row arena, a 2^18-row active view, a two-image fresh region),
    the reference's ``use_filtered_vertexmap`` option on, loop closure and
    host spill off."""
    return SumaConfig(
        map=MapConfig(surfel_capacity=1 << 21, active_capacity=1 << 18,
                      min_fresh_rows=2 * 64 * 900, max_poses=8192,
                      spill_enabled=False),
        loop=LoopClosureConfig(enabled=False),
        preprocess=PreprocessConfig(use_filtered_vertexmap=True))


def loop_config() -> SumaConfig:
    """The loop-closure path at full width: the loop configuration of
    ``bench.py`` (a 2^21-row arena, a 2^18-row active view, a 1.5-image fresh
    region, 8192 poses; the gates shrunk for a ~115 m synthetic lap:
    ``min_trajectory_distance`` 60, ``delta_timestamp`` 20,
    ``search_distance`` 20, ``min_verifications`` 3, ``outlier_threshold``
    6), the default unfiltered preprocessing, host spill off (not ported)."""
    return SumaConfig(
        map=MapConfig(surfel_capacity=1 << 21, active_capacity=1 << 18,
                      min_fresh_rows=64 * 900 + 64 * 900 // 2, max_poses=8192,
                      spill_enabled=False),
        loop=LoopClosureConfig(enabled=True, min_trajectory_distance=60.0,
                               delta_timestamp=20, search_distance=20.0,
                               min_verifications=3, outlier_threshold=6.0))
