"""Typed configuration for the port: the same frozen dataclasses and code
defaults as ``semantic_suma_tpu/config.py`` (kept as a copy, because importing
that module would import JAX), the loader of the reference's XML parameter
files and the ``sweep`` iterator."""

from __future__ import annotations

import dataclasses
import itertools
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Tuple


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
    6), the default unfiltered preprocessing, host spill off."""
    return SumaConfig(
        map=MapConfig(surfel_capacity=1 << 21, active_capacity=1 << 18,
                      min_fresh_rows=64 * 900 + 64 * 900 // 2, max_poses=8192,
                      spill_enabled=False),
        loop=LoopClosureConfig(enabled=True, min_trajectory_distance=60.0,
                               delta_timestamp=20, search_distance=20.0,
                               min_verifications=3, outlier_threshold=6.0))


def forced_spill_sections(height: int, width: int, arena_rows: int,
                          view_rows: int, spill: bool = True,
                          loops: bool = True) -> Dict[str, Dict[str, Any]]:
    """The forced-spill configuration of ``tests/test_spill.py`` at any image
    size, as keyword arguments by section (``data``, ``icp``, ``map``,
    ``loop``), so that either package can build it: a 12 m sensor (1 m
    minimum), 10 ICP iterations, 256 poses, one 8 m submap cell, spill and
    page-in margins of 5 m (keep radius 12 + 5 = 17 m: nothing the sensor
    still sees is evicted), 4-block chunks, and the loop gates of
    ``loop_config()``."""
    return dict(
        data=dict(width=width, height=height, max_depth=12.0, min_depth=1.0),
        icp=dict(max_iterations=10),
        map=dict(surfel_capacity=arena_rows, active_capacity=view_rows,
                 max_poses=256, submap_dimension=1, submap_extent=8.0,
                 spill_enabled=spill, spill_margin=5.0, unspill_margin=5.0,
                 spill_chunk_blocks=4),
        loop=dict(enabled=loops, min_trajectory_distance=60.0,
                  delta_timestamp=20, search_distance=20.0,
                  min_verifications=3, outlier_threshold=6.0))


def forced_spill_config(height: int, width: int, arena_rows: int,
                        view_rows: int, spill: bool = True,
                        loops: bool = True) -> SumaConfig:
    """``forced_spill_sections`` as the port's configuration."""
    s = forced_spill_sections(height, width, arena_rows, view_rows, spill,
                              loops)
    d = DataConfig(**s["data"])
    return SumaConfig(data=d, model=d, icp=IcpConfig(**s["icp"]),
                      map=MapConfig(**s["map"]),
                      loop=LoopClosureConfig(**s["loop"]))


# ---------------------------------------------------------------------------
# XML compatibility layer
# ---------------------------------------------------------------------------

_XML_CASTS = {
    "integer": int,
    "float": float,
    "string": str,
    "boolean": lambda s: s.strip().lower() == "true",
}

# reference XML parameter name -> (section, field) in SumaConfig
_XML_MAP: Dict[str, Tuple[str, str]] = {
    "data_width": ("data", "width"),
    "data_height": ("data", "height"),
    "data_fov_up": ("data", "fov_up"),
    "data_fov_down": ("data", "fov_down"),
    "max_depth": ("data", "max_depth"),
    "min_depth": ("data", "min_depth"),
    "model_width": ("model", "width"),
    "model_height": ("model", "height"),
    "model_fov_up": ("model", "fov_up"),
    "model_fov_down": ("model", "fov_down"),
    "model_max_depth": ("model", "max_depth"),
    "model_min_depth": ("model", "min_depth"),
    "max iterations": ("icp", "max_iterations"),
    "stopping threshold": ("icp", "stopping_threshold"),
    "delta": ("icp", "delta"),
    "icp-max-distance": ("icp", "max_distance"),
    "icp-max-angle": ("icp", "max_angle"),
    "weighting": ("icp", "weighting"),
    "factor": ("icp", "factor"),
    "initialize_identity": ("icp", "initialize_identity"),
    "fallback_mode": ("icp", "fallback_mode"),
    "fallback-max-distance": ("icp", "fallback_max_distance"),
    "fallback-max-angle": ("icp", "fallback_max_angle"),
    "min_radius": ("map", "min_radius"),
    "max_radius": ("map", "max_radius"),
    "max_angle": ("map", "max_angle"),
    "map-max-distance": ("map", "max_distance"),
    "map-max-angle": ("map", "map_max_angle"),
    "unstable_age": ("map", "unstable_age"),
    "confidence_mode": ("map", "confidence_mode"),
    "confidence_threshold": ("map", "confidence_threshold"),
    "p_stable": ("map", "p_stable"),
    "p_prior": ("map", "p_prior"),
    "sigma_angle": ("map", "sigma_angle"),
    "sigma_distance": ("map", "sigma_distance"),
    "use_stability": ("map", "use_stability"),
    "update_always": ("map", "update_always"),
    "weighting_scheme": ("map", "weighting_scheme"),
    "averaging_scheme": ("map", "averaging_scheme"),
    "submap-dimension": ("map", "submap_dimension"),
    "submap-extent": ("map", "submap_extent"),
    "close-loops": ("loop", "enabled"),
    "loop-residual-threshold": ("loop", "residual_threshold"),
    "loop-valid-threshold": ("loop", "valid_threshold"),
    "loop-outlier-threshold": ("loop", "outlier_threshold"),
    "loop-search-distance": ("loop", "search_distance"),
    "loop-min-verifications": ("loop", "min_verifications"),
    "loop-min-trajectory-distance": ("loop", "min_trajectory_distance"),
    "max_loop_closure_distance": ("loop", "max_loop_closure_distance"),
    "compose_rendering": ("loop", "compose_rendering"),
    "loop-min-valid-ratio": ("loop", "min_valid_ratio"),
    "loop-max-outlier-ratio": ("loop", "max_outlier_ratio"),
    "loop-max-increment-difference": ("loop", "max_increment_difference"),
    "loop-residual-margin": ("loop", "residual_margin"),
    "loop-delta-timestamp": ("loop", "delta_timestamp"),
    "loop-search-levels": ("loop", "search_levels"),
    "loop-verify-view-fraction": ("loop", "verify_view_fraction"),
    "use_filtered_vertexmap": ("preprocess", "use_filtered_vertexmap"),
    "bilateral_sigma_range": ("preprocess", "bilateral_sigma_range"),
    "model_path": ("semantic", "model_path"),
    "approach": ("", "approach"),
}


def parse_parameter_xml(path: str) -> Dict[str, Any]:
    """Parse the reference's ``<config><param name=.. type=..>value</param>
    </config>`` format into a dict."""
    root = ET.parse(path).getroot()
    out: Dict[str, Any] = {}
    for node in root.iter("param"):
        name = node.attrib["name"]
        cast = _XML_CASTS.get(node.attrib.get("type", "string"), str)
        out[name] = cast(node.text or "")
    return out


def config_from_xml(path: str, base: SumaConfig | None = None) -> SumaConfig:
    """A SumaConfig from a reference-format XML file: the parameters of
    ``_XML_MAP`` replace the fields of ``base`` (default ``SumaConfig()``);
    other names are ignored."""
    cfg = base or SumaConfig()
    sections: Dict[str, Dict[str, Any]] = {}
    top: Dict[str, Any] = {}
    for name, value in parse_parameter_xml(path).items():
        if name not in _XML_MAP:
            continue
        section, fname = _XML_MAP[name]
        if section == "":
            top[fname] = value
        else:
            sections.setdefault(section, {})[fname] = value
    for section, kv in sections.items():
        cfg = replace(cfg, **{section: replace(getattr(cfg, section), **kv)})
    if top:
        cfg = replace(cfg, **top)
    return cfg


def sweep(cfg: SumaConfig, grid: Dict[str, List[Any]]) -> Iterator[SumaConfig]:
    """Parameter-sweep iterator over dotted field paths, e.g.
    ``sweep(cfg, {"icp.factor": [0.25, 0.5], "map.p_stable": [0.6]})``."""
    keys = list(grid.keys())
    for combo in itertools.product(*(grid[k] for k in keys)):
        out = cfg
        for key, value in zip(keys, combo):
            parts = key.split(".")
            if len(parts) == 1:
                out = replace(out, **{parts[0]: value})
            else:
                section = getattr(out, parts[0])
                out = replace(out, **{parts[0]: replace(
                    section, **{parts[1]: value})})
        yield out


def asdict(cfg: SumaConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
