"""The port's XML loader and ``sweep`` against the JAX package's: every
result equal field by field, exactly (``dataclasses.asdict``)."""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses
from pathlib import Path

import pytest

from semantic_suma_tpu import config as jc
from semantic_suma_tpu_torch import config as tc

LOOP_XML = (Path(tc.__file__).resolve().parent / "configs"
            / "synthetic_loop.xml")


def _typed(value) -> tuple:
    """(XML type, text) of a value that differs from ``value``, so that a
    parameter that is dropped shows."""
    if isinstance(value, bool):
        return "boolean", "true" if not value else "false"
    if isinstance(value, int):
        return "integer", str(value + 3)
    if isinstance(value, float):
        return "float", repr(value + 0.375)
    return "string", "frame-to-frame" if value == "frame-to-model" \
        else value + "-x"


def _full_xml(tmp_path) -> Path:
    """An XML file that sets every key of ``_XML_MAP``."""
    base = jc.SumaConfig()
    lines = ["<config>"]
    for name, (section, field) in jc._XML_MAP.items():
        owner = base if section == "" else getattr(base, section)
        typ, text = _typed(getattr(owner, field))
        lines.append(f'<param name="{name}" type="{typ}">{text}</param>')
    # a name neither loader knows is ignored by both
    lines.append('<param name="no-such-parameter" type="float">1</param>')
    lines.append("</config>")
    path = tmp_path / "full.xml"
    path.write_text("\n".join(lines))
    return path


def test_xml_map_is_the_same_and_every_target_exists():
    assert tc._XML_MAP == jc._XML_MAP
    base = tc.SumaConfig()
    for section, field in tc._XML_MAP.values():
        owner = base if section == "" else getattr(base, section)
        assert field in {f.name for f in dataclasses.fields(owner)}


@pytest.mark.parametrize("which", ["synthetic_loop", "every_key"])
def test_config_from_xml_matches_jax(which, tmp_path):
    path = LOOP_XML if which == "synthetic_loop" else _full_xml(tmp_path)
    assert tc.parse_parameter_xml(str(path)) \
        == jc.parse_parameter_xml(str(path))
    got = tc.config_from_xml(str(path))
    want = jc.config_from_xml(str(path))
    assert tc.asdict(got) == jc.asdict(want)
    if which == "every_key":
        # every parameter moved its field off the default
        d0, d1 = tc.asdict(tc.SumaConfig()), tc.asdict(got)
        for section, field in tc._XML_MAP.values():
            if section == "":
                assert d1[field] != d0[field], field
            else:
                assert d1[section][field] != d0[section][field], \
                    (section, field)
    # on a base that is not the default
    got = tc.config_from_xml(str(path), tc.SumaConfig().small())
    want = jc.config_from_xml(str(path), jc.SumaConfig().small())
    assert tc.asdict(got) == jc.asdict(want)


def test_synthetic_loop_xml_is_the_ledger_loop_gates():
    loop = tc.config_from_xml(str(LOOP_XML)).loop
    assert (loop.min_trajectory_distance, loop.delta_timestamp,
            loop.search_distance, loop.min_verifications,
            loop.outlier_threshold) == (60.0, 20, 20.0, 3, 6.0)
    # the gates of loop_config(), which is bench.py's loop configuration
    assert dataclasses.asdict(loop) \
        == dataclasses.asdict(tc.loop_config().loop)


def test_sweep_matches_jax():
    grid = {"icp.factor": [0.25, 0.5], "map.p_stable": [0.6, 0.7],
            "approach": ["frame-to-model", "frame-to-frame"]}
    got = [tc.asdict(c) for c in tc.sweep(tc.SumaConfig(), grid)]
    want = [jc.asdict(c) for c in jc.sweep(jc.SumaConfig(), grid)]
    assert len(got) == 8 and got == want
