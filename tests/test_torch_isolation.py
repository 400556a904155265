"""The port stands alone: importing ``semantic_suma_tpu_torch`` and every one
of its modules loads neither JAX (nor flax or optax) nor the JAX package, no
source of the port (nor ``chip_smoke.py``) imports them, and a whole CLI run
(spill, KITTI files, evaluation, the stats log and the PLY exports) and a
segmenter loaded from a versioned weight file load none of them."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "semantic_suma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "semantic_suma_tpu")


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    # a fresh interpreter: this test process already imported JAX
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "semantic_suma_tpu_torch.core.pipeline" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert bad == []


# the modules of the headless entry point and what it drives
ENTRY_MODULES = (
    "semantic_suma_tpu_torch.cli",
    "semantic_suma_tpu_torch.core.spill",
    "semantic_suma_tpu_torch.io.kitti",
    "semantic_suma_tpu_torch.io.kitti_export",
    "semantic_suma_tpu_torch.utils.eventlog",
    "semantic_suma_tpu_torch.utils.scan_accumulator",
    "semantic_suma_tpu_torch.tools.make_results",
)


def test_entry_modules_are_covered():
    assert set(ENTRY_MODULES) <= set(_modules())
    assert (PKG / "configs" / "synthetic_loop.xml").is_file()


def test_cli_run_loads_no_jax(tmp_path):
    """``cli.main`` over a small KITTI directory and a synthetic run, in a
    fresh interpreter: every module it loaded is JAX-free."""
    xml = tmp_path / "small.xml"
    xml.write_text(
        '<config><param name="data_width" type="integer">120</param>'
        '<param name="data_height" type="integer">24</param>'
        '<param name="model_width" type="integer">120</param>'
        '<param name="model_height" type="integer">24</param></config>')
    common = ["--config", str(xml), "--no-loop-closure", "--surfel-capacity",
              str(1 << 15), "--active-capacity", str(1 << 13)]
    seq = tmp_path / "seq"
    code = (
        "import json, sys\n"
        "from semantic_suma_tpu_torch import cli\n"
        "from semantic_suma_tpu_torch.config import DataConfig\n"
        "from semantic_suma_tpu_torch.io.kitti_export import "
        "export_synthetic_sequence\n"
        f"export_synthetic_sequence({str(seq)!r}, 3, "
        "DataConfig(width=120, height=24), step=1.0, device='cpu')\n"
        f"assert cli.main(['--cpu', 'run', '--dataset', {str(seq)!r}, "
        f"'--eval'] + {common!r}) == 0\n"
        f"assert cli.main(['--cpu', 'run', '--synthetic', '3', '--stats-json',"
        f" {str(tmp_path / 's.jsonl')!r}, '--save-map', "
        f"{str(tmp_path / 'm.ply')!r}, '--save-cloud', "
        f"{str(tmp_path / 'c.ply')!r}] + {common!r}) == 0\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("semantic_suma_tpu_torch.core.spill",
              "semantic_suma_tpu_torch.io.kitti",
              "semantic_suma_tpu_torch.utils.eventlog",
              "semantic_suma_tpu_torch.utils.scan_accumulator"):
        assert m in loaded
    assert [m for m in loaded if _forbidden(m)] == []


# the modules of the segmenter slice
SEGMENTER_MODULES = (
    "semantic_suma_tpu_torch.models.labels",
    "semantic_suma_tpu_torch.models.rangenet",
    "semantic_suma_tpu_torch.models.segmenter",
    "semantic_suma_tpu_torch.ops.knn",
    "semantic_suma_tpu_torch.convert",
)


def test_segmenter_loads_no_jax():
    """A versioned weight file (pickled numpy, written by the JAX package)
    loaded and run on a synthetic scan in a fresh interpreter: every module
    loaded is free of JAX, flax and optax."""
    assert set(SEGMENTER_MODULES) <= set(_modules())
    assert (PKG / "csrc" / "knn.cu").is_file()
    code = (
        "import json, sys, torch\n"
        "from semantic_suma_tpu_torch.config import DataConfig\n"
        "from semantic_suma_tpu_torch.io.simulation import render_scan, "
        "default_world\n"
        "from semantic_suma_tpu_torch.models.segmenter import Segmenter\n"
        "cfg = DataConfig(width=96, height=16)\n"
        "seg = Segmenter.load('weights/segmenter_synth_mid.pkl', cfg, "
        "device='cpu')\n"
        "s = render_scan(default_world(0), torch.eye(4), cfg)\n"
        "labels, probs = seg(s.points)\n"
        "assert labels.shape == probs.shape == s.points.shape[:1]\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in SEGMENTER_MODULES:
        assert m in loaded
    assert [m for m in loaded if _forbidden(m)] == []
