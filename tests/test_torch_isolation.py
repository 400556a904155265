"""The port stands alone: importing ``semantic_suma_tpu_torch`` and every one
of its modules loads neither JAX nor the JAX package, and no source of the
port (nor ``chip_smoke.py``) imports them."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "semantic_suma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "semantic_suma_tpu")


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
