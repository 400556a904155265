"""The port stands alone: importing ``semantic_suma_tpu_torch`` and every one
of its modules loads neither JAX (nor flax or optax) nor the JAX package, no
source of the port (nor ``chip_smoke.py``) imports them or names a path
outside the package, a ``run --sharded 2`` works where neither can be
imported (in the CLI's process and in its ranks), and a whole CLI run
(spill, KITTI files, evaluation, the stats log and the PLY exports), a
segmenter loaded from a versioned weight file, a training run with its
plots, checkpoint and viewer, and a ``run --resume`` of an archive that the
JAX package wrote (with loop candidates, in a process where importing JAX
fails) load none of them."""
import torch_env  # noqa: F401  (first: one torch thread)

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
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
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


def test_every_port_test_file_imports_the_thread_helper():
    """Each ``tests/test_torch_*.py`` imports ``torch_env`` before anything
    else: a port test file without it would run its worker on every core
    again (``tests/torch_env.py``)."""
    paths = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert paths
    bad = []
    for path in paths:
        tree = ast.parse(path.read_text(), str(path))
        first = next(n for n in tree.body
                     if isinstance(n, (ast.Import, ast.ImportFrom)))
        if not (isinstance(first, ast.Import)
                and [a.name for a in first.names] == ["torch_env"]):
            bad.append(path.name)
    assert bad == []


def test_models_import_nothing_from_core():
    """The networks sit below the session: no module under ``models/``
    imports from ``core/`` (what both need, such as the CUDA-graph
    replayer, lives under the package root)."""
    core = "semantic_suma_tpu_torch.core"
    bad = []
    for path in sorted((PKG / "models").rglob("*.py")):
        package = ".".join(path.relative_to(ROOT).parts[:-1])
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = package.split(".")
                if node.level:
                    base = base[:len(base) - node.level + 1]
                else:
                    base = []
                mod = ".".join(base + ([node.module] if node.module else []))
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n == core or n.startswith(core + ".")]
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
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
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
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in SEGMENTER_MODULES:
        assert m in loaded
    assert [m for m in loaded if _forbidden(m)] == []


# the modules of the training, checkpoint and plot slice
TRAIN_MODULES = (
    "semantic_suma_tpu_torch.models.segmenter",
    "semantic_suma_tpu_torch.utils.checkpoint",
    "semantic_suma_tpu_torch.utils.viz",
    "semantic_suma_tpu_torch.utils.viz3d",
)


def test_train_checkpoint_and_viz_load_no_jax(tmp_path):
    """``train-segmenter``, then a run with ``--plot-dir``,
    ``--save-viewer`` and ``--save-checkpoint``, in a fresh interpreter:
    every module loaded is free of JAX, flax and optax."""
    assert set(TRAIN_MODULES) <= set(_modules())
    xml = tmp_path / "small.xml"
    xml.write_text(
        '<config><param name="data_width" type="integer">120</param>'
        '<param name="data_height" type="integer">24</param>'
        '<param name="model_width" type="integer">120</param>'
        '<param name="model_height" type="integer">24</param></config>')
    common = ["--config", str(xml), "--no-loop-closure", "--surfel-capacity",
              str(1 << 15), "--active-capacity", str(1 << 13)]
    code = (
        "import json, sys\n"
        "from semantic_suma_tpu_torch import cli\n"
        "from semantic_suma_tpu_torch.config import DataConfig\n"
        "from semantic_suma_tpu_torch.models import rangenet, segmenter\n"
        "seg, m = segmenter.train_synthetic(DataConfig(width=96, height=16), "
        "n_train=2, n_val=1, steps=2, batch=2, device='cpu')\n"
        f"seg.save({str(tmp_path / 'w.pkl')!r})\n"
        f"assert cli.main(['--cpu', 'run', '--synthetic', '3', '--plot-dir', "
        f"{str(tmp_path / 'plots')!r}, '--save-viewer', "
        f"{str(tmp_path / 'v.html')!r}, '--save-checkpoint', "
        f"{str(tmp_path / 'c.npz')!r}] + {common!r}) == 0\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in TRAIN_MODULES:
        assert m in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert (tmp_path / "c.npz").is_file() and (tmp_path / "v.html").is_file()


def test_resume_of_a_jax_archive_needs_no_jax(tmp_path):
    """The JAX package writes an archive of a session at the CLI's sizing of
    the small XML, loop closure on, with a candidate in each list of its
    closer; ``cli run --resume`` of it in a fresh interpreter where
    ``import jax`` and ``import semantic_suma_tpu`` fail."""
    import argparse

    import numpy as np

    from semantic_suma_tpu import cli as jcli
    from semantic_suma_tpu.core import loop_closure as jlc
    from semantic_suma_tpu.core.pipeline import SurfelSLAM as JSlam
    from semantic_suma_tpu.io.simulation import (SimulationReader,
                                                 default_world)
    from semantic_suma_tpu.utils.checkpoint import save_checkpoint

    xml = tmp_path / "small.xml"
    xml.write_text(
        '<config><param name="data_width" type="integer">120</param>'
        '<param name="data_height" type="integer">24</param>'
        '<param name="model_width" type="integer">120</param>'
        '<param name="model_height" type="integer">24</param></config>')
    caps = dict(surfel_capacity=1 << 15, active_capacity=1 << 13)
    cfg = jcli.build_config(argparse.Namespace(
        config=str(xml), max_scans=None, approach=None, no_semantics=False,
        no_loop_closure=False, **caps))
    assert cfg.loop.enabled
    reader = SimulationReader(cfg.data, n_scans=4, world=default_world(seed=0),
                              radius=18.0, step=1.0)
    slam = JSlam(cfg)
    for i in range(4):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    for lst, (frm, to) in ((slam._loop.verified, (3, 0)),
                           (slam._loop.unverified, (3, 1))):
        lst.append(jlc.LoopClosureCandidate(
            frm=frm, to=to, rel_pose=np.linalg.inv(slam.poses[frm])
            @ slam._loop.posegraph.pose(to)))
    ckpt = str(tmp_path / "jax.npz")
    save_checkpoint(slam, ckpt)

    argv = ["--cpu", "run", "--config", str(xml), "--surfel-capacity",
            str(caps["surfel_capacity"]), "--active-capacity",
            str(caps["active_capacity"]), "--synthetic", "7", "--resume", ckpt,
            "--eval"]
    code = (
        "import json, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'semantic_suma_tpu'):"
        "\n    sys.modules[name] = None\n"
        "from semantic_suma_tpu_torch import cli\n"
        f"assert cli.main({argv!r}) == 0\n"
        "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
        "                        if v is not None)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed at scan 4 from" in out.stderr
    assert "processed 3 scans in " in out.stdout
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "semantic_suma_tpu_torch.utils.checkpoint" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


# the modules of the readers and the sharded pipeline
PARALLEL_MODULES = (
    "semantic_suma_tpu_torch.io.native_io",
    "semantic_suma_tpu_torch.io.robocar",
    "semantic_suma_tpu_torch.parallel.distributed",
    "semantic_suma_tpu_torch.parallel.sharding",
    "semantic_suma_tpu_torch.parallel.multihost_smoke",
)


def test_sources_name_no_path_outside_the_package():
    """No string of a port source is an absolute path, and no path built
    from ``__file__`` climbs above the package's root (the native loader's
    source is the package's own copy)."""
    import re
    assert set(PARALLEL_MODULES) <= set(_modules())
    assert (PKG / "native" / "scan_loader.cpp").is_file()
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        for node in ast.walk(ast.parse(text, str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and re.match(r"/[A-Za-z]", node.value):
                bad.append(f"{path.name}: {node.value!r}")
        depth = len(path.relative_to(PKG).parts)  # parents to leave PKG
        for m in re.finditer(r"Path\(__file__\)\.resolve\(\)((?:\.parent)+)",
                             text):
            if m.group(1).count(".parent") > depth:
                bad.append(f"{path.name}: {m.group(0)}")
        if "dirname(__file__)" in text or "os.pardir" in text \
                and path.name != "kitti.py":
            bad.append(f"{path.name}: a path from __file__ or os.pardir")
    assert bad == []


def test_loader_source_is_the_jax_package_code():
    """The port's ``native/scan_loader.cpp`` is the JAX package's source,
    line for line outside its comments."""
    def code(p):
        return [line for line in p.read_text().splitlines()
                if not line.lstrip().startswith("//")]
    assert code(PKG / "native" / "scan_loader.cpp") == \
        code(ROOT / "native" / "scan_loader.cpp")


def test_sharded_run_loads_no_jax(tmp_path):
    """``cli run --sharded 2`` in a fresh interpreter where ``import jax``
    and ``import semantic_suma_tpu`` fail, in that process and in the ranks
    it spawns (each finds the failing packages first on its path)."""
    block = tmp_path / "block"
    for name in ("jax", "jaxlib", "flax", "optax", "semantic_suma_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    xml = tmp_path / "small.xml"
    xml.write_text(
        '<config><param name="data_width" type="integer">120</param>'
        '<param name="data_height" type="integer">24</param>'
        '<param name="model_width" type="integer">120</param>'
        '<param name="model_height" type="integer">24</param></config>')
    argv = ["--cpu", "run", "--config", str(xml), "--surfel-capacity",
            str(1 << 15), "--active-capacity", str(1 << 13), "--sharded", "2",
            "--synthetic", "3", "--eval"]
    code = (
        "import json, sys\n"
        "from semantic_suma_tpu_torch import cli\n"
        f"assert cli.main({argv!r}) == 0\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "processed 3 scans in " in out.stdout
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "semantic_suma_tpu_torch.parallel.distributed" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


# JAX names that the port's module of the same path does not keep under the
# same name: "module:name" -> the port's counterpart ("module:name", or a
# source file of ``semantic_suma_tpu_torch``), or "none: " and why
RENAMED = {
    "cli:jax_tree_to_np": "none: the port holds no JAX trees",
    "core/posegraph:_so3_left_jacobian_inv_approx":
        "none: no caller in the JAX package",
    "core/surfel_map:PackedSurfels.put": "none: no caller in the JAX package",
    "core/surfel_map:PackedSurfels.take": "none: no caller in the JAX package",
    "core/surfel_map:_zeros_data": "none: no caller in the JAX package",
    # split in two, the second half being _update_finish
    "core/surfel_map:_update_view": "core/surfel_map:_update_stage_a",
    "io/native_io:_build": "io/native_io:build",
    "models/rangenet:knn_clean": "ops/knn:knn_clean",
    "models/rangenet:knn_clean_image": "ops/knn:knn_clean_image",
    "models/rangenet:labels_for_points": "ops/knn:labels_for_points",
    "models/segmenter:Segmenter._infer_impl":
        "models/segmenter:Segmenter.__call__",
    "ops/pallas_kernels:bilateral_filter_pallas":
        "ops/bilateral:bilateral_filter",
    "ops/pallas_kernels:_bilateral_kernel": "csrc/bilateral.cu",
    "parallel/sharding:ShardedSurfelSLAM._local_shard":
        "none: a rank holds one shard, ShardedSurfelSLAM.local",
    "parallel/sharding:ShardedSurfelSLAM._my_shards":
        "none: a rank holds one shard, ShardedSurfelSLAM.local",
    "parallel/sharding:ShardedSurfelSLAM._write_shard":
        "none: a rank holds one shard, ShardedSurfelSLAM.local",
    "parallel/sharding:_stack_tree":
        "none: a rank holds its own state, stacked over no device axis",
    "parallel/sharding:_local": "none: no shard_map device axis to strip",
    "parallel/sharding:_delocal": "none: no shard_map device axis to add",
    "parallel/sharding:_maps_struct": "none: no shard_map output spec",
    "parallel/sharding:make_sharded_step": "parallel/sharding:sharded_step",
    "parallel/sharding:make_sharded_compact": "core/surfel_map:compact",
    "parallel/sharding:make_sharded_update_poses":
        "core/surfel_map:update_poses",
    "parallel/sharding:make_sharded_render": "parallel/sharding:sharded_render",
    # a rank builds its old view alone (ShardedSurfelSLAM.render_old_maps)
    "parallel/sharding:make_sharded_old_view":
        "core/surfel_map:refresh_active",
    "parallel/sharding:make_sharded_view_render":
        "parallel/sharding:sharded_view_render",
    "utils/eventlog:get_log":
        "none: no reader; the CLI holds its EventLog itself",
    "utils/timing:Stopwatch._record": "utils/timing:Stopwatch.record",
    # a span is the scope, and a profiler's range around it while one
    # records
    "utils/timing:Stopwatch.scope": "utils/timing:Stopwatch.span",
    "utils/viz:_plt": "none: the card's hosts have no matplotlib; the port "
                      "draws its PNGs with numpy",
}


def _defined(package: Path):
    """``{module path: names}`` of a package's top-level functions and
    classes and its classes' methods (``Class.method``; a class also has
    the methods of its bases that the package defines, and a module's
    ``forward`` stands for flax's ``__call__``)."""
    trees = {p.relative_to(package).with_suffix("").as_posix():
             ast.parse(p.read_text(), str(p))
             for p in sorted(package.rglob("*.py"))}
    classes = {}
    for tree in trees.values():
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                classes[node.name] = (
                    {b.name for b in node.body
                     if isinstance(b, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))},
                    [b.id for b in node.bases if isinstance(b, ast.Name)])

    def methods(name):
        own, bases = classes.get(name, (set(), []))
        out = set(own) | ({"__call__"} if "forward" in own else set())
        for b in bases:
            out |= methods(b)
        return out

    out = {}
    for mod, tree in trees.items():
        names = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef):
                names.add(node.name)
                names |= {f"{node.name}.{m}" for m in methods(node.name)}
        out[mod] = names
    return out


def test_every_jax_name_has_a_counterpart_in_the_port():
    jax_names = _defined(ROOT / "semantic_suma_tpu")
    port = _defined(PKG)
    missing = sorted(f"{mod}:{n}" for mod, names in jax_names.items()
                     for n in names if n not in port.get(mod, ()))
    assert sorted(set(missing) - set(RENAMED)) == []   # none truly missing
    assert sorted(set(RENAMED) - set(missing)) == []   # no stale row
    for where in RENAMED.values():
        if where.startswith("none: "):
            continue
        if ":" not in where:
            assert (PKG / where).is_file(), where
            continue
        mod, name = where.split(":")
        assert name in port.get(mod, ()), where
