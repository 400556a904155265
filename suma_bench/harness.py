"""What the runner finds by name, and what it reduces a run to.

* ``BENCHMARK.json`` at the checkout's root names each cell's configuration
  (``configs/<name>.json``) and traffic mix (``traffic/<name>.json``); the
  limits of its check are ``limits/<cell>.json``; each per-layer metric is
  read by ``metrics/<metric>.py``, which defines ``read(record)``; the
  segmentation network a configuration's ``segmenter`` group names by
  ``arch`` has its plain reference, FLOP count and weights reader in
  ``nets/<arch>.py`` (``nets/__init__.py`` gives the contract).
* The reduction of a profiler trace (Chrome format) to the device's busy
  time, its idle gaps under the benchmark's own spans, and the device
  operations that took the most time.
* The import check: no module whose top-level name is JAX's, flax's or the
  JAX package's."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".cache" / "suma_bench"
NETS = HERE / "nets"

FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_suma_tpu")

# the benchmark's own spans (torch.profiler.record_function) in the window
SPANS = ("session", "wait", "segmenter", "dispatch", "drain", "finalize")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with everything it names: ``{"cell", "config",
    "traffic", "limits", "end_to_end", "per_layer"}``, the metrics those
    that this cell reports."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    here = root / HERE.name
    config = load_json(here / "configs" / f"{w['config']}.json")
    if config.get("segmenter") is not None \
            and "arch" not in config["segmenter"]:
        raise ValueError(f"configs/{w['config']}.json: the segmenter group "
                         "names no \"arch\", the network module "
                         "nets/<arch>.py")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"cell": w,
            "config": config,
            "traffic": load_json(here / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(here / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced, nested groups merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base[k], v) if isinstance(v, dict) \
            and isinstance(base.get(k), dict) else v
    return out


def _load(path: Path, kind: str, name: str):
    """The file ``path`` loaded as a module (``name`` may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"suma_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py`` loaded as a module."""
    return _load(root / HERE.name / "metrics" / f"{metric}.py", "metric",
                 metric)


def net(arch: str):
    """``nets/<arch>.py`` loaded as a module: the plain reference network of
    the architecture ``arch``, its weights reader and its FLOP count."""
    path = NETS / f"{arch}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no network module {path} for the "
                                f"segmenter's arch {arch!r}")
    return _load(path, "net", arch)


def read_metrics(names, record: dict, root: Path = ROOT) -> dict:
    """``{name: value}`` of each reader that found something to read."""
    out = {}
    for name in names:
        value = reader(name, root).read(record)
        if value is not None:
            out[name] = value
    return out


def forbidden_modules(names) -> list:
    """The module names whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _union(intervals):
    """Merge ``(start, end)`` intervals; returns them sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, window_name: str = "traced") -> dict:
    """A Chrome trace's events reduced to the traced window (the span
    ``window_name``): ``window_s``; ``busy_s``, the union of device
    operations inside it; ``ops`` ``{name: [count, seconds]}``; ``gaps``,
    each idle stretch ``[span open at its middle, seconds]``, longest first;
    ``kernels``, ``(name, start_us, dur_us)`` of every device operation."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == window_name
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    kernels = []
    ops: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        kernels.append((e["name"], s, t - s))
        c = ops.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += (t - s) * 1e-6
    busy = _union((s, s + d) for _, s, d in kernels)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in SPANS)
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [n for s, t, n in spans if s <= mid < t]
        gaps.append([open_[-1] if open_ else "none", (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "ops": ops, "gaps": gaps, "kernels": kernels}


def breakdown(trace: dict) -> dict:
    """The ten device operations that took the most time and the ten
    longest idle gaps, each with the benchmark's span open at its middle
    (the innermost, where spans nest)."""
    ops = sorted(trace["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n[:160], v[1]] for n, v in ops],
            "idle_gaps": trace["gaps"][:10]}
