"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (BENCHMARK.json's `configs`, whose `file`
holds the scene) and a traffic mix (rtbench/traffic/<traffic>.json); a
per-layer metric <name> is read by rtbench/metrics/<name>.py.  A
configuration's "scene" other than the built-in `box` is made by
rtbench/makers/<scene>.py (rtbench/scenes.py), whose data comes from the
configuration file alone: arrays such as texels are drawn from a seed in
its "args", never read from a file outside the repo nor fetched.  Adding a
scene, a mix, a cell or a metric is adding files and entries: nothing here
lists them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def by_name(entries, name: str, what: str) -> dict:
    hit = [e for e in entries if e["name"] == name]
    if len(hit) != 1:
        raise KeyError(f"{len(hit)} {what} named {name!r}")
    return hit[0]


class Cell:
    """One workload of the manifest with its configuration, traffic and
    metric lists resolved."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT,
                 bench_dir: Path = BENCH_DIR):
        self.name = name
        workload = by_name(manifest["workloads"], name, "workloads")
        entry = by_name(manifest["configs"], workload["config"], "configs")
        self.config = json.loads((root / entry["file"]).read_text())
        self.bench_dir = bench_dir
        from rtbench import scenes
        scenes.maker(self.config["scene"], bench_dir)  # raises before set-up
        self.traffic = traffic(workload["traffic"], bench_dir)
        self.chips = int(workload["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if reports(m, name)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module rtbench/metrics/<name>.py (names may hold dots, so it is
    loaded from its path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    return load_module(path, f"rtbench_metric_{name.replace('.', '_')}")


def load_module(path: Path, modname: str):
    """The module of a file, loaded from its path."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
