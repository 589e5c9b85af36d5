"""One run of one cell: set-up, a closed-loop window of whole frames, the
check against the reference, and the result line.  A cell on several
cards runs one process a card through rtbench/sharded.py.

The system under test is rtf_tpu_torch (the program); the harness takes
from it `build_scene`, `scene_tables`, `render_path` and `render` (on
several cards `init_multihost`, `make_mesh`, `render_sharded` and
`finalize`), and in a traced run the kernels' names and its Python launch
entries (wrapped from here to count each launch's rays).  Everything else
(scenes, traffic, statistics, the trace's reduction, the roofline
arithmetic, the reference and the comparison) lives in rtbench/.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from rtbench import check, devtrace, manifest, scenes, stats

FORBIDDEN = ("jax", "jaxlib", "flax", "rtf_tpu")


class NoCard(RuntimeError):
    """The cell's cards are not there."""


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers (rtbench/metrics/<name>.py) read."""
    spans: dict                  # set-up spans, seconds by name
    frames: int                  # frames completed in the window
    facts: dict                  # `scene_facts`
    trace: devtrace.Trace = None  # the window's device trace (--trace 1)
    calls: dict = None           # recorded launches by entry (--trace 1)
    program: dict = None         # the program's spans (rtbench/
                                 # program_trace.py; None: its hook's)


def derived_seed(seed: int, *path: int) -> int:
    """A 31-bit seed from the run's seed and a path of small ints."""
    return int(np.random.SeedSequence([int(seed), *path])
               .generate_state(1)[0] & 0x7FFFFFFF)


def frame_seed(seed: int, i: int) -> int:
    """Frame i's render seed (i = -1: the warm-up frame)."""
    return derived_seed(seed, 1, i + 1)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def refuse_forbidden():
    """Raise where JAX or rtf_tpu was loaded (checked once the window has
    closed)."""
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded after the window: {', '.join(bad)}")


def scene_facts(scene, tables) -> dict:
    """Counts of the scene's inputs that the roofline arithmetic reads."""
    mesh = scene.mesh
    return {
        "faces": 0 if mesh is None else int(mesh.tri_a.shape[0]),
        "spheres": int(scene.num_spheres), "planes": int(scene.num_planes),
        "mesh_instances": int(scene.num_mesh_inst),
        "lights": int(scene.num_lights),
        "materials": int(scene.materials.diffuse.shape[0]),
        "texels": int(scene.textures.atlas.shape[0]
                      * scene.textures.atlas.shape[1])
        if scene.has_file_tex else 0,
        "textured": bool(tables.textured),
    }


def render_config(traffic: dict):
    from rtf_tpu_torch.render.config import PROFILES, RenderConfig
    base = PROFILES[traffic["profile"]] if "profile" in traffic \
        else RenderConfig()
    return base.with_(**traffic.get("render", {}))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _span(spans: dict, name: str, dev):
    _sync(dev)
    t = time.perf_counter()
    yield
    _sync(dev)
    spans[name] = time.perf_counter() - t


def build(config: dict, dev, width=None, height=None,
          bench_dir: Path = manifest.BENCH_DIR):
    """The program's scene and tables for a configuration file (its maker
    found under bench_dir)."""
    from rtf_tpu_torch.core import transform
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene import model
    from rtf_tpu_torch.scene.build import build_scene
    desc = scenes.make(config, scenes.kinds_of(model, transform), width,
                       height, bench_dir)
    scene = build_scene(desc, device=dev)
    algo = config.get("mesh_algo", "auto")
    if algo != scene.mesh_algo:
        scene = dataclasses.replace(scene, mesh_algo=algo)
    return scene, scene_tables(scene, dev)


def set_up(cell, dev, width=None, height=None):
    """The cell's scene and tables built under the scene_build_s span, and
    the path the program takes checked against the traffic's: (spans,
    scene, tables)."""
    from rtf_tpu_torch.render.scene_tables import render_path
    spans = {}
    with _span(spans, "scene_build_s", dev):
        scene, tables = build(cell.config, dev, width, height,
                              cell.bench_dir)
    path = render_path(scene, render_config(cell.traffic))[0]
    if path != cell.traffic["path"]:
        raise RuntimeError(f"{cell.name} declares the {cell.traffic['path']}"
                           f" path, the program takes {path}")
    return spans, scene, tables


class _Wrapped:
    """The program's launch entries that the cell's readers name (ENTRY =
    "module:function"), wrapped in every module of the program that holds
    them, to record each call (the reader's `record`) while active."""

    def __init__(self, readers):
        self.calls, self.saved = {}, []
        for mod in readers:
            entry = getattr(mod, "ENTRY", None)
            if entry and entry not in self.calls:
                self.calls[entry] = []
                self._wrap(entry, mod.record)

    def _wrap(self, entry, record):
        import importlib

        from torch.autograd import profiler
        modname, fn = entry.split(":")
        orig = getattr(importlib.import_module(modname), fn)
        calls = self.calls[entry]

        def wrapped(*a, **k):
            calls.append(record(a, k))
            with profiler.record_function(f"rtbench.launch:{entry}"):
                return orig(*a, **k)
        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").split(".")[0] != "rtf_tpu_torch":
                continue
            for name, val in list(vars(m).items()):
                if val is orig:
                    self.saved.append((m, name, orig))
                    setattr(m, name, wrapped)

    def restore(self):
        for m, name, orig in self.saved:
            setattr(m, name, orig)


def window(scene, cfg, tables, dev, seed, seconds, keep_seed):
    """The timed closed loop: frames start until `seconds` have passed, the
    last completes.  Returns (start, end, frame times, kept) where kept is
    (index, seed, result) of one frame chosen by reservoir sampling from
    keep_seed."""
    from torch.autograd import profiler

    from rtf_tpu_torch.render.renderer import render
    rng = np.random.default_rng(keep_seed)
    times, kept = [], None
    start = time.perf_counter()
    with profiler.record_function(devtrace.WINDOW):
        while True:
            s = frame_seed(seed, len(times))
            t = time.perf_counter()
            with profiler.record_function(devtrace.FRAME):
                res = render(scene, cfg, seed=s, device=dev, tables=tables)
            end = time.perf_counter()
            times.append(end - t)
            if rng.random() * len(times) < 1.0:
                kept = (len(times) - 1, s, res)
            if end - start >= seconds:
                break
    return start, end, times, kept


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def load_readers(cell, bench_dir: Path) -> dict:
    return {m["name"]: manifest.metric_reader(m["name"], bench_dir)
            for m in cell.per_layer}


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", width=None, height=None,
        root: Path = manifest.ROOT,
        bench_dir: Path = manifest.BENCH_DIR, rank: int = 0,
        port: int = None, parent: int = None) -> dict:
    """One run; returns the result line's object (metrics left out on the
    CPU, where no device number exists).  A cell on several cards runs
    rtbench/sharded.py, where rank 0 starts the other ranks (rank, port
    and parent: those ranks' own, given by rank 0); they return None."""
    cell = manifest.Cell(manifest.load(root), workload, root, bench_dir)
    from rtbench import sharded
    mesh = sharded.mesh_of(cell, width, height)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} cards, the cell "
                         f"asks for {cell.chips}")
    if mesh is not None:
        return sharded.run(cell, *mesh, workload, seed, seconds, trace, t0,
                           device, width, height, bench_dir, rank, port,
                           parent)
    from rtf_tpu_torch.render.renderer import render
    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = render_config(cell.traffic)
    readers = load_readers(cell, bench_dir) if trace else {}

    # set-up: the scene and its tables, one warm-up frame
    with torch.no_grad():
        spans, scene, tables = set_up(cell, dev, width, height)
        render(scene, cfg, seed=frame_seed(seed, -1), device=dev,
               tables=tables)
        _sync(dev)

        wrapped = _Wrapped(readers.values()) if trace else None
        prof = devtrace.Recorder(dev.type == "cuda") if trace \
            else contextlib.nullcontext()
        try:
            with prof:
                start, end, times, kept = window(
                    scene, cfg, tables, dev, seed, seconds,
                    derived_seed(seed, 3))
        finally:
            if wrapped is not None:
                wrapped.restore()
    setup_s = start - t0
    refuse_forbidden()
    facts = scene_facts(scene, tables)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    record = RunRecord(spans=spans, frames=len(times), facts=facts)
    if trace:
        record.trace = prof.trace()
        record.calls = wrapped.calls

    # the check: the program's state freed, the reference on the kept frame
    index, kseed, res = kept
    program = {k: getattr(res, k) for k in
               ("image", "radiance", "z", "sample_count")}
    del scene, tables, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, compared, ref_s = verify(cell, seed, kseed, program, dev, width,
                                 height)
    return result(cell, workload, seed, ok, compared, record, readers, trace,
                  start, end, times, setup_s, dev, peak, index, ref_s)


def result(cell, workload, seed, ok, compared, record, readers, trace,
           start, end, times, setup_s, dev, peak, index, ref_s) -> dict:
    """The result line's object of a run checked `ok`."""
    import torch
    out = {"correct": ok, "attempted": len(times), "failed": 0 if ok else 1}
    metrics = {}
    if trace:
        for name, mod in readers.items():
            v = mod.read(record)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit_of(cell, name)}
    else:
        e2e = {"frame_s": stats.window_mean(start, end, len(times)),
               "frame_p95_s": stats.percentile(times, 95),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    if dev.type == "cuda":
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev),
                         "count": cell.chips, "memory_peak_bytes": int(peak),
                         "power_limit": power_limit()}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu",
                         "count": cell.chips, "memory_peak_bytes": 0}
    if trace:
        out["device"]["busy_s"] = record.trace.busy_us / 1e6
        out["device"]["window_s"] = record.trace.window_us / 1e6
        out["breakdown"] = devtrace.breakdown(record.trace)
    print(f"[rtbench] {workload} seed {seed}: {len(times)} frames in "
          f"{end - start:.4f} s, set-up {setup_s:.4f} s, spans "
          f"{record.spans}, "
          f"checked frame {index} in {ref_s:.2f} s", file=sys.stderr)
    out["check"] = compared
    return out


def verify(cell, seed, kseed, program, dev, width, height):
    """(correct, compared numbers with limits, reference seconds) of the
    kept frame against the reference's frame of the same seeds."""
    from rtbench.reference import frames
    t = time.perf_counter()
    ref = frames.reference(cell.config, cell.traffic, kseed, dev,
                           derived_seed(seed, 4), width, height,
                           bench_dir=cell.bench_dir)
    ok, compared = check.judge(check.numbers(program, ref),
                               cell.traffic["check"]["limits"])
    return ok, compared, time.perf_counter() - t


def unit_of(cell, name):
    return next(m["unit"] for m in cell.per_layer if m["name"] == name)
