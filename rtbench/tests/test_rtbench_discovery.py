"""A later change adds a scene, a traffic mix, a cell and a per-layer
metric by adding files and entries alone: the harness finds them by name."""
import json
import re
import shutil
import time

import numpy as np
import pytest
import torch

from rtbench import harness, manifest, scenes
from rtbench.reference import frames
from rtf_tpu_torch.core import transform
from rtf_tpu_torch.scene import model

BENCH = manifest.BENCH_DIR


BOX_CONFIG = {"name": "box", "source": "a test", "file": "rtbench/configs/box.json",
              "reduced": [], "why": "a test"}
BOX_CELL = {"name": "box.fused_64spp", "config": "box",
            "traffic": "fused_64spp", "chips": 1, "why": "a test"}


def copy_bench(tmp_path):
    """A checkout of BENCHMARK.json and rtbench/, whose manifest also holds
    the cell box.fused_64spp on rtbench/configs/box.json (a configuration
    and a cell added by entries alone; BENCHMARK.json leaves the cell out,
    PERF.md section 7)."""
    shutil.copytree(BENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load()
    if not any(c["name"] == "box" for c in m["configs"]):
        m["configs"].append(BOX_CONFIG)
    if not any(w["name"] == BOX_CELL["name"] for w in m["workloads"]):
        m["workloads"].append(BOX_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path, tmp_path / "rtbench"


def add_dummy(root, bench):
    (bench / "metrics" / "dummy_frames.py").write_text(
        '"""dummy_frames: the frames of the window."""\n\n\n'
        "def read(run):\n    return float(run.frames)\n")
    (bench / "traffic" / "dummy.json").write_text(json.dumps({
        "why": "one sample a pixel, no bounce",
        "render": {"min_samples": 1, "max_samples": 1, "bounces": 0,
                   "shadow_min": 1, "shadow_max": 1, "split_mode": "rr"},
        "path": "fused",
        "check": {"blocks": 2, "limits": {"radiance_gap": 1e-6}}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "box.dummy", "config": "box",
                           "traffic": "dummy", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "dummy_frames", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "frame loop", "moves": "frame_s",
                           "workloads": ["box.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def test_new_files_are_found_by_name(tmp_path):
    root, bench = copy_bench(tmp_path)
    add_dummy(root, bench)
    cell = manifest.Cell(manifest.load(root), "box.dummy", root, bench)
    assert cell.traffic["render"]["min_samples"] == 1
    assert [m["name"] for m in cell.per_layer] == [
        "scene_build_s", "device_idle_share", "launches_per_frame",
        "torch_ops_ms_per_frame", "dummy_frames"]
    assert manifest.metric_reader("dummy_frames", bench).read(
        harness.RunRecord({}, 3, {})) == 3.0


def test_a_run_of_the_new_cell_reports_the_new_metric(tmp_path):
    root, bench = copy_bench(tmp_path)
    add_dummy(root, bench)
    out = harness.run("box.dummy", 11, 0.01, True, time.perf_counter(),
                      device="cpu", width=16, height=12, root=root,
                      bench_dir=bench)
    assert out["correct"] is True
    assert out["metrics"]["dummy_frames"]["value"] == out["attempted"]
    assert list(out)[-1] == "check"


# A scene that rtbench/scenes.py does not know, brought by new files alone:
# a maker, a configuration, a traffic mix, a reader and manifest entries.
TEX_MAKER = '''"""tinytex: the box with an 8x8 file texture on the walls' kd, a checker
on the mirror's ks and a 16x8 environment map, texels drawn from the
configuration's seed."""
import numpy as np

from rtbench import scenes


def make(k, width, height, seed, mesh_subdiv=1):
    desc = scenes.box(k, width, height, light_size=1.0,
                      mesh_subdiv=mesh_subdiv)
    rng = np.random.default_rng(seed)
    walls, env = (k.TextureDesc(kind="file", name=name,
                                data=rng.random((h, w, 3), np.float32))
                  for name, w, h in (("walls", 8, 8), ("env", 16, 8)))
    checker = k.TextureDesc(kind="checker", name="checker",
                            color1=np.array([0.1, 0.1, 0.1]),
                            color2=np.array([0.9, 0.8, 0.2]))
    wall = desc.materials["wall"]
    wall.diffuse = k.TexturedColorDesc(
        wall.diffuse.color, k.TexMapDesc(walls, k.Transform().scale(0.25)))
    mirror = desc.materials["mirror"]
    mirror.specular = k.TexturedColorDesc(
        mirror.specular.color,
        k.TexMapDesc(checker, k.Transform().scale(0.125)))
    desc.environment = k.TexturedColorDesc(np.ones(3), k.TexMapDesc(env))
    return desc
'''
TEX_READER = ('"""scene_texels: the texels of a textured scene."""\n\n\n'
              "def read(run):\n"
              "    f = run.facts\n"
              "    return float(f[\"texels\"]) if f[\"textured\"] else None\n")


def add_textured(root, bench):
    """The tinytex configuration and its cell tinytex.tex1spp, as files
    under rtbench/makers/, configs/, traffic/ and metrics/ and entries in
    BENCHMARK.json."""
    (bench / "makers").mkdir(exist_ok=True)
    (bench / "makers" / "tinytex.py").write_text(TEX_MAKER)
    (bench / "metrics" / "scene_texels.py").write_text(TEX_READER)
    (bench / "configs" / "tinytex.json").write_text(json.dumps({
        "source": "a test", "precision": "float32", "scene": "tinytex",
        "args": {"width": 64, "height": 48, "seed": 1234567,
                 "mesh_subdiv": 1},
        "sample_points": [[1.0, 4.0, 3.0]]}))
    (bench / "traffic" / "tex1spp.json").write_text(json.dumps({
        "why": "one sample a pixel, two bounces",
        "render": {"min_samples": 1, "max_samples": 1, "bounces": 2,
                   "shadow_min": 1, "shadow_max": 1, "split_mode": "rr"},
        "path": "fused",
        "check": {"blocks": 2, "limits": {"radiance_gap": 1e-6,
                                          "z_gap": 0.0,
                                          "samples_gap": 0.0}}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tinytex", "source": "a test",
                         "file": "rtbench/configs/tinytex.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tinytex.tex1spp", "config": "tinytex",
                           "traffic": "tex1spp", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "scene_texels", "unit": "texels",
                           "better": "higher", "source": "program_counter",
                           "layer": "scene build", "moves": "setup_s",
                           "workloads": ["tinytex.tex1spp"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def alike(a, b, path="desc"):
    """Two sides' descriptions equal: classes of one name, arrays bit for
    bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            alike(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            alike(a[k], b[k], f"{path}.{k}")
    elif hasattr(a, "__dict__") or hasattr(a, "__slots__"):
        assert type(a).__name__ == type(b).__name__, path
        for k in getattr(a, "__slots__", None) or vars(a):
            alike(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert a == b, path


def test_a_new_maker_is_new_files_alone(tmp_path):
    root, bench = copy_bench(tmp_path)
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    add_textured(root, bench)
    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    cell = manifest.Cell(manifest.load(root), "tinytex.tex1spp", root, bench)
    assert cell.bench_dir == bench
    ours = scenes.make(cell.config, scenes.kinds_of(model, transform),
                       bench_dir=bench)
    theirs = scenes.make(cell.config, frames.KINDS, bench_dir=bench)
    assert type(ours) is model.SceneDesc
    assert type(theirs) is not model.SceneDesc
    alike(ours, theirs)
    assert ours.environment.texmap.texture.data.shape == (8, 16, 3)
    again = scenes.make(cell.config, frames.KINDS, bench_dir=bench)
    alike(theirs, again)                      # texels from the file's seed


def test_both_sides_build_the_new_maker(tmp_path):
    root, bench = copy_bench(tmp_path)
    add_textured(root, bench)
    cell = manifest.Cell(manifest.load(root), "tinytex.tex1spp", root, bench)
    cpu = torch.device("cpu")
    scene, tables = harness.build(cell.config, cpu, 16, 12, bench)
    ref, ref_tables = frames.build(cell.config, cpu, 16, 12, bench_dir=bench)
    facts = harness.scene_facts(scene, tables)
    assert facts["textured"] and facts["texels"] > 0
    assert ref.has_file_tex and ref_tables.textured
    assert torch.equal(scene.textures.atlas, ref.textures.atlas)


def test_a_run_of_the_new_maker_is_correct(tmp_path):
    root, bench = copy_bench(tmp_path)
    add_textured(root, bench)
    out = harness.run("tinytex.tex1spp", 2**31 + 17, 0.01, True,
                      time.perf_counter(), device="cpu", width=16, height=12,
                      root=root, bench_dir=bench)
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["scene_texels"]["value"] > 0


def test_an_unknown_scene_names_the_missing_path(tmp_path):
    root, bench = copy_bench(tmp_path)
    add_textured(root, bench)
    (bench / "makers" / "tinytex.py").unlink()
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(bench / "makers" / "tinytex.py"))):
        manifest.Cell(manifest.load(root), "tinytex.tex1spp", root, bench)
    for bad in ("../tinytex", "tiny tex", ""):
        with pytest.raises(ValueError, match="A-Za-z0-9_"):
            scenes.maker(bad, bench)
