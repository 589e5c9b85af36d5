"""A later change adds a traffic mix, a cell and a per-layer metric by
adding files and entries alone: the harness finds them by name."""
import json
import shutil
import time

from rtbench import harness, manifest

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
