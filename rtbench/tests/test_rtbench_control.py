"""`correct` comes out false for the control and for each fault a cell
can have, at a size a CPU test run holds (the cells' own size runs on the
card: rtbench/calibrate.py).

The control is the reference computed with its scene and camera rays in
bfloat16, put in the program's place.  The faults break the timed path
underneath a whole run (rtbench/harness.py with the card's look skipped):
a sample wave that leaves the accumulators as they were, half of the
sample waves left out and the mean taken over the rest, and a pixel's
radiance altered where the wave produces it.  (One chip: no exchange
between chips to leave out.)"""
import json
import time

import numpy as np
import pytest
import torch

from rtbench import check, harness, manifest
from rtbench.reference import frames
from rtbench.tests.test_rtbench_discovery import copy_bench

W, H = 32, 24


CELLS = ["box.fused_64spp", "ball.fused_64spp"]


def small_bench(tmp_path):
    """The benchmark with its traffic cut to a CPU test's size (4 spp)."""
    root, bench = copy_bench(tmp_path)
    p = bench / "traffic" / "fused_64spp.json"
    t = json.loads(p.read_text())
    t["render"].update({"min_samples": 4, "max_samples": 4})
    p.write_text(json.dumps(t))
    return root, bench


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tmp_path, workload):
    root, bench = small_bench(tmp_path)
    cell = manifest.Cell(manifest.load(root), workload, root, bench)
    args = (cell.config, cell.traffic, 77, torch.device("cpu"), 79, W, H)
    ref = frames.reference(*args)
    low = frames.reference(*args, lower=True)
    program = {k: low[k] for k in ("image", "radiance", "z",
                                   "sample_count")}
    assert np.array_equal(low["pixels"], ref["pixels"])
    n = W * H
    program = {k: np.zeros((n,) + v.shape[1:], v.dtype)
               for k, v in program.items()}
    for k in program:
        program[k][low["pixels"]] = low[k]
    ok, compared = check.judge(check.numbers(program, ref),
                               cell.traffic["check"]["limits"])
    assert not ok, compared


def fault(kind):
    from rtf_tpu_torch.render import renderer
    orig = renderer.wave_contrib

    def broken(scene, cfg, tables, px, py, mask, j, *a, **k):
        contrib, hc, zm = orig(scene, cfg, tables, px, py, mask, j, *a, **k)
        if kind == "unchanged" or (kind == "half" and int(j) % 2):
            return (torch.zeros_like(contrib), torch.zeros_like(hc),
                    torch.full_like(zm, 1e30))
        if kind == "altered":
            contrib = contrib.clone()
            contrib[:, ::16] *= 1.5
        return contrib, hc, zm
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_fails(tmp_path, monkeypatch, workload, kind):
    from rtf_tpu_torch.render import renderer
    root, bench = small_bench(tmp_path)
    monkeypatch.setattr(renderer, "wave_contrib", fault(kind))
    out = harness.run(workload, 5, 0.01, False, time.perf_counter(),
                      device="cpu", width=W, height=H, root=root,
                      bench_dir=bench)
    assert out["correct"] is False, out["check"]
    assert out["failed"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes(tmp_path, workload):
    root, bench = small_bench(tmp_path)
    out = harness.run(workload, 5, 0.01, False, time.perf_counter(),
                      device="cpu", width=W, height=H, root=root,
                      bench_dir=bench)
    assert out["correct"] is True, out["check"]
    assert all(c["value"] == 0.0 for c in out["check"].values())
    assert set(out["check"]) == {"radiance_gap", "z_gap", "samples_gap",
                                 "image_gap"}


def test_wavefront_traffic_has_no_reference_yet():
    """A traffic on the wavefront fails its check rather than pass
    unchecked: the reference renders the fused path only."""
    cell = manifest.Cell(manifest.load(), "ball.fused_64spp")
    traffic = dict(cell.traffic, path="wavefront")
    with pytest.raises(NotImplementedError):
        frames.reference(cell.config, traffic, 1, torch.device("cpu"), 2,
                         W, H)
