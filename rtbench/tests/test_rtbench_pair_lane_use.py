"""wave_pair_lane_use on synthetic kernel counts: the face loops' active
lanes over 32 a warp-iteration, summed over the wave kernel's variants;
none without counts or face-loop iterations; its indices are the kernel's
and its entry is declared."""
import re

import pytest

from rtbench import devtrace, harness, manifest

NAME = "wave_pair_lane_use"


def reader():
    return manifest.metric_reader(NAME)


def run_with(kernel_counts):
    run = harness.RunRecord(spans={}, frames=1, facts={}, trace=None)
    run.program = {"spans": [], "counters": {},
                   "kernel_counts": kernel_counts}
    run.kernel_counts = kernel_counts
    return run


def counts(iters, lanes):
    c = [0] * 26
    c[reader().STAT_PAIR_ITERS], c[reader().STAT_PAIR_LANES] = iters, lanes
    return c


def test_lanes_over_warp_iterations():
    run = run_with({"launches.wave_kernel.mxu": counts(10, 80),
                    "launches.wave_kernel": counts(30, 240),
                    "launches.wave_kernel.textured": [0] * 26})
    assert reader().read(run) == pytest.approx(100.0 * 320 / (32 * 40))


def test_none_without_face_loops():
    assert reader().read(run_with({"launches.wave_kernel.mxu":
                                   counts(0, 0)})) is None
    assert reader().read(run_with({})) is None


def test_indices_are_the_kernels():
    src = devtrace.program_dir() / "csrc"
    walk = dict(re.findall(r"(\w+) = (\d+)", (src / "box_walk.cuh")
                           .read_text().split("enum")[1].split("}")[0]))
    assert int(walk["PAIR_ITERS"]) == reader().STAT_PAIR_ITERS
    assert int(walk["PAIR_LANES"]) == reader().STAT_PAIR_LANES


def test_declared():
    m = {e["name"]: e for e in manifest.load()["per_layer"]}
    e = m[NAME]
    assert (e["layer"], e["moves"], e["source"], e["unit"], e["better"],
            e["workloads"]) == ("wave kernel", "frame_s", "program_counter",
                                "%", "higher", ["ball.fused_64spp"])
