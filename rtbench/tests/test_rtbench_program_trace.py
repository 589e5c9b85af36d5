"""The readers of the program's own spans and counters
(rtbench/program_trace.py and its metrics) on synthetic runs, a CPU
rehearsal of the ball's traced run, and on the card the shared clock."""
import re
import time

import pytest

from rtbench import devtrace, harness, manifest
from rtbench import program_trace as P
from rtbench.tests.test_rtbench_control import small_bench

SPAN_METRICS = ("host_ms_per_wave", "launch_host_us", "idle_ms_in_waves",
                "idle_ms_in_prepare", "idle_ms_in_finalize")
KERNEL_METRICS = ("wave_walk_cycle_share", "wave_slab_tests_per_ray",
                  "wave_walk_lane_use")
NEW = SPAN_METRICS + KERNEL_METRICS

HOST = [(devtrace.WINDOW, 0.0, 1000.0)]
DEV = [("void wave_kernel<false>(Args)", 120.0, 300.0), ("add", 320.0, 330.0),
       ("void wave_kernel<false>(Args)", 400.0, 600.0),
       ("Memcpy DtoH (Device -> Pageable)", 700.0, 720.0)]
# one frame of two waves (times in us; spans carry ns)
SPANS = [(P.FRAME, 1, None, 1, 50, 800), (P.PREPARE, 2, 1, 1, 60, 110),
         (P.WAVE, 3, 1, 1, 115, 390), (P.LAUNCH, 4, 3, 1, 118, 130),
         (P.WAVE, 5, 1, 1, 390, 650), (P.LAUNCH, 6, 5, 1, 392, 400),
         (P.FINALIZE, 7, 1, 1, 660, 790)]


def synthetic(device=DEV, kernel_counts=None):
    run = harness.RunRecord(spans={}, frames=1, facts={},
                            trace=devtrace.reduce(device, HOST))
    run.program = {"spans": [(n, i, p, f, 1e3 * s, 1e3 * e, {})
                             for n, i, p, f, s, e in SPANS],
                   "counters": {}, "kernel_counts": {}}
    run.kernel_counts = kernel_counts
    return run


def read(name, run):
    return manifest.metric_reader(name).read(run)


def test_idle_splits_the_gaps_exactly():
    run = synthetic()
    # gaps: [0,120] [300,320] [330,400] [600,700] [720,1000]
    assert read("idle_ms_in_prepare", run) == pytest.approx(50e-3)
    assert read("idle_ms_in_waves", run) == pytest.approx((5 + 20 + 60
                                                           + 10 + 50) * 1e-3)
    assert read("idle_ms_in_finalize", run) == pytest.approx(110e-3)
    split = P.idle_split(run)
    assert split == pytest.approx({P.PREPARE: 50, P.WAVE: 145,
                                   P.FINALIZE: 110, "frame_other": 35,
                                   "outside": 250})
    idle = (read("device_idle_share", run) / 100 * run.trace.window_us
            / run.frames)
    assert sum(split.values()) == pytest.approx(idle)
    assert read("host_ms_per_wave", run) == pytest.approx((275 + 260) / 2e3)
    assert read("launch_host_us", run) == pytest.approx((12 + 8) / 2)


def test_idle_within_merges_overlaps():
    tr = devtrace.reduce(DEV, HOST)
    assert P.idle_within(tr, [(0, 50), (40, 130), (310, 1000)]) \
        == pytest.approx(120 + 10 + 70 + 100 + 280)
    assert P.idle_within(tr, []) == 0.0


def test_kernel_ratios():
    c = [0] * 26
    for i, v in ((P.STAT_RAYS, 100), (P.STAT_SHADOW, 50),
                 (P.STAT_TILES, 300), (P.STAT_ROOT, 150),
                 (P.STAT_GROUPS, 600), (P.STAT_LEAVES, 450),
                 (P.STAT_CYC_WALK, 700), (P.STAT_CYC_BOUNCES, 1000),
                 (P.STAT_WALK_ITERS, 10), (P.STAT_WALK_LANES, 240)):
        c[i] = v
    half = [v // 2 for v in c]
    run = synthetic(kernel_counts={"launches.wave_kernel.mxu": half,
                                   "launches.wave_kernel": half,
                                   "launches.wave_kernel.textured": [0] * 26})
    assert read("wave_slab_tests_per_ray", run) == pytest.approx(10.0)
    assert read("wave_walk_cycle_share", run) == pytest.approx(70.0)
    assert read("wave_walk_lane_use", run) == pytest.approx(75.0)


def test_none_on_a_cpu_record():
    run = synthetic(device=[])           # no device events: the CPU
    for name in NEW:
        assert read(name, run) is None, name
    run = synthetic()
    run.program = None                   # a program without the spans
    run.kernel_counts = {}
    for name in NEW:
        assert read(name, run) is None, name


def test_stat_indices_are_the_kernels():
    """The STAT_* indices the readers take are csrc/wave_kernel.cu's."""
    src = devtrace.program_dir() / "csrc"
    walk = dict(re.findall(r"(\w+) = (\d+)", (src / "box_walk.cuh")
                           .read_text().split("enum")[1].split("}")[0]))
    enum = (src / "wave_kernel.cu").read_text().split("enum Stat")[1]
    enum = enum.split("};")[0]
    stat = {}
    for name, val in re.findall(r"(STAT_\w+) = ([\w:]+)", enum):
        stat[name] = int(walk[val.split("::")[1]] if "::" in val else val)
    for name in dir(P):
        if name.startswith("STAT_"):
            assert stat[name] == getattr(P, name), name


def test_new_metrics_are_declared():
    m = {e["name"]: e for e in manifest.load()["per_layer"]}
    for name in NEW:
        assert m[name]["workloads"] == ["ball.fused_64spp"]
        assert m[name]["moves"] == "frame_s"
        assert hasattr(manifest.metric_reader(name), "ENTRY")


def _recorded(monkeypatch):
    records = []

    class Recorded(harness.RunRecord):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            records.append(self)
    monkeypatch.setattr(harness, "RunRecord", Recorded)
    return records


def test_rehearsal_launch_spans_equal_the_wrapped_calls(tmp_path,
                                                        monkeypatch):
    """A traced CPU run of the ball (32x24, 4 spp): the rtf.launch spans'
    attributes equal the roofline's recorded calls one for one, and every
    window frame has its span tree."""
    root, bench = small_bench(tmp_path)
    records = _recorded(monkeypatch)
    out = harness.run("ball.fused_64spp", 2 ** 31 + 5, 0.01, True,
                      time.perf_counter(), device="cpu", width=32,
                      height=24, root=root, bench_dir=bench)
    assert out["correct"] is True
    (run,) = records
    calls = run.calls["rtf_tpu_torch.render.wave:wave"]
    spans = P.spans(run)
    launches = [s[6] for s in spans if s[0] == P.LAUNCH]
    assert len(calls) == len(launches) == 4 * run.frames
    assert [(a["lanes"], a["state"], a["surf_out"], a["gi_bounces"])
            for a in launches] == calls
    assert {a["counter"] for a in launches} == {"launches.wave_kernel.mxu"}
    names = [s[0] for s in spans]
    assert names.count(P.FRAME) == run.frames
    assert names.count(P.WAVE) == 4 * run.frames
    assert not any(name in out["metrics"] for name in NEW)   # the CPU


@pytest.mark.cuda
def test_launch_spans_start_before_their_kernels(monkeypatch):
    """On the card, a traced run of the ball: each wave_kernel device
    event starts after its rtf.launch span (the shared clock, checked by
    causality), the eight metrics read, 3,174 launches a frame."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    records = _recorded(monkeypatch)
    out = harness.run("ball.fused_64spp", 2 ** 31 + 11, 2.0, True,
                      time.perf_counter())
    (run,) = records
    kernels = sorted(s for n, s, _ in run.trace.device
                     if "wave_kernel" in n)
    starts = sorted(s[4] / 1e3 for s in P.spans(run) if s[0] == P.LAUNCH)
    lead = [k - s for k, s in zip(kernels, starts)]
    print(f"[program_trace] {len(lead)} launches, kernel start after its "
          f"span's by {min(lead):.1f}-{max(lead):.1f} us; idle split "
          f"(us) {P.idle_split(run)}; metrics "
          f"{ {k: v['value'] for k, v in out['metrics'].items()} }")
    assert len(kernels) == len(starts) == 64 * run.frames
    assert min(lead) >= 0.0
    assert out["correct"] is True
    for name in NEW:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["launches_per_frame"]["value"] == 3174
