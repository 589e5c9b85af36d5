"""The tracing registry and the renderer's spans (rtf_tpu_torch/utils/
tracing.py) on the CPU, on the 32x24 box at 2 spp; the launch counts and
the wave kernel's counts on the card (`cuda` cases, which skip here)."""
import time
import tracemalloc

import numpy as np
import pytest
import torch

from rtf_tpu_torch.utils import tracing

W, H, SPP = 32, 24, 2


@pytest.fixture
def clean():
    """Tracing off and nothing recorded, before and after the test."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _frame(dev="cpu", seed=3):
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(W, H), device=dev)
    tables = scene_tables(scene, dev)
    cfg = RenderConfig(min_samples=SPP, max_samples=SPP, bounces=2,
                       shadow_min=1, shadow_max=1, split_mode="rr")
    return render(scene, cfg, seed=seed, device=dev, tables=tables), tables


def test_span_off_reads_no_clock_and_allocates_nothing(clean, monkeypatch):
    def no_clock():
        raise AssertionError("a disabled span read the clock")
    monkeypatch.setattr(time, "time_ns", no_clock)
    assert tracing.span(tracing.WAVE) is tracing.NO_SPAN
    with tracing.span(tracing.FRAME, width=1) as sp:
        sp.set(path="fused")
    _frame()                              # every span of a frame, off
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(10000):
            with tracing.span(tracing.LAUNCH):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 10,000 spans leave nothing behind and never hold a kilobyte at once
    assert current - base < 1024 and peak - base < 1024, (base, current,
                                                          peak)
    assert tracing.collect()["spans"] == []


def test_frame_span_tree(clean):
    tracing.enable()
    _, tables = _frame()
    spans = tracing.collect()["spans"]
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert sorted(by) == sorted([tracing.FRAME, tracing.PREPARE,
                                 tracing.WAVE, tracing.LAUNCH,
                                 tracing.FINALIZE])
    (frame,) = by[tracing.FRAME]
    assert frame[2] is None and frame[3] == frame[1]
    assert frame[6] == {"path": "fused", "width": W, "height": H}
    assert len(by[tracing.PREPARE]) == len(by[tracing.FINALIZE]) == 1
    assert len(by[tracing.WAVE]) == len(by[tracing.LAUNCH]) == SPP
    ids = {s[1]: s for s in spans}
    for s in spans:
        assert s[3] == frame[1]                     # one frame id
        assert s[4] <= s[5]
        if s is frame:
            continue
        parent = ids[s[2]]
        assert parent[4] <= s[4] and s[5] <= parent[5]   # nested in time
        want = tracing.WAVE if s[0] == tracing.LAUNCH else tracing.FRAME
        assert parent[0] == want
    waves = {s[1] for s in by[tracing.WAVE]}
    assert {s[2] for s in by[tracing.LAUNCH]} == waves   # one launch each
    assert [s[6] for s in by[tracing.WAVE]] == [
        {"index": j, "lanes": W * H} for j in range(SPP)]
    from rtf_tpu_torch.render.wave import launch_counter
    for s in by[tracing.LAUNCH]:
        assert s[6] == {"counter": launch_counter(tables), "lanes": W * H,
                        "state": False, "surf_out": False, "gi_bounces": 0}


def test_frame_is_the_same_with_tracing_on(clean):
    off, _ = _frame()
    tracing.enable(kernel_counters=True)
    on, _ = _frame()
    out = tracing.collect()
    assert out["spans"] and out["kernel_counts"] == {}   # the plain wave
    for k in ("image", "radiance", "z", "sample_count"):
        assert np.array_equal(getattr(off, k), getattr(on, k)), k


def test_counters_registry(clean):
    for key in ("a", "a", "b", "a"):
        tracing.count(key)
    assert tracing.counter("a") == 3 and tracing.counter("c") == 0
    tracing.reset_counters("a")
    assert (tracing.counter("a"), tracing.counter("b")) == (0, 1)
    tracing.count("a")
    tracing.reset_counters()
    assert (tracing.counter("a"), tracing.counter("b")) == (0, 0)
    tracing.count("a")
    assert tracing.kernel_stats("k", 4, "cpu") is None    # counters off
    tracing.enable(kernel_counters=True)
    t = tracing.kernel_stats("k", 4, "cpu")
    assert t is tracing.kernel_stats("k", 4, "cpu")
    assert t.dtype == torch.int64
    t += 2
    out = tracing.collect()
    assert out == {"spans": [], "counters": {"a": 1},
                   "kernel_counts": {"k": [2, 2, 2, 2]}}
    assert tracing.collect() == {"spans": [], "counters": {},
                                 "kernel_counts": {}}


def test_program_span_and_profiler_share_a_clock(clean):
    """A program span and a torch.profiler range opened inside it, as the
    benchmark's recorder reads them, agree within 1 ms."""
    from torch.autograd import profiler

    from rtbench import devtrace
    rec = devtrace.Recorder(False)
    tracing.enable()
    with rec:
        with profiler.record_function(devtrace.WINDOW):
            with tracing.span("outer"):
                with profiler.record_function("inner"):
                    torch.ones(64).sum()
    (inner,) = [h for h in rec.trace().host if h[0] == "inner"]
    (outer,) = tracing.collect()["spans"]
    s, e = outer[4] / 1e3, outer[5] / 1e3
    assert abs(inner[1] - s) < 1000 and abs(inner[2] - e) < 1000, \
        (inner, s, e)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_registry_counts_each_wave_launch(clean, cuda_dev):
    from rtf_tpu_torch.render.wave import NSTAT, launch_counter
    tracing.enable(kernel_counters=True)
    _, tables = _frame(cuda_dev)
    key = launch_counter(tables)
    out = tracing.collect()
    offsets = [out["counters"].pop(k, 0) for k in
               ("camera.offsets.hit", "camera.offsets.miss")]
    assert out["counters"] == {key: SPP}
    assert sum(offsets) == 2 * SPP        # one x and one y offset a wave
    (counts,) = out["kernel_counts"].values()
    assert list(out["kernel_counts"]) == [key] and len(counts) == NSTAT
    assert counts[0] >= SPP * W * H          # STAT_RAYS: every lane traced
    launches = [s for s in out["spans"] if s[0] == tracing.LAUNCH]
    assert [s[6]["counter"] for s in launches] == [key] * SPP
