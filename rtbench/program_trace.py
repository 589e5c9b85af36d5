"""The program's own spans and counters (rtf_tpu_torch/utils/tracing.py) in
a traced run, for the per-layer readers that read them.

The harness wraps the entries that its readers name (ENTRY,
`harness.py::_Wrapped`) and calls their `record` at every call in the
window.  These readers name the program's `render`: the window's first
frame switches the program's spans on (`record`) and keeps the frame's
arguments.  After the window, `spans(run)` collects the spans once per run,
and `kernel_counts(run)` renders one more frame of the same traffic with
the wave kernel's counters on (`tracing.enable(kernel_counters=True)`),
outside the window and outside set-up, and reads them.  Where the harness
itself gives `run.program` or `run.kernel_counts`, those are read instead.
A program without the tracing module records nothing, and both give None.

Times: a program span carries Unix-epoch nanoseconds, the clock of the
profiler's events (rtbench/devtrace.py, microseconds), so a span's
interval is its (start_ns, end_ns) / 1000 on the trace's timeline.
"""
from __future__ import annotations

import importlib

ENTRY = "rtf_tpu_torch.render.renderer:render"
TRACING = "rtf_tpu_torch.utils.tracing"

FRAME, PREPARE, WAVE, LAUNCH, FINALIZE = (
    "rtf.frame", "rtf.prepare", "rtf.wave", "rtf.launch", "rtf.finalize")

# csrc/wave_kernel.cu's work counters (enum Stat) that the readers take
STAT_RAYS, STAT_SHADOW, STAT_TILES = 0, 2, 3
STAT_ROOT, STAT_GROUPS, STAT_LEAVES = 11, 12, 13
STAT_CYC_WALK, STAT_CYC_BOUNCES = 15, 17
STAT_WALK_ITERS, STAT_WALK_LANES = 18, 19
WARP = 32

_held = {"tracing": None, "frame": None}   # the window's tracing module,
                                           # its first frame's arguments


def _tracing():
    try:
        return importlib.import_module(TRACING)
    except ImportError:
        return None


def record(a, k):
    """At a frame of the window: switch the program's spans on at the
    first, and keep its arguments for the counted frame."""
    if _held["frame"] is None:
        tr = _tracing()
        if tr is not None:
            tr.collect()             # drop what an earlier run left
            tr.enable()
            _held["tracing"], _held["frame"] = tr, (a, k)


def spans(run):
    """The program's spans of the window's frames, [(name, id, parent,
    frame, start_ns, end_ns, attrs)], or None.  Spans outside any rtf.frame
    (a sharded frame's waves: `render_sharded` opens none) count where they
    lie inside the window."""
    if getattr(run, "program", None) is None:
        tr = _held["tracing"]
        run.program = None
        if tr is not None:
            run.program = tr.collect()
            tr.disable()
            _held["tracing"] = None
    if run.program is None:
        return None
    out = run.program["spans"]
    if run.trace is not None:
        w0, w1 = (1e3 * t for t in run.trace.window)
        frames = {s[1] for s in out
                  if s[0] == FRAME and w0 <= s[4] and s[5] <= w1}
        out = [s for s in out if s[3] in frames or (
            s[3] is None and w0 <= s[4] and s[5] <= w1)]
    return out


def kernel_counts(run):
    """The wave kernel's work counts over one counted frame after the
    window, summed over its variants ([NSTAT] ints), or None (no card, no
    tracing module, no frame)."""
    if getattr(run, "kernel_counts", None) is None:
        spans(run)                   # the window's spans first
        run.kernel_counts = _counted_frame()
    counts = [c for c in (run.kernel_counts or {}).values() if any(c)]
    if not counts:
        return None
    return [sum(col) for col in zip(*counts)]


def _counted_frame():
    frame, _held["frame"] = _held["frame"], None
    tr = _tracing()
    if frame is None or tr is None:
        return None
    a, k = frame
    dev = k.get("device")
    if getattr(dev, "type", dev) != "cuda":
        return None
    import torch

    from rtf_tpu_torch.render.renderer import render
    tr.collect()
    tr.enable(kernel_counters=True)
    try:
        with torch.no_grad():
            render(*a, **k)
        return tr.collect()["kernel_counts"]
    finally:
        tr.disable()


def on_device(run) -> bool:
    """Whether the run traced a card (a CPU run has no device events)."""
    return run.trace is not None and bool(run.trace.device)


def intervals(run, name):
    """The (start, end) us of the window's spans named `name`."""
    sp = spans(run)
    if sp is None:
        return None
    return [(s[4] / 1e3, s[5] / 1e3) for s in sp if s[0] == name]


def mean_us(run, name):
    """Mean duration (us) of the window's spans named `name`, on a card."""
    iv = intervals(run, name) if on_device(run) else None
    if not iv:
        return None
    return sum(e - s for s, e in iv) / len(iv)


def idle_within(trace, spans_us) -> float:
    """Device-idle us of the trace's gaps that fall inside the union of
    the given host intervals [(start, end)] us."""
    merged = []
    for s, e in sorted(spans_us):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total, i = 0.0, 0
    for g0, g1 in trace.gaps:
        while i < len(merged) and merged[i][1] <= g0:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < g1:
            total += min(g1, merged[j][1]) - max(g0, merged[j][0])
            j += 1
    return total


def idle_ms_per_frame(run, name):
    """Device-idle ms a frame inside the window's spans named `name`."""
    iv = intervals(run, name) if on_device(run) else None
    if iv is None or run.frames < 1:
        return None
    return idle_within(run.trace, iv) / 1e3 / run.frames


def idle_split(run):
    """The window's device-idle us split by where the host was: inside
    rtf.prepare, rtf.wave or rtf.finalize spans, inside rtf.frame outside
    those, and outside every span (the harness between frames); the parts
    sum to the trace's idle time."""
    parts = {n: intervals(run, n) for n in (PREPARE, WAVE, FINALIZE, FRAME)}
    if any(v is None for v in parts.values()):
        return None
    inner = parts[PREPARE] + parts[WAVE] + parts[FINALIZE]
    out = {n: idle_within(run.trace, parts[n])
           for n in (PREPARE, WAVE, FINALIZE)}
    out["frame_other"] = idle_within(run.trace, parts[FRAME]) \
        - idle_within(run.trace, inner)
    out["outside"] = sum(g1 - g0 for g0, g1 in run.trace.gaps) \
        - idle_within(run.trace, parts[FRAME])
    return out
