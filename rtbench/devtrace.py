"""Reduce a torch.profiler trace of the window to what the per-layer
metrics read.

Device events are the kernels, copies and sets the profiler saw on the
card (CUPTI); host events are the CPU-side ops and the harness's own
record_function spans.  Both carry microseconds on one clock.  The
arithmetic (device busy time as the union of the device events' intervals,
kernel time summed by name) is chip_smoke.py's profile_frame, kept here so
that the program's scripts can change without moving the yardstick.
"""
from __future__ import annotations

import importlib.util
import re
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "rtbench.window"   # the harness's span around the timed frames
FRAME = "rtbench.frame"     # its span around one frame
# the harness's record_function names, the profiler's own and c10d's
# around a collective ("nccl:all_reduce"): ranges on the device's timeline
# that are no work of their own
ANNOTATIONS = ("rtbench.", "ProfilerStep", "nccl:")


@dataclass
class Trace:
    window: tuple                   # (start, end) us
    device: list                    # [(name, start, end)] us, in the window
    host: list                      # [(name, start, end)] us
    busy_us: float = 0.0
    gaps: list = field(default_factory=list)  # [(start, end)] us

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_us(self, pattern: str) -> tuple:
        """(device us, launches) of the device events whose name holds
        `pattern`."""
        hits = [e - s for n, s, e in self.device if pattern in n]
        return sum(hits), len(hits)

    def launches(self) -> int:
        """Kernels launched in the window (copies and sets left out)."""
        return sum(1 for n, _, _ in self.device if not is_copy(n))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def is_collective(name: str) -> bool:
    """A collective's kernel (NCCL's `ncclDevKernel_...`)."""
    return name.startswith("nccl")


_CUDA_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?(\w+)\s*[(<]")
_TRITON_JIT = re.compile(r"@triton\.jit\b[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
_CUDA_SUFFIXES = (".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp")


def program_dir() -> Path:
    """The directory of the program's package as this process imports it."""
    spec = importlib.util.find_spec("rtf_tpu_torch")
    return Path(spec.origin).parent


def own_kernels(pkg: Path) -> tuple:
    """The names of the program's own device kernels, read from its sources
    under `pkg`: every `__global__` function of its CUDA files and every
    `@triton.jit` function of its Python files.  Read anew each run, so a
    kernel that a later change adds counts as the program's own."""
    names = set()
    for path in sorted(pkg.rglob("*")):
        if path.suffix in _CUDA_SUFFIXES:
            names.update(_CUDA_GLOBAL.findall(path.read_text(errors="replace")))
        elif path.suffix == ".py":
            names.update(_TRITON_JIT.findall(path.read_text(errors="replace")))
    return tuple(sorted(names))


def kernel_matcher(names) -> re.Pattern:
    """A pattern that finds any of `names` as a whole identifier in a
    profiler's kernel name (`void wave_kernel<false, ...>(Args)`)."""
    if not names:
        return re.compile(r"(?!)")
    return re.compile(r"(?<![\w])(?:" + "|".join(map(re.escape, names))
                      + r")(?![\w])")


def union(intervals) -> list:
    """Merged, sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(device_events, host_events) -> Trace:
    """device_events, host_events: [(name, start_us, end_us)]; the window
    is the host span named WINDOW.  Device events named as ANNOTATIONS
    (a host range's shadow on the device) are left out."""
    win = [(s, e) for n, s, e in host_events if n == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans, not 1")
    w0, w1 = win[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in device_events
           if e > w0 and s < w1 and not n.startswith(ANNOTATIONS)]
    busy = union((s, e) for _, s, e in dev)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return Trace(window=(w0, w1), device=dev, host=list(host_events),
                 busy_us=sum(e - s for s, e in busy), gaps=gaps)


class Recorder:
    """torch.profiler's kineto recorder over a block, read as raw events.

    The raw events are read without building torch.profiler's
    FunctionEvent tree, which takes minutes on a window of a million ops
    (the wavefront issues tens of thousands a frame) against seconds
    here.  `trace()` after the block gives the window's Trace."""

    def __init__(self, cuda: bool):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd.profiler import (
            ProfilerConfig, ProfilerState, _prepare_profiler)
        from torch.profiler import ProfilerActivity
        self.acts = {ProfilerActivity.CPU} | (
            {ProfilerActivity.CUDA} if cuda else set())
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        _prepare_profiler(self.config, self.acts)
        self.results = None

    def __enter__(self):
        from torch.autograd.profiler import _enable_profiler
        _enable_profiler(self.config, self.acts)
        return self

    def __exit__(self, *exc):
        from torch.autograd.profiler import _disable_profiler
        self.results = _disable_profiler()

    def trace(self) -> Trace:
        from torch.autograd import DeviceType
        dev, host = [], []
        for ev in self.results.events():
            name = ev.name()
            if hasattr(ev, "start_ns"):
                s, d = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
            else:
                s, d = float(ev.start_us()), float(ev.duration_us())
            if ev.device_type() == DeviceType.CUDA:
                dev.append((name, s, s + d))
            else:
                host.append((name, s, s + d))
        self.results = None
        return reduce(dev, host)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps named by the innermost host op running at the gap's middle, in
    seconds."""
    by_name = {}
    for n, s, e in tr.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [h for h in tr.host if h[0] != WINDOW]
    gaps = []
    for s, e in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        gaps.append([name, (e - s) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": gaps}
