"""Spans and counters inside the renderer, for operators and the benchmark.

Spans (off unless `enable()`): `span(name, **attrs)` around a part of the
frame.  Off, it costs one test of a module-level flag and returns the
shared `NO_SPAN`: no clock read, no allocation.  On, each span appends
(name, id, parent id, frame id, start_ns, end_ns, attrs) to a list in
memory, written nowhere until `collect()`.  The clock is `time.time_ns()`,
the Unix-epoch clock of torch.profiler's kineto events, so a span and the
device events of a profiler trace share one timeline (microseconds =
ns / 1000).  The renderer's spans (render/renderer.py, render/wave.py):

  rtf.frame     `render` (frame and finalize), `render_device_host` or
                parallel/mesh.py::render_sharded (a rank's frame, the
                collectives included); attrs path, width, height.  Its
                id is the frame id of every span inside it.
  rtf.prepare   `_prepare` and the pixel order on the device
  rtf.wave      one sample wave of `adaptive_ladder`, from the host seed
                draw to the accumulators; attrs index (Halton), lanes
  rtf.launch    `render/wave.py::wave`, from packing the rays to the
                return; attrs counter (the launch's registry key), lanes,
                state (a child wave's state given), surf_out, gi_bounces
  rtf.finalize  `lanes_to_pixels`, `_finalize_device` and the copies to
                the host

Counters (always on): plain ints by key, `count(key)`.  The kernels'
launches: launches.wave_kernel, .wave_kernel.textured, .wave_kernel.mxu,
.wave_kernel.textured_mxu (render/wave.py::launch_counter),
launches.mesh_closest_hit, launches.mesh_closest_hit_mxu,
launches.bvh_closest_hit (the wide walk) and launches.bvh_closest_hit.binary.
The camera's memo of Halton sub-pixel offsets (render/camera.py::_offset,
two lookups a sample wave): camera.offsets.hit, camera.offsets.miss.

Kernel counts (`enable(kernel_counters=True)`): `wave` hands each launch
that is given no `stats=` a device int64 [NSTAT] tensor held here per
launch counter and device, so the kernel's counting instantiation adds its
STAT_* work counts there (csrc/wave_kernel.cu).  They stay on the card and
are read once, by `collect()`: no sync and no kernel per launch.  The plain
version on the CPU counts nothing.

State is per process and not locked: render from one thread while tracing.
"""
from __future__ import annotations

import itertools
import time

FRAME = "rtf.frame"
PREPARE = "rtf.prepare"
WAVE = "rtf.wave"
LAUNCH = "rtf.launch"
FINALIZE = "rtf.finalize"

_on = False
_kernel_counters = False
_spans = []               # finished spans, as `collect` returns them
_open = []                # the open spans, innermost last
_ids = itertools.count(1)
_counts = {}              # counter key -> int
_stats = {}               # (launch counter, device) -> int64 tensor


class _NoSpan:
    """The span of disabled tracing: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "frame", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.frame = self.id if self.name == FRAME else (
            outer.frame if outer else None)
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.remove(self)
        _spans.append((self.name, self.id, self.parent, self.frame,
                       self.start, end, self.attrs))
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager timing one part of the frame (see the module
    docstring); `NO_SPAN` while tracing is off."""
    if not _on:
        return NO_SPAN
    return _Span(name, attrs)


def enable(kernel_counters: bool = False):
    """Record spans from now on; with kernel_counters, also the wave
    kernel's work counts (a slower, counting instantiation of the
    kernel)."""
    global _on, _kernel_counters
    _on, _kernel_counters = True, bool(kernel_counters)


def disable():
    """Stop recording spans and kernel counts (what was recorded stays
    until `collect`)."""
    global _on, _kernel_counters
    _on = _kernel_counters = False


def collect() -> dict:
    """What was recorded since the last collect, then cleared: {"spans":
    [(name, id, parent, frame, start_ns, end_ns, attrs)] in start order,
    "counters": {key: int}, "kernel_counts": {launch counter: [NSTAT
    ints]}}.  Reading the kernel counts waits for the card."""
    spans = sorted(_spans, key=lambda s: s[1])
    kernel = {}
    for (key, _), t in _stats.items():
        vals = t.tolist()
        old = kernel.get(key)
        kernel[key] = vals if old is None else [a + b for a, b in
                                                zip(old, vals)]
    counters = dict(_counts)
    _spans.clear()
    _stats.clear()
    _counts.clear()
    return {"spans": spans, "counters": counters, "kernel_counts": kernel}


def count(key: str):
    """Add one to the counter `key`."""
    _counts[key] = _counts.get(key, 0) + 1


def counter(key: str) -> int:
    """The counter's value (0 if never counted)."""
    return _counts.get(key, 0)


def reset_counters(*keys: str):
    """Set the named counters, or all of them, to 0."""
    for key in keys or list(_counts):
        _counts.pop(key, None)


def kernel_stats(key: str, size: int, device):
    """The device int64 [size] tensor that a launch counted under `key`
    adds its work counts to, while kernel counters are on; else None."""
    if not _kernel_counters:
        return None
    t = _stats.get((key, str(device)))
    if t is None:
        import torch
        t = _stats[(key, str(device))] = torch.zeros(
            size, dtype=torch.int64, device=device)
    return t
