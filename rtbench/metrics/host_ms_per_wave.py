"""host_ms_per_wave (ms): the mean host duration of the window's sample
waves, the program's rtf.wave spans (one loop body of
render/renderer.py::adaptive_ladder, from the host seed draw to the
accumulators: camera, `wave` and the accumulator ops).  Program spans on
the profiler's clock (rtbench/program_trace.py).  Moves frame_s."""

from rtbench import program_trace
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    us = program_trace.mean_us(run, program_trace.WAVE)
    return None if us is None else us / 1e3
