"""idle_ms_in_prepare (ms): device-idle milliseconds a frame while the host is
inside the rtf.prepare span (`_prepare` and the pixel order copied to the
device): the gaps of the traced window's device events (rtbench/devtrace.py)
that fall inside the program's spans
(rtbench/program_trace.py::idle_within), over the frames.  Moves frame_s."""

from rtbench import program_trace
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    return program_trace.idle_ms_per_frame(run, program_trace.PREPARE)
