"""launch_host_us (us): the mean host duration of the window's rtf.launch
spans (render/wave.py::wave from packing the rays to the return: the
packing, the table checks, `shade_params` and the kernel's asynchronous
launch).  Program spans (rtbench/program_trace.py).  Moves frame_s."""

from rtbench import program_trace
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    return program_trace.mean_us(run, program_trace.LAUNCH)
