"""torch_ops_ms_per_frame: device milliseconds a frame in kernels that are
not the port's own (its `__global__` CUDA functions and `@triton.jit`
functions, read from the program's sources each run by
rtbench/devtrace.py::own_kernels): the wavefront's and the GI's torch ops,
the camera, accumulation and finalize (torch.profiler; copies, sets and a
sharded frame's collectives, collective_ms_per_frame's, left out).  Moves
frame_s."""

from rtbench import devtrace


def read(run):
    if run.trace is None or run.frames < 1:
        return None
    own = devtrace.kernel_matcher(devtrace.own_kernels(devtrace.program_dir()))
    us = sum(e - s for n, s, e in run.trace.device
             if not (devtrace.is_copy(n) or devtrace.is_collective(n)
                     or own.search(n)))
    return us / 1e3 / run.frames
