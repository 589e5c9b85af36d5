"""collective_ms_per_frame (ms): device milliseconds a frame in the
collectives' kernels on rank 0's card (NCCL's, `ncclDevKernel_...`;
rtbench/devtrace.py::is_collective): on a sharded cell the spp group's
sums in `adaptive_ladder` and the tile group's gather in `render_sharded`,
with the time a kernel waits for the other cards (torch.profiler).  None
where no collective ran (one card, the CPU).  Moves frame_s."""

from rtbench import devtrace


def read(run):
    if run.trace is None or run.frames < 1:
        return None
    us = [e - s for n, s, e in run.trace.device if devtrace.is_collective(n)]
    return sum(us) / 1e3 / run.frames if us else None
