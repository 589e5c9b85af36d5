"""wave_walk_lane_use (%): the wave kernel's SIMT efficiency in the mesh
walk: active lanes of the walk's warp-iterations (STAT_WALK_LANES) over 32
lanes each (STAT_WALK_ITERS), over the counted frame after the window
(rtbench/program_trace.py::kernel_counts).  Moves frame_s."""

from rtbench import program_trace as P
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    c = P.kernel_counts(run)
    if c is None or not c[P.STAT_WALK_ITERS]:
        return None
    return 100.0 * c[P.STAT_WALK_LANES] / (P.WARP * c[P.STAT_WALK_ITERS])
