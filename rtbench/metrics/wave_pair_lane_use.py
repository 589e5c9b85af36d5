"""wave_pair_lane_use (%): the wave kernel's SIMT efficiency in the mesh
walk's face loops: active lanes of the face loops' warp-iterations
(STAT_PAIR_LANES) over 32 lanes each (STAT_PAIR_ITERS), over the counted
frame after the window (rtbench/program_trace.py::kernel_counts).  Moves
frame_s."""

from rtbench import program_trace as P
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)

# csrc/box_walk.cuh's PAIR_ITERS and PAIR_LANES (the wave kernel's
# STAT_PAIR_ITERS and STAT_PAIR_LANES)
STAT_PAIR_ITERS, STAT_PAIR_LANES = 20, 21


def read(run):
    c = P.kernel_counts(run)
    if c is None or not c[STAT_PAIR_ITERS]:
        return None
    return 100.0 * c[STAT_PAIR_LANES] / (P.WARP * c[STAT_PAIR_ITERS])
