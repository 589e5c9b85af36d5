"""wave_walk_cycle_share (%): the share of the wave kernel's lane cycles
in the mesh walk (group, tile and leaf slab tests: STAT_CYC_WALK) of its
whole bounce loop (STAT_CYC_BOUNCES), over one frame of the cell's
traffic rendered after the window with the kernel's counters on (its
counting instantiation; rtbench/program_trace.py::kernel_counts).  Moves
frame_s."""

from rtbench import program_trace as P
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    c = P.kernel_counts(run)
    if c is None or not c[P.STAT_CYC_BOUNCES]:
        return None
    return 100.0 * c[P.STAT_CYC_WALK] / c[P.STAT_CYC_BOUNCES]
