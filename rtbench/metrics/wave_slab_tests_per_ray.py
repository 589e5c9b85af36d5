"""wave_slab_tests_per_ray (tests): the wave kernel's box (slab) tests of
the mesh walk, root, groups, tiles and leaves (STAT_ROOT + STAT_GROUPS +
STAT_TILES + STAT_LEAVES), per ray traced, closest-hit and shadow
(STAT_RAYS + STAT_SHADOW), over the counted frame after the window
(rtbench/program_trace.py::kernel_counts).  Moves frame_s."""

from rtbench import program_trace as P
from rtbench.program_trace import ENTRY, record  # noqa: F401  (the hook)


def read(run):
    c = P.kernel_counts(run)
    rays = None if c is None else c[P.STAT_RAYS] + c[P.STAT_SHADOW]
    if not rays:
        return None
    return (c[P.STAT_ROOT] + c[P.STAT_GROUPS] + c[P.STAT_TILES]
            + c[P.STAT_LEAVES]) / rays
