"""A hemisphere child wave on the textured box (tput3, absorb3,
rtype=RT_REFRACT, every other lane dead, query rows from bounce 0)
against interpret-mode rtf_tpu.render.fused_seg.fused_wave_seg, within
one 1024-lane block.  Refraction-typed rays that leave the box sample the
environment map.  Tolerances as in test_torch_gi_seg.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import textured_desc  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_rows import _cfg, assert_rows_close, run_rows  # noqa: E402


def test_child_wave_matches_fused_wave_seg():
    alive = np.ones(32 * 24, bool)
    alive[1::2] = False
    ref, port = run_rows(textured_desc(port=False), _cfg(), 2 ** 31 - 5,
                         seg=True, alive=alive, child=True, gi_from=0)
    assert_rows_close(ref, port, alive, 0, atol=5e-4)
    for rad, hit in ((ref[0], ref[1]), (port[0], port[1])):
        assert not hit[~alive].any()
        assert (rad[:, ~alive] == 0).all()
