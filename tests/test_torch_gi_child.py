"""A hemisphere child wave (render/wave.py with tput3, absorb3 and
rtype=RT_REFRACT, every other lane dead, and the query rows of a photon
child, gi_from=0) against interpret-mode rtf_tpu.render.fused.fused_wave.
Tolerances as in test_torch_gi_rows.py; dead lanes give zero radiance, no
hit and a zero query weight on both sides."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_rows import _cfg, assert_rows_close, run_rows  # noqa: E402


def test_child_wave_matches_fused_wave():
    from rtf_tpu.scene.procedural import box_scene
    alive = np.ones(32 * 24, bool)
    alive[::2] = False
    ref, port = run_rows(box_scene(32, 24, mesh_subdiv=1), _cfg(), 104729,
                         alive=alive, child=True, gi_from=0)
    assert_rows_close(ref, port, alive, 0)
    for rad, hit in ((ref[0], ref[1]), (port[0], port[1])):
        assert not hit[~alive].any()
        assert (rad[:, ~alive] == 0).all()
