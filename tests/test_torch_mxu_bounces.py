"""The port's wave on the MXU tables past bounce 0 against interpret-mode
rtf_tpu.render.fused.fused_wave with mxu_tables, per lane.  A rounding
difference can flip a Russian-roulette choice, so at most 1% of lanes may
lie outside atol 2e-4 and the mean radiance agrees within 1%; hit masks
and z (bounce 0) stay equal."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_mxu_wave import _cfg, run_mxu  # noqa: E402


def assert_bounces(ref, port, atol=2e-4):
    (rr, rh, rz), (pr, ph, pz) = ref, port
    np.testing.assert_array_equal(ph, rh)
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    off = (np.abs(pr - rr) > atol).any(0).mean()
    assert off <= 0.01, off
    assert rr.mean() > 0.05
    assert abs(pr.mean() - rr.mean()) <= 0.01 * rr.mean()


def test_mxu_wave_bounces4_soft_shadows():
    """A sized light (adaptive 4 -> 16 disk shadow samples through the
    mesh any-hit), 4 bounces, a seed whose per-group term wraps int32."""
    from rtf_tpu.scene.procedural import box_scene
    cfg = _cfg(bounces=4, shadow_min=4, shadow_max=16)
    ref, port, _ = run_mxu(box_scene(32, 24, mesh_subdiv=3, light_size=1.0),
                           cfg, 2 ** 31 - 5)
    assert_bounces(ref, port)
    lum = ref[0].mean(0)
    assert ((lum > 0.02) & (lum < 0.98 * lum.max())).mean() > 0.1


def test_mxu_wave_bounces2_two_groups():
    """Bounces 2 at 48x32: two 1024-lane RNG groups."""
    from rtf_tpu.scene.procedural import box_scene
    ref, port, _ = run_mxu(box_scene(48, 32, mesh_subdiv=3), _cfg(bounces=2),
                           77)
    assert_bounces(ref, port)
