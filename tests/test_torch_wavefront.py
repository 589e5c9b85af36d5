"""Whole frames on the port's XLA wavefront against rtf_tpu's renderer.

proj5 and proj3 take the 'both' split with hard shadows and no glossy
material or GI, so neither renderer draws a random number: the 32x24 box
(icosphere ball, mesh_subdiv=1) is held per pixel against
rtf_tpu.render.renderer.render with mesh_algo="pallas_interpret" (the
Pallas mesh kernel's arithmetic; JAX's CPU default, the dense path,
differs by up to 1.4e-4).  Sample counts and hit masks equal, z within
rtol 1e-4, radiance within atol 2e-4 on all but at most 0.5% of pixels
(rtf_tpu's jitted frame itself rounds a few sphere pixels 1e-4 relative
away from its own eager functions, which the port matches), the mean
within 0.1%."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


@pytest.mark.parametrize("profile", ["proj5", "proj3"])
def test_frame_matches_jax_per_pixel(profile):
    from rtf_tpu.render.config import PROFILES as JPROFILES
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.ops import mesh_hit
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    js = dataclasses.replace(build_scene(box_scene(32, 24, mesh_subdiv=1)),
                             mesh_algo="pallas_interpret")
    ps = port_scene_from_jax(js)
    cfg = PROFILES[profile]
    assert render_path(ps, cfg)[0] == "wavefront"
    ref = jrender(js, JPROFILES[profile])
    calls = []
    plain = mesh_hit.mesh_closest_hit_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    mesh_hit.mesh_closest_hit_plain = counted
    try:
        got = render(ps, cfg, device="cpu")
    finally:
        mesh_hit.mesh_closest_hit_plain = plain
    # one mesh test per trace: 1 + 1 shadow per shade_lanes, 1 + bounces
    # shade_lanes per wave
    assert len(calls) == 2 * (1 + cfg.bounces)
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - ref.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, err.max()
    assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 1e-3
    assert (ref.z < 1e29).all() and got.radiance.mean() > 1.0


@pytest.mark.parametrize("profile", ["default", "proj7", "proj8",
                                     "proj10"])
def test_profile_renders_on_cpu(profile):
    """RenderConfig() and the profiles without GI that proj5/proj3 leave
    out (proj7's L2 environment, proj8's and proj10's 4 -> 16 -> 64
    adaptive ladder) on the box at 32x24 (mesh_subdiv=0) take the
    wavefront and give a finite frame (the GI profiles:
    test_torch_wavefront_gi.py and _photon.py)."""
    from rtf_tpu_torch.render.config import PROFILES, RenderConfig
    from rtf_tpu_torch.render.renderer import _phase_bounds, render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    cfg = RenderConfig() if profile == "default" else PROFILES[profile]
    res = render(build_scene(box_scene(32, 24, mesh_subdiv=0), device="cpu"),
                 cfg, device="cpu")
    assert np.isfinite(res.radiance).all() and res.image.mean() > 5.0
    assert set(np.unique(res.sample_count)) <= set(_phase_bounds(cfg))
