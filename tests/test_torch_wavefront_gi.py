"""GI on the port's wavefront (the 'both' split), on the CPU: a
hemisphere-GI frame against rtf_tpu's on the mean, and the GI profiles
proj11 and proj12 on the 32x24 box (mesh_subdiv=0).

The hemisphere frame: 32x24, 4 spp, 2 bounces, 4 hemisphere samples, hard
shadows; the means agree within 5% (the hemisphere draws differ: the
port's torch.Generator against rtf_tpu's threefry keys; the port's mean
moves by about 1% between seeds) and GI adds light over the same frame
without it."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401

GI = dict(min_samples=4, max_samples=4, bounces=2, gi_mode="hemisphere",
          hemisphere_samples=4, shadow_min=1, shadow_max=1)


def test_hemisphere_frame_matches_jax_mean():
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    ref = jrender(jbuild(jbox(32, 24, mesh_subdiv=1)), JConfig(**GI))
    scene = build_scene(box_scene(32, 24, mesh_subdiv=1), device="cpu")
    cfg = RenderConfig(**GI)
    assert render_path(scene, cfg)[0] == "wavefront"
    got = render(scene, cfg, device="cpu")
    base = render(scene, cfg.with_(gi_mode="none"), device="cpu")
    assert np.isfinite(got.radiance).all()
    np.testing.assert_array_equal(got.z, base.z)
    assert got.radiance.mean() > 1.2 * base.radiance.mean()
    assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 0.05


@pytest.mark.parametrize("profile", ["proj11", "proj12"])
def test_gi_profile_renders_on_cpu(profile):
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    cfg = PROFILES[profile]
    res = render(build_scene(box_scene(32, 24, mesh_subdiv=0), device="cpu"),
                 cfg, device="cpu")
    assert np.isfinite(res.radiance).all() and res.image.mean() > 5.0
    assert set(np.unique(res.sample_count)) <= {cfg.min_samples, 16}
