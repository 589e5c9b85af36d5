"""The default configuration with soft shadows on the port's wavefront
against rtf_tpu's renderer, on the mean.

RenderConfig() (adaptive 4 -> 8 spp, 4 bounces, the 'both' split, soft
shadows 4 -> 16) on the 32x24 box with a sized light (light_size=1.0)
and without the ball, which keeps rtf_tpu's frame to one compile of 105
shadow-and-hit traces per wave (about 45 s here).  The shadow draws
differ (the port's torch.Generator against rtf_tpu's threefry keys), so
the frames agree on the mean within 1% (the port's mean moves by about
0.05% between seeds); sample counts agree on at least 97% of pixels (the
adaptive rung fires where the penumbra's variance crosses the threshold)
and z equals on the pixels sampled alike."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


def test_default_config_soft_shadows_match_jax_mean():
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    js = build_scene(box_scene(32, 24, with_mesh=False, light_size=1.0))
    ps = port_scene_from_jax(js)
    assert ps.any_soft_light
    cfg = RenderConfig()
    assert render_path(ps, cfg)[0] == "wavefront"
    ref = jrender(js, JConfig())
    got = render(ps, cfg, device="cpu")
    assert np.isfinite(got.radiance).all()
    assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 0.01
    same = got.sample_count == ref.sample_count
    assert same.mean() >= 0.97 and (got.sample_count == 8).any()
    np.testing.assert_allclose(got.z[same], ref.z[same], rtol=1e-4)
    hard = render(ps, cfg.with_(shadow_min=1, shadow_max=1), device="cpu")
    assert np.abs(hard.radiance - got.radiance).max() > 0.005
