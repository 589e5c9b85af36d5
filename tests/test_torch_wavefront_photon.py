"""Photon GI on the port's wavefront, on the CPU, from the committed
scene_b irradiance volume (points outside it clamp to its border): the
'final' and 'photon' profiles on the 32x24 box (mesh_subdiv=0) render
with the volume handed in, and 'pm_direct', which the fused path refuses,
lights the box from the volume alone."""
import numpy as np
import pytest

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_volume import VOLUME  # noqa: E402


def _render(cfg):
    """(scene, volume, frame); the volume is handed in for the photon
    modes."""
    from rtf_tpu_torch.gi.volume import load_volume
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    vol = load_volume(VOLUME, device="cpu")
    scene = build_scene(box_scene(32, 24, mesh_subdiv=0), device="cpu")
    kw = dict(gi_vol=vol) if cfg.gi_mode in ("photon", "pm_direct") else {}
    return scene, vol, render(scene, cfg, device="cpu", **kw)


@pytest.mark.parametrize("profile", ["final", "photon"])
def test_photon_profile_renders_on_cpu(profile):
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.scene_tables import render_path
    cfg = PROFILES[profile]
    scene, vol, res = _render(cfg)
    assert render_path(scene, cfg)[0] == "wavefront"
    assert np.isfinite(res.radiance).all() and res.image.mean() > 5.0
    assert set(np.unique(res.sample_count)) <= {4, 8}


def test_pm_direct_lights_from_the_volume():
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import render_path
    cfg = RenderConfig(min_samples=4, max_samples=4, bounces=1,
                       gi_mode="pm_direct", shadow_min=1, shadow_max=1)
    scene, vol, res = _render(cfg)
    path, why = render_path(scene, cfg)
    assert path == "wavefront" and "pm_direct" in why
    assert np.isfinite(res.radiance).all()
    # no light loop: the box's lit surfaces are the volume's alone
    _, _, none = _render(cfg.with_(gi_mode="none"))
    assert res.radiance.mean() > 0.0 and \
        abs(res.radiance.mean() - none.radiance.mean()) > 1e-3
