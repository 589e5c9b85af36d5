"""The port's renderer with GI on the CPU (rtf_tpu_torch.render.renderer.
render, device='cpu'): hemisphere GI brightens the box like
test_render.py:225 and tracks rtf_tpu.render.renderer.render in the mean
within test_fused.py:153's 8% band (the RNG streams differ); photon and
caustic volumes add light on top of the same waves; the GI configurations
neither path of the port renders are refused with NotImplementedError (GI
on the 'both' split and with a lens render now:
test_torch_wavefront_gi.py, test_torch_wavefront_render.py; photon GI
without a volume and with photon_volume=False since the photon pass was
ported: test_torch_photon_render.py)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_volume import VOLUME  # noqa: E402

KW = dict(min_samples=8, max_samples=8, bounces=2, shadow_min=1,
          shadow_max=1, split_mode="rr", hemisphere_samples=4)


def _port(gi_mode, **kw):
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(32, 24), device="cpu")
    return render(scene, RenderConfig(gi_mode=gi_mode, **KW), device="cpu",
                  **kw)


def test_render_hemisphere_matches_jax_mean():
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.utils.tracing import counter
    keys = ("launches.wave_kernel", "launches.wave_kernel.textured")
    before = sum(map(counter, keys))
    base, gi = _port("none"), _port("hemisphere")
    assert sum(map(counter, keys)) == before   # the plain version
    ref = jrender(jbuild(jbox(32, 24)), JConfig(gi_mode="hemisphere", **KW))
    assert np.isfinite(gi.radiance).all() and gi.image.shape == (24, 32, 3)
    np.testing.assert_array_equal(gi.z, base.z)
    assert gi.radiance.mean() > base.radiance.mean() * 1.02
    mean_r, mean_p = ref.radiance.mean(), gi.radiance.mean()
    assert abs(mean_p - mean_r) / mean_r < 0.08


def test_render_photon_and_caustic_volumes_add_light():
    """The committed scene_b volume, loaded with load_volume, as the photon
    and the caustic volume of the box (points outside it clamp to its
    border): the same seeds give the same waves, so the volume terms
    only add light."""
    from rtf_tpu_torch.gi.volume import load_volume
    vol = load_volume(VOLUME, device="cpu")
    hemi = _port("hemisphere")
    photon = _port("photon", gi_vol=vol)
    caustic = _port("none", caustic_vol=vol)
    base = _port("none")
    for res in (photon, caustic):
        assert np.isfinite(res.radiance).all()
    for more, less in ((photon, hemi), (caustic, base)):
        assert (more.radiance >= less.radiance - 1e-5).all()
        assert more.radiance.mean() > less.radiance.mean() + 1e-3
    with pytest.raises(ValueError, match="photon"):
        _port("hemisphere", gi_vol=vol)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_volume(VOLUME)     # the card by default


@pytest.mark.parametrize("case", [
    "caustic_volume_false", "caustic_both_split"])
def test_gi_refusals_raise(case):
    """A caustic volume where only the wavefront can run: its caustic term
    is the exact gather from a caustic grid, as in rtf_tpu."""
    from rtf_tpu_torch.gi.volume import load_volume
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    vol = load_volume(VOLUME, device="cpu")
    cfg = RenderConfig(gi_mode="hemisphere", **KW)
    desc = box_scene(8, 6, mesh_subdiv=0)
    if case == "caustic_volume_false":     # no caustic volume is read
        cfg = cfg.with_(photon_volume=False)
    else:                                  # the wavefront's is the gather
        cfg = cfg.with_(split_mode="both")
    kw = dict(caustic_vol=vol)
    scene = build_scene(desc, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="caustic volume on the wavefront"):
        render(scene, cfg, device="cpu", **kw)
