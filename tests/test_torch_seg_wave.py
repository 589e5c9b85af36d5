"""The port on file-textured scenes against rtf_tpu: the wave
(render/wave.py::wave_plain, through `wave` on CPU tensors) against
interpret-mode rtf_tpu.render.fused_seg.fused_wave_seg at bounce 0, and
the whole render against rtf_tpu.render.renderer.render.

Wave at bounce 0: no Russian roulette, so hit masks are equal, radiance
within atol 5e-4 (test_fused_seg.py:70) and z within rtol 1e-4 on hits.
Render: at bounces=0 a sample is deterministic given its Halton index, so
bytes agree within 1 on 99.5% of pixels, z within rtol 1e-4 and sample
counts on 99% of pixels; at bounces=4 the RNG streams differ and the mean
radiance agrees within 5% (test_torch_render.py)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_common import port_scene_from_jax, textured_desc  # noqa: E402


def _cfg(**kw):
    from rtf_tpu.render.config import RenderConfig
    base = dict(min_samples=8, max_samples=8, bounces=0, shadow_min=1,
                shadow_max=1, gi_mode="none")
    base.update(kw)
    return RenderConfig(**base)


def run_seg_both(desc, cfg, seed, bounces=None):
    """The JAX camera's rays (sample 0) and one seed through interpret-mode
    fused_wave_seg and the port's wave; returns ((rad [N,3], hit, z) JAX,
    (...) port, the port's inputs (tables, o3, d3, alive))."""
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import mxu_tables, scene_consts
    from rtf_tpu.render.fused_seg import fused_wave_seg, fusable_seg
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.utils.tracing import counter
    scene = build_scene(desc)
    assert fusable_seg(scene, cfg) and mxu_tables(scene) is None
    w, h = scene.width, scene.height
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(scene, order % w, order // w,
                             jnp.zeros_like(order))
    alive = np.ones(w * h, bool)
    rad3, hit, z = fused_wave_seg(cfg, scene_consts(scene), scene, o3, d3,
                                  jnp.asarray(alive), jnp.int32(seed),
                                  bounces=bounces)
    ref = (np.stack([np.asarray(c) for c in rad3], 1), np.asarray(hit),
           np.asarray(z))
    tables = scene_tables(port_scene_from_jax(scene))
    assert tables.textured
    inputs = (tables, torch.as_tensor(np.stack([np.asarray(x) for x in o3])),
              torch.as_tensor(np.stack([np.asarray(x) for x in d3])),
              torch.as_tensor(alive))
    before = counter("launches.wave_kernel.textured")
    prad, phit, pz = W.wave(cfg, *inputs, seed, bounces=bounces)
    # CPU tensors: the plain version
    assert counter("launches.wave_kernel.textured") == before
    return ref, (prad.T.numpy(), phit.numpy(), pz.numpy()), inputs


def test_seg_wave_bounce0():
    (rr, rh, rz), (pr, ph, pz), _ = run_seg_both(
        textured_desc(port=False), _cfg(), 3, bounces=0)
    np.testing.assert_array_equal(ph, rh)
    assert rh.mean() > 0.5
    np.testing.assert_allclose(pr, rr, atol=5e-4)
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    assert pr.max() > 0.05 and rr.std() > 0.05


@pytest.fixture(scope="module")
def renders():
    """Both renderers on the textured box at bounces 0 and 4."""
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    out = {}
    for bounces in (0, 4):
        kw = dict(min_samples=8, max_samples=16, bounces=bounces,
                  shadow_min=1, shadow_max=1, gi_mode="none",
                  split_mode="rr")
        ref = jrender(jbuild(textured_desc(port=False)), JConfig(**kw))
        port = render(build_scene(textured_desc(), device="cpu"),
                      RenderConfig(**kw), device="cpu")
        out[bounces] = ref, port
    return out


def test_seg_render_matches_jax_bounces0(renders):
    ref, port = renders[0]
    diff = np.abs(port.image.astype(int) - ref.image.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.995
    hit = ref.z < 1e29
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(port.z < 1e29, hit)
    np.testing.assert_allclose(port.z[hit], ref.z[hit], rtol=1e-4)
    assert (port.sample_count == ref.sample_count).mean() >= 0.99
    assert set(np.unique(port.sample_count)) == {8, 16}


def test_seg_render_matches_jax_bounces4_mean(renders):
    ref, port = renders[4]
    assert np.isfinite(port.radiance).all()
    mean_r, mean_p = ref.radiance.mean(), port.radiance.mean()
    assert mean_r > 0.05
    assert abs(mean_p - mean_r) / mean_r < 0.05
