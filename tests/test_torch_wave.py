"""The port's wave (render/wave.py::wave_plain, and through `wave` the CPU
path of the kernel wrapper) against interpret-mode
rtf_tpu.render.fused.fused_wave on the same scene tables, rays and seed.

At bounce 0 there is no Russian roulette: hit masks must be equal,
radiance within atol 2e-4 (test_fused.py:75), z within rtol 1e-4."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_common import checker_desc, port_scene_from_jax  # noqa: E402


def run_both(desc, cfg, seed, bounces=None, alive=None):
    """Same rays (the JAX camera, sample 0, numpy), lane mask (default all
    alive) and seed through both waves; returns ((rad [N,3], hit, z) JAX,
    (...) port)."""
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu.render.fused import fused_wave, scene_consts
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render import wave as W
    from rtf_tpu_torch.utils.tracing import counter
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = build_scene(desc)
    w, h = scene.width, scene.height
    order = jnp.asarray(pixel_order(w, h))
    o3, d3 = primary_rays_ch(scene, order % w, order // w,
                             jnp.zeros_like(order))
    o3 = np.stack([np.asarray(x) for x in o3])
    d3 = np.stack([np.asarray(x) for x in d3])
    n = w * h
    if alive is None:
        alive = np.ones(n, bool)
    rad3, hit, z = fused_wave(cfg, scene_consts(scene),
                              tuple(jnp.asarray(x) for x in o3),
                              tuple(jnp.asarray(x) for x in d3),
                              jnp.asarray(alive), jnp.int32(seed),
                              bounces=bounces)
    ref = (np.stack([np.asarray(c) for c in rad3], 1), np.asarray(hit),
           np.asarray(z))
    tables = scene_tables(port_scene_from_jax(scene))
    before = counter("launches.wave_kernel")
    prad, phit, pz = W.wave(cfg, tables, torch.as_tensor(o3),
                            torch.as_tensor(d3),
                            torch.as_tensor(alive), seed,
                            bounces=bounces)
    assert counter("launches.wave_kernel") == before   # CPU: the plain version
    return ref, (prad.T.numpy(), phit.numpy(), pz.numpy())


def _cfg(**kw):
    from rtf_tpu.render.config import RenderConfig
    base = dict(min_samples=8, max_samples=8, bounces=0, shadow_min=1,
                shadow_max=1, gi_mode="none")
    base.update(kw)
    return RenderConfig(**base)


def _assert_bounce0(ref, port, alive=slice(None)):
    (rr, rh, rz), (pr, ph, pz) = ref, port
    np.testing.assert_array_equal(ph, rh)
    assert rh[alive].mean() > 0.5
    np.testing.assert_allclose(pr, rr, atol=2e-4)
    np.testing.assert_allclose(pz[rh], rz[rh], rtol=1e-4)
    assert pr.max() > 0.05


def test_wave_bounce0_box():
    from rtf_tpu.scene.procedural import box_scene
    ref, port = run_both(box_scene(32, 24, mesh_subdiv=1), _cfg(), 123)
    _assert_bounce0(ref, port)


def test_wave_bounce0_soft_shadows_seed_wrap():
    """Adaptive disk soft shadows over two 1024-lane RNG groups, with a
    seed whose per-group term wraps int32."""
    from rtf_tpu.scene.procedural import box_scene
    cfg = _cfg(shadow_min=4, shadow_max=16)
    ref, port = run_both(box_scene(48, 32, mesh_subdiv=1, light_size=1.0),
                         cfg, 2 ** 31 - 5)
    _assert_bounce0(ref, port)
    lum = ref[0].mean(-1)
    assert ((lum > 0.02) & (lum < 0.98 * lum.max())).mean() > 0.1


def test_wave_bounce0_checker():
    ref, port = run_both(checker_desc(port=False), _cfg(), 1)
    _assert_bounce0(ref, port)


def test_wave_bounce0_dead_lanes():
    """Every other lane dead, as the adaptive ladder's later rungs mask
    pixels: dead lanes give zero radiance and no hit on both sides, and
    the live lanes match."""
    from rtf_tpu.scene.procedural import box_scene
    alive = np.ones(32 * 24, bool)
    alive[::2] = False
    ref, port = run_both(box_scene(32, 24, mesh_subdiv=1), _cfg(), 31,
                         alive=alive)
    _assert_bounce0(ref, port, alive)
    for rad, hit in ((ref[0], ref[1]), (port[0], port[1])):
        assert not hit[~alive].any()
        assert (rad[~alive] == 0).all()
