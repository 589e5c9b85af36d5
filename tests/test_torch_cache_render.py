"""The cached-GI render (rtf_tpu_torch/gi/irradiance_cache.py::
render_with_cache, indirect_image, cache_from_arrays) on the CPU.

Against rtf_tpu: both packages get one cache, made from a numpy seed as
rtf_tpu's IrradianceCache and carried across with `cache_from_arrays`;
`indirect_image` must be equal, and `render_with_cache` with that cache
put in place of each package's build (pytest's monkeypatch) gives the
frame of tests/test_torch_wavefront.py's pixel rule: the direct pass takes
the 'both' split with hard shadows and no glossy material, so neither
package draws a random number (32x24 box without the mesh).

The port alone: test_irradiance_cache.py's three checks on its box
(48x36, no mesh, 2 spp, 1 bounce, 8 hemisphere samples): the traced share
lies in (0, 0.6), cached GI adds energy as full GI does (the indirect
energies within 0.5-1.7 of each other), and the fused and wavefront
evaluators agree within 0.8-1.25 in the mean."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_common import port_scene_from_jax  # noqa: E402

GI = dict(min_samples=2, max_samples=2, bounces=1, shadow_min=1,
          shadow_max=1, gi_mode="hemisphere", hemisphere_samples=8,
          split_mode="rr")


def seeded_cache(num_px, seed=0):
    rng = np.random.RandomState(seed)
    n = rng.normal(size=(num_px, 3))
    return dict(
        E=rng.uniform(0.0, 0.5, (num_px, 3)).astype(np.float32),
        computed=rng.rand(num_px) < 0.3,
        kd=rng.uniform(0.0, 1.0, (num_px, 3)).astype(np.float32),
        hit=rng.rand(num_px) < 0.8, front=rng.rand(num_px) < 0.9,
        z=rng.uniform(10.0, 90.0, num_px).astype(np.float32),
        n=(n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32))


def test_render_with_cache_matches_jax(monkeypatch):
    import jax.numpy as jnp
    from rtf_tpu.gi import irradiance_cache as J
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.gi import irradiance_cache as P
    from rtf_tpu_torch.render.config import RenderConfig
    js = build_scene(box_scene(32, 24, with_mesh=False))
    ps = port_scene_from_jax(js)
    arrays = seeded_cache(32 * 24)
    jcache = J.IrradianceCache(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()})
    pcache = P.cache_from_arrays(**arrays, device="cpu")
    np.testing.assert_array_equal(P.indirect_image(pcache).numpy(),
                                  np.asarray(J.indirect_image(jcache)))

    monkeypatch.setattr(J, "build_irradiance_cache",
                        lambda *a, **k: jcache)
    monkeypatch.setattr(P, "build_irradiance_cache",
                        lambda *a, **k: pcache)
    cfg = dict(GI, split_mode="both")
    ref, _ = J.render_with_cache(js, JConfig(**cfg), jax.random.PRNGKey(1))
    got, cache = P.render_with_cache(ps, RenderConfig(**cfg), 1,
                                     device="cpu")
    assert cache is pcache
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - ref.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, err.max()
    assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 1e-3


@pytest.fixture(scope="module")
def box():
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    return build_scene(box_scene(48, 36, with_mesh=False), device="cpu")


def test_cache_build_and_sparsity(box):
    from rtf_tpu_torch.gi.irradiance_cache import build_irradiance_cache
    from rtf_tpu_torch.render.config import RenderConfig
    cache = build_irradiance_cache(box, RenderConfig(**GI), 0,
                                   max_spacing=8, device="cpu")
    E = cache.E.numpy()
    assert E.shape == (48 * 36, 3) and np.isfinite(E).all()
    assert E.max() > 0.01
    frac = float(cache.computed.float().mean())
    assert 0.0 < frac < 0.6


def test_cache_render_tracks_full_gi(box):
    from rtf_tpu_torch.gi.irradiance_cache import render_with_cache
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    cfg = RenderConfig(**GI)
    full = render(box, cfg, seed=1, device="cpu")
    direct = render(box, cfg.with_(gi_mode="none"), seed=1, device="cpu")
    cached, _ = render_with_cache(box, cfg, 1, device="cpu")
    m_full = float(full.radiance.mean())
    m_dir = float(direct.radiance.mean())
    m_cache = float(cached.radiance.mean())
    assert m_full > m_dir * 1.02 and m_cache > m_dir * 1.02
    assert 0.5 < (m_cache - m_dir) / (m_full - m_dir) < 1.7
    assert np.isfinite(cached.radiance).all()


def test_cache_evaluators_agree(box):
    from rtf_tpu_torch.gi import irradiance_cache as P
    from rtf_tpu_torch.render.config import RenderConfig
    cfg = RenderConfig(**GI)
    calls = []
    fused = P._eval_irradiance_fused

    def counted(*a, **k):
        calls.append(1)
        return fused(*a, **k)
    P._eval_irradiance_fused = counted
    try:
        auto = P.build_irradiance_cache(box, cfg, 2, max_spacing=8,
                                        device="cpu")
    finally:
        P._eval_irradiance_fused = fused
    assert calls, "auto must take the fused evaluator on this scene"
    wf = P.build_irradiance_cache(box, cfg, 2, max_spacing=8,
                                  evaluator="wavefront", device="cpu")
    ef, ex = float(auto.E.mean()), float(wf.E.mean())
    assert ex > 0 and ef > 0
    assert 0.8 < ef / ex < 1.25
