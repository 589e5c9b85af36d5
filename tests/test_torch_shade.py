"""The wavefront's shading and queue steps (rtf_tpu_torch/render/shade.py,
render/integrator.py) against rtf_tpu's on the same inputs, with the
reference's jax.random draws fed in as tensors (built with fold_in/split
exactly as the JAX functions build them):

* sample_material and direct_lighting, hard shadows on the 32x24 box with
  its mesh (mesh_algo="pallas_interpret") and soft 4 -> 16 shadows on the
  box with a sized light: rtol 1e-4, atol 1e-5;
* fresnel_split with glossy reflection and refraction: rtol 1e-4, atol
  1e-5;
* _compact with tied priorities, _rr_select and _hemisphere_chunk per
  lane: the same lanes survive, values within rtol 1e-5, atol 1e-6."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _surfaces(with_mesh, light_size=0.0, glossy=False):
    """JAX scene, port scene and the JAX first-hit surface of the camera
    rays (sample 1), with the port's copy of that surface."""
    import jax.numpy as jnp
    from rtf_tpu.ops.trace import resolve_surface, trace
    from rtf_tpu.render.camera import pixel_order, primary_rays
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.ops.trace import Surface
    desc = box_scene(32, 24, with_mesh=with_mesh, mesh_subdiv=1,
                     light_size=light_size)
    if glossy:
        desc.materials["mirror"].reflection_glossiness = 0.15
        desc.materials["glass"].refraction_glossiness = 0.2
    js = dataclasses.replace(build_scene(desc), mesh_algo="pallas_interpret")
    order = jnp.asarray(pixel_order(32, 24))
    o, d = primary_rays(js, order % 32, order // 32, jnp.ones_like(order))
    jsurf = resolve_surface(js, o, d, trace(js, o, d))
    psurf = Surface(**{f.name: _t(getattr(jsurf, f.name))
                       for f in dataclasses.fields(Surface)})
    return js, port_scene_from_jax(js), o, d, jsurf, psurf


def _shadow_draws(key, light_kinds, cfg, n):
    """direct_lighting's draws as rtf_tpu makes them (shade.py:103-107,
    :124-153): per point light, split(fold_in(key, li), nsamp), then a
    split per sample; the escalation from fold_in(that key, 7)."""
    def disk(k, nsamp):
        out = []
        for ki in jax.random.split(k, nsamp):
            k1, k2 = jax.random.split(ki)
            out.append([np.asarray(jax.random.uniform(k1, (n,))),
                        np.asarray(jax.random.uniform(k2, (n,)))])
        return torch.as_tensor(np.array(out))
    draws = {}
    for li, kind in enumerate(light_kinds):
        if kind == "point":
            lkey = jax.random.fold_in(key, li)
            draws[li] = (disk(lkey, cfg.shadow_min),
                         disk(jax.random.fold_in(lkey, 7), cfg.shadow_max))
    return draws


@pytest.mark.parametrize("case", ["hard_mesh", "soft"])
def test_direct_lighting_matches_jax(case):
    from rtf_tpu.render import shade as JS
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.render import shade as PS
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import scene_tables
    soft = case == "soft"
    js, ps, o, d, jsurf, psurf = _surfaces(not soft, 1.0 if soft else 0.0)
    kw = dict(shadow_min=4, shadow_max=16) if soft else \
        dict(shadow_min=1, shadow_max=1)
    jcfg, pcfg = JConfig(**kw), RenderConfig(**kw)
    jm = JS.sample_material(js, jsurf.mtl, jsurf.uvw)
    pm = PS.sample_material(ps, scene_tables(ps), psurf.mtl, psurf.uvw)
    for a, b in zip(pm, jm):
        _close(a, b)
    key = jax.random.PRNGKey(3)
    ref = JS.direct_lighting(js, jcfg, jsurf, jm, -d, key)
    draws = _shadow_draws(key, js.light_kinds, pcfg, o.shape[0]) \
        if soft else None
    got = PS.direct_lighting(ps, pcfg, psurf, pm, -_t(d), draws)
    _close(got, ref)
    assert float(got.mean()) > 0.05
    if soft:
        # the draws matter: other uniforms move the penumbrae
        other = {li: (a.flip(-1), b.flip(-1)) for li, (a, b) in
                 draws.items()}
        moved = PS.direct_lighting(ps, pcfg, psurf, pm, -_t(d), other)
        assert not torch.allclose(moved, got, rtol=1e-4, atol=1e-5)
        with pytest.raises(ValueError, match="uniforms"):
            PS.direct_lighting(ps, pcfg, psurf, pm, -_t(d))


def test_fresnel_split_glossy_matches_jax():
    from rtf_tpu.render import shade as JS
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.render import shade as PS
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import scene_tables
    js, ps, o, d, jsurf, psurf = _surfaces(False, glossy=True)
    assert js.any_glossy and ps.any_glossy
    jm = JS.sample_material(js, jsurf.mtl, jsurf.uvw)
    pm = PS.sample_material(ps, scene_tables(ps), psurf.mtl, psurf.uvw)
    key = jax.random.fold_in(jax.random.PRNGKey(8), 4099)
    ref = JS.fresnel_split(JConfig(), jsurf, jm, -d, key=key, glossy=True)
    # fresnel_split: kr, kt = split(key); _perturb_normal: k1, k2 = split
    u = torch.as_tensor(np.array([
        [np.asarray(jax.random.uniform(k, (o.shape[0],)))
         for k in jax.random.split(kk)] for kk in jax.random.split(key)]))
    got = PS.fresnel_split(RenderConfig(), psurf, pm, -_t(d), u=u,
                           glossy=True)
    for a, b in zip(got, ref):
        _close(a, b)
    flat = PS.fresnel_split(RenderConfig(), psurf, pm, -_t(d))
    assert not torch.allclose(flat.r_dir, got.r_dir)


def _queue(rng, n, lib):
    """A random RayQueue of either package: priorities from a small set
    (many exact ties), a third of the lanes dead."""
    tput = rng.choice([0.0, 0.25, 0.5, 0.75], (n, 3)).astype(np.float32)
    tput[:, 1] = tput[:, 0]
    tput[:, 2] = tput[:, 0]
    arr = dict(o=rng.normal(size=(n, 3)), d=rng.normal(size=(n, 3)),
               tput=tput, absorb=rng.uniform(size=(n, 3)),
               pixel=np.arange(n) % (n // 2),
               rtype=rng.integers(0, 3, n), alive=rng.uniform(size=n) > 0.33)
    if lib == "jax":
        import jax.numpy as jnp
        from rtf_tpu.render.integrator import RayQueue
        return RayQueue(**{k: jnp.asarray(v.astype(np.float32) if
                                          v.dtype.kind == "f" else
                                          v.astype(np.int32) if k != "alive"
                                          else v) for k, v in arr.items()})
    from rtf_tpu_torch.render.integrator import RayQueue
    return RayQueue(**{k: torch.as_tensor(
        v.astype(np.float32) if v.dtype.kind == "f" else
        v.astype(np.int64) if k == "pixel" else
        v.astype(np.int32) if k != "alive" else v) for k, v in arr.items()})


def _same_queue(p, j, rtol=1e-5, atol=1e-6):
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name).numpy(), np.asarray(getattr(j, f.name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f.name)


def test_compact_rr_select_hemisphere_match_jax():
    from rtf_tpu.render import integrator as JI
    from rtf_tpu_torch.render import integrator as PI
    n = 512
    # _compact: 2n candidates with tied priorities down to n
    jq = _queue(np.random.default_rng(1), 2 * n, "jax")
    pq = _queue(np.random.default_rng(1), 2 * n, "torch")
    _same_queue(PI._compact(pq, n), JI._compact(jq, n))
    # _rr_select: [2n] children -> n lane-aligned continuations
    key = jax.random.PRNGKey(4)
    u = _t(jax.random.uniform(key, (n,)))
    sel = PI._rr_select(pq, u)
    _same_queue(sel, JI._rr_select(jq, key))
    assert 0 < int(sel.alive.sum()) < n
    # _hemisphere_chunk: one GI sample per first-hit lane
    rng = np.random.default_rng(2)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    fields = dict(radiance=np.zeros((n, 3)), hit_t=rng.uniform(1, 9, n),
                  surf_p=rng.uniform(-9, 9, (n, 3)), surf_n=nrm,
                  kd=rng.uniform(size=(n, 3)), k_eff=rng.uniform(size=(n, 3)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    hit = rng.uniform(size=n) > 0.2
    jres = JI.ShadeResult(children=jq, hit_mask=jax.numpy.asarray(hit),
                          **{k: jax.numpy.asarray(v)
                             for k, v in fields.items()})
    pres = PI.ShadeResult(children=pq, hit_mask=torch.as_tensor(hit),
                          **{k: torch.as_tensor(v)
                             for k, v in fields.items()})
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu_torch.render.config import RenderConfig
    key = jax.random.PRNGKey(6)
    u = torch.as_tensor(np.array([np.asarray(jax.random.uniform(k, (n,)))
                                  for k in jax.random.split(key)]))
    pix = np.arange(n)
    got = PI._hemisphere_chunk(None, RenderConfig(hemisphere_samples=5),
                               pres, torch.as_tensor(pix), u)
    ref = JI._hemisphere_chunk(None, JConfig(hemisphere_samples=5), jres,
                               jax.numpy.asarray(pix), key)
    _same_queue(got, ref, rtol=1e-5, atol=1e-6)
    assert bool((got.alive == torch.as_tensor(hit)).all())
