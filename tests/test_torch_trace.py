"""The wavefront's tracing (rtf_tpu_torch/ops/trace.py, ops/intersect.py)
against rtf_tpu/ops/trace.py with mesh_algo="pallas_interpret" (the
Pallas mesh kernel in interpret mode), on the same numpy rays:

* trace: kind, instance, face and front equal, t within rtol 1e-5 (atol
  1e-5), barycentrics within rtol 1e-4, atol 1e-5;
* resolve_surface: material and validity equal, p, n and uvw within
  rtol/atol 1e-4;
* trace_shadow: equal.

Scenes: the 32x24 box (icosphere ball, mesh_subdiv=1) and a two-instance
mesh scene (a second, rotated and scaled ball with another material, so
another slot of the packed table); the intersection-era variants
(isect_zero=0, ref_exact's textbook sphere quadratic, the Proj3 min-root
rule) on the box without its mesh.  Rays: the camera's (sample 1) and 257
random rays from inside the box."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


def _jax_scene(name):
    from rtf_tpu.core.transform import Transform
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import _node, box_scene
    desc = box_scene(32, 24, with_mesh=name in ("box", "two_inst"),
                     mesh_subdiv=1)
    if name == "two_inst":
        ball = next(n for n in desc.root.children if n.obj_kind == "mesh")
        desc.root.children.append(_node(
            "ball2", "mesh", "mirror",
            Transform().scale(2).rotate([0, 0, 1], 30).translate([-4, 2, 9]),
            mesh=ball.mesh))
    scene = dataclasses.replace(build_scene(desc),
                                mesh_algo="pallas_interpret")
    variant = {"zero0": dict(isect_zero=0.0), "ref_exact":
               dict(ref_exact=True), "minroot": dict(sphere_minroot=True,
                                                     isect_zero=0.0)}
    return dataclasses.replace(scene, **variant.get(name, {}))


def _rays(scene):
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays
    order = jnp.asarray(pixel_order(32, 24))
    o, d = primary_rays(scene, order % 32, order // 32,
                        jnp.ones_like(order))
    rng = np.random.default_rng(11)
    ro = rng.uniform([-14, -19, 1], [14, 19, 23], (257, 3))
    rd = rng.normal(size=(257, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (np.concatenate([np.asarray(o), ro]).astype(np.float32),
            np.concatenate([np.asarray(d), rd]).astype(np.float32))


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["box", "two_inst", "zero0", "ref_exact",
                                  "minroot"])
def test_trace_resolve_shadow_match_jax(name):
    import jax.numpy as jnp
    from rtf_tpu.ops import trace as JT
    from rtf_tpu_torch.ops import trace as PT
    js = _jax_scene(name)
    ps = port_scene_from_jax(js)
    assert ps.mesh_algo == "pallas_interpret"
    assert (ps.isect_zero, ps.ref_exact, ps.sphere_minroot) == (
        js.isect_zero, js.ref_exact, js.sphere_minroot)
    o, d = _rays(js)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.as_tensor(o), \
        torch.as_tensor(d)
    jh, ph = JT.trace(js, jo, jd), PT.trace(ps, to, td)
    for f in ("kind", "inst", "face", "front"):
        np.testing.assert_array_equal(getattr(ph, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    hit = np.asarray(jh.kind) != 0
    assert hit.mean() > 0.9
    if name in ("box", "two_inst"):
        mesh = np.asarray(jh.kind) == 3
        assert mesh.sum() > 10
        if name == "two_inst":
            assert set(np.asarray(jh.inst)[mesh]) == {0, 1}
    _close(ph.t.numpy(), jh.t, 1e-5, 1e-5)
    _close(ph.ba.numpy(), jh.ba, 1e-4, 1e-5)
    _close(ph.bb.numpy(), jh.bb, 1e-4, 1e-5)

    js_, ps_ = JT.resolve_surface(js, jo, jd, jh), \
        PT.resolve_surface(ps, to, td, ph)
    np.testing.assert_array_equal(ps_.mtl.numpy(), np.asarray(js_.mtl))
    np.testing.assert_array_equal(ps_.valid.numpy(), np.asarray(js_.valid))
    for f in ("p", "n", "uvw"):
        _close(getattr(ps_, f).numpy(), getattr(js_, f), 1e-4, 1e-4)

    # shadow rays toward the light, unnormalized with t_max = 1, from the
    # JAX surface points (misses start at the 1e7 sentinel)
    light = np.asarray(js.lights.position[0])
    sp = np.array(js_.p)
    sd = (light - sp).astype(np.float32)
    jsh = JT.trace_shadow(js, js_.p, jnp.asarray(sd), 1.0)
    psh = PT.trace_shadow(ps, torch.as_tensor(sp), torch.as_tensor(sd), 1.0)
    np.testing.assert_array_equal(psh.numpy(), np.asarray(jsh))
    assert 0.0 < float(psh[:768][hit[:768]].mean()) < 1.0


def test_intersect_primitives_match_jax():
    """intersect_sphere (all variants), intersect_plane, intersect_triangle
    and the attribute functions on local rays from numpy."""
    import jax.numpy as jnp
    from rtf_tpu.ops import intersect as JI
    from rtf_tpu_torch.ops import intersect as PI
    rng = np.random.default_rng(5)
    o = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    t_prev = rng.uniform(0.5, 8.0, 500).astype(np.float32)
    j = [jnp.asarray(x) for x in (o, d, t_prev)]
    p = [torch.as_tensor(x) for x in (o, d, t_prev)]
    for kw in (dict(), dict(zero=0.0), dict(textbook=True),
               dict(minroot=True, zero=0.0)):
        for a, b in zip(PI.intersect_sphere(*p, **kw),
                        JI.intersect_sphere(*j, **kw)):
            _close(a.numpy(), b, 1e-5, 1e-5)
    for a, b in zip(PI.intersect_plane(*p), JI.intersect_plane(*j)):
        _close(a.numpy(), b, 1e-5, 1e-5)
    tri = rng.uniform(-2, 2, (3, 500, 3)).astype(np.float32)
    for a, b in zip(PI.intersect_triangle(p[0], p[1], *map(torch.as_tensor,
                                                             tri), p[2]),
                    JI.intersect_triangle(j[0], j[1], *map(jnp.asarray, tri),
                                          j[2])):
        _close(a.numpy(), b, 1e-4, 1e-4)
    for pf, jf in ((PI.sphere_attributes, JI.sphere_attributes),
                   (PI.plane_attributes, JI.plane_attributes)):
        for a, b in zip(pf(p[0], p[1], p[2]), jf(j[0], j[1], j[2])):
            _close(a.numpy(), b, 1e-5, 1e-5)
