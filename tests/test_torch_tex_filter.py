"""Ray-differential texture filtering on the wavefront (cfg.tex_filter)
against rtf_tpu: halton_np, ops/trace.py::footprint_duv,
ops/texture.py::sample_texmap_filtered and a whole frame.

Inputs: the textured box (tests/test_torch_common.py::textured_desc: file
textures on the walls' and the ball's kd, a checker on the mirror's ks) at
32x24, its camera rays (sample 1) traced by rtf_tpu (mesh_algo="dense");
the port gets the same hits and surfaces.  Tolerances: halton_np equal;
the footprints within atol 1e-6 on planes, spheres and the mesh; the
filtered samples within atol 2e-4 (32 bilinear taps each, summed in one
order by both); the frame by the wavefront tests' rule (radiance within
atol 2e-4 on all but 0.5% of pixels, hit masks and sample counts equal, z
within rtol 1e-4)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax, textured_desc)


def test_halton_np_matches_jax():
    from rtf_tpu.core.halton import halton_np as jh
    from rtf_tpu_torch.core.halton import halton_np as ph
    idx = np.arange(2000)
    for base in (2, 3, 5):
        a, b = ph(idx, base), jh(idx, base)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert float(ph(17, base)) == float(jh(17, base))


def _traced():
    """rtf_tpu's textured box, its camera rays, hits and surfaces, and the
    port's scene carried across with the same hits and surfaces."""
    import jax.numpy as jnp
    from rtf_tpu.ops import trace as JT
    from rtf_tpu.render.camera import pixel_order, primary_rays
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.ops import trace as PT
    js = dataclasses.replace(build_scene(textured_desc(32, 24, port=False)),
                             mesh_algo="dense")
    order = jnp.asarray(pixel_order(32, 24))
    o, d = primary_rays(js, order % 32, order // 32, jnp.ones_like(order))
    hit = JT.trace(js, o, d)
    surf = JT.resolve_surface(js, o, d, hit)

    def t(x):
        return torch.as_tensor(np.array(x))
    phit = PT.Hit(**{f.name: t(getattr(hit, f.name))
                     for f in dataclasses.fields(PT.Hit)})
    psurf = PT.Surface(**{f.name: t(getattr(surf, f.name))
                          for f in dataclasses.fields(PT.Surface)})
    return js, port_scene_from_jax(js), (o, d, hit, surf), \
        (t(o), t(d), phit, psurf)


def test_footprint_matches_jax():
    from rtf_tpu.ops.trace import KIND_MESH, KIND_PLANE, KIND_SPHERE
    from rtf_tpu.ops.trace import footprint_duv as jfoot
    from rtf_tpu_torch.ops.trace import footprint_duv
    js, ps, jargs, pargs = _traced()
    pix = 2.0 * math.tan(math.radians(js.fov) * 0.5) / js.height
    ref = [np.asarray(x) for x in jfoot(js, *jargs, pix, pix)]
    got = [x.numpy() for x in footprint_duv(ps, *pargs, pix, pix)]
    kind = np.asarray(jargs[2].kind)
    for k in (KIND_PLANE, KIND_SPHERE, KIND_MESH):
        m = kind == k
        assert m.sum() > 10, k
        for a, b in zip(got, ref):
            assert np.abs(b[m]).max() > 1e-3
            np.testing.assert_allclose(a[m], b[m], atol=1e-6, rtol=0)


def test_filtered_sample_matches_jax():
    """sample_texmap_filtered on the hits' own texture maps (the walls'
    and the ball's kd maps, the mirror's ks map), 32 taps."""
    import jax.numpy as jnp
    from rtf_tpu.ops.texture import sample_texmap_filtered as jfilt
    from rtf_tpu.ops.trace import footprint_duv as jfoot
    from rtf_tpu_torch.ops.texture import sample_texmap_filtered
    from rtf_tpu_torch.render.scene_tables import scene_tables
    js, ps, (o, d, hit, surf), _ = _traced()
    pix = 2.0 * math.tan(math.radians(js.fov) * 0.5) / js.height
    duv0, duv1 = jfoot(js, o, d, hit, surf, pix, pix)
    mt = js.materials
    tm = jnp.where(surf.valid, jnp.maximum(
        mt.diffuse_tm[surf.mtl], mt.specular_tm[surf.mtl]), -1)
    assert len(set(np.asarray(tm).tolist())) >= 4    # three maps and none
    ref = np.asarray(jfilt(js, tm, surf.uvw, duv0, duv1))
    got = sample_texmap_filtered(
        scene_tables(ps), torch.as_tensor(np.array(tm)).long(),
        *(torch.as_tensor(np.array(x)) for x in (surf.uvw, duv0, duv1)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)
    unfiltered = np.asarray(jfilt(js, tm, surf.uvw, 0 * duv0, 0 * duv1))
    assert np.abs(ref - unfiltered).max() > 0.05


def test_tex_filter_frame_matches_jax_per_pixel():
    """The textured box at 32x24 with tex_filter on both sides (the port's
    mesh test the plain mesh_closest_hit, rtf_tpu's the Pallas kernel in
    interpret mode), the 'both' split, hard shadows, 1 bounce: no random
    draws; the filter changes the textured pixels."""
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    kw = dict(min_samples=1, max_samples=1, bounces=1, shadow_min=1,
              shadow_max=1, split_mode="both", tex_filter=True)
    js = dataclasses.replace(jbuild(textured_desc(32, 24, port=False)),
                             mesh_algo="pallas_interpret")
    ref = jrender(js, JConfig(**kw))
    scene = build_scene(textured_desc(32, 24), device="cpu")
    cfg = RenderConfig(**kw)
    assert render_path(scene, cfg)[0] == "wavefront"
    got = render(scene, cfg, device="cpu")
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - ref.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, err.max()
    plain = render(scene, cfg.with_(tex_filter=False), device="cpu")
    assert np.abs(plain.radiance - got.radiance).max() > 0.05


def test_row_wise_samplers_match_jax():
    """sample_texture and sample_texmap ([N,3] uvw in, colours out) against
    rtf_tpu's on the textured box's textures and maps (and no map), at
    seeded uvw that tile: within atol 1e-5."""
    import jax.numpy as jnp
    from rtf_tpu.ops import texture as JX
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.ops import texture as PX
    from rtf_tpu_torch.render.scene_tables import scene_tables
    js = build_scene(textured_desc(32, 24, port=False))
    tables = scene_tables(port_scene_from_jax(js))
    rng = np.random.RandomState(9)
    n = 4096
    uvw = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    ntex, nmap = js.textures.kind.shape[0], js.texmaps.tex.shape[0]
    tex = rng.randint(0, ntex, n).astype(np.int32)
    tm = rng.randint(-1, nmap, n).astype(np.int32)
    got = PX.sample_texture(tables, torch.as_tensor(tex).long(),
                            torch.as_tensor(uvw))
    ref = JX.sample_texture(js, jnp.asarray(tex), jnp.asarray(uvw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    got = PX.sample_texmap(tables, torch.as_tensor(tm).long(),
                           torch.as_tensor(uvw))
    ref = JX.sample_texmap(js, jnp.asarray(tm), jnp.asarray(uvw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (got.numpy()[tm < 0] == 1.0).all() and got.numpy().std() > 0.1
