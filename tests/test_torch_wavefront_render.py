"""The port's renderer on its wavefront path, on the CPU: the thin lens
against rtf_tpu's with its jax.random draws fed in, a depth-of-field frame
on the mean, and the scenes and configurations the port refused before
the wavefront was ported, which render now.

Tolerances: rays within rtol/atol 1e-5; the DOF frames' means within 5%
(the lens draws differ: rtf_tpu's threefry keys against the port's
torch.Generator; four samples per pixel at 32x24 spread the mean by
about 2% between seeds)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)


def test_lens_rays_match_jax():
    """primary_rays and primary_rays_ch with the lens: the port fed the
    uniforms that rtf_tpu draws from split(key) (camera.py:49-56, 78-86)."""
    import jax.numpy as jnp
    from rtf_tpu.render import camera as JC
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.render import camera as PC
    js = build_scene(box_scene(32, 24, mesh_subdiv=0, dof=0.5))
    ps = port_scene_from_jax(js)
    order = np.asarray(JC.pixel_order(32, 24))
    px, py = order % 32, order // 32
    key = jax.random.PRNGKey(12)
    lens_u = torch.as_tensor(np.array(
        [np.asarray(jax.random.uniform(k, px.shape))
         for k in jax.random.split(key)]))
    tpx, tpy = torch.as_tensor(px).long(), torch.as_tensor(py).long()
    j = torch.tensor(3)
    ref = JC.primary_rays(js, jnp.asarray(px), jnp.asarray(py),
                          jnp.full(px.shape, 3), key=key, dof=True)
    got = PC.primary_rays(ps, tpx, tpy, j, lens_u=lens_u)
    ref_ch = JC.primary_rays_ch(js, jnp.asarray(px), jnp.asarray(py),
                                jnp.full(px.shape, 3), key=key, dof=True)
    got_ch = PC.primary_rays_ch(ps, tpx, tpy, j, lens_u=lens_u)
    for a, b in ((got[0], ref[0]), (got[1], ref[1]),
                 (got_ch[0], np.stack(ref_ch[0])),
                 (got_ch[1], np.stack(ref_ch[1]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    pin = PC.primary_rays(ps, tpx, tpy, j)
    assert float((got[0] - pin[0]).abs().max()) > 0.05


def test_dof_frames_match_jax_mean():
    """The box with a lens (dof 0.5) under proj5 at 4 samples per pixel:
    the wavefront ('both') against rtf_tpu's frame on the mean, and the
    fused path ('rr', the plain wave here) with the same lens."""
    from rtf_tpu.render.config import PROFILES as JPROFILES
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    js = build_scene(box_scene(32, 24, mesh_subdiv=0, dof=0.5))
    ps = port_scene_from_jax(js)
    kw = dict(min_samples=4, max_samples=4)
    ref = jrender(js, JPROFILES["proj5"].with_(**kw))
    wave_cfg = PROFILES["proj5"].with_(**kw)
    fused_cfg = wave_cfg.with_(split_mode="rr")
    assert render_path(ps, wave_cfg)[0] == "wavefront"
    assert render_path(ps, fused_cfg)[0] == "fused"
    for cfg in (wave_cfg, fused_cfg):
        got = render(ps, cfg, device="cpu")
        assert np.isfinite(got.radiance).all()
        assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 0.05
    pin = render(port_scene_from_jax(dataclasses.replace(js, dof=0.0)),
                 wave_cfg, device="cpu")
    assert np.abs(pin.radiance - got.radiance).max() > 1.0


def _three_lights(desc):
    from rtf_tpu_torch.scene.model import LightDesc
    desc.lights += [LightDesc(kind="point", intensity=np.full(3, 50.0),
                              position=np.array([5.0, -5.0, 20.0])),
                    LightDesc(kind="direct", intensity=np.full(3, 0.5),
                              direction=np.array([0.0, 0.3, -1.0]))]
    return desc


def test_rr_split_on_the_wavefront_matches_jax_mean():
    """Three lights send the 'rr' split to the wavefront (rtf_tpu's fused
    gate refuses more than 2): render_wave's lane-aligned branch with its
    Russian-roulette draws, 8 spp, 2 bounces, against rtf_tpu on the mean
    within 3% (the draws differ; hit masks and z agree exactly)."""
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.model import LightDesc as JLight
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    kw = dict(min_samples=8, max_samples=8, bounces=2, shadow_min=1,
              shadow_max=1)
    jdesc = jbox(32, 24, mesh_subdiv=1)
    jdesc.lights += [JLight(kind="point", intensity=np.full(3, 50.0),
                            position=np.array([5.0, -5.0, 20.0])),
                     JLight(kind="direct", intensity=np.full(3, 0.5),
                            direction=np.array([0.0, 0.3, -1.0]))]
    ref = jrender(jbuild(jdesc), JConfig(**kw))
    scene = build_scene(_three_lights(box_scene(32, 24, mesh_subdiv=1)),
                        device="cpu")
    cfg = RenderConfig(**kw)
    assert cfg.resolved_split_mode() == "rr"
    assert render_path(scene, cfg)[0] == "wavefront"
    got = render(scene, cfg, device="cpu")
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    assert abs(got.radiance.mean() / ref.radiance.mean() - 1.0) < 0.03


@pytest.mark.parametrize("case", ["both_split", "dof", "lights", "materials",
                                  "emission_texture", "gi_dof",
                                  "faces_both", "faces_rr_lights"])
def test_formerly_refused_scenes_render(case):
    """The cases test_torch_common.py::test_unsupported_scenes_raise and
    test_torch_gi_render.py::test_gi_refusals_raise refused before the
    wavefront was ported: each takes the wavefront (the fused path for a
    lens on 'rr', with GI too) and gives a finite, lit frame."""
    from rtf_tpu_torch.core.transform import Transform
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.model import (
        TexMapDesc, TextureDesc, TexturedColorDesc)
    from rtf_tpu_torch.scene.procedural import _mtl, _node, box_scene
    desc = box_scene(16, 12, mesh_subdiv=0)
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=2,
                       shadow_min=1, shadow_max=1)
    path = "wavefront"
    if case == "emission_texture":
        # the wavefront samples emission as its plain colour, as rtf_tpu
        m = desc.materials["wall"]
        tex = TextureDesc(kind="file", data=np.zeros((2, 2, 3), np.float32))
        m.emission = TexturedColorDesc(np.full(3, 0.1), TexMapDesc(tex))
    elif case == "both_split":
        cfg = cfg.with_(split_mode="both")
    elif case in ("dof", "gi_dof"):
        desc, path = box_scene(16, 12, mesh_subdiv=0, dof=0.5), "fused"
        if case == "gi_dof":
            cfg = cfg.with_(gi_mode="hemisphere", hemisphere_samples=2)
    elif case == "lights":
        desc = _three_lights(desc)
    elif case == "faces_both":     # the wavefront takes any mesh size
        desc = box_scene(16, 12, mesh_subdiv=3)              # 1280 faces
        cfg = cfg.with_(split_mode="both")
    elif case == "faces_rr_lights":
        # on 'rr' too, where a fused gate other than the mesh size fires
        desc = _three_lights(box_scene(16, 12, mesh_subdiv=3))
    else:                          # 6 box materials + 12 more
        for k in range(12):
            desc.materials[f"m{k}"] = _mtl(f"m{k}", (0.5, 0.5, 0.5))
            desc.root.children.append(_node(
                f"s{k}", "sphere", f"m{k}",
                Transform().translate([-11 + 2 * k, 14, 2])))
    scene = build_scene(desc, device="cpu")
    assert render_path(scene, cfg)[0] == path
    res = render(scene, cfg, device="cpu")
    assert np.isfinite(res.radiance).all() and res.image.mean() > 5.0


@pytest.mark.parametrize("case", ["tex_filter", "tex_filter_wavefront",
                                  "bvh"])
def test_formerly_refused_filter_scenes_render(case):
    """The cases test_torch_common.py::test_unsupported_scenes_raise
    refused before footprint filtering and the BVH walk were ported:
    tex_filter on the 'rr' split (the fused gate refuses it, so the
    wavefront takes it, as in rtf_tpu) and on the 'both' split, on the
    textured box, and mesh_algo="bvh" on the box: each takes the
    wavefront and gives a finite, lit frame."""
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    from test_torch_common import textured_desc
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=0,
                       shadow_min=1, shadow_max=1)
    if case == "bvh":
        scene = dataclasses.replace(
            build_scene(box_scene(8, 6, mesh_subdiv=0), device="cpu"),
            mesh_algo="bvh")
        cfg = cfg.with_(split_mode="both")
    else:
        scene = build_scene(textured_desc(8, 6, mesh_subdiv=0),
                            device="cpu")
        cfg = cfg.with_(tex_filter=True)
        if case == "tex_filter_wavefront":
            cfg = cfg.with_(split_mode="both")
        else:
            assert cfg.resolved_split_mode() == "rr"
    assert render_path(scene, cfg)[0] == "wavefront"
    res = render(scene, cfg, device="cpu")
    assert np.isfinite(res.radiance).all() and res.image.mean() > 5.0
