"""The port's scene build, scene hand-over and camera against the JAX
package (rtf_tpu.scene.build, rtf_tpu.render.camera)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_common import (  # noqa: E402
    checker_desc, jax_scene_arrays, textured_desc)


def scene_leaves(scene):
    """The port's scene as {tree path: tensor} (tensor fields only)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                x = getattr(v, g.name)
                if isinstance(x, torch.Tensor):
                    out[f"{f.name}.{g.name}"] = x
    return out


def _descs(name):
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.scene.procedural import box_scene as pbox
    if name == "box":
        return (jbox(32, 24, mesh_subdiv=1), pbox(32, 24, mesh_subdiv=1))
    if name == "textured":
        return (textured_desc(port=False, background=True),
                textured_desc(port=True, background=True))
    return checker_desc(port=False), checker_desc(port=True)


@pytest.mark.parametrize("name", ["box", "checker", "textured"])
def test_build_scene_matches_jax(name):
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.convert import scene_from_arrays
    jdesc, pdesc = _descs(name)
    arrays, statics = jax_scene_arrays(jbuild(jdesc))
    ref = scene_from_arrays(arrays, statics, device="cpu")
    port = build_scene(pdesc, device="cpu")
    if port.mesh is not None:
        # the BVH arena is built at the first "bvh" trace; rtf_tpu's comes
        # across with the rest
        ensure_bvh(port.mesh)
    ref_leaves, port_leaves = scene_leaves(ref), scene_leaves(port)
    assert ref_leaves.keys() == port_leaves.keys()
    assert len(port_leaves) > 40
    for key, a in port_leaves.items():
        b = ref_leaves[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=key)
    for key in ("width", "height", "fov", "focaldist", "dof", "bg_tm",
                "env_tm", "num_spheres", "num_planes", "num_mesh_inst",
                "num_lights", "light_kinds", "mesh_inst_slots",
                "has_file_tex"):
        assert getattr(port, key) == getattr(ref, key), key
    np.testing.assert_allclose(port.world_min, ref.world_min, atol=1e-6)
    np.testing.assert_allclose(port.world_max, ref.world_max, atol=1e-6)
    if name != "checker":
        assert port.mesh.slot_faces == ref.mesh.slot_faces
        assert port.mesh.slot_pack == ref.mesh.slot_pack
    if name != "box":
        assert int(port.materials.diffuse_tm.max()) >= 1
    if name == "textured":
        # atlas rows: A (512), B (256), C (512); the checker keeps 1x1
        assert port.has_file_tex and port.env_tm >= 0 and port.bg_tm >= 0
        assert tuple(port.textures.atlas.shape) == (1280, 512, 3)
        assert sorted(port.textures.row0.tolist()) == [0, 0, 512, 768]


def test_camera_matches_jax():
    import jax.numpy as jnp
    from rtf_tpu.render import camera as jcam
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.render import camera as pcam
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene as pbox
    w, h = 48, 32
    jscene = jbuild(jbox(w, h, mesh_subdiv=1))
    pscene = build_scene(pbox(w, h, mesh_subdiv=1), device="cpu")
    order = jcam.pixel_order(w, h)
    np.testing.assert_array_equal(pcam.pixel_order(w, h), order)
    np.testing.assert_array_equal(pcam.pixel_order_inv(w, h),
                                  jcam.pixel_order_inv(w, h))
    # a ragged size too: edge tiles fold into their tile row
    np.testing.assert_array_equal(pcam.pixel_order(50, 37),
                                  jcam.pixel_order(50, 37))
    px, py = order % w, order // w
    for j in (0, 5, 63):
        jo, jd = jcam.primary_rays_ch(
            jscene, jnp.asarray(px), jnp.asarray(py),
            jnp.full((w * h,), j, jnp.int32))
        po, pd = pcam.primary_rays_ch(
            pscene, torch.as_tensor(px), torch.as_tensor(py),
            torch.tensor(j))
        for c in range(3):
            np.testing.assert_allclose(po[c].numpy(), np.asarray(jo[c]),
                                       atol=1e-6)
            np.testing.assert_allclose(pd[c].numpy(), np.asarray(jd[c]),
                                       atol=1e-6)
