"""The port's mesh closest hit (rtf_tpu_torch/ops/mesh_hit.py) against
rtf_tpu/ops/pallas_mesh.py::mesh_closest_hit in interpret mode, on the
box scene's icosphere (mesh_subdiv=1, 320 faces in three 128-face tiles):
257 random rays aimed at the mesh region (test_trace.py's set-up) and
coherent camera rays with a finite t_init, in the ball's local space.
Faces and front equal; t within rtol/atol 1e-5; ba and bb within rtol
1e-4, atol 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401


def _scene():
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    return build_scene(box_scene(32, 24, with_mesh=True, mesh_subdiv=1))


def _rays(kind, scene):
    """World rays (o, d) [N,3] and t_init [N] as numpy float32."""
    if kind == "random":
        rng = np.random.default_rng(7)
        n = 257
        o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        o[:, 2] = rng.uniform(0, 20, n)
        d = rng.uniform(-6, 6, (n, 3)).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return o, d, np.full(n, 1e30, np.float32)
    import jax.numpy as jnp
    from rtf_tpu.render.camera import pixel_order, primary_rays
    order = jnp.asarray(pixel_order(64, 48))
    o, d = primary_rays(dataclasses.replace(scene, width=64, height=48),
                        order % 64, order // 64, jnp.zeros_like(order))
    # a finite cap in front of, inside and behind the ball
    t_init = np.random.default_rng(3).uniform(60.0, 66.0, o.shape[0])
    return np.asarray(o), np.asarray(d), t_init.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_plain_matches_pallas_interpret(kind):
    import jax.numpy as jnp
    from rtf_tpu.ops.pallas_mesh import mesh_closest_hit, pack_rays
    from rtf_tpu_torch.ops import mesh_hit as M
    from rtf_tpu_torch.utils.tracing import counter
    scene = _scene()
    o, d, t_init = _rays(kind, scene)
    itm = np.asarray(scene.mesh_inst.itm[0])
    pos = np.asarray(scene.mesh_inst.pos[0])
    lo = ((o - pos) @ itm.T).astype(np.float32)
    ld = (d @ itm.T).astype(np.float32)
    col0, fpad, ar0, nt, (mlo, mhi) = scene.mesh.slot_pack[0]
    tris = np.array(scene.mesh.tri_packed)[:, col0:col0 + fpad]
    aabb = np.array(scene.mesh.tile_aabb)[ar0:ar0 + nt]
    rays8, npad = pack_rays(jnp.asarray(lo), jnp.asarray(ld),
                            jnp.asarray(t_init))
    ref = mesh_closest_hit(rays8, jnp.asarray(tris), jnp.asarray(aabb),
                           face0=col0, mesh_lo=mlo, mesh_hi=mhi,
                           interpret=True)
    p8, pnpad = M.pack_rays(torch.as_tensor(lo), torch.as_tensor(ld),
                            torch.as_tensor(t_init))
    assert pnpad == npad
    np.testing.assert_array_equal(p8.numpy(), np.asarray(rays8))
    before = counter("launches.mesh_closest_hit")
    got = M.mesh_closest_hit(p8, torch.as_tensor(tris), torch.as_tensor(aabb),
                             face0=col0)
    # CPU tensors: the plain version
    assert counter("launches.mesh_closest_hit") == before
    t, face, front, ba, bb = (x.numpy() for x in got)
    rt, rface, rfront, rba, rbb = (np.asarray(x) for x in ref)
    hit = rface >= 0
    assert hit.sum() > 10
    np.testing.assert_array_equal(face, rface)
    np.testing.assert_array_equal(front, rfront)
    np.testing.assert_allclose(t, rt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ba, rba, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bb, rbb, rtol=1e-4, atol=1e-5)
    # a miss keeps t_init; padding rays (t_init 0) never hit
    np.testing.assert_array_equal(t[:len(t_init)][~hit[:len(t_init)]],
                                  t_init[~hit[:len(t_init)]])
    assert (face[len(t_init):] == -1).all()


def test_tie_keeps_the_lowest_face():
    """Two copies of one triangle at packed columns 5 and 130 (two tiles):
    every ray that hits them gets column 5, as the Pallas kernel's
    lane reduction keeps the lowest face id among exact t ties."""
    from rtf_tpu_torch.ops.mesh_hit import mesh_closest_hit_plain, pack_rays
    from rtf_tpu_torch.ops.pack import pack_triangles
    a = np.array([[-1.0, -1.0, 0.0]], np.float32)
    b = np.array([[1.0, -1.0, 0.0]], np.float32)
    c = np.array([[0.0, 1.0, 0.0]], np.float32)
    table, _, aabb, _ = pack_triangles(a, b, c)
    tris = np.zeros((40, 256), np.float32)
    tris[:, 5] = tris[:, 130] = table[:, 0]
    o = torch.tensor([[0.0, 0.0, 5.0], [0.1, -0.2, -3.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    rays8, _ = pack_rays(o, d, torch.full((3,), 1e30))
    t, face, front, _, _ = mesh_closest_hit_plain(
        rays8, torch.as_tensor(tris), torch.as_tensor(np.repeat(aabb, 2, 0)),
        face0=1000)
    assert face[:3].tolist() == [1005, 1005, -1]
    assert front[:3].tolist() == [1.0, 0.0, 0.0]
    np.testing.assert_allclose(t[:2].numpy(), [5.0, 3.0], rtol=1e-6)


def test_mesh_hit_refuses_other_devices():
    from rtf_tpu_torch.ops.mesh_hit import mesh_closest_hit
    x = torch.zeros((512, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mesh_closest_hit(x, x, x)
