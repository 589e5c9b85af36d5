"""The BVH walk (rtf_tpu_torch/ops/bvh_hit.py::bvh_closest_hit_plain, the
plain version of csrc/bvh_hit.cu) against rtf_tpu's lock-step
bvh_traverse, jitted on the CPU, on rtf_tpu's own tree carried across and
on the port's; against the port's mesh_closest_hit; and a whole frame with
mesh_algo="bvh" against rtf_tpu's per pixel.

Tolerances: hit masks, faces and front flags equal; t within atol 1e-6,
ba and bb within atol 2e-6 (the two round the same operations, but XLA's
fused loops may contract a multiply-add: one ray of 2048 differs in bb by
1.1e-6 on the scattered set).  Against mesh_closest_hit (another triangle
test: the packed table's projected barycentrics) hit masks equal and t
within rtol 1e-4.  The frame: the wavefront tests' rule, radiance within
atol 2e-4 on all but at most 0.5% of pixels, hit masks and sample counts
equal, z within rtol 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    dense_rays, one_torch_thread, port_scene_from_jax)


def local_rays(mesh, kind, seed=0, n=2048):
    """Rays (o, d) [N, 3] float32 numpy in the first slot's local space:
    "scattered" (test_torch_common.dense_rays) or "centroid", one ray per
    face from about 3 outside its centroid straight at it; and t_init [N]:
    1e30, but a seeded third of the rays get a t_init in [1, 6) that cuts
    some hits off."""
    f0, f1 = mesh.slot_faces[0]
    a, b, c = (np.asarray(getattr(mesh, k))[f0:f1]
               for k in ("tri_a", "tri_b", "tri_c"))
    rng = np.random.RandomState(seed + 1)
    if kind == "scattered":
        o, d = dense_rays("scattered", a, b, c, seed=seed, n=n)
    else:
        p = (a.astype(np.float64) + b + c) / 3.0
        out = p - p.mean(0)
        out /= np.linalg.norm(out, axis=1, keepdims=True)
        o = p + 3.0 * out + rng.normal(0.0, 0.3, p.shape)
        d = p - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
    t_init = np.where(rng.uniform(size=len(o)) < 1 / 3,
                      rng.uniform(1.0, 6.0, len(o)), 1e30).astype(np.float32)
    return o, d, t_init


def _jax_walk(jmesh, o, d, t_init):
    import jax.numpy as jnp
    from rtf_tpu.ops.trace import bvh_traverse
    n = len(o)
    root = jmesh.slot_root[0]
    out = jax.jit(bvh_traverse)(
        jmesh, root, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_init),
        jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool),
        jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("tree", ["jax", "port"])
@pytest.mark.parametrize("kind", ["scattered", "centroid"])
def test_walk_matches_jax(tree, kind):
    """The 320-face ball (subdiv 2): rtf_tpu's tree carried across by
    scene_from_arrays, or the port's own from ensure_bvh."""
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.ops.bvh_hit import bvh_closest_hit
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.procedural import box_scene
    js = jbuild(jbox(16, 12, mesh_subdiv=2))
    if tree == "jax":
        mesh = port_scene_from_jax(js).mesh
        assert mesh.bvh_min is not None          # carried, not built
    else:
        mesh = build_scene(box_scene(16, 12, mesh_subdiv=2),
                           device="cpu").mesh
        ensure_bvh(mesh)
    o, d, t_init = local_rays(js.mesh, kind)
    t, face, front, ba, bb = bvh_closest_hit(
        mesh, int(mesh.slot_root[0]), torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t_init))
    jt, jface, jfront, jba, jbb = _jax_walk(js.mesh, o, d, t_init)
    hit = jface >= 0
    assert 0.1 < hit.mean() < 0.99, hit.mean()
    np.testing.assert_array_equal(face.numpy(), jface)
    np.testing.assert_array_equal(front.numpy()[hit] > 0.5, jfront[hit])
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ba.numpy(), jba, atol=2e-6, rtol=0)
    np.testing.assert_allclose(bb.numpy(), jbb, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(t.numpy()[~hit], t_init[~hit])


def test_walk_matches_mesh_closest_hit():
    """The walk against the port's plain mesh_closest_hit_rays on the
    same rays (1280-face ball): the same rays hit, t within rtol 1e-4; the
    counters add up (every face test inside an entered leaf)."""
    from rtf_tpu_torch.ops import bvh_hit, mesh_hit
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.procedural import box_scene
    mesh = build_scene(box_scene(16, 12, mesh_subdiv=3), device="cpu").mesh
    ensure_bvh(mesh)
    o, d, t_init = (torch.as_tensor(x) for x in local_rays(
        mesh, "scattered", seed=3, n=4096))
    stats = torch.zeros(bvh_hit.NSTAT, dtype=torch.int64)
    t, face, _, _, _ = bvh_hit.bvh_closest_hit(
        mesh, int(mesh.slot_root[0]), o, d, t_init, stats=stats)
    col0, fpad, ar0, nt, _ = mesh.slot_pack[0]
    mt, mface, _, _, _ = mesh_hit.mesh_closest_hit_rays(
        o, d, t_init, mesh.tri_packed[:, col0:col0 + fpad],
        mesh.tile_aabb[ar0:ar0 + nt], face0=col0)
    hit = face >= 0
    assert torch.equal(hit, mface >= 0) and 0.1 < float(hit.float().mean())
    np.testing.assert_allclose(t[hit].numpy(), mt[hit].numpy(), rtol=1e-4)
    nodes, inner, leaves, faces, most, boxes = stats.tolist()
    assert leaves <= faces <= 8 * leaves and most <= nodes
    # a ray pops its root, then two nodes for every inner node it enters;
    # a pop tests one box, an inner node its two children's
    assert nodes == o.shape[0] + 2 * inner
    assert boxes == nodes + 2 * inner


def test_bvh_frame_matches_jax_per_pixel(monkeypatch):
    """The box at 32x24 (320-face ball) with mesh_algo="bvh" on both sides,
    the 'both' split, hard shadows, 2 bounces: no random draws.  The port's
    frame walks the BVH in every trace (the plain walk, counted)."""
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.ops import bvh_hit
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    kw = dict(min_samples=1, max_samples=1, bounces=2, shadow_min=1,
              shadow_max=1, split_mode="both")
    js = dataclasses.replace(jbuild(jbox(32, 24, mesh_subdiv=2)),
                             mesh_algo="bvh")
    ref = jrender(js, JConfig(**kw))
    scene = dataclasses.replace(
        build_scene(box_scene(32, 24, mesh_subdiv=2), device="cpu"),
        mesh_algo="bvh")
    cfg = RenderConfig(**kw)
    assert render_path(scene, cfg)[0] == "wavefront"
    calls = []
    plain = bvh_hit.bvh_closest_hit_plain
    monkeypatch.setattr(bvh_hit, "bvh_closest_hit_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = render(scene, cfg, device="cpu")
    assert len(calls) == 2 * (1 + cfg.bounces)
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - ref.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, err.max()
    assert got.radiance.mean() > 0.05


def test_box_tests_match_jax():
    """intersect_box and intersect_box_enter against rtf_tpu's on seeded
    rays and boxes, with axis-parallel directions (the 1e-30 guard) and
    origins inside boxes: hits equal, tenter within rtol 1e-6."""
    import jax.numpy as jnp
    from rtf_tpu.ops import intersect as JI
    from rtf_tpu_torch.ops import intersect as PI
    rng = np.random.RandomState(5)
    n = 4096
    lo = rng.uniform(-2.0, 1.0, (n, 3))
    hi = lo + rng.uniform(0.0, 2.0, (n, 3))
    o = rng.uniform(-4.0, 4.0, (n, 3))
    o[:512] = lo[:512] + 0.5 * (hi[:512] - lo[:512])          # inside
    d = rng.normal(size=(n, 3))
    d[512:1024, rng.randint(0, 3)] = 0.0                      # 1e-30 guard
    d[1024:1536, 1] = -0.0
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30,
                     rng.uniform(0.0, 4.0, n))
    args = [x.astype(np.float32) for x in (o, d, lo, hi, t_max)]
    got = PI.intersect_box_enter(*map(torch.as_tensor, args))
    ref = JI.intersect_box_enter(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    h = np.asarray(ref[0])
    assert 0.1 < h.mean() < 0.9
    np.testing.assert_allclose(got[1].numpy()[h], np.asarray(ref[1])[h],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        PI.intersect_box(*map(torch.as_tensor, args)).numpy(),
        np.asarray(JI.intersect_box(*map(jnp.asarray, args))))
