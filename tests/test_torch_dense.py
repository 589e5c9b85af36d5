"""The dense tiled mesh test (rtf_tpu_torch/ops/trace.py::_dense_mesh,
mesh_algo="dense") against rtf_tpu's _dense_mesh, jitted on the CPU, at
face counts below, at and above one tile of 512; in ray chunks; against
mesh_closest_hit; and a whole frame against rtf_tpu's per pixel.

Tolerances: faces, hit masks and front flags equal; t within atol 1e-6,
ba and bb within atol 1e-5 (the same operations, but XLA's fused loops
may contract a multiply-add: a unit in the last place of the hit point
becomes up to 6.4e-6 of a barycentric over the 1280-face ball's 0.1-wide
faces).  A chunked call equals the unchunked one exactly.
Against mesh_closest_hit (the packed table's test) hit masks equal and t
within rtol 1e-4.  The frame: the wavefront tests' rule (radiance within
atol 2e-4 on all but 0.5% of pixels, hit masks and sample counts equal, z
within rtol 1e-4)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    dense_rays, icosphere_faces, one_torch_thread)


def _arena():
    """The 1280-face icosphere's corners as an arena (well-conditioned
    faces: on a seeded soup's slivers the two round apart by up to 8e-6
    relative in t)."""
    return dict(zip(("tri_a", "tri_b", "tri_c"), icosphere_faces(3)))


def _inputs(arena, f0, f1, seed=0, n=2048):
    """Per ray a seeded face of the range and a point inside it, the ray
    from a seeded origin 3 away on the face's front side straight at that
    point; t_init 1e30 but
    for a seeded third in [1, 4); face_init -1, front_init True, ba, bb
    0."""
    rng = np.random.RandomState(seed + 7)
    f = rng.randint(f0, f1, n)
    w = rng.dirichlet(np.ones(3), n)
    p = sum(w[:, k:k + 1] * arena[key][f].astype(np.float64)
            for k, key in enumerate(("tri_a", "tri_b", "tri_c")))
    # from the face's front side, within about 45 degrees of its normal:
    # grazing rays turn a unit in the last place of N.d into 1e-4 of t
    a, b, c = (arena[k][f].astype(np.float64) for k in ("tri_a", "tri_b",
                                                        "tri_c"))
    nrm = np.cross(b - a, c - a)
    u = nrm / np.linalg.norm(nrm, axis=1, keepdims=True) \
        + 0.5 * rng.normal(size=(n, 3)) / np.sqrt(3.0)
    o = p + 3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t = np.where(rng.uniform(size=n) < 1 / 3, rng.uniform(1.0, 4.0, n),
                 1e30).astype(np.float32)
    return (o, d, t, np.full(n, -1, np.int32), np.ones(n, bool),
            np.zeros(n, np.float32), np.zeros(n, np.float32))


def _port(arena, inputs, face_range, chunk=None):
    from rtf_tpu_torch.ops.trace import _dense_mesh
    mesh = SimpleNamespace(**{k: torch.as_tensor(v)
                              for k, v in arena.items()})
    out = _dense_mesh(mesh, *(torch.as_tensor(x) for x in inputs),
                      face_range, chunk=chunk)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("face_range", [(0, 300), (100, 612), (0, 1100)],
                         ids=["below", "at", "above"])
def test_dense_matches_jax(face_range):
    import jax.numpy as jnp
    from rtf_tpu.ops.trace import _dense_mesh as jdense
    arena = _arena()
    inputs = _inputs(arena, *face_range)
    got = _port(arena, inputs, face_range)
    jmesh = SimpleNamespace(**{k: jnp.asarray(v) for k, v in arena.items()})
    ref = [np.asarray(x) for x in jax.jit(
        lambda *a: jdense(jmesh, *a, face_range))(
            *(jnp.asarray(x) for x in inputs))]
    t, face, front, ba, bb = got
    hit = ref[1] >= 0
    assert 0.5 < hit.mean() < 0.95, hit.mean()
    np.testing.assert_array_equal(face, ref[1])
    np.testing.assert_array_equal(front, ref[2])
    np.testing.assert_allclose(t, ref[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ba, ref[3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(bb, ref[4], atol=1e-5, rtol=0)
    assert (face[hit] >= face_range[0]).all() \
        and (face[hit] < face_range[1]).all()
    for x, y in zip(_port(arena, inputs, face_range, chunk=7), got):
        np.testing.assert_array_equal(x, y)


def test_dense_matches_mesh_closest_hit():
    """_dense_mesh against the port's plain mesh_closest_hit_rays on the
    1280-face ball's local rays: the same rays hit, t within rtol 1e-4."""
    from rtf_tpu_torch.ops import mesh_hit
    from rtf_tpu_torch.ops.trace import _dense_mesh
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    mesh = build_scene(box_scene(16, 12, mesh_subdiv=3), device="cpu").mesh
    f0, f1 = mesh.slot_faces[0]
    o, d = (torch.as_tensor(x) for x in dense_rays(
        "scattered", *(getattr(mesh, k)[f0:f1].numpy()
                       for k in ("tri_a", "tri_b", "tri_c")), seed=4))
    n = o.shape[0]
    t_init = torch.full((n,), 1e30)
    t, face, _, _, _ = _dense_mesh(
        mesh, o, d, t_init, torch.full((n,), -1, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), torch.zeros(n), torch.zeros(n),
        (f0, f1))
    col0, fpad, ar0, nt, _ = mesh.slot_pack[0]
    mt, mface, _, _, _ = mesh_hit.mesh_closest_hit_rays(
        o, d, t_init, mesh.tri_packed[:, col0:col0 + fpad],
        mesh.tile_aabb[ar0:ar0 + nt], face0=col0)
    hit = face >= 0
    assert torch.equal(hit, mface >= 0) and 0.05 < float(hit.float().mean())
    np.testing.assert_allclose(t[hit].numpy(), mt[hit].numpy(), rtol=1e-4)


def test_dense_frame_matches_jax_per_pixel():
    """The box at 32x24 (320-face ball) with mesh_algo="dense" on both
    sides, the 'both' split, hard shadows, 2 bounces: no random draws."""
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    kw = dict(min_samples=1, max_samples=1, bounces=2, shadow_min=1,
              shadow_max=1, split_mode="both")
    js = dataclasses.replace(jbuild(jbox(32, 24, mesh_subdiv=2)),
                             mesh_algo="dense")
    ref = jrender(js, JConfig(**kw))
    scene = dataclasses.replace(
        build_scene(box_scene(32, 24, mesh_subdiv=2), device="cpu"),
        mesh_algo="dense")
    got = render(scene, RenderConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.sample_count, ref.sample_count)
    hit = ref.z < 1e29
    np.testing.assert_array_equal(got.z < 1e29, hit)
    np.testing.assert_allclose(got.z[hit], ref.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - ref.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, err.max()
    assert got.radiance.mean() > 0.05
