"""The port's BVH builders (rtf_tpu_torch/ops/bvh.py: the C++ builder of
its host library and the NumPy builder, use_native=True and False) and the
arena's BVH (scene/build.py::ensure_bvh) against rtf_tpu's: every array
equal, on icospheres and on a seeded triangle soup, against rtf_tpu's
NumPy builder and its native one."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401


def soup(seed, n=600):
    """n triangles [n, 3, 3] float32 scattered in a box, from a seed."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5.0, 5.0, (n, 1, 3))
    return (c + rng.normal(0.0, 0.4, (n, 3, 3))).astype(np.float32)


def _corners(case):
    from rtf_tpu_torch.scene.procedural import icosphere_mesh
    if case.startswith("ico"):
        m = icosphere_mesh(int(case[3:]))
        return m.v[m.f], 8
    return soup(int(case[4:])), int(case[4:])


@pytest.mark.parametrize("port_native", [False, True])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("case", ["ico1", "ico3", "soup4", "soup8"])
def test_builder_matches_jax(case, native, port_native):
    """build_bvh over the faces' boxes (max_elems 8 on the icospheres, 4 and
    8 on the soup), the port's C++ or NumPy builder: the six arrays equal
    rtf_tpu's native or NumPy builder's, values and types."""
    from rtf_tpu.ops import bvh as J
    from rtf_tpu_torch.ops import bvh as P
    tri, max_elems = _corners(case)
    bmin, bmax = tri.min(1), tri.max(1)
    centers = (0.5 * (bmin + bmax)).astype(np.float64)
    got = P.build_bvh(centers, bmin, bmax, max_elems, use_native=port_native)
    ref = J.build_bvh(centers, bmin, bmax, max_elems, use_native=native)
    assert len(got.bmin) > 20
    for name, a, b in zip(got._fields, got, ref):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nf = len(tri)
    mesh = P.build_mesh_bvh(tri.reshape(-1, 3),
                            np.arange(3 * nf).reshape(nf, 3), max_elems,
                            use_native=port_native)
    for a, b in zip(mesh, got):
        np.testing.assert_array_equal(a, b)


def _two_mesh_desc(port):
    """The box with its 320-face ball, plus an 80-face ball in a second
    slot: two BVHs in one arena."""
    if port:
        from rtf_tpu_torch.core.transform import Transform
        from rtf_tpu_torch.scene.procedural import (
            _node, box_scene, icosphere_mesh)
    else:
        from rtf_tpu.core.transform import Transform
        from rtf_tpu.scene.procedural import _node, box_scene, icosphere_mesh
    desc = box_scene(16, 12, mesh_subdiv=2)
    desc.root.children.append(_node(
        "ball2", "mesh", "redball", Transform().scale(2).translate([5, 8, 3]),
        mesh=icosphere_mesh(1)))
    return desc


@pytest.mark.parametrize("port_native", [False, True])
@pytest.mark.parametrize("case", ["one slot", "two slots"])
def test_arena_bvh_matches_jax(case, port_native):
    """ensure_bvh on the port's scene, with the port's C++ or NumPy builder,
    gives rtf_tpu's GpuScene.mesh.bvh_* and slot_root (its native builder)
    for the same description; a second call keeps them."""
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.procedural import box_scene
    if case == "one slot":
        pdesc, jdesc = box_scene(16, 12, mesh_subdiv=3), jbox(
            16, 12, mesh_subdiv=3)
    else:
        pdesc, jdesc = _two_mesh_desc(True), _two_mesh_desc(False)
    mesh = build_scene(pdesc, device="cpu").mesh
    assert mesh.bvh_min is None               # nothing built up front
    ensure_bvh(mesh, use_native=port_native)
    ref = jbuild(jdesc).mesh
    assert mesh.max_leaf == ref.max_leaf and mesh.max_depth == ref.max_depth
    for name in ("bvh_min", "bvh_max", "bvh_child", "bvh_eoff", "bvh_ecnt",
                 "bvh_elems", "slot_root"):
        got, want = getattr(mesh, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(mesh.slot_root) == (1 if case == "one slot" else 2)
    first = mesh.bvh_min
    ensure_bvh(mesh)
    assert mesh.bvh_min is first
