"""The dense Plücker closest hit (ops/mesh_hit_mxu.py::
mesh_closest_hit_mxu_plain, and through mesh_closest_hit_mxu on CPU
tensors) against interpret-mode rtf_tpu.ops.pallas_mesh_mxu.
mesh_closest_hit_mxu, on the same packed matrix and rays16.

Interpret mode sums each pair as an XLA float32 dot, in the backend's
order; the port sums in one fixed order, so values round apart: t within
rtol 1e-5, ba and bb within atol 1e-4 (each s_k is a six-term sum that
cancels near an edge, with terms up to |o x d| = 4 here), front equal on
every ray that both sides hit on the same face.  Hit masks are equal;
faces are equal except on at most 0.5% of the rays, where a ray meets an
edge shared by two faces and the two roundings pick different sides of
it.  The crafted ties (a face repeated in one tile, and in two tiles)
resolve exactly: the lowest column of a tile, and the earlier tile."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401


def _icosphere(subdiv):
    from rtf_tpu.scene.procedural import icosphere_mesh
    m = icosphere_mesh(subdiv)
    v = m.v.astype(np.float32)
    return v[m.f[:, 0]], v[m.f[:, 1]], v[m.f[:, 2]]


def _rays(n, seed):
    """Origins on a sphere of radius 4, aimed at points within 1.2 of the
    centre (most hit the unit icosphere, some miss), t_init 100."""
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    tgt = rng.uniform(-1.2, 1.2, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), \
        np.full(n, 100.0, np.float32)


def run_both(a, b, c, o, d, t_init, face0=0):
    """Both packers and both closest hits; returns (ref, port), each
    (t, face, front, ba, bb) as numpy arrays over the padded rays."""
    import jax.numpy as jnp
    from rtf_tpu.ops import pallas_mesh_mxu as R
    from rtf_tpu_torch.ops import mesh_hit_mxu as M
    from rtf_tpu_torch.utils.tracing import counter
    trim = R.pack_tri_matrix(a, b, c)
    ptrim = M.pack_tri_matrix(a, b, c)
    np.testing.assert_array_equal(ptrim, trim)
    rays16, npad = R.pack_rays16(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_init))
    prays, pnpad = M.pack_rays16(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.as_tensor(t_init))
    assert pnpad == npad
    np.testing.assert_allclose(prays.numpy(), np.asarray(rays16), rtol=1e-6,
                               atol=1e-6)
    ref = R.mesh_closest_hit_mxu(rays16, jnp.asarray(trim), face0=face0,
                                 interpret=True)
    before = counter("launches.mesh_closest_hit_mxu")
    port = M.mesh_closest_hit_mxu(torch.as_tensor(np.array(rays16)),
                                  torch.as_tensor(ptrim), face0)
    # CPU tensors: the plain version
    assert counter("launches.mesh_closest_hit_mxu") == before
    return ([np.asarray(x) for x in ref], [x.numpy() for x in port])


def assert_close(ref, port, max_face_share=0.005):
    (rt, rf, rfr, rba, rbb), (pt, pf, pfr, pba, pbb) = ref, port
    np.testing.assert_array_equal(pf >= 0, rf >= 0)
    same = pf == rf
    assert (~same).mean() <= max_face_share, (~same).mean()
    np.testing.assert_allclose(pt, rt, rtol=1e-5)
    np.testing.assert_array_equal(pfr[same], rfr[same])
    np.testing.assert_allclose(pba[same], rba[same], atol=1e-4)
    np.testing.assert_allclose(pbb[same], rbb[same], atol=1e-4)


def test_seeded_rays_against_the_icosphere():
    """The subdiv-3 icosphere (1280 faces, three 512-face tiles) and 2000
    seeded rays, padded to 2048."""
    a, b, c = _icosphere(3)
    o, d, t0 = _rays(2000, 0)
    ref, port = run_both(a, b, c, o, d, t0)
    assert_close(ref, port)
    hit = port[1] >= 0
    assert 0.5 < hit[:2000].mean() < 0.99
    # the padding rays: t_init 0, no hit
    assert (port[1][2000:] == -1).all() and (port[0][2000:] == 0).all()


def test_ties_padding_degenerate_face0():
    """Face 7 of the icosphere repeated at column 300 of tile 0 (a tie in
    one tile) and at column 100 of tile 1 (a tie across tiles), a
    degenerate face (a == b), face0 = 1000: the original column wins every
    tie, the degenerate face never hits."""
    a, b, c = (x[:700].copy() for x in _icosphere(3))
    for col in (300, 512 + 100):
        a[col], b[col], c[col] = a[7], b[7], c[7]
    a[3], b[3], c[3] = (np.array([[-9, -9, 2.0]], np.float32),
                        np.array([[-9, -9, 2.0]], np.float32),
                        np.array([[9, 9, 2.0]], np.float32))
    ctr = (a[7] + b[7] + c[7]) / 3.0
    n = 300
    rng = np.random.RandomState(1)
    # from outside, along face 7's centroid direction, at points near it
    o = (3.0 * ctr[None, :] + rng.uniform(-0.05, 0.05, (n, 3))).astype(
        np.float32)
    d = ctr[None, :] + rng.uniform(-0.02, 0.02, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref, port = run_both(a, b, c, o, d, np.full(n, 100.0, np.float32),
                         face0=1000)
    assert_close(ref, port)
    on7 = port[1][:n] == 1000 + 7
    assert on7.mean() > 0.3
    # no ray keeps a copy of face 7 or the degenerate face
    for f in (1000 + 3, 1000 + 300, 1000 + 612):
        assert not (port[1] == f).any() and not (ref[1] == f).any()
