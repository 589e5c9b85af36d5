"""The wide BVH walk's tables and plain twin (rtf_tpu_torch/ops/bvh_hit.py:
collapse, face_rows, intersect_face_rows, bvh_wide_closest_hit_plain, the
depth rule of build_walk), on the CPU.  The card's kernel equals the twin
bit for bit (tests/test_torch_kernel.py::test_bvh_kernel_matches_plain).

Tolerances: the collapse and the face rows are exact (boxes, leaves and
counts equal; t, ba, bb and the masks of intersect_triangle bit for bit).
The twin against the lock-step walk `bvh_closest_hit_plain`: hit masks
and t equal bit for bit; face, front, ba and bb equal but on near-tie rays
(two faces that each hit within 4 ulp of the ray's t, which the two walks
test in another order), each checked to be one; at most 1 in 10^5 of the
rays on the scattered and centroid sets, any number on the rays aimed at
shared edges.  Against rtf_tpu's jitted bvh_traverse: hit masks equal,
the same tie rule with t within atol 1e-6 (tests/test_torch_bvh_hit.py's:
XLA's fused loops may contract a multiply-add), but on the rays aimed at
shared edges, where a ray may slip between the two faces in one rounding
and hit the far side, or take the other face: there t and the face may
differ where either side's hit has a barycentric below 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_bvh_hit import _jax_walk, local_rays  # noqa: E402
from test_torch_common import (  # noqa: E402,F401
    dense_rays, mxu_walk_desc, one_torch_thread, port_scene_from_jax)


def _mesh(desc):
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    return ensure_bvh(build_scene(desc, device="cpu").mesh)


def _ball(subdiv):
    from rtf_tpu_torch.scene.procedural import box_scene
    return _mesh(box_scene(16, 12, mesh_subdiv=subdiv))


def _reach(child, i):
    """The binary leaves under node i."""
    if child[i] < 0:
        return [i]
    return _reach(child, child[i]) + _reach(child, child[i] + 1)


@pytest.mark.parametrize("case", ["ball2", "ball5", "twin", "tie"])
def test_collapse_keeps_leaves_and_boxes(case):
    """Every slot's wide tree reaches the binary tree's leaves, each once,
    with their faces (first element) and tested counts (min(count,
    max_leaf)); every stored child box is its binary node's bit for bit;
    each wide node holds 2-4 children that partition its binary node's
    leaves (a leaf root: one); the stack need bounds every path; each
    slot's nodes follow its root depth first."""
    from rtf_tpu_torch.ops import bvh_hit as B
    mesh = (_ball(int(case[-1])) if case.startswith("ball")
            else _mesh(mxu_walk_desc(case, subdiv=2)))
    child, eoff, ecnt = (getattr(mesh, k).numpy() for k in
                         ("bvh_child", "bvh_eoff", "bvh_ecnt"))
    bmin, bmax = mesh.bvh_min.numpy(), mesh.bvh_max.numpy()
    roots = [int(r) for r in mesh.slot_root]
    assert len(roots) == (2 if case == "twin" else 1)
    wn, root_of, stack, kids = B.collapse(
        child, bmin, bmax, eoff, ecnt, mesh.max_leaf, roots)
    wn = wn.reshape(-1, 8, B.WIDTH)
    words = wn[:, 6].view(np.int32)
    nk = wn[:, 7, 0].view(np.int32)
    assert set(root_of) == set(roots) and (nk >= 1).all()
    for w in range(len(wn)):
        k = kids[w, :nk[w]]
        assert (kids[w, nk[w]:] == -1).all() and (words[w, nk[w]:] == -1).all()
        assert np.array_equal(wn[w, 0:3, :nk[w]].T.view(np.int32),
                              bmin[k].view(np.int32))
        assert np.array_equal(wn[w, 3:6, :nk[w]].T.view(np.int32),
                              bmax[k].view(np.int32))
    for r in roots:
        seen, order = [], []

        def visit(w, binary):
            order.append(w)
            k = list(kids[w, :nk[w]])
            # the children partition the binary node's leaves
            assert sorted(sum((_reach(child, i) for i in k), [])) \
                == sorted(_reach(child, binary))
            assert 2 <= len(k) <= B.WIDTH or (len(k) == 1 and child[k[0]] < 0
                                              and binary == r)
            sub = 0
            for i, word in zip(k, words[w, :nk[w]]):
                if child[i] >= 0:
                    assert word >= 0 and kids[word, 0] >= 0
                    sub = max(sub, visit(word, i))
                else:
                    pay = -(int(word) + 2)
                    assert pay >> 8 == eoff[i]
                    assert pay & 255 == min(ecnt[i], mesh.max_leaf)
                    seen.append(i)
            return max(len(k), len(k) - 1 + sub)
        need = visit(root_of[r], r)
        assert sorted(seen) == sorted(_reach(child, r))
        assert need <= stack
        # the slot's nodes: from its root on, depth first
        assert order == list(range(root_of[r], root_of[r] + len(order)))
    levels = max(B.tree_levels(child, r) for r in roots)
    assert stack <= 3 * (levels - 1) + 1
    if case == "ball5":
        assert levels >= 12 and stack < 32 < B.LOCAL_STACK


def _corners(n, seed):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(n, 3))
    b = a + rng.normal(size=(n, 3))
    c = a + rng.normal(size=(n, 3))
    c[::9] = b[::9]                          # zero area
    c[1::9] = a[1::9] + 2.0 * (b[1::9] - a[1::9])   # collinear
    b[2::9, 2] = a[2::9, 2]                  # axis-aligned faces
    c[2::9, 2] = a[2::9, 2]
    return [torch.as_tensor(x.astype(np.float32)) for x in (a, b, c)]


def test_face_rows_match_intersect_triangle():
    """intersect_face_rows on face_rows against intersect_triangle on the
    corners: rays at random faces (zero-area, collinear and axis-aligned
    ones among them), at their centroids and edges and scattered, seeded
    t_prev caps: valid, front, ba and bb equal bit for bit, t where
    valid."""
    from rtf_tpu.core.math import BIGFLOAT
    from rtf_tpu_torch.ops.bvh_hit import face_rows, intersect_face_rows
    from rtf_tpu_torch.ops.intersect import intersect_triangle
    n = 6000
    a, b, c = _corners(n, 1)
    rows = face_rows(a, b, c, torch.arange(n, dtype=torch.int32))
    assert rows.shape == (n, 16)
    assert torch.equal(rows[:, 3].view(torch.int32), torch.arange(n,
                       dtype=torch.int32))
    rng = np.random.RandomState(2)
    w = rng.dirichlet([1, 1, 1], n)
    w[::4] = [1 / 3, 1 / 3, 1 / 3]
    w[1::4, 0] = 0.0                         # on an edge
    w[1::4, 1:] /= w[1::4, 1:].sum(1, keepdims=True)
    p = sum(torch.as_tensor(w[:, k:k + 1].astype(np.float32)) * x
            for k, x in enumerate((a, b, c)))
    o = p + torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)) * 3
    d = p - o
    d[3::4] = torch.as_tensor(rng.normal(size=(n // 4, 3)).astype(np.float32))
    t_prev = torch.as_tensor(np.where(rng.uniform(size=n) < 0.3,
                                      rng.uniform(0.5, 3.0, n), 1e30)
                             .astype(np.float32))
    got = intersect_face_rows(o, d, rows, t_prev)
    ref = intersect_triangle(o, d, a, b, c, t_prev)
    valid = ref[4]
    assert 0.2 < float(valid.float().mean()) < 0.9
    assert torch.equal(got[4], valid)
    assert torch.equal(torch.where(got[4], got[0], BIGFLOAT), ref[0])
    for g, r in zip(got[1:4], ref[1:4]):
        assert torch.equal(g, r)


def _near_ties(mesh, o, d, t, face, face_ref):
    """Rays whose faces differ: each must hit both faces within 4 ulp of
    its t (intersect_triangle alone, no cap).  Returns their count."""
    from rtf_tpu_torch.ops.intersect import intersect_triangle
    idx = torch.nonzero(face != face_ref)[:, 0]
    for i in idx.tolist():
        tt = []
        for f in (int(face[i]), int(face_ref[i])):
            assert f >= 0, (i, f)
            got = intersect_triangle(o[i], d[i], mesh.tri_a[f],
                                     mesh.tri_b[f], mesh.tri_c[f],
                                     torch.tensor(1e30))
            assert bool(got[4]), (i, f)
            tt.append(float(got[0]))
        ulp = float(np.spacing(np.float32(abs(float(t[i])))))
        assert abs(tt[0] - float(t[i])) <= 4 * ulp, (i, tt, float(t[i]))
        assert abs(tt[1] - float(t[i])) <= 4 * ulp, (i, tt, float(t[i]))
    return idx.numel()


def _rays(mesh, kind, n):
    """Local rays of the first slot: test_torch_bvh_hit.local_rays'
    "scattered" and "centroid"; "edge": one ray per face at the midpoint
    of one of its edges (test_torch_common.dense_rays); "surface": origins
    on the faces (seeded barycentrics, a fifth on an edge) with seeded
    directions, half into the ball."""
    if kind in ("scattered", "centroid"):
        return local_rays(mesh, kind, seed=4, n=n)
    f0, f1 = mesh.slot_faces[0]
    a, b, c = (getattr(mesh, k)[f0:f1].numpy() for k in
               ("tri_a", "tri_b", "tri_c"))
    rng = np.random.RandomState(9)
    if kind == "edge":
        o, d = dense_rays("edge", a, b, c, seed=5)
    else:
        f = rng.randint(0, len(a), n)
        w = rng.dirichlet([1, 1, 1], n)
        w[::5, 0] = 0.0
        w[::5, 1:] /= w[::5, 1:].sum(1, keepdims=True)
        o = (w[:, :1] * a[f] + w[:, 1:2] * b[f] + w[:, 2:] * c[f])
        d = rng.normal(size=(n, 3))
        d[::2] = -o[::2] + 0.3 * d[::2]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_init = np.full(len(o), 1e30, np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_init


@pytest.mark.parametrize("subdiv,kind", [
    (2, "scattered"), (2, "centroid"), (2, "edge"), (2, "surface"),
    (4, "scattered"), (4, "edge")])
def test_wide_walk_matches_lockstep_and_jax(subdiv, kind):
    """The wide twin against bvh_closest_hit_plain and rtf_tpu's
    bvh_traverse on the same tree (rtf_tpu's, carried across) on the 320-
    and 5,120-face balls, the tie rule above; its counters against the
    lock-step walk's: fewer pops, the same leaves at most."""
    from rtf_tpu.scene.build import build_scene as jbuild
    from rtf_tpu.scene.procedural import box_scene as jbox
    from rtf_tpu_torch.ops import bvh_hit as B
    js = jbuild(jbox(16, 12, mesh_subdiv=subdiv))
    mesh = port_scene_from_jax(js).mesh
    walk = B.build_walk(mesh)
    assert walk.walk == "wide"
    root = int(mesh.slot_root[0])
    o, d, t_init = _rays(mesh, kind, 4096)
    o_, d_, t_ = (torch.as_tensor(x) for x in (o, d, t_init))
    sw, sp = (torch.zeros(B.NSTAT, dtype=torch.int64) for _ in range(2))
    wide = B.bvh_wide_closest_hit_plain(walk, root, o_, d_, t_, stats=sw)
    lock = B.bvh_closest_hit_plain(mesh, root, o_, d_, t_, stats=sp)
    hit = lock[1] >= 0
    assert 0.05 < float(hit.float().mean())
    assert torch.equal(wide[1] >= 0, hit)
    assert torch.equal(wide[0], lock[0])
    ties = _near_ties(mesh, o_, d_, wide[0], wide[1], lock[1])
    same = wide[1] == lock[1]
    for k, p in zip(wide[2:], lock[2:]):
        assert torch.equal(k[same], p[same])
    if kind in ("scattered", "centroid"):
        assert ties <= max(1, len(o) // 100000), ties
    # pops, inner, leaves, faces, most pops, box tests
    assert sw[0] < sp[0] and sw[4] < sp[4] and sw[5] < sp[5]
    assert sw[2] <= sp[2] and sw[3] <= sp[3]
    jt, jface, _, jba, jbb = (np.array(x) for x in
                              _jax_walk(js.mesh, o, d, t_init))
    np.testing.assert_array_equal(wide[1].numpy() >= 0, jface >= 0)
    off = np.abs(wide[0].numpy() - jt) > 1e-6
    if kind == "edge":
        # a ray at a shared edge may slip between its two faces in one of
        # the two roundings and hit the far side: each such ray has a
        # barycentric below 1e-5 on one side
        def edge(ba_, bb_):
            return np.minimum(np.minimum(ba_, bb_), 1.0 - ba_ - bb_) < 1e-5
        slip = edge(wide[3].numpy(), wide[4].numpy()) | edge(jba, jbb)
        differ = off | (wide[1].numpy() != jface)
        assert not (differ & ~slip).any(), np.nonzero(differ & ~slip)[0][:8]
    else:
        assert not off.any(), np.nonzero(off)[0][:8]
        _near_ties(mesh, o_, d_, wide[0], wide[1], torch.as_tensor(jface))


@pytest.mark.parametrize("max_depth", [None, "levels+1", "levels+2"])
def test_depth_rule(max_depth):
    """bvh_walk takes the binary walk where the binary tree has more than
    max_depth - 2 levels (bvh_traverse's clamp can then drop a node), the
    wide walk otherwise; the choice is kept on the arena.  On a capped
    tree the clamp does drop nodes: the lock-step walk misses hits that
    the uncapped walk finds."""
    from rtf_tpu_torch.ops import bvh_hit as B
    mesh = _ball(2)
    levels = B.tree_levels(mesh.bvh_child.numpy(), int(mesh.slot_root[0]))
    assert levels == 8
    if max_depth is not None:
        mesh.max_depth = levels + int(max_depth[-1])
    walk = B.bvh_walk(mesh)
    assert B.bvh_walk(mesh) is walk and walk.levels == levels
    assert walk.walk == ("binary" if max_depth == "levels+1" else "wide")
    if walk.walk == "binary":
        assert walk.nodes.shape == (mesh.bvh_min.shape[0], 8)
        assert walk.wnodes is None
        capped = dataclasses.replace(mesh, max_depth=4, bvh_walk=None)
        assert B.bvh_walk(capped).walk == "binary"
        o, d, t_init = (torch.as_tensor(x) for x in
                        local_rays(mesh, "centroid", n=1024))
        root = int(mesh.slot_root[0])
        full = B.bvh_closest_hit_plain(mesh, root, o, d, t_init)
        cut = B.bvh_closest_hit_plain(capped, root, o, d, t_init)
        assert int(((cut[1] >= 0) < (full[1] >= 0)).sum()) > 0
    else:
        assert walk.nodes is None and walk.stack <= B.LOCAL_STACK
        assert walk.face_rows.shape == (mesh.bvh_elems.shape[0], B.ROW)
