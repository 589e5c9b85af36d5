"""The box hierarchy over packed faces (ops/mxu_pack.py::packed_hierarchy
and walk_tables) that the wave kernel's immediates variants
(render/scene_tables.py's tables) and mesh_closest_hit (the scene's
ops/mesh_hit.py::MeshTree) walk through csrc/box_walk.cuh: leaves, tiles
and groups cover every face of a slot exactly once, every box is padded,
and the conservativeness that the walks' exactness rests on: the plain
winner (least t, then least packed row) lies inside its leaf, tile, group
and root boxes with a slab entry below its t, on the rays of a small
frame, on seeded random rays, on one ray per face and on one ray per face
vertex.  Cases: the box scene, a ball whose faces are listed twice (ties
across tiles), one ball instanced twice, a ball with degenerate faces
(dropped from the immediates tables, empty-area faces of the slot's
MeshTree), and "ball": the box scene's ball at the largest size each table
takes (the immediates' 320 faces; the MeshTree's 20,480 in 20 groups,
whose face and vertex rays are a seeded 2048 of each).  The packed tables
are byte for byte those of the table code frozen at 224dbd1.  Port only
(no JAX); 32x24, icosphere balls of subdivision 1-5 (80-20,480 faces; the
immediates tables take at most 512)."""
import numpy as np
import pytest
import torch

from test_torch_common import (  # noqa: F401
    face_rays, mxu_walk_desc, one_torch_thread, vertex_rays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = ["box", "tie", "two", "degenerate", "ball"]
# per table, the ball's subdivision of each case
SUBDIV = {"imm": {"box": 2, "tie": 1, "two": 1, "degenerate": 2, "ball": 2},
          "hit": {"box": 3, "tie": 3, "two": 1, "degenerate": 2, "ball": 5}}
RAYS_PER_KIND = 2048     # face and vertex rays kept on the largest balls


def _scene(table, case):
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    sub = SUBDIV[table][case]
    desc = box_scene(32, 24, mesh_subdiv=sub) if case in ("box", "ball") \
        else mxu_walk_desc(case, 32, 24, sub)
    return build_scene(desc, device="cpu")


def _tree(table, case):
    """(scene, levels, face rows [F, >= 12], per instance (root row, first
    tile, tile count), per slot its faces' rows in the table): the
    immediates wave tables or the scene's MeshTree."""
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = _scene(table, case)
    mesh = scene.mesh
    if table == "imm":
        tab = scene_tables(scene)
        assert not tab.mxu
        lv = dict(roots=tab.roots, groups=tab.groups, tnodes=tab.tnodes,
                  leaves=tab.leaves)
        insts = [(tab.roots[i], int(r[22]), int(r[23]))
                 for i, r in enumerate(tab.mesh_insts.tolist())]
        return scene, lv, tab.faces, insts
    ht = mesh.hit_tree
    lv = dict(roots=ht.roots, groups=ht.groups, tnodes=ht.tnodes,
              leaves=ht.leaves)
    insts = [(ht.roots[s], mesh.slot_pack[s][2], mesh.slot_pack[s][3])
             for s in scene.mesh_inst_slots]
    return scene, lv, ht.faces, insts


def _slot_faces(table, scene, slot):
    """The slot's faces as (rows 0-11 [f, 12], vertex boxes lo, hi [f, 3])
    in packed order: its packed columns, on the immediates without the
    degenerate ones."""
    col0, _, _, _, _ = scene.mesh.slot_pack[slot]
    f0, f1 = scene.mesh.slot_faces[slot]
    cols = scene.mesh.tri_packed[:, col0:col0 + f1 - f0].numpy()
    if table == "imm":
        cols = cols[:, ~((cols[0] == 0) & (cols[1] == 0) & (cols[2] == 0))]
    return cols[0:12].T, cols[32:35].T, cols[35:38].T


def _unpack(v, n):
    v = int(v)
    return [(v >> (3 * k)) & 7 for k in range(n)]


@pytest.mark.parametrize("table", ["imm", "hit"])
@pytest.mark.parametrize("case", CASES)
def test_tree_covers_every_face_once(table, case):
    """Per slot: its groups cover its tiles once, its tiles' face ranges
    and their leaves' cover its faces once, in packed order, 128 rows a
    tile; the face rows are the slot's (on the immediates the degenerate
    columns dropped, zero rows after); every visit order is a
    permutation; the key base is the tile's own index; the root rows
    name the slot's groups."""
    scene, lv, faces, insts = _tree(table, case)
    groups, tn, leaves = (lv[k].numpy() for k in ("groups", "tnodes",
                                                  "leaves"))
    faces = faces.numpy()
    assert leaves.shape[0] == 8 * tn.shape[0] and faces.shape[0] \
        == 128 * tn.shape[0]
    np.testing.assert_array_equal(
        tn[:, 8:16], np.repeat(np.arange(tn.shape[0])[:, None], 8, 1))
    seen_slots = {}
    for (root, t0, nt), slot in zip(insts, scene.mesh_inst_slots):
        g0, ng = (int(x) for x in root[6:8])
        seen_slots.setdefault(slot, (t0, nt, g0, ng))
        assert seen_slots[slot] == (t0, nt, g0, ng)
        assert ng == (nt + 7) // 8
        tiles = np.concatenate([np.arange(groups[g, 6], groups[g, 6]
                                          + groups[g, 7])
                                for g in range(g0, g0 + ng)])
        np.testing.assert_array_equal(tiles, np.arange(t0, t0 + nt))
        for o in range(8):
            assert sorted(groups[g0:g0 + ng, 8 + o]) \
                == list(range(g0, g0 + ng))
            for g in range(g0, g0 + ng):
                nj = int(groups[g, 7])
                assert sorted(_unpack(groups[g, 16 + o], nj)) \
                    == list(range(nj))
        rows = []
        for j in range(t0, t0 + nt):
            assert tn[j, 6] == 128 * j
            lrows = np.concatenate([np.arange(leaves[8 * j + q, 6],
                                              leaves[8 * j + q, 6]
                                              + leaves[8 * j + q, 7])
                                    for q in range(8)])
            np.testing.assert_array_equal(
                lrows, np.arange(tn[j, 6], tn[j, 6] + tn[j, 7]))
            for o in range(8):
                assert sorted(_unpack(tn[j, 16 + o], 8)) == list(range(8))
            rows.append(lrows)
        rows = np.concatenate(rows).astype(np.int64)
        f12, _, _ = _slot_faces(table, scene, slot)
        np.testing.assert_array_equal(faces[rows, 0:12], f12)
        np.testing.assert_array_equal(rows, 128 * t0 + np.arange(len(rows)))
        pad = np.setdiff1d(np.arange(128 * t0, 128 * (t0 + nt)), rows)
        assert not faces[pad, 0:12].any()
    if case == "degenerate":
        f0, f1 = scene.mesh.slot_faces[0]
        kept = len(_slot_faces("imm", scene, 0)[0])
        assert kept < f1 - f0
        assert int(tn[:, 7].sum()) == (kept if table == "imm" else f1 - f0)


@pytest.mark.parametrize("table", ["imm", "hit"])
@pytest.mark.parametrize("case", CASES)
def test_tree_boxes_padded(table, case):
    """Every non-empty box strictly contains the vertex boxes of its
    faces, by at most twice the pad; empty leaves stay empty."""
    from rtf_tpu_torch.ops.mxu_pack import TILE_PAD
    scene, lv, _, insts = _tree(table, case)
    groups, tn, leaves = (lv[k].numpy() for k in ("groups", "tnodes",
                                                  "leaves"))

    def padded(box, lo, hi):
        assert (box[0:3] < lo).all() and (box[3:6] > hi).all()
        pad = 2 * TILE_PAD * (1 + np.abs(box[0:6]).max())
        assert (lo - box[0:3] <= pad).all() and (box[3:6] - hi <= pad).all()

    for (root, t0, nt), slot in zip(insts, scene.mesh_inst_slots):
        _, flo, fhi = _slot_faces(table, scene, slot)

        def span(r0, n):
            k = r0 - 128 * t0
            return flo[k:k + n].min(0), fhi[k:k + n].max(0)
        padded(root.numpy(), flo.min(0), fhi.max(0))
        for row in leaves[8 * t0:8 * (t0 + nt)]:
            if row[7] == 0:
                assert (row[0:3] > row[3:6]).all()
                continue
            padded(row, *span(int(row[6]), int(row[7])))
        for row in tn[t0:t0 + nt]:
            padded(row, *span(int(row[6]), int(row[7])))
        g0, ng = (int(x) for x in root[6:8])
        for row in groups[g0:g0 + ng]:
            j0, nj = int(row[6]), int(row[7])
            padded(row, *span(int(tn[j0, 6]),
                              int(tn[j0 + nj - 1, 6] + tn[j0 + nj - 1, 7])
                              - int(tn[j0, 6])))


def _rays(scene, seed=0, n_random=2000):
    """[3, N] world rays: the 32x24 frame's primary rays, seeded random
    rays from inside the box towards the balls, one ray per face, one ray
    per face vertex."""
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays_ch
    order = torch.as_tensor(pixel_order(32, 24)).to(torch.int64)
    o_f, d_f = primary_rays_ch(scene, order % 32, order // 32,
                               torch.tensor(0))
    rng = np.random.RandomState(seed)
    o_r = rng.uniform([-14, -20, 1], [14, 18, 23], (n_random, 3))
    aim = np.where(rng.rand(n_random, 1) < 0.5, [1.0, 4.0, 3.0],
                   [-6.0, 8.0, 14.0]) + rng.normal(0, 2.0, (n_random, 3))
    d_r = aim - o_r
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o_p, d_p = face_rays(scene, "cpu")
    o_v, d_v = vertex_rays(scene, "cpu", seed)
    if o_p.shape[1] > 4 * RAYS_PER_KIND:     # the 20,480-face ball
        keep = [torch.as_tensor(rng.permutation(x.shape[1])[:RAYS_PER_KIND])
                for x in (o_p, o_v)]
        o_p, d_p = o_p[:, keep[0]], d_p[:, keep[0]]
        o_v, d_v = o_v[:, keep[1]], d_v[:, keep[1]]
    o = torch.cat([o_f, torch.as_tensor(o_r.T, dtype=torch.float32), o_p,
                   o_v], 1)
    d = torch.cat([d_f, torch.as_tensor(d_r.T, dtype=torch.float32), d_p,
                   d_v], 1)
    return o, d


def _winners(faces, lo3, ld3, t0, nt):
    """Per ray the plain winner among the tiles [t0, t0 + nt) of the face
    rows: (t, row), least t then least row; (inf, -1) on a miss."""
    from rtf_tpu_torch.ops.mesh_hit import _tri_test
    rows = torch.arange(128 * t0, 128 * (t0 + nt))
    col = [faces[rows, c][None, :] for c in range(12)]
    n = lo3[0].shape[0]
    bt = torch.full((n,), float("inf"))
    bf = torch.full((n,), -1, dtype=torch.int64)
    for s in range(0, n, 512):
        sl = slice(s, s + 512)
        t, *_, valid = _tri_test(col, tuple(v[sl][:, None] for v in lo3),
                                 tuple(v[sl][:, None] for v in ld3))
        t = torch.where(valid, t, torch.inf)
        tmin, idx = t.min(1)          # the first (least) row at the least t
        bt[sl] = tmin
        bf[sl] = torch.where(tmin < torch.inf, rows[idx], -1)
    return bt, bf


@pytest.mark.parametrize("table", ["imm", "hit"])
@pytest.mark.parametrize("case", CASES)
def test_winner_inside_its_boxes(table, case):
    """The plain winner's face lies inside its leaf, tile, group and root
    boxes with a slab entry strictly below its t, so the walk's culls
    capped by the best t never drop it, a tied face included; its t is
    the plain versions' (render/wave.py::_mesh_closest on the immediates,
    ops/mesh_hit.py::mesh_closest_hit_plain on the MeshTree's slot)."""
    from rtf_tpu_torch.ops.mesh_hit import mesh_closest_hit_plain, pack_rays
    from rtf_tpu_torch.render import wave as W
    scene, lv, faces, insts = _tree(table, case)
    o, d = _rays(scene)
    o3, d3 = tuple(o), tuple(d)
    n = o.shape[1]
    best = torch.full((n,), W.BIG)
    mesh_inst = scene.mesh_inst
    ties_across_tiles = 0
    for k, ((root, t0, nt), slot) in enumerate(zip(insts,
                                                   scene.mesh_inst_slots)):
        itm, pos = mesh_inst.itm[k], mesh_inst.pos[k]
        row = itm.reshape(9).tolist() + pos.tolist()
        lo3, ld3 = W._to_local(row, o3, d3)
        ild3 = W._inv_dir(ld3)
        t, f = _winners(faces, lo3, ld3, t0, nt)
        hit = f >= 0
        assert int(hit.sum()) > 100
        j = f[hit] // 128
        leaf = j * 8 + (f[hit] % 128) // 16
        g = torch.searchsorted(lv["groups"][:, 6].contiguous(),
                               j.float(), right=True) - 1
        sub = tuple(v[hit] for v in lo3), tuple(v[hit] for v in ild3)
        for name, tab, idx in (("leaf", lv["leaves"], leaf),
                               ("tile", lv["tnodes"], j),
                               ("group", lv["groups"], g),
                               ("root", root[None].expand(len(j), 8), None)):
            box = tab if idx is None else tab[idx]
            inside = W._slab([box[:, a] for a in range(3)],
                             [box[:, 3 + a] for a in range(3)], *sub, t[hit])
            assert bool(inside.all()), \
                f"{case}: {int((~inside).sum())} winners outside their {name}"
        if table == "hit":
            # the kernel's plain version on the slot's columns
            col0, fpad, ar0, nts, _ = scene.mesh.slot_pack[slot]
            rays8, _ = pack_rays(torch.stack(lo3, 1), torch.stack(ld3, 1),
                                 torch.full((n,), 1e30))
            tp, fp, *_ = mesh_closest_hit_plain(
                rays8, scene.mesh.tri_packed[:, col0:col0 + fpad],
                scene.mesh.tile_aabb[ar0:ar0 + nts], col0)
            assert torch.equal(fp[:n].long(), f)
            assert torch.equal(torch.where(hit, tp[:n], torch.inf), t)
        best = torch.minimum(best, torch.where(hit, t, W.BIG))
        if case == "tie":
            # each copy's twin (the rows pair up after the first, far
            # face) at the winner's t, a few in the next tile
            fk = f[hit] + torch.where(f[hit] % 2 == 0, -1, 1)
            tw, *_, valid = _tri_test_rows(faces, fk, lo3, ld3, hit)
            tied = valid & (tw == t[hit])
            assert float(tied.float().mean()) > 0.95
            ties_across_tiles += int((tied & (fk // 128
                                              != f[hit] // 128)).sum())
    if case == "tie":
        assert ties_across_tiles >= 1
    if table == "imm":
        from rtf_tpu_torch.render.scene_tables import scene_tables
        h = W._Host(scene_tables(scene))
        st = [torch.full((n,), W.BIG)] + [torch.zeros(n) for _ in range(7)]
        W._mesh_closest(h, o3, d3, st, False)
        assert torch.equal(st[0], best)


def _tri_test_rows(faces, rows, lo3, ld3, hit):
    from rtf_tpu_torch.ops.mesh_hit import _tri_test
    F = faces[rows]
    return _tri_test([F[:, c] for c in range(12)],
                     tuple(v[hit] for v in lo3), tuple(v[hit] for v in ld3))


@pytest.mark.parametrize("table", ["imm", "hit"])
@pytest.mark.parametrize("case", CASES)
def test_packed_tables_unchanged(table, case):
    """The packed tables against the table code frozen at 224dbd1
    (rtbench/reference/frozen/ops/mxu_pack.py) on the same faces: groups,
    tiles, leaves and root rows equal byte for byte, on slots of at most 8
    groups and on the MeshTree's ball of 20."""
    from rtbench.reference.frozen.ops import mxu_pack as old
    from rtf_tpu_torch.ops import mxu_pack as new
    scene = _scene(table, case)
    boxes = []
    for slot in range(len(scene.mesh.slot_faces)):
        _, lo, hi = _slot_faces(table, scene, slot)
        boxes.append((lo, hi))
    got = new.walk_tables(new.packed_hierarchy(boxes))
    want = old.walk_tables(old.packed_hierarchy(boxes))
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert sorted(got[3]) == sorted(want[3])
    for slot, row in got[3].items():
        assert row.tobytes() == want[3][slot].tobytes()
