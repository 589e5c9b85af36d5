"""The box hierarchy on the MXU tables (ops/mxu_pack.py, render/
scene_tables.py) that the wave kernel's MXU walk reads (csrc/
wave_kernel.cu): leaves, tiles and groups cover every face exactly once,
the orders and ranks are permutations of what they order, every box is
padded, and the conservativeness that the walk's exactness rests on: the
winner that the plain version picks (least t, then least key = rank * 128
+ column) lies inside its leaf, tile, group and root boxes with a slab
entry below its t, on the rays of a small frame, on seeded random rays,
on one ray per face and on one ray per face vertex (a hit on a box's face,
where only the padding keeps the entry below t).  The walk's tables are
byte for byte those of the table code frozen at 224dbd1, and the pair and
shade rows are the face rows' columns.  Port only (no JAX); 32x24,
1280-face balls and the 20,480-face ball ("ball": 20 groups; its face and
vertex rays a seeded 2048 of each)."""
import numpy as np
import pytest
import torch

from test_torch_common import (  # noqa: F401
    face_rays, mxu_walk_desc, one_torch_thread, vertex_rays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = ["box", "tie", "twin", "two", "ball"]
RAYS_PER_KIND = 2048     # face and vertex rays kept on the "ball"


def _scene(case):
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    desc = box_scene(32, 24, mesh_subdiv={"box": 3, "ball": 5}[case]) \
        if case in ("box", "ball") else mxu_walk_desc(case)
    return build_scene(desc, device="cpu")


def _unpack(v, n):
    """A packed order (three bits a step) as a list of n children."""
    v = int(v)
    return [(v >> (3 * k)) & 7 for k in range(n)]


def _tables(case):
    from rtf_tpu_torch.ops.mxu_pack import mesh_mxu_pack
    from rtf_tpu_torch.render.scene_tables import scene_tables
    scene = _scene(case)
    tab = scene_tables(scene)
    assert tab.mxu
    return scene, tab, mesh_mxu_pack(scene.mesh)


def _sorted_boxes(scene, slot):
    """Per face of the slot, in the tables' Morton order, its vertex box
    (lo [f, 3], hi [f, 3])."""
    from rtf_tpu_torch.ops.pack import _morton3
    f0, f1 = scene.mesh.slot_faces[slot]
    a, b, c = (getattr(scene.mesh, k)[f0:f1].numpy().astype(np.float32)
               for k in ("tri_a", "tri_b", "tri_c"))
    order = np.argsort(_morton3((a + b + c) / 3.0), kind="stable")
    a, b, c = a[order], b[order], c[order]
    return np.minimum(np.minimum(a, b), c), np.maximum(np.maximum(a, b), c)


@pytest.mark.parametrize("case", CASES)
def test_tree_covers_every_face_once(case):
    from rtf_tpu_torch.ops.mxu_pack import MXU_TILE, TILE_LEAVES
    scene, tab, pack = _tables(case)
    tiles, groups = pack["tiles"], tab.groups.numpy()
    tn, lv, roots = tab.tnodes.numpy(), tab.leaves.numpy(), tab.roots.numpy()
    assert groups.shape[1] == tn.shape[1] == 24 and lv.shape[1] == 8
    assert lv.shape[0] == TILE_LEAVES * tiles.shape[0] == 8 * tn.shape[0]
    np.testing.assert_array_equal(tn[:, 6:8], tiles[:, 14:16])
    for slot, (row0, nt, _, _) in pack["slots"].items():
        g0, ng = pack["slot_groups"][slot]
        assert ng == (nt + 7) // 8
        seen = np.concatenate([np.arange(groups[g, 6], groups[g, 6]
                                         + groups[g, 7])
                               for g in range(g0, g0 + ng)])
        np.testing.assert_array_equal(seen, np.arange(row0, row0 + nt))
        for o in range(8):
            assert sorted(groups[g0:g0 + ng, 8 + o]) \
                == list(range(g0, g0 + ng))
            for g in range(g0, g0 + ng):
                nj = int(groups[g, 7])
                assert sorted(_unpack(groups[g, 16 + o], nj)) \
                    == list(range(nj))
            # the ranks invert the tiles' visit orders
            order = tiles[row0:row0 + nt, 6 + o].astype(np.int64)
            np.testing.assert_array_equal(tn[order, 8 + o],
                                          row0 + np.arange(nt))
        faces = 0
        for j in range(row0, row0 + nt):
            f0, nf = int(tiles[j, 14]), int(tiles[j, 15])
            rows = np.concatenate([np.arange(lv[TILE_LEAVES * j + q, 6],
                                             lv[TILE_LEAVES * j + q, 6]
                                             + lv[TILE_LEAVES * j + q, 7])
                                   for q in range(TILE_LEAVES)])
            np.testing.assert_array_equal(rows, np.arange(f0, f0 + nf))
            assert f0 == j * MXU_TILE
            counts = lv[TILE_LEAVES * j:TILE_LEAVES * (j + 1), 7]
            nl = int((counts > 0).sum())
            for o in range(8):
                perm = _unpack(tn[j, 16 + o], TILE_LEAVES)
                assert sorted(perm) == list(range(TILE_LEAVES))
                assert (counts[perm[:nl]] > 0).all()
            faces += nf
        f0, f1 = scene.mesh.slot_faces[slot]
        assert faces == f1 - f0
    for i, slot in enumerate(scene.mesh_inst_slots):
        assert tuple(roots[i, 6:8]) == pack["slot_groups"][slot]


@pytest.mark.parametrize("case", CASES)
def test_tree_boxes_padded(case):
    """Every non-empty box strictly contains the vertices of its faces,
    by at most twice the pad; empty leaves stay empty."""
    from rtf_tpu_torch.ops.mxu_pack import MXU_TILE
    from rtf_tpu_torch.render.scene_tables import TILE_PAD
    scene, tab, pack = _tables(case)
    groups, tn, lv = tab.groups.numpy(), tab.tnodes.numpy(), tab.leaves.numpy()

    def padded(box, lo, hi):
        assert (box[0:3] < lo).all() and (box[3:6] > hi).all()
        pad = 2 * TILE_PAD * (1 + np.abs(box[0:6]).max())
        assert (lo - box[0:3] <= pad).all() and (box[3:6] - hi <= pad).all()

    for slot, (row0, nt, _, _) in pack["slots"].items():
        flo, fhi = _sorted_boxes(scene, slot)

        def span(r0, n):     # the vertex box of face rows [r0, r0 + n)
            k = r0 - row0 * MXU_TILE
            return flo[k:k + n].min(0), fhi[k:k + n].max(0)
        for row in lv[8 * row0:8 * (row0 + nt)]:
            if row[7] == 0:
                assert (row[0:3] > row[3:6]).all()
                continue
            padded(row, *span(int(row[6]), int(row[7])))
        for row in tn[row0:row0 + nt]:
            padded(row, *span(int(row[6]), int(row[7])))
        g0, ng = pack["slot_groups"][slot]
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
    if o_p.shape[1] > 4 * RAYS_PER_KIND:     # the ball: a seeded subset
        keep = [torch.as_tensor(rng.permutation(x.shape[1])[:RAYS_PER_KIND])
                for x in (o_p, o_v)]
        o_p, d_p = o_p[:, keep[0]], d_p[:, keep[0]]
        o_v, d_v = o_v[:, keep[1]], d_v[:, keep[1]]
    o = torch.cat([o_f, torch.as_tensor(o_r.T, dtype=torch.float32), o_p,
                   o_v], 1)
    d = torch.cat([d_f, torch.as_tensor(d_r.T, dtype=torch.float32), d_p,
                   d_v], 1)
    return o, d


def _winners(tab, k, lo3, ld3, row0, nt):
    """Per ray the plain winner among instance k's faces: (t, face row),
    least t then least key = rank * 128 + column; (inf, -1) on a miss."""
    from rtf_tpu_torch.ops.mxu_pack import MXU_TILE, cross_od, plucker_pair
    rows = torch.arange(row0 * MXU_TILE, (row0 + nt) * MXU_TILE)
    col = [tab.faces[rows, c][None, :] for c in range(22)]
    c3 = cross_od(lo3, ld3)
    n = lo3[0].shape[0]
    bt = torch.full((n,), float("inf"))
    bf = torch.full((n,), -1, dtype=torch.int64)
    for s in range(0, n, 256):
        sl = slice(s, s + 256)
        t, valid, *_ = plucker_pair(col, *(tuple(v[sl][:, None] for v in x)
                                           for x in (ld3, c3, lo3)))
        t = torch.where(valid, t, torch.inf)
        tmin = t.amin(1)
        octant = ((ld3[0][sl] >= 0).long() * 4 + (ld3[1][sl] >= 0).long() * 2
                  + (ld3[2][sl] >= 0).long())
        rank = tab.tnodes[rows // MXU_TILE][:, 8:16].long()      # [F, 8]
        key = rank[:, octant].T * MXU_TILE + rows % MXU_TILE     # [n, F]
        key = torch.where((t == tmin[:, None]) & (t < torch.inf), key,
                          torch.iinfo(torch.int64).max)
        kmin = key.amin(1)
        hit = tmin < torch.inf
        bt[sl] = tmin
        idx = torch.argmax((key == kmin[:, None]).long(), dim=1)
        bf[sl] = torch.where(hit, rows[idx], -1)
    return bt, bf


@pytest.mark.parametrize("case", CASES)
def test_winner_inside_its_boxes(case):
    """The plain winner's face lies inside its leaf, tile, group and root
    boxes with a slab entry strictly below its t, so the walk's culls
    capped by the best t never drop it, a tied face included; the winner's
    t is the plain `_mesh_closest_mxu`'s."""
    from rtf_tpu_torch.ops.mxu_pack import LEAF_FACES, MXU_TILE
    from rtf_tpu_torch.render import wave as W
    scene, tab, pack = _tables(case)
    h = W._Host(tab)
    o, d = _rays(scene)
    o3, d3 = tuple(o), tuple(d)
    n = o.shape[1]
    best = torch.full((n,), W.BIG)
    ties_across_tiles = 0
    for k, inst in enumerate(h.insts):
        row0, nt = int(inst[22]), int(inst[23])
        lo3, ld3 = W._to_local(inst, o3, d3)
        ild3 = W._inv_dir(ld3)
        t, f = _winners(tab, k, lo3, ld3, row0, nt)
        hit = f >= 0
        assert int(hit.sum()) > 100
        j = f[hit] // MXU_TILE
        leaf = j * 8 + (f[hit] % MXU_TILE) // LEAF_FACES
        g = torch.searchsorted(tab.groups[:, 6].contiguous(),
                               j.float(), right=True) - 1
        root = torch.full_like(j, k)
        sub = tuple(v[hit] for v in lo3), tuple(v[hit] for v in ild3)
        for name, table, idx in (("leaf", tab.leaves, leaf),
                                 ("tile", tab.tnodes, j),
                                 ("group", tab.groups, g),
                                 ("root", tab.roots, root)):
            box = table[idx]
            inside = W._slab([box[:, a] for a in range(3)],
                             [box[:, 3 + a] for a in range(3)], *sub, t[hit])
            assert bool(inside.all()), \
                f"{case}: {int((~inside).sum())} winners outside their {name}"
        best = torch.minimum(best, torch.where(hit, t, W.BIG))
        # ties: another face of the instance at the winner's t in another
        # tile (only the "tie" ball has them)
        if case == "tie":
            lo_t, ld_t = tuple(v[hit] for v in lo3), tuple(v[hit]
                                                          for v in ld3)
            fk = f[hit] + torch.where(f[hit] % 2 == 0, -1, 1)
            from rtf_tpu_torch.ops.mxu_pack import cross_od, plucker_pair
            tw, valid, *_ = plucker_pair(
                [tab.faces[fk, c] for c in range(22)], ld_t,
                cross_od(lo_t, ld_t), lo_t)
            tied = valid & (tw == t[hit])
            ties_across_tiles += int((tied & (fk // MXU_TILE
                                              != f[hit] // MXU_TILE)).sum())
            assert float(tied.float().mean()) > 0.95
    if case == "tie":
        assert ties_across_tiles >= 10
    st = [torch.full((n,), W.BIG)] + [torch.zeros(n) for _ in range(7)]
    W._mesh_closest_mxu(h, o3, d3, st, False)
    assert torch.equal(st[0], best)


@pytest.mark.parametrize("case", CASES)
def test_walk_tables_unchanged(case):
    """The walk's tables against the table code frozen at 224dbd1
    (rtbench/reference/frozen/ops/mxu_pack.py) on the same mesh: groups,
    tiles, leaves and root rows equal byte for byte, on slots of at most
    8 groups and on the ball's slot of 20."""
    from rtbench.reference.frozen.ops import mxu_pack as old
    from rtf_tpu_torch.ops import mxu_pack as new
    scene = _scene(case)
    got = new.walk_tables(new.mesh_mxu_pack(scene.mesh))
    want = old.walk_tables(old.mesh_mxu_pack(scene.mesh))
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert sorted(got[3]) == sorted(want[3])
    for slot, row in got[3].items():
        assert row.tobytes() == want[3][slot].tobytes()


@pytest.mark.parametrize("case", CASES)
def test_pair_and_shade_rows_are_the_face_columns(case):
    """The MXU tables' faces hold the pair test's columns of each face row
    (0-21, then two zero columns: six float4 a face) and shade the rest
    (columns 22-37 of ops/mxu_pack.py's rows), bit for bit, contiguous
    and 16-byte aligned; the immediates tables have no shade rows."""
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    _, tab, pack = _tables(case)
    rows = torch.as_tensor(pack["faces"])
    assert tab.faces.shape == (rows.shape[0], 24)
    assert tab.shade.shape == (rows.shape[0], 16)
    for x in (tab.faces, tab.shade):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
    assert torch.equal(tab.faces[:, 0:22].view(torch.int32),
                       rows[:, 0:22].contiguous().view(torch.int32))
    assert not tab.faces[:, 22:24].any()
    assert torch.equal(tab.shade.view(torch.int32),
                       rows[:, 22:38].contiguous().view(torch.int32))
    imm = scene_tables(build_scene(box_scene(32, 24, mesh_subdiv=1),
                                   device="cpu"))
    assert not imm.mxu and tuple(imm.shade.shape) == (0, 16)
    assert imm.faces.shape[1] == 40
