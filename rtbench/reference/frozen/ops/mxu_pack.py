# Frozen copy of rtf_tpu_torch/ops/mxu_pack.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Plücker tables of large meshes (rtf_tpu/render/fused.py::_mxu_pack,
NumPy only), and the Plücker ray-triangle pair test that reads them.

rtf_tpu runs a mesh of more than 512 faces on its wave kernel's MXU-table
variant: per 128-face Morton tile one [1024, 16] x [16, 5*128] matrix
product gives, for every ray-face pair, the three edge signs and the plane
terms of the bilinear factorization (rtf_tpu/ops/pallas_mesh_mxu.py:1-33):

    s_k = d . m_k + (o x d) . e_k      (w_k = (m_k, e_k) the Plücker
                                        coordinates of the edge opposite
                                        vertex k: w_a = plucker(b, c), ...)
    dn  = d . n,   on = n . a - o . n  (n the unit geometric normal)

The same numbers are kept here, one row per face instead of the TPU's
matrix layout, so that one thread per ray reads a face with a few 16-byte
loads (csrc/wave_kernel.cu).  Face rows [NT * 128, FACE_W] float32, each
slot's faces in Morton order, each tile padded with zero rows:

    0-5   w_a = plucker(b, c)    (cross(b, c), c - b)
    6-11  w_b = plucker(c, a)
    12-17 w_c = plucker(a, b)
    18-20 n, the unit geometric normal   21  n . a
    22-24 vertex normal c   25-27 na - nc   28-30 nb - nc
    31    material id
    32-33 uv_c   34-35 uv_a - uv_c   36-37 uv_b - uv_c

Degenerate faces (zero normal) have rows 0-21 zero, so dn == 0 and they
never hit.  These are the columns of rtf_tpu's `trit` (rows 0-21) and
`shade` tables (rows 22-37; its geometric-normal columns 10-12 are row
18-20 here, the same numbers).  Tile rows [NT, TILE_W]: 0-5 the tile's
AABB (lo xyz, hi xyz; empty tiles 1e30 / -1e30), 6-13 the front-to-back
visit order of the slot's tiles for each direction octant (global tile
index at visit step k, octant o = 4 (dx >= 0) + 2 (dy >= 0) + (dz >= 0)),
14 the tile's first face row, 15 its face count.

On top of the tiles, the port keeps a box hierarchy per slot that the
kernels walk one ray per thread (csrc/walk.cuh, shared by the wave
kernel's variants and csrc/mesh_hit.cu); rtf_tpu's TPU tables are one
level only because a tile is one matrix product.  The faces stay in
Morton column order, so a face's (tile, column) key is unchanged.
`packed_hierarchy` builds the same hierarchy over faces whose key is
their packed row (the immediates tables, mesh_closest_hit's slot tables):
there the tree rows 0-7 are the tile's own index in every octant.

    groups [NG, GROUP_W]  GROUP_TILES consecutive tiles of one slot: 0-5
        the group's box (the union of its tiles'), 6 its first tile, 7 its
        tile count, 8-15 the near-to-far visit order of the slot's groups
        for each octant (global group index at visit step k, as the tile
        rows 6-13), 16-23 per octant the near-to-far order of the group's
        own tiles, packed three bits a step (tile 6 + ((v >> 3 k) & 7) at
        step k; an exact float below 2^24);
    tree [NT, TREE_W]  per tile 0-7 its rank in each octant's visit order
        (the inverse of rows 6-13: its row in the slot's order column),
        8-15 per octant the near-to-far order of its leaves, packed the
        same way (non-empty leaves first);
    leaves [NT * TILE_LEAVES, LEAF_W]  LEAF_FACES consecutive columns of a
        tile: 0-5 the box of their faces (empty: 1e30 / -1e30), 6 the first
        face row, 7 the face count.

Every order uses the tiles' key: the box centre along the octant's
diagonal, empty boxes last, ties by index.

The walk's tables (`walk_tables`) pad every box by TILE_PAD * (1 + the
box's largest |coordinate|): the triangle vertices lie on the box faces,
so a slab entry rounded a hair past a triangle's own t must not cull it,
and a face at exactly the lane's best t keeps a slab entry below that t.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench.reference.frozen.ops.pack import DZ_EPS, ZERO, _morton3

MXU_TILE = 128        # faces per tile (fused.py:56)
FACE_W = 40
TILE_W = 16
GROUP_TILES = 8       # tiles per group
LEAF_FACES = 16       # faces per leaf
TILE_LEAVES = MXU_TILE // LEAF_FACES
GROUP_W, TREE_W, LEAF_W = 24, 16, 8
NODE_W = 24           # the walk's tile rows: box, face range, tree row
EMPTY_BOX = (1e30, 1e30, 1e30, -1e30, -1e30, -1e30)
TILE_PAD = 1e-4


def _octant_keys(ctr):
    """[..., 8] near-to-far keys of box centres ctr [..., 3] (float64, rows
    of 1e30 for empty boxes) along each octant's diagonal (fused.py's
    `ctr @ s`, octant by octant), empty boxes last."""
    key = np.stack([ctr @ np.array([1.0 if o & 4 else -1.0,
                                    1.0 if o & 2 else -1.0,
                                    1.0 if o & 1 else -1.0])
                    for o in range(8)], axis=-1)
    key[ctr[..., 0] >= 1e30] = np.inf
    return key


def _centres(boxes):
    """Centres [..., 3] (float64) of float32 boxes [..., 6], 1e30 where a
    box is empty."""
    b = boxes.astype(np.float64)
    ctr = (b[..., 0:3] + b[..., 3:6]) / 2
    ctr[b[..., 0] > b[..., 3]] = 1e30
    return ctr


def _packed_orders(boxes):
    """Per octant the near-to-far order of each row's children, boxes
    [R, C, 6] with C <= 8, packed three bits a step: [R, 8] float32."""
    order = np.argsort(_octant_keys(_centres(boxes)), axis=1,
                       kind="stable")                      # [R, C, 8]
    shift = 3 * np.arange(boxes.shape[1])[None, :, None]
    return np.sum(order << shift, axis=1).astype(np.float32)


def _tile_rows(tri_lo, tri_hi, f, row0):
    """The tile rows [nt, TILE_W] of one slot's f faces (vertex boxes
    tri_lo, tri_hi [f, 3] in packed order), its first tile row0: boxes,
    the octant visit orders and the face ranges; at least one tile."""
    nt = max(1, (f + MXU_TILE - 1) // MXU_TILE)
    tiles = np.zeros((nt, TILE_W), np.float32)
    count = np.clip(f - MXU_TILE * np.arange(nt), 0, MXU_TILE)
    pad = nt * MXU_TILE - f
    lo = np.concatenate([tri_lo, np.full((pad, 3), np.inf, np.float32)])
    hi = np.concatenate([tri_hi, np.full((pad, 3), -np.inf, np.float32)])
    tiles[:, 0:3] = lo.reshape(nt, MXU_TILE, 3).min(1)
    tiles[:, 3:6] = hi.reshape(nt, MXU_TILE, 3).max(1)
    tiles[count == 0, 0:6] = EMPTY_BOX
    tiles[:, 14] = (row0 + np.arange(nt)) * MXU_TILE
    tiles[:, 15] = count
    # near-to-far along each octant's diagonal, empty tiles last
    tiles[:, 6:14] = np.argsort(_octant_keys(_centres(tiles[:, 0:6])),
                                axis=0, kind="stable") + row0
    return tiles


def _tree(tri_lo, tri_hi, f, tiles, row0, grow0, packed=False):
    """The hierarchy of one slot (see the module docstring): groups rows,
    tree rows and leaf rows; tiles [nt, TILE_W] are the slot's tile rows
    (unpadded boxes and orders), row0 its first tile and grow0 its first
    group.  packed: the key is the face row, so the tree rows 0-7 hold
    the tile's own index instead of its octant ranks."""
    nt = tiles.shape[0]
    # leaves: LEAF_FACES consecutive columns of each tile
    pad = nt * MXU_TILE - f
    lo = np.concatenate([tri_lo, np.full((pad, 3), np.inf, np.float32)])
    hi = np.concatenate([tri_hi, np.full((pad, 3), -np.inf, np.float32)])
    lo = lo.reshape(nt * TILE_LEAVES, LEAF_FACES, 3).min(1)
    hi = hi.reshape(nt * TILE_LEAVES, LEAF_FACES, 3).max(1)
    count = np.clip(f - LEAF_FACES * np.arange(nt * TILE_LEAVES), 0,
                    LEAF_FACES)
    leaves = np.zeros((nt * TILE_LEAVES, LEAF_W), np.float32)
    leaves[:, 0:3], leaves[:, 3:6] = lo, hi
    leaves[count == 0, 0:6] = EMPTY_BOX
    leaves[:, 6] = row0 * MXU_TILE + LEAF_FACES * np.arange(nt * TILE_LEAVES)
    leaves[:, 7] = count
    tree = np.zeros((nt, TREE_W), np.float32)
    # rank: the inverse of each octant's visit order (global rows)
    order = tiles[:, 6:14].astype(np.int64) - row0
    for o in range(8):
        tree[order[:, o], o] = row0 + np.arange(nt)
    if packed:
        tree[:, 0:8] = (row0 + np.arange(nt))[:, None]
    tree[:, 8:16] = _packed_orders(
        leaves[:, 0:6].reshape(nt, TILE_LEAVES, 6))
    # groups: GROUP_TILES consecutive tiles, the last one short
    ng = (nt + GROUP_TILES - 1) // GROUP_TILES
    tb = np.concatenate([tiles[:, 0:6], np.tile(
        np.asarray(EMPTY_BOX, np.float32), (ng * GROUP_TILES - nt, 1))])
    tb = tb.reshape(ng, GROUP_TILES, 6)
    groups = np.zeros((ng, GROUP_W), np.float32)
    groups[:, 0:3] = tb[:, :, 0:3].min(1)
    groups[:, 3:6] = tb[:, :, 3:6].max(1)
    groups[:, 6] = row0 + GROUP_TILES * np.arange(ng)
    groups[:, 7] = np.minimum(nt - GROUP_TILES * np.arange(ng), GROUP_TILES)
    groups[:, 8:16] = (np.argsort(_octant_keys(_centres(groups[:, 0:6])),
                                  axis=0, kind="stable") + grow0)
    for g in range(ng):
        groups[g, 16:24] = _packed_orders(tb[g:g + 1, :int(groups[g, 7])])
    return groups, tree, leaves


def mxu_pack(tri_a, tri_b, tri_c, tri_na, tri_nb, tri_nc, tri_mtl, attr_t,
             slot_faces):
    """fused.py::_mxu_pack on float32 NumPy arrays of a mesh arena, and the
    box hierarchy on top of it.  Returns dict(faces [NT*128, 40], tiles
    [NT, 16], slots {slot: (first tile, tile count, lo3, hi3)}, groups
    [NG, 24], tree [NT, 16], leaves [NT*8, 8], slot_groups {slot: (first
    group, group count)}), lo3/hi3 the slot's bounding box as Python
    floats; boxes unpadded."""
    face_parts, tile_parts, slots = [], [], {}
    tree_parts, slot_groups = [], {}
    row0 = grow0 = 0
    for slot, (f0, f1) in enumerate(slot_faces):
        a, b, c = tri_a[f0:f1], tri_b[f0:f1], tri_c[f0:f1]
        nav, nbv, ncv = tri_na[f0:f1], tri_nb[f0:f1], tri_nc[f0:f1]
        mt = tri_mtl[f0:f1]
        at = attr_t[f0:f1]
        f = f1 - f0
        order = np.argsort(_morton3((a + b + c) / 3.0), kind="stable")
        a, b, c = a[order], b[order], c[order]
        nav, nbv, ncv, mt, at = (x[order] for x in (nav, nbv, ncv, mt, at))

        n = np.cross(b - a, c - a)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        degen = ln[:, 0] == 0
        n = n / np.where(ln > 0, ln, 1.0)
        na_d = np.sum(n * a, axis=-1)

        def plucker(p, q):
            return np.concatenate([np.cross(p, q), q - p], axis=-1)

        w = [plucker(b, c), plucker(c, a), plucker(a, b)]
        for wk in w:
            wk[degen] = 0.0
        n[degen] = 0.0
        na_d[degen] = 0.0

        tri_lo = np.minimum(np.minimum(a, b), c)
        tri_hi = np.maximum(np.maximum(a, b), c)
        tiles = _tile_rows(tri_lo, tri_hi, f, row0)
        nt = tiles.shape[0]
        faces = np.zeros((nt * MXU_TILE, FACE_W), np.float32)
        faces[:f, 0:6], faces[:f, 6:12], faces[:f, 12:18] = w
        faces[:f, 18:21] = n
        faces[:f, 21] = na_d
        faces[:f, 22:25] = ncv
        faces[:f, 25:28] = nav - ncv
        faces[:f, 28:31] = nbv - ncv
        faces[:f, 31] = mt
        uva, uvb, uvc = at[:, 0:2], at[:, 3:5], at[:, 6:8]
        faces[:f, 32:34] = uvc
        faces[:f, 34:36] = uva - uvc
        faces[:f, 36:38] = uvb - uvc
        slots[slot] = (row0, nt, tuple(float(x) for x in tri_lo.min(0)),
                       tuple(float(x) for x in tri_hi.max(0)))
        face_parts.append(faces)
        tile_parts.append(tiles)
        tree_parts.append(_tree(tri_lo, tri_hi, f, tiles, row0, grow0))
        slot_groups[slot] = (grow0, tree_parts[-1][0].shape[0])
        row0 += nt
        grow0 += slot_groups[slot][1]
    groups, tree, leaves = (np.concatenate(x) for x in zip(*tree_parts))
    return dict(faces=np.concatenate(face_parts),
                tiles=np.concatenate(tile_parts), slots=slots,
                groups=groups, tree=tree, leaves=leaves,
                slot_groups=slot_groups)


def packed_hierarchy(boxes):
    """The box hierarchy over faces whose key is their packed row: boxes
    is a list, per slot, of its faces' vertex boxes (lo [f, 3], hi [f, 3])
    in packed order; slot s takes whole tiles from row0 on, its faces rows
    row0 * 128 + column, padding rows after them.  Returns dict(tiles
    [NT, 16], slots {s: (first tile, tile count, lo3, hi3)}, groups, tree,
    leaves, slot_groups) as `mxu_pack` does, boxes unpadded; lo3/hi3 of a
    slot without faces are 0."""
    tile_parts, tree_parts, slots, slot_groups = [], [], {}, {}
    row0 = grow0 = 0
    for slot, (lo, hi) in enumerate(boxes):
        f = lo.shape[0]
        tiles = _tile_rows(lo, hi, f, row0)
        nt = tiles.shape[0]
        tile_parts.append(tiles)
        tree_parts.append(_tree(lo, hi, f, tiles, row0, grow0, packed=True))
        bounds = (lo.min(0), hi.max(0)) if f else (np.zeros(3),) * 2
        slots[slot] = (row0, nt, *(tuple(float(x) for x in v)
                                   for v in bounds))
        slot_groups[slot] = (grow0, tree_parts[-1][0].shape[0])
        row0 += nt
        grow0 += slot_groups[slot][1]
    groups, tree, leaves = (np.concatenate(x) for x in zip(*tree_parts))
    return dict(tiles=np.concatenate(tile_parts), slots=slots,
                groups=groups, tree=tree, leaves=leaves,
                slot_groups=slot_groups)


def _pad_box(lo, hi):
    pad = TILE_PAD * (1.0 + max(np.abs(lo).max(), np.abs(hi).max()))
    return lo - pad, hi + pad


def _pad_boxes(rows):
    """_pad_box on the box columns 0-5 of every non-empty row (empty boxes
    stay empty), in place: the same float32 operations, row by row."""
    full = rows[:, 0] <= rows[:, 3]
    pad = TILE_PAD * (1.0 + np.abs(rows[full, 0:6]).max(1, keepdims=True))
    rows[full, 0:3] -= pad
    rows[full, 3:6] += pad
    return rows


def walk_tables(pack):
    """The tables the kernels' walk reads, boxes padded, from a pack
    (`mxu_pack` or `packed_hierarchy`): groups [G, 24], tnodes [T, 24] (0-5
    the padded box, 6 first face row, 7 face count, 8-23 the tree row) and
    leaves [T * 8, 8]; and per slot its root row [8]: the padded bounds
    of its faces, its first group and group count."""
    tiles = pack["tiles"]
    tnodes = np.zeros((tiles.shape[0], NODE_W), np.float32)
    tnodes[:, 0:6] = _pad_boxes(tiles[:, 0:6].copy())
    tnodes[:, 6:8] = tiles[:, 14:16]
    tnodes[:, 8:24] = pack["tree"]
    roots = {}
    for slot, (_, _, lo, hi) in pack["slots"].items():
        row = np.zeros(8, np.float32)
        row[0:3], row[3:6] = _pad_box(np.asarray(lo, np.float32),
                                      np.asarray(hi, np.float32))
        row[6:8] = pack["slot_groups"][slot]
        roots[slot] = row
    return (_pad_boxes(pack["groups"].copy()), tnodes,
            _pad_boxes(pack["leaves"].copy()), roots)


def mesh_mxu_pack(mesh):
    """`mxu_pack` of a built scene's MeshArena (scene/build.py)."""
    def np32(x):
        return x.cpu().numpy().astype(np.float32)
    return mxu_pack(*(np32(getattr(mesh, k)) for k in (
        "tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc")),
        mesh.tri_mtl.cpu().numpy(), np32(mesh.attr_t), mesh.slot_faces)


def cross_od(o3, d3):
    """o x d per ray, in fused.py::_rays16's order."""
    return (o3[1] * d3[2] - o3[2] * d3[1],
            o3[2] * d3[0] - o3[0] * d3[2],
            o3[0] * d3[1] - o3[1] * d3[0])


def plucker_pair(col, d3, c3, o3):
    """The pair test of csrc/plucker.cuh: face columns col[k] (rows 0-21 of
    the face layout, broadcastable against the ray channels), ray d, o x d
    and o.  Every product is summed in one fixed order, element by element
    (no matmul), so the kernel agrees bit for bit.  Returns (t, valid
    without a t cap, sa, sb, sc, dn): valid = some winding inside, |dn| >=
    1e-7 and t > 1e-3."""
    dx, dy, dz = d3
    cx, cy, cz = c3
    s = [dx * col[6 * k] + dy * col[6 * k + 1] + dz * col[6 * k + 2]
         + cx * col[6 * k + 3] + cy * col[6 * k + 4] + cz * col[6 * k + 5]
         for k in range(3)]
    dn = dx * col[18] + dy * col[19] + dz * col[20]
    on = col[21] - (o3[0] * col[18] + o3[1] * col[19] + o3[2] * col[20])
    sa, sb, sc = s
    inside = ((torch.minimum(torch.minimum(sa, sb), sc) >= 0.0)
              | (torch.maximum(torch.maximum(sa, sb), sc) <= 0.0))
    bad = torch.abs(dn) < DZ_EPS
    t = on / torch.where(bad, torch.full_like(dn, DZ_EPS), dn)
    return t, inside & ~bad & (t > ZERO), sa, sb, sc, dn


def plucker_bary(sa, sb, sc):
    """The winner's barycentrics ba, bb: s_k over their sum (1 where the
    sum is 0)."""
    ssum = sa + sb + sc
    rs = 1.0 / torch.where(ssum == 0.0, torch.ones_like(ssum), ssum)
    return sa * rs, sb * rs
