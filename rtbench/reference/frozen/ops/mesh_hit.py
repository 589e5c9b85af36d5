# Frozen copy of rtf_tpu_torch/ops/mesh_hit.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
# Changed: mesh_closest_hit and mesh_closest_hit_rays run the plain version on every device; _launch is gone; the plain step is 1 << 24 on the card.
"""Closest ray-triangle hit over one mesh slot's packed triangle table: the
plain PyTorch version and the CUDA kernel's wrapper.

The port of rtf_tpu/ops/pallas_mesh.py (`pack_rays`, `mesh_closest_hit`
and its Pallas kernel `_mesh_kernel`).  Rays are already in the instance's
local space; the table is a slot's columns of the scene's packed table
(ops/pack.py: rows 0-2 unit normal, 3 n.a, 4-6 K, 7-9 L, 10 axis==0 mask,
11 axis==2 mask; padding columns are zero and never hit) with its tile
boxes.  Both versions return (t, face, front, ba, bb), each [N]: face is
the packed (Morton) id plus `face0`, -1 where no face beats t_init (t is
then t_init and the rest zero).  Among exact t ties the lowest face id
wins, the Pallas kernel's lane-reduction rule.

`mesh_closest_hit_plain` tests every face, [rays, 128] per tile, with no
culling; `mesh_closest_hit` launches csrc/mesh_hit.cu for CUDA tensors,
which walks the slot's box hierarchy (`MeshTree`, built with the scene)
per ray, and runs the plain version for CPU tensors;
`mesh_closest_hit_rays` does the same on rays that are not packed (what
ops/trace.py calls).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtbench.reference.frozen.ops.mxu_pack import packed_hierarchy, walk_tables
from rtbench.reference.frozen.ops.pack import DZ_EPS, TRI_LANES, ZERO

RAY_BLOCK = 512        # rays per Pallas program: pack_rays pads to it
_CHUNK = 1 << 20       # ray x face elements per plain step
_CHUNK_CUDA = 1 << 24  # the same on the card

# kernel launches made by `mesh_closest_hit` (the plain version never
# counts)
launches = 0
# kernel work counters: slab tests (all levels), ray-face pairs, root-box
# tests, rays that entered the root, group, tile and leaf slab tests
NSTAT = 7
# shared memory of a launch (bytes): the slot's face rows up to this, in
# blocks where a ray walks; larger slots read them from device memory
SMEM_BYTES = 48 * 1024


@dataclass
class MeshTree:
    """What csrc/mesh_hit.cu reads of a scene's packed triangle table:
    faces [F_pad, 12], its rows 0-11 face-major (three 16-byte rows a
    face), and per slot the box hierarchy over its packed columns
    (ops/mxu_pack.py's packed_hierarchy and walk_tables, boxes padded):
    roots [S, 8], groups [G, 24], tnodes [T, 24] (tile j is the scene's
    tile_aabb row j), leaves [T * 8, 8]; zero padding columns are empty
    leaves.  face_base, face_rows: per slot its first column and its
    column count."""
    faces: torch.Tensor
    roots: torch.Tensor
    groups: torch.Tensor
    tnodes: torch.Tensor
    leaves: torch.Tensor
    face_base: tuple
    face_rows: tuple


def mesh_tree(tri_packed, slot_pack, slot_faces, device) -> MeshTree:
    """The MeshTree of a packed table (ops/pack.py layout, [40, sum F_pad],
    each slot's columns at slot_pack's col0) on `device`: each slot's
    faces (slot_faces' count, in packed order) boxed by their rows
    32-37."""
    table = tri_packed.cpu().numpy() if isinstance(tri_packed, torch.Tensor) \
        else np.asarray(tri_packed)
    boxes = []
    for (col0, _, _, _, _), (f0, f1) in zip(slot_pack, slot_faces):
        cols = table[:, col0:col0 + f1 - f0]
        boxes.append((cols[32:35].T, cols[35:38].T))
    pack = packed_hierarchy(boxes)
    for (col0, fpad, ar0, nt, _), s in zip(slot_pack, pack["slots"]):
        assert pack["slots"][s][0:2] == (ar0, nt) and col0 == ar0 * TRI_LANES
    groups, tnodes, leaves, roots = walk_tables(pack)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)
    return MeshTree(faces=t(table[0:12].T),
                    roots=t(np.stack([roots[s] for s in sorted(roots)])),
                    groups=t(groups), tnodes=t(tnodes), leaves=t(leaves),
                    face_base=tuple(int(p[0]) for p in slot_pack),
                    face_rows=tuple(int(p[1]) for p in slot_pack))


def pack_rays(o: torch.Tensor, d: torch.Tensor, t_init: torch.Tensor):
    """[N,3] x 2 + [N] -> ([N_pad, 8] rows ox oy oz dx dy dz t_init 0,
    N_pad), N_pad a multiple of RAY_BLOCK.  Padding rays get t_init = 0 so
    nothing validates (face stays -1)."""
    n = o.shape[0]
    npad = ((max(n, RAY_BLOCK) + RAY_BLOCK - 1) // RAY_BLOCK) * RAY_BLOCK
    rays = torch.zeros((npad, 8), dtype=torch.float32, device=o.device)
    rays[:n, 0:3] = o
    rays[:n, 3:6] = d
    rays[:n, 6] = t_init
    return rays, npad


def _tri_test(col, lo3, ld3):
    """Projected-barycentric ray/triangle test (pallas_mesh.py layout rows
    0-11, in the Pallas kernel's operation order): `col` holds the 12 face
    rows, broadcastable against the ray channels lo3/ld3.  Returns (t, dn,
    ba, bb, bc, valid without the t cap)."""
    lx, ly, lz = lo3
    dx, dy, dz = ld3
    dn = dx * col[0] + dy * col[1] + dz * col[2]
    pn = lx * col[0] + ly * col[1] + lz * col[2] - col[3]
    bad = torch.abs(dn) < DZ_EPS
    t = -pn / torch.where(bad, torch.full_like(dn, DZ_EPS), dn)
    hx = lx + t * dx
    hy = ly + t * dy
    hz = lz + t * dz
    pu = torch.where(col[10] > 0.5, hy, hx)
    pv = torch.where(col[11] > 0.5, hy, hz)
    ba = col[4] + col[5] * pu + col[6] * pv
    bb = col[7] + col[8] * pu + col[9] * pv
    bc = 1.0 - ba - bb
    valid = (~bad) & (t > ZERO) & (ba >= 0.0) & (bb >= 0.0) & (bc >= 0.0)
    return t, dn, ba, bb, bc, valid


def mesh_closest_hit_plain(rays8: torch.Tensor, tris: torch.Tensor,
                           aabb: torch.Tensor = None, face0: int = 0):
    """The plain version: the Pallas kernel's table test as dense
    [rays, 128] tensor ops per tile, without culling (`aabb` is not
    read).  The strict `<` against the running best over tiles in packed
    order, and the lowest id among a tile's exact ties, give the kernel's
    tie rule."""
    n = rays8.shape[0]
    nt = tris.shape[1] // TRI_LANES
    dev = rays8.device
    t_best = rays8[:, 6].clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.float32, device=dev)
    ba = torch.zeros_like(front)
    bb = torch.zeros_like(front)
    col = torch.arange(TRI_LANES, dtype=torch.int32, device=dev)
    chunk = _CHUNK_CUDA if dev.type == "cuda" else _CHUNK
    step = max(1, chunk // TRI_LANES)
    for s in range(0, n, step):
        sl = slice(s, min(n, s + step))
        lo3 = tuple(rays8[sl, k:k + 1] for k in range(3))
        ld3 = tuple(rays8[sl, k:k + 1] for k in range(3, 6))
        for j in range(nt):
            tri = tris[0:12, j * TRI_LANES:(j + 1) * TRI_LANES]
            t, dn, ba_t, bb_t, _, valid = _tri_test(
                [tri[r][None, :] for r in range(12)], lo3, ld3)
            tv = torch.where(valid, t, torch.inf)
            t_min = torch.amin(tv, dim=1)
            # the lowest column among the tile's exact ties
            c = torch.amin(torch.where(tv == t_min[:, None], col, TRI_LANES),
                           dim=1).to(torch.int64)
            upd = t_min < t_best[sl]
            pick = c[:, None].clamp(max=TRI_LANES - 1)
            t_best[sl] = torch.where(upd, t_min, t_best[sl])
            face[sl] = torch.where(upd, (face0 + j * TRI_LANES + c)
                                   .to(torch.int32), face[sl])
            front[sl] = torch.where(
                upd, (dn.gather(1, pick)[:, 0] <= 0.0).to(torch.float32),
                front[sl])
            ba[sl] = torch.where(upd, ba_t.gather(1, pick)[:, 0], ba[sl])
            bb[sl] = torch.where(upd, bb_t.gather(1, pick)[:, 0], bb[sl])
    return t_best, face, front, ba, bb


def mesh_closest_hit(rays8: torch.Tensor, tris: torch.Tensor,
                     aabb: torch.Tensor, face0: int = 0, stats=None,
                     tree: MeshTree = None, slot: int = 0):
    """`mesh_closest_hit_plain` on any device (the port launches
    csrc/mesh_hit.cu for CUDA tensors, which equals it)."""
    return mesh_closest_hit_plain(rays8, tris, aabb, face0)


def mesh_closest_hit_rays(o: torch.Tensor, d: torch.Tensor,
                          t_init: torch.Tensor, tris: torch.Tensor,
                          aabb: torch.Tensor, face0: int = 0, stats=None,
                          tree: MeshTree = None, slot: int = 0):
    """`pack_rays` and the plain version on any device.  Returns (t, face,
    front, ba, bb), each [N]."""
    rays8, _ = pack_rays(o, d, t_init)
    return tuple(x[:o.shape[0]] for x in mesh_closest_hit_plain(
        rays8, tris, aabb, face0))
