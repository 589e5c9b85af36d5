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

from rtf_tpu_torch import _build
from rtf_tpu_torch.ops.mxu_pack import packed_hierarchy, walk_tables
from rtf_tpu_torch.ops.pack import DZ_EPS, TRI_LANES, ZERO
from rtf_tpu_torch.utils import tracing

RAY_BLOCK = 512        # rays per Pallas program: pack_rays pads to it
_CHUNK = 1 << 20       # ray x face elements per plain step

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

    def __post_init__(self):
        _build.check_tables("MeshTree", {
            k: getattr(self, k)
            for k in ("faces", "roots", "groups", "tnodes", "leaves")})
        if self.faces.dim() != 2 or self.faces.shape[1] != 12:
            raise ValueError("MeshTree: faces must be [F_pad, 12]")


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
    step = max(1, _CHUNK // TRI_LANES)
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
    """rays8 [N, 8] float32 (`pack_rays`), tris [>= 12, F_pad] float32 (a
    column slice of the scene table is fine) and aabb [F_pad / 128, 8]:
    slot `slot`'s columns and tile boxes; tree: the scene's MeshTree
    (scene.mesh.hit_tree), which the kernel reads in their place.
    Returns (t, face int32, front 0/1, ba, bb), each [N].  Launches
    csrc/mesh_hit.cu for CUDA tensors (counted in the tracing registry as
    launches.mesh_closest_hit; a build or launch failure raises), or runs
    `mesh_closest_hit_plain` for CPU tensors (which reads tris and not the
    tree).

    stats: optional CUDA int64 tensor [NSTAT] that the kernel adds its
    work counts to."""
    if rays8.device.type == "cpu":
        return mesh_closest_hit_plain(rays8, tris, aabb, face0)
    if rays8.dim() != 2 or rays8.shape[1] != 8 or rays8.stride(1) != 1:
        raise ValueError("mesh_closest_hit: rays8 must be [N, 8] rows")
    return _launch(rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6], face0, stats,
                   tree, slot)


def mesh_closest_hit_rays(o: torch.Tensor, d: torch.Tensor,
                          t_init: torch.Tensor, tris: torch.Tensor,
                          aabb: torch.Tensor, face0: int = 0, stats=None,
                          tree: MeshTree = None, slot: int = 0):
    """`mesh_closest_hit` of local rays o, d [N, 3] and t_init [N] that are
    not packed: the kernel reads them in place (a trace's pack_rays, four
    ops, costs as much as the launch); on CPU tensors `pack_rays` and the
    plain version.  Returns (t, face, front, ba, bb), each [N]."""
    if o.device.type == "cpu":
        rays8, _ = pack_rays(o, d, t_init)
        return tuple(x[:o.shape[0]] for x in mesh_closest_hit_plain(
            rays8, tris, aabb, face0))
    return _launch(o, d, t_init, face0, stats, tree, slot)


def _launch(o, d, t_init, face0, stats, tree, slot):
    """csrc/mesh_hit.cu on CUDA rays o, d [N, 3] (rows of one stride, unit
    column stride) and t_init [N]."""
    if o.device.type != "cuda":
        raise ValueError(f"mesh_closest_hit: unsupported device {o.device}")
    n = o.shape[0]
    dev = o.device
    if tree is None:
        raise ValueError("mesh_closest_hit: the kernel needs the scene's "
                         "MeshTree (tree=scene.mesh.hit_tree)")
    if not 0 <= slot < tree.roots.shape[0]:
        raise ValueError(f"mesh_closest_hit: no slot {slot}")
    for name, x in (("o", o), ("d", d), ("t_init", t_init)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"mesh_closest_hit: {name} must be float32 on "
                             f"{dev}")
    if tuple(o.shape) != (n, 3) or tuple(d.shape) != (n, 3) \
            or o.stride() != d.stride() or o.stride(1) != 1 \
            or tuple(t_init.shape) != (n,):
        raise ValueError("mesh_closest_hit: o and d must be [N, 3] rows of "
                         "one stride, unit column stride, and t_init [N]")
    if tree.faces.device != dev:
        raise ValueError(f"mesh_closest_hit: the tree lives on "
                         f"{tree.faces.device}, the rays on {dev}")
    _build.check_stats("mesh_closest_hit", stats, NSTAT, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    front, ba, bb = (torch.empty_like(t) for _ in range(3))
    base, rows = tree.face_base[slot], tree.face_rows[slot]
    _build.launch("mesh_hit", "rtf_mesh_hit_launch", dev,
                  o, d, o.stride(0), t_init, t_init.stride(0), n,
                  tree.faces[base:base + rows], rows,
                  int(rows * 12 * 4 <= SMEM_BYTES), tree.roots[slot],
                  tree.groups, tree.tnodes, tree.leaves, base, int(face0),
                  t, face, front, ba, bb, stats)
    tracing.count("launches.mesh_closest_hit")
    return t, face, front, ba, bb
