"""BVH builder on the host (rtf_tpu/ops/bvh.py's builders).

It reproduces cy::BVH (cyBVH.h:122-142, 242-328): a binary tree over
element boxes, a mean split on the widest axis that falls back to the next
axes and then to an arbitrary halving, at most `max_elems` elements a leaf
(up to 8 where no split separates them), children stored adjacently
(child2 = child1 + 1), the root at index 1 (node 0 unused).  `build_bvh`
takes the C++ builder of the port's host library (native/binding.py), as
rtf_tpu takes its own; use_native=False runs the NumPy builder below, the
plain version the tests hold it against.  Both give the same arrays as
rtf_tpu's NumPy builder, and as its native one but where that one splits
otherwise (tests/test_torch_native.py).  The walk over the tree is
ops/bvh_hit.py.
"""
from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

from rtf_tpu_torch.native.binding import native_build_bvh


class BvhArrays(NamedTuple):
    """Flattened BVH.  Node 0 is a dummy; the root is node 1 (cyBVH.h:76)."""
    bmin: np.ndarray      # [N,3] float32
    bmax: np.ndarray      # [N,3] float32
    child: np.ndarray     # [N] int32: first child id, or -1 for a leaf
    elem_off: np.ndarray  # [N] int32: offset into elems (leaves)
    elem_cnt: np.ndarray  # [N] int32: element count (leaves)
    elems: np.ndarray     # [E] int32: element (face) ids, leaf-contiguous


class _Tmp:
    __slots__ = ("off", "cnt", "bmin", "bmax", "c1", "c2")

    def __init__(self, off, cnt, bmin, bmax):
        self.off, self.cnt = off, cnt
        self.bmin, self.bmax = bmin, bmax
        self.c1 = self.c2 = None


def build_bvh(centers: np.ndarray, boxes_min: np.ndarray,
              boxes_max: np.ndarray, max_elems: int = 8,
              use_native: bool = True) -> BvhArrays:
    """Build over element bounds; `centers` are the split keys
    (GetElementCenter).  The C++ builder unless use_native=False; a build
    or load failure of the host library raises."""
    n = len(centers)
    if use_native and n > 0:
        return BvhArrays(*native_build_bvh(centers, boxes_min, boxes_max,
                                           max_elems))
    elems = np.arange(n, dtype=np.int32)
    if n == 0:
        z3 = np.zeros((2, 3), np.float32)
        return BvhArrays(z3, z3, np.full(2, -1, np.int32),
                         np.zeros(2, np.int32), np.zeros(2, np.int32),
                         np.zeros(0, np.int32))

    def node_bounds(e):
        return boxes_min[e].min(axis=0), boxes_max[e].max(axis=0)

    def find_split(e, bmin, bmax):
        """MeanSplit (cyBVH.h:295-328): the widest axis first, then the
        others, widest first."""
        cnt = len(e)
        if cnt <= max_elems:
            return 0
        d = bmax - bmin
        order = [int(np.argmax(d))]
        rest = [a for a in range(3) if a != order[0]]
        if d[rest[0]] < d[rest[1]]:
            rest = [rest[1], rest[0]]
        order += rest
        for axis in order:
            split_pos = 0.5 * (bmin[axis] + bmax[axis])
            left = centers[e][:, axis] <= split_pos
            i = int(left.sum())
            if 0 < i < cnt:
                # a stable partition (cy's in-place swap partition orders
                # the halves otherwise; the tree's boxes are the same)
                e[:] = np.concatenate([e[left], e[~left]])
                return i
        return 0

    def split(t: _Tmp):
        e = elems[t.off:t.off + t.cnt]
        i = find_split(e, t.bmin, t.bmax)
        if i == 0 or i >= t.cnt:
            if t.cnt > 8:        # CY_BVH_MAX_ELEMENT_COUNT: halve anyway
                i = t.cnt // 2
            else:
                return
        l_min, l_max = node_bounds(e[:i])
        r_min, r_max = node_bounds(e[i:])
        t.c1 = _Tmp(t.off, i, l_min, l_max)
        t.c2 = _Tmp(t.off + i, t.cnt - i, r_min, r_max)
        split(t.c1)
        split(t.c2)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = _Tmp(0, n, *node_bounds(elems))
        split(root)

        def count(t):
            return 1 if t.c1 is None else 1 + count(t.c1) + count(t.c2)

        size = count(root) + 1
        a_bmin = np.zeros((size, 3), np.float32)
        a_bmax = np.zeros((size, 3), np.float32)
        a_child = np.full(size, -1, np.int32)
        a_eoff = np.zeros(size, np.int32)
        a_ecnt = np.zeros(size, np.int32)

        def convert(node_id, t, child_index):
            """ConvertTempData (cyBVH.h:242-258): depth first, children
            adjacent."""
            a_bmin[node_id] = t.bmin
            a_bmax[node_id] = t.bmax
            if t.c1 is None:
                a_eoff[node_id] = t.off
                a_ecnt[node_id] = t.cnt
                return child_index
            a_child[node_id] = child_index
            new_ci = convert(child_index, t.c1, child_index + 2)
            return convert(child_index + 1, t.c2, new_ci)

        convert(1, root, 2)
    finally:
        sys.setrecursionlimit(old_limit)
    return BvhArrays(a_bmin, a_bmax, a_child, a_eoff, a_ecnt, elems.copy())


def build_mesh_bvh(verts: np.ndarray, faces: np.ndarray,
                   max_elems: int = 8, use_native: bool = True) -> BvhArrays:
    """BVH over triangles: element bounds are the faces' boxes, centers the
    boxes' centers (cyBVHTriMesh::GetElementBounds/Center,
    cyBVH.h:339-379)."""
    tri = verts[faces]                      # [F,3,3]
    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    centers = 0.5 * (bmin + bmax)
    return build_bvh(centers.astype(np.float64), bmin, bmax, max_elems,
                     use_native)
