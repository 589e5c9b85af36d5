# Frozen copy of rtf_tpu_torch/ops/pack.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Host-side triangle packing (rtf_tpu/ops/pallas_mesh.py::_morton3 and
pack_triangles, NumPy only).

Faces are Morton-sorted by centroid and grouped into 128-face tiles with
per-tile AABBs.  Each face becomes one 40-row column of precomputed
intersection constants: rows 0-2 unit normal, 3 n.a, 4-6 K (bary a), 7-9 L
(bary b), 10 axis==0 mask, 11 axis==2 mask, 12-20 vertex normals a/b/c,
21-29 vertex uvw a/b/c, 30 material id, 32-37 face AABB lo/hi.  Padding
and degenerate columns have rows 0-11 zero, so dn == 0 and they never hit.
"""
from __future__ import annotations

import numpy as np

ZERO = 1e-3        # reference `bias` epsilon (objects.h:226-268)
DZ_EPS = 1e-7      # reference |dz| cutoff
TRI_LANES = 128    # faces per tile


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized xyz into a 30-bit Morton key."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    lo = x.min(axis=0)
    ext = np.maximum(x.max(axis=0) - lo, 1e-30)
    q = np.clip(((x - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) \
        | spread(q[:, 2])


def pack_triangles(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                   na: np.ndarray = None, nb: np.ndarray = None,
                   nc: np.ndarray = None, ta: np.ndarray = None,
                   tb: np.ndarray = None, tc: np.ndarray = None,
                   mtl: np.ndarray = None):
    """Host-side packed triangle table.

    Faces are Morton-sorted by centroid so each 128-face lane tile is
    spatially coherent, enabling per-tile AABB culling in the kernel.

    Returns (table [32, F_pad] f32, perm [F_pad] int32 packed->original
    face id (padding cols repeat the last id), tile_aabb [nt, 8] f32
    rows (xlo ylo zlo xhi yhi zhi 0 0), mesh_bounds (lo3, hi3) floats).

    Rows 0-11: intersection constants (see module docstring).
    Rows 12-20: vertex normals a/b/c (when `na..nc` given).
    Rows 21-29: vertex uvw a/b/c (when `ta..tc` given).
    Row 30: per-face material id (when `mtl` given).
    Rows 32-37: per-face AABB lo/hi (culling).
    """
    f = len(a)
    fp = max(TRI_LANES, ((f + TRI_LANES - 1) // TRI_LANES) * TRI_LANES)
    nt = fp // TRI_LANES
    out = np.zeros((40, fp), np.float32)
    perm = np.zeros(fp, np.int32)
    aabb = np.zeros((nt, 8), np.float32)
    if f == 0:
        return out, perm, aabb, ((0.0,) * 3, (0.0,) * 3)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    order = np.argsort(_morton3(((a + b + c) / 3.0)), kind="stable")
    a, b, c = a[order], b[order], c[order]
    perm[:f] = order.astype(np.int32)
    perm[f:] = perm[f - 1] if f > 0 else 0

    tri_lo = np.minimum(np.minimum(a, b), c)
    tri_hi = np.maximum(np.maximum(a, b), c)
    for j in range(nt):
        lo = j * TRI_LANES
        hi = min(f, lo + TRI_LANES)
        if hi > lo:
            aabb[j, 0:3] = tri_lo[lo:hi].min(axis=0)
            aabb[j, 3:6] = tri_hi[lo:hi].max(axis=0)
        else:  # all-padding tile: empty box that never overlaps
            aabb[j, 0:3] = 1e30
            aabb[j, 3:6] = -1e30
    mesh_bounds = (tuple(float(x) for x in tri_lo.min(axis=0)),
                   tuple(float(x) for x in tri_hi.max(axis=0)))
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(ln > 0, ln, 1.0)
    axis = np.argmax(np.abs(n), axis=-1)

    # projected (u, v) coords per dominant axis: x->(y,z), y->(x,z), z->(x,y)
    def uv(p):
        u = np.where(axis == 0, p[:, 1], p[:, 0])
        v = np.where(axis == 2, p[:, 1], p[:, 2])
        return u, v

    au, av = uv(a)
    bu, bv = uv(b)
    cu, cv = uv(c)
    # signed double area of the projected triangle, reference component
    # conventions (TriangleArea, objects.h:146-157; the y-axis component
    # is NOT sign-flipped — quirk preserved, it cancels in the ratio)
    total = (bu - au) * (cv - av) - (cu - au) * (bv - av)
    inv_total = np.where(total != 0, 1.0 / np.where(total == 0, 1.0, total), 0.0)
    # area(p,b,c) = K0' + K1'*pu + K2'*pv ; bary_a = area * inv_total
    k0 = (bu * cv - cu * bv) * inv_total
    k1 = (bv - cv) * inv_total
    k2 = (cu - bu) * inv_total
    # area(p,c,a)
    l0 = (cu * av - au * cv) * inv_total
    l1 = (cv - av) * inv_total
    l2 = (au - cu) * inv_total

    out[0, :f] = n[:, 0]
    out[1, :f] = n[:, 1]
    out[2, :f] = n[:, 2]
    out[3, :f] = np.sum(n * a, axis=-1)
    out[4, :f] = k0
    out[5, :f] = k1
    out[6, :f] = k2
    out[7, :f] = l0
    out[8, :f] = l1
    out[9, :f] = l2
    out[10, :f] = (axis == 0).astype(np.float32)
    out[11, :f] = (axis == 2).astype(np.float32)
    # degenerate triangles (zero normal or zero area): force invalid
    degen = (ln[:, 0] == 0) | (total == 0)
    for r in range(12):
        out[r, :f] = np.where(degen, 0.0, out[r, :f])
    # shading attributes (Morton order), for in-kernel surface resolve
    for base, arr in ((12, na), (15, nb), (18, nc),
                      (21, ta), (24, tb), (27, tc)):
        if arr is not None:
            out[base:base + 3, :f] = np.asarray(arr, np.float32)[order].T
    if mtl is not None:
        out[30, :f] = np.asarray(mtl, np.float32)[order]
    out[32:35, :f] = tri_lo[:f].T
    out[35:38, :f] = tri_hi[:f].T
    return out, perm, aabb, mesh_bounds
