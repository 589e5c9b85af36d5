"""Closest hit of local-space rays against one mesh instance's BVH: the
plain PyTorch versions and the CUDA kernels' wrapper.

The port of rtf_tpu/ops/trace.py::bvh_traverse, the lock-step walk that
mesh_algo="bvh" takes over the arena's per-slot BVH (scene/build.py::
ensure_bvh).  It reaches no pallas_call in rtf_tpu: there it is one XLA
while_loop.  Every version returns (t, face, front, ba, bb), each [N]:
face is the arena face id, -1 where no face beats t_init (t is then
t_init, front, ba and bb zero); front is 0/1 in float32.

`bvh_closest_hit_plain` is bvh_traverse step for step in torch ops: each
step pops one node per ray with a non-empty stack, tests its box against
the ray's best t, tests a leaf's faces (at most max_leaf, the best t
updated face by face) or pushes an inner node's far child, then its near
one (near: the child whose box the ray enters first, ties to the first
child), the stack pointer clamped at max_depth - 1.  Only the rays whose
stack is not empty take part in a step; that changes no ray's sequence of
tests.  It is the port's statement of bvh_traverse, and what
`bvh_closest_hit` runs for CPU tensors.

For CUDA tensors `bvh_closest_hit` launches one of csrc/bvh_hit.cu's two
walks, chosen once per arena by `bvh_walk` (the depth rule):

* the wide walk (`bvh_wide_kernel`), over a 4-wide tree collapsed from the
  binary one (`collapse`): an inner node is one 128-byte line, its
  children's boxes as rows of 4 with a child word each, so one fetch gives
  four independent slab tests; a child that is hit is pushed with its
  entry distance, far to near, and re-checked at its pop against the best
  t only (never reloaded); the leaves are the binary tree's, each face a
  64-byte row computed once (`face_rows`: corner a, the unit normal, the
  reciprocal projected area, the projected corners), so a ray-face test
  is only its ray-dependent part, two faces at a time; one thread a ray,
  its stack in local memory.  `bvh_wide_closest_hit_plain` is its plain twin, the
  same per-ray sequence of pops and tests in lock step: the kernel equals
  it bit for bit, outputs and counters.  Against the lock-step walk it
  visits faces in another order: t and the hit mask agree; the face (and
  front, ba, bb) may differ only where two faces hit at the same t, and
  pruning by another best t can only change a result there (each child box
  is inside its parent's, bit for bit).
* the binary walk (`bvh_hit_kernel`), one thread per ray with the lock-step
  walk's pops, tests, pushes and clamp: it equals `bvh_closest_hit_plain`
  bit for bit.  `bvh_walk` takes it where the binary tree has more than
  max_depth - 2 levels, where bvh_traverse's stack clamp can drop a node
  in a way that depends on the order of the walk.

The kernels round as torch does (--fmad=false, IEEE division and square
root) and each ray's sequence of tests does not depend on the other rays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtf_tpu_torch import _build
from rtf_tpu_torch.ops.intersect import (
    ZERO, intersect_box_enter, intersect_triangle, triangle_face)
from rtf_tpu_torch.utils import tracing

# work counters: nodes popped, inner nodes entered, leaves entered,
# ray-face tests, the most pops of one ray (the lock-step versions' step
# count), box tests
NSTAT = 6
MAX_DEPTH = 32     # the binary walk's stack, ints per thread
WIDTH = 4          # the wide tree's children a node
ROW = 16           # floats a face row
LOCAL_STACK = 96   # the wide walk's stack, entries a ray
EMPTY = -1         # a wide node's unused child slot


@dataclass
class BvhWalk:
    """What csrc/bvh_hit.cu reads of an arena's BVH, on the arena's device.

    walk "wide": wnodes [Nw, 8 * WIDTH] float32, a node's rows of WIDTH
    (children's bmin x, y, z, bmax x, y, z; child words as int bits: a wide
    node >= 0, EMPTY, or a leaf -(2 + (first << 8 | faces tested)); meta:
    the child count, then zeros); face_rows [E, ROW] float32 (`face_rows`,
    in leaf order); wide_root {binary root: its wide node}; stack: the
    entries the walk needs at most.
    walk "binary": nodes [N, 8] float32, two 16-byte rows a node
    (bmin and the first child's id as int bits; bmax and the leaf word,
    its first element << 8 | the faces it tests, min(count, max_leaf), as
    int bits), and leaf_tris [E, 12] float32, the faces in leaf order
    (bvh_elems), three 16-byte rows a face (corner a and the arena face id
    as int bits, b, c).
    roots: slot_root on the host; levels: the binary tree's most levels
    over the slots."""
    walk: str
    roots: tuple
    levels: int
    max_depth: int
    nodes: torch.Tensor = None
    leaf_tris: torch.Tensor = None
    wnodes: torch.Tensor = None
    face_rows: torch.Tensor = None
    wide_root: dict = None
    stack: int = 0

    def __post_init__(self):
        _build.check_tables("BvhWalk", {
            k: getattr(self, k)
            for k in ("nodes", "leaf_tris", "wnodes", "face_rows")})


def tree_levels(child: np.ndarray, root: int) -> int:
    """Levels of the binary tree under `root` (a leaf root: 1)."""
    levels, level = 0, np.array([root])
    while level.size:
        levels += 1
        c = child[level]
        c = c[c >= 0]
        level = np.concatenate([c, c + 1])
    return levels


def face_rows(a, b, c, fid) -> torch.Tensor:
    """[E, ROW] float32 rows of faces with corners a, b, c [E, 3] and arena
    ids fid [E]: a x, y, z, fid (int bits); the unit normal n x, y, z and
    s = 1 / (projected double area, 1e-30 where it is 0); the corners
    projected perpendicular to the dominant axis, (u, v) = (y, z), (x, z)
    or (x, y): b u, b v, c u, c v, a u, a v; flags (int bits: the axis |
    4 where the area is not 0); 0.  The same operations as
    ops/intersect.py::intersect_triangle's ray-independent part
    (`triangle_face`), so `intersect_face_rows` rounds as it does."""
    A, B, C = ([x[:, k] for k in range(3)] for x in (a, b, c))
    n, axis, total = triangle_face(A, B, C)
    s = 1.0 / torch.where(total == 0, 1e-30, total)

    def proj(x):
        return (torch.where(axis == 0, x[1], x[0]),
                torch.where(axis == 2, x[1], x[2]))
    flags = axis.to(torch.int32) | ((total != 0).to(torch.int32) << 2)
    return torch.stack(
        [*A, fid.to(torch.int32).view(torch.float32), *n, s, *proj(B),
         *proj(C), *proj(A), flags.view(torch.float32),
         torch.zeros_like(s)], dim=1).contiguous()


def intersect_face_rows(o, d, rows, t_prev):
    """intersect_triangle's ray-dependent part on face rows [..., ROW]
    (`face_rows`): (t, front, ba, bb, valid), t not replaced where
    invalid.  Equal bit for bit to intersect_triangle on the faces' corners
    (where valid; ba and bb everywhere)."""
    o, d = ([x[..., k] for k in range(3)] for x in (o, d))
    a = [rows[..., k] for k in range(3)]
    n = [rows[..., 4 + k] for k in range(3)]
    s = rows[..., 7]
    bu, bv, cu, cv, au, av = (rows[..., 8 + k] for k in range(6))
    flags = rows[..., 14].view(torch.int32)
    axis = flags & 3
    dz = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    pz = (o[0] - a[0]) * n[0] + (o[1] - a[1]) * n[1] + (o[2] - a[2]) * n[2]
    safe_dz = torch.where(torch.abs(dz) < 1e-7, 1e-7, dz)
    t = -pz / safe_dz
    pu = torch.where(axis == 0, o[1], o[0]) \
        + t * torch.where(axis == 0, d[1], d[0])
    pv = torch.where(axis == 2, o[1], o[2]) \
        + t * torch.where(axis == 2, d[1], d[2])
    ba = ((bu - pu) * (cv - pv) - (cu - pu) * (bv - pv)) * s
    bb = ((cu - pu) * (av - pv) - (au - pu) * (cv - pv)) * s
    bc = 1.0 - ba - bb
    valid = (torch.abs(dz) >= 1e-7) & (t > ZERO) & (t < t_prev) \
        & ((flags & 4) != 0) & (ba >= 0) & (bb >= 0) & (bc >= 0)
    return t, dz <= 0.0, ba, bb, valid


def collapse(child, bmin, bmax, eoff, ecnt, max_leaf, roots):
    """The wide tree of binary BVH arrays (numpy): (wnodes [Nw, 8 * WIDTH]
    float32, {root: its wide node}, the stack entries the wide walk needs
    at most, kids [Nw, WIDTH] int32: each child's binary node, -1 where
    unused).  A wide node starts from a binary inner node's two children
    and replaces the child with the largest surface area that is an inner
    node by its two children (in place, the first on ties) until it has
    WIDTH or only leaves; a binary leaf root makes a wide root with that
    leaf as its one child.  The children keep their binary boxes bit for
    bit; the leaves keep their faces (first element, min(count,
    max_leaf)).  Each slot's nodes follow its root depth first."""
    ext = (bmax.astype(np.float64) - bmin.astype(np.float64))
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]
    rows, kid_ids = [], []

    def make(i):
        """The wide node for binary node i, depth first: (its index, its
        stack need)."""
        if child[i] < 0:
            kids = [i]
        else:
            kids = [int(child[i]), int(child[i]) + 1]
            while len(kids) < WIDTH:
                inner = [k for k in kids if child[k] >= 0]
                if not inner:
                    break
                j = max(inner, key=lambda k: area[k])
                p = kids.index(j)
                kids[p:p + 1] = [int(child[j]), int(child[j]) + 1]
        idx = len(rows)
        rows.append(None)
        kid_ids.append(kids + [-1] * (WIDTH - len(kids)))
        words, need = [], len(kids)
        for k in kids:
            if child[k] >= 0:
                w, sub = make(k)
                need = max(need, len(kids) - 1 + sub)
            else:
                w = -(2 + (int(eoff[k]) << 8 | min(int(ecnt[k]), max_leaf)))
            words.append(w)
        row = np.zeros((8, WIDTH), np.float32)
        row[0:3, :len(kids)] = bmin[kids].T
        row[3:6, :len(kids)] = bmax[kids].T
        row[6] = np.array(words + [EMPTY] * (WIDTH - len(kids)),
                          np.int32).view(np.float32)
        row[7, 0] = np.array([len(kids)], np.int32).view(np.float32)[0]
        rows[idx] = row
        return idx, need

    stack, root_of = 1, {}
    for r in roots:
        root_of[int(r)], need = make(int(r))
        stack = max(stack, need)
    wn = np.stack([row.reshape(-1) for row in rows])
    return wn, root_of, stack, np.array(kid_ids, np.int32)


def build_walk(mesh, walk=None) -> BvhWalk:
    """The arena's BvhWalk (not kept; `bvh_walk` keeps the arena's own).
    walk: None chooses by the depth rule ("binary" where the binary tree
    has more than max_depth - 2 levels, else "wide"); "wide" or "binary"
    force one (for tests and A/B runs)."""
    if mesh.max_depth > MAX_DEPTH:
        raise ValueError(f"bvh_closest_hit: max_depth {mesh.max_depth} > "
                         f"the kernel's stack of {MAX_DEPTH}")
    if mesh.max_leaf > 255 or mesh.bvh_elems.shape[0] >= 1 << 23:
        raise ValueError("bvh_closest_hit: the leaf word holds at most "
                         "255 faces a leaf and 2^23 elements")
    child = mesh.bvh_child.cpu().numpy()
    roots = tuple(int(r) for r in mesh.slot_root.tolist())
    levels = max(tree_levels(child, r) for r in roots)
    if walk is None:
        walk = "binary" if levels > mesh.max_depth - 2 else "wide"
    head = dict(walk=walk, roots=roots, levels=levels,
                max_depth=int(mesh.max_depth))
    dev = mesh.bvh_min.device
    f = mesh.bvh_elems.to(torch.int64)
    if walk == "binary":
        n_test = torch.clamp(mesh.bvh_ecnt, max=mesh.max_leaf)
        leaf = mesh.bvh_eoff * 256 + n_test
        zero = torch.zeros((f.shape[0], 1), dtype=torch.float32, device=dev)
        return BvhWalk(**head, nodes=torch.cat(
            [mesh.bvh_min, mesh.bvh_child[:, None].view(torch.float32),
             mesh.bvh_max, leaf.to(torch.int32)[:, None].view(torch.float32)],
            dim=1).contiguous(), leaf_tris=torch.cat(
            [mesh.tri_a[f], mesh.bvh_elems[:, None].view(torch.float32),
             mesh.tri_b[f], zero, mesh.tri_c[f], zero], dim=1).contiguous())
    if walk != "wide":
        raise ValueError(f"bvh_closest_hit: no walk {walk!r}")
    wn, wide_root, stack, _ = collapse(
        child, mesh.bvh_min.cpu().numpy(), mesh.bvh_max.cpu().numpy(),
        mesh.bvh_eoff.cpu().numpy(), mesh.bvh_ecnt.cpu().numpy(),
        int(mesh.max_leaf), roots)
    if stack > LOCAL_STACK:
        raise ValueError(f"bvh_closest_hit: the wide walk needs a stack of "
                         f"{stack} entries, the kernel's holds "
                         f"{LOCAL_STACK}")
    return BvhWalk(**head, wnodes=torch.as_tensor(wn, device=dev),
                   face_rows=face_rows(mesh.tri_a[f], mesh.tri_b[f],
                                       mesh.tri_c[f], mesh.bvh_elems),
                   wide_root=wide_root, stack=stack)


def bvh_walk(mesh) -> BvhWalk:
    """The arena's BvhWalk on its device, built once and kept on it
    (mesh.bvh_walk); the BVH must exist (scene/build.py::ensure_bvh)."""
    if mesh.bvh_walk is None:
        mesh.bvh_walk = build_walk(mesh)
    return mesh.bvh_walk


def _add_stats(stats, sums, most, boxes):
    stats[:4] += torch.tensor(sums, dtype=torch.int64, device=stats.device)
    stats[4] = torch.clamp(stats[4], min=most)
    stats[5] += boxes


def bvh_closest_hit_plain(mesh, root: int, o: torch.Tensor,
                          d: torch.Tensor, t_init: torch.Tensor,
                          stats=None):
    """The plain version (see the module docstring) over the arena's BVH
    arrays and face corners.  stats: an optional int64 tensor [NSTAT] the
    walk adds its counts to."""
    n = o.shape[0]
    dev = o.device
    depth, max_leaf = int(mesh.max_depth), int(mesh.max_leaf)
    t = t_init.clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.float32, device=dev)
    ba = torch.zeros_like(front)
    bb = torch.zeros_like(front)
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stack[:, 0] = int(root)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    child_all = mesh.bvh_child.to(torch.int64)
    counts = [0] * NSTAT
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        counts[0] += act.numel()
        counts[4] += 1
        oa, da = o[act], d[act]
        spa = sp[act] - 1
        node = stack[act, spa]
        hit, _ = intersect_box_enter(oa, da, mesh.bvh_min[node],
                                     mesh.bvh_max[node], t[act])
        child = child_all[node]

        li = torch.nonzero(hit & (child < 0))[:, 0]
        if li.numel():
            rl = act[li]
            ol, dl = oa[li], da[li]
            eoff = mesh.bvh_eoff[node[li]].to(torch.int64)
            ecnt = mesh.bvh_ecnt[node[li]].to(torch.int64)
            counts[2] += li.numel()
            counts[3] += int(torch.clamp(ecnt, max=max_leaf).sum())
            emax = mesh.bvh_elems.shape[0] - 1
            tl, fl, frl, bal, bbl = t[rl], face[rl], front[rl], ba[rl], \
                bb[rl]
            for kk in range(max_leaf):
                fid = mesh.bvh_elems[torch.clamp(eoff + kk, max=emax)] \
                    .to(torch.int64)
                tt, fr, tba, tbb, valid = intersect_triangle(
                    ol, dl, mesh.tri_a[fid], mesh.tri_b[fid],
                    mesh.tri_c[fid], tl)
                upd = valid & (kk < ecnt)
                tl = torch.where(upd, tt, tl)
                fl = torch.where(upd, fid.to(torch.int32), fl)
                frl = torch.where(upd, fr.to(torch.float32), frl)
                bal = torch.where(upd, tba, bal)
                bbl = torch.where(upd, tbb, bbl)
            t[rl], face[rl], front[rl], ba[rl], bb[rl] = tl, fl, frl, bal, \
                bbl

        ii = torch.nonzero(hit & (child >= 0))[:, 0]
        if ii.numel():
            counts[1] += ii.numel()
            oi, di = oa[ii], da[ii]
            c1 = child[ii]
            c2 = c1 + 1
            tb = t[act[ii]]
            _, e1 = intersect_box_enter(oi, di, mesh.bvh_min[c1],
                                        mesh.bvh_max[c1], tb)
            _, e2 = intersect_box_enter(oi, di, mesh.bvh_min[c2],
                                        mesh.bvh_max[c2], tb)
            first = e1 <= e2
            near = torch.where(first, c1, c2)
            far = torch.where(first, c2, c1)
            ri = act[ii]
            s = spa[ii]
            stack[ri, torch.clamp(s, max=depth - 1)] = far
            s = torch.clamp(s + 1, max=depth - 1)
            stack[ri, torch.clamp(s, max=depth - 1)] = near
            spa[ii] = torch.clamp(s + 1, max=depth - 1)
        sp[act] = spa
    if stats is not None:
        _add_stats(stats, counts[:4], counts[4], counts[0] + 2 * counts[1])
    return t, face, front, ba, bb


def _slab(o, inv, lo, hi, t_max):
    """intersect_box_enter's slab test of rays o, inv [M, 3] against each
    of `width` boxes lo, hi [M, 3, width]: (hit, inside, tenter) [M, width],
    in the kernel's order of min and max."""
    t0 = [(lo[:, k] - o[:, k, None]) * inv[:, k, None] for k in range(3)]
    t1 = [(hi[:, k] - o[:, k, None]) * inv[:, k, None] for k in range(3)]
    mn = [torch.minimum(x, y) for x, y in zip(t0, t1)]
    mx = [torch.maximum(x, y) for x, y in zip(t0, t1)]
    tenter = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    texit = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    inside = torch.ones_like(tenter, dtype=torch.bool)
    for k in range(3):
        inside &= (o[:, k, None] >= lo[:, k]) & (o[:, k, None] <= hi[:, k])
    hit = inside | ((tenter <= texit) & (texit >= 0.0)
                    & (tenter <= t_max[:, None]))
    return hit, inside, tenter


def bvh_wide_closest_hit_plain(walk: BvhWalk, root: int, o: torch.Tensor,
                               d: torch.Tensor, t_init: torch.Tensor,
                               stats=None):
    """The wide walk's plain twin (the module docstring), over a "wide"
    BvhWalk on the rays' device: per ray, pop the top entry (a wide node or
    a leaf, and its key: -inf where the ray's origin was inside its box,
    else its entry distance); skip it unless key == -inf or key <= the best
    t; a leaf tests its faces in order (`intersect_face_rows`, the best t
    updated face by face); a wide node tests its children's boxes against
    the best t and pushes those hit (with a key below +inf) with their
    keys, sorted by key (ties to the first slot), far to near.  Lock step
    over the rays, one pop a step.  stats: an optional int64 tensor
    [NSTAT] the walk adds its counts to."""
    if walk.walk != "wide":
        raise ValueError("bvh_wide_closest_hit_plain needs the wide walk")
    n, dev, W = o.shape[0], o.device, WIDTH
    wn = walk.wnodes.view(-1, 8, W)
    words = wn[:, 6].view(torch.int32).to(torch.int64)
    nkids = wn[:, 7, 0].view(torch.int32).to(torch.int64)
    rows = walk.face_rows
    emax = rows.shape[0] - 1
    t = t_init.clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.float32, device=dev)
    ba, bb = torch.zeros_like(front), torch.zeros_like(front)
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)
    inf = float("inf")
    st_w = torch.zeros((n, walk.stack), dtype=torch.int64, device=dev)
    st_k = torch.zeros((n, walk.stack), dtype=torch.float32, device=dev)
    st_w[:, 0] = walk.wide_root[int(root)]
    st_k[:, 0] = -inf
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    slot = torch.arange(W, device=dev)
    counts = [0] * NSTAT
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        counts[0] += act.numel()
        counts[4] += 1
        spa = sp[act] - 1
        w, key = st_w[act, spa], st_k[act, spa]
        sp[act] = spa
        ok = (key == -inf) | (key <= t[act])

        ii = torch.nonzero(ok & (w >= 0))[:, 0]
        if ii.numel():
            r, node = act[ii], w[ii]
            counts[1] += ii.numel()
            counts[5] += int(nkids[node].sum())
            hit, inside, tenter = _slab(o[r], inv[r], wn[node, 0:3],
                                        wn[node, 3:6], t[r])
            hit &= slot[None, :] < nkids[node][:, None]
            k = torch.where(hit, torch.where(inside, -inf, tenter), inf)
            k, perm = torch.sort(k, dim=1, stable=True)
            hs = k != inf
            ws = words[node].gather(1, perm)
            s = sp[r]
            for j in reversed(range(W)):
                m = torch.nonzero(hs[:, j])[:, 0]
                st_w[r[m], s[m]] = ws[m, j]
                st_k[r[m], s[m]] = k[m, j]
                s[m] += 1
            sp[r] = s

        li = torch.nonzero(ok & (w <= -2))[:, 0]
        if li.numel():
            r = act[li]
            payload = -(w[li] + 2)
            first, cnt = payload >> 8, payload & 255
            counts[2] += li.numel()
            counts[3] += int(cnt.sum())
            ol, dl = o[r], d[r]
            tl, fl, frl, bal, bbl = t[r], face[r], front[r], ba[r], bb[r]
            for kk in range(int(cnt.max())):
                fr_ = rows[torch.clamp(first + kk, max=emax)]
                tt, fr, tba, tbb, valid = intersect_face_rows(ol, dl, fr_, tl)
                upd = valid & (kk < cnt)
                tl = torch.where(upd, tt, tl)
                fl = torch.where(upd, fr_[:, 3].view(torch.int32), fl)
                frl = torch.where(upd, fr.to(torch.float32), frl)
                bal = torch.where(upd, tba, bal)
                bbl = torch.where(upd, tbb, bbl)
            t[r], face[r], front[r], ba[r], bb[r] = tl, fl, frl, bal, bbl
    if stats is not None:
        _add_stats(stats, counts[:4], counts[4], counts[5])
    return t, face, front, ba, bb


def near_ties(mesh, o, d, got, ref, ulps=4):
    """The rays where two walks' outputs got and ref ((t, face, front, ba,
    bb) on rays o, d) differ: (idx, tie), tie True where both faces hit
    (intersect_triangle alone, no cap) and both walks' t lie within `ulps`
    ulp of the got walk's t: a near tie, which walks that test faces in
    another order may settle either way.  For tests and chip_smoke.py."""
    differ = torch.zeros_like(got[1], dtype=torch.bool)
    for g, r in zip(got, ref):
        differ |= g != r
    idx = torch.nonzero(differ)[:, 0]
    t = got[0][idx]
    ulp = torch.nextafter(t.abs(), torch.full_like(t, float("inf"))) \
        - t.abs()
    tie = (got[1][idx] >= 0) & (ref[1][idx] >= 0) \
        & ((ref[0][idx] - t).abs() <= ulps * ulp)
    for face in (got[1][idx], ref[1][idx]):
        f = face.clamp(min=0).to(torch.int64)
        tt, _, _, _, valid = intersect_triangle(
            o[idx], d[idx], mesh.tri_a[f], mesh.tri_b[f], mesh.tri_c[f],
            torch.full_like(t, 1e30))
        tie &= valid & ((tt - t).abs() <= ulps * ulp)
    return idx, tie


def bvh_closest_hit(mesh, root: int, o: torch.Tensor, d: torch.Tensor,
                    t_init: torch.Tensor, stats=None):
    """Closest hit of local rays o, d [N, 3] float32 (rows of one stride,
    unit column stride) below t_init [N] against the BVH rooted at node
    `root` of the arena `mesh` (the slot's scene.mesh.slot_root entry).
    Launches the walk `bvh_walk(mesh)` chose for CUDA tensors (`launch_walk`;
    a build or launch failure raises), or runs `bvh_closest_hit_plain` for
    CPU tensors.  Returns (t, face int32, front 0/1, ba, bb), each [N].

    stats: optional int64 tensor [NSTAT] on the rays' device that the walk
    adds its counts to (slot 4 takes the maximum)."""
    if o.device.type == "cpu":
        return bvh_closest_hit_plain(mesh, root, o, d, t_init, stats)
    if o.device.type != "cuda":
        raise ValueError(f"bvh_closest_hit: unsupported device {o.device}")
    return launch_walk(bvh_walk(mesh), root, o, d, t_init, stats)


def launch_walk(walk: BvhWalk, root, o, d, t_init, stats=None):
    """Launch csrc/bvh_hit.cu's walk of `walk` (a BvhWalk on the rays'
    CUDA device) and count it."""
    n = o.shape[0]
    dev = o.device
    for name, x in (("o", o), ("d", d), ("t_init", t_init)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"bvh_closest_hit: {name} must be float32 on "
                             f"{dev}")
    if tuple(o.shape) != (n, 3) or tuple(d.shape) != (n, 3) \
            or o.stride() != d.stride() or o.stride(1) != 1 \
            or tuple(t_init.shape) != (n,):
        raise ValueError("bvh_closest_hit: o and d must be [N, 3] rows of "
                         "one stride, unit column stride, and t_init [N]")
    wide = walk.walk == "wide"
    fn, tree = ("rtf_bvh_wide_launch", (
        walk.wnodes, walk.face_rows, walk.wide_root.get(int(root)),
        walk.stack)) if wide else ("rtf_bvh_hit_launch", (
            walk.nodes, walk.leaf_tris, int(root), walk.max_depth))
    if tree[0].device != dev:
        raise ValueError(f"bvh_closest_hit: the BVH lives on "
                         f"{tree[0].device}, the rays on {dev}")
    if int(root) not in walk.roots:
        raise ValueError(f"bvh_closest_hit: node {root} is no slot's root")
    _build.check_stats("bvh_closest_hit", stats, NSTAT, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    front, ba, bb = (torch.empty_like(t) for _ in range(3))
    _build.launch("bvh_hit", fn, dev, o, d, o.stride(0), t_init,
                  t_init.stride(0), n, *tree, t, face, front, ba, bb, stats)
    tracing.count("launches.bvh_closest_hit" if wide
                  else "launches.bvh_closest_hit.binary")
    return t, face, front, ba, bb
