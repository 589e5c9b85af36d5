"""Closest hit of local-space rays against one mesh instance's BVH: the
plain PyTorch version and the CUDA kernel's wrapper.

The port of rtf_tpu/ops/trace.py::bvh_traverse, the lock-step walk that
mesh_algo="bvh" takes over the arena's per-slot BVH (scene/build.py::
ensure_bvh).  It reaches no pallas_call in rtf_tpu: there it is one XLA
while_loop.  Both versions return (t, face, front, ba, bb), each [N]:
face is the arena face id, -1 where no face beats t_init (t is then
t_init, front, ba and bb zero); front is 0/1 in float32.

`bvh_closest_hit_plain` is bvh_traverse step for step in torch ops: each
step pops one node per ray with a non-empty stack, tests its box against
the ray's best t, tests a leaf's faces (at most max_leaf, the best t
updated face by face) or pushes an inner node's far child, then its near
one (near: the child whose box the ray enters first, ties to the first
child), the stack pointer clamped at max_depth - 1.  Only the rays whose
stack is not empty take part in a step; that changes no ray's sequence of
tests.  `bvh_closest_hit` launches csrc/bvh_hit.cu for CUDA tensors, one
thread per ray with the same pops, tests and pushes, and runs the plain
version for CPU tensors.  Each ray's sequence of tests does not depend on
the other rays, and the kernel rounds as torch does (--fmad=false, IEEE
division and square root), so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from rtf_tpu_torch.ops.intersect import intersect_box_enter, intersect_triangle

# kernel launches made by `bvh_closest_hit` (the plain version never counts)
launches = 0
# work counters: nodes popped (one box test each), inner nodes entered
# (two child box tests each), leaves entered, ray-face tests, and the
# most pops of one ray (the plain version's step count)
NSTAT = 5
MAX_DEPTH = 32     # the kernel's stack, ints per thread


@dataclass
class BvhWalk:
    """What csrc/bvh_hit.cu reads of an arena's BVH: nodes [N, 8] float32,
    two 16-byte rows a node (bmin and the first child's id as int bits;
    bmax and the leaf word, its first element << 8 | the faces it tests,
    min(count, max_leaf), as int bits), and leaf_tris [E, 12] float32, the
    faces in leaf order (bvh_elems), three 16-byte rows a face (corner a
    and the arena face id as int bits, b, c); roots: slot_root on the
    host."""
    nodes: torch.Tensor
    leaf_tris: torch.Tensor
    max_depth: int
    roots: tuple


def bvh_walk(mesh) -> BvhWalk:
    """The arena's BvhWalk on its device, built once and kept on it
    (mesh.bvh_walk); the BVH must exist (scene/build.py::ensure_bvh)."""
    if mesh.bvh_walk is not None:
        return mesh.bvh_walk
    if mesh.max_depth > MAX_DEPTH:
        raise ValueError(f"bvh_closest_hit: max_depth {mesh.max_depth} > "
                         f"the kernel's stack of {MAX_DEPTH}")
    if mesh.max_leaf > 255 or mesh.bvh_elems.shape[0] >= 1 << 23:
        raise ValueError("bvh_closest_hit: the leaf word holds at most "
                         "255 faces a leaf and 2^23 elements")
    n_test = torch.clamp(mesh.bvh_ecnt, max=mesh.max_leaf)
    leaf = mesh.bvh_eoff * 256 + n_test
    nodes = torch.cat([mesh.bvh_min, mesh.bvh_child[:, None]
                       .view(torch.float32), mesh.bvh_max,
                       leaf.to(torch.int32)[:, None].view(torch.float32)],
                      dim=1)
    f = mesh.bvh_elems.to(torch.int64)
    zero = torch.zeros((f.shape[0], 1), dtype=torch.float32,
                       device=f.device)
    tris = torch.cat([mesh.tri_a[f], mesh.bvh_elems[:, None]
                      .view(torch.float32), mesh.tri_b[f], zero,
                      mesh.tri_c[f], zero], dim=1)
    mesh.bvh_walk = BvhWalk(nodes=nodes.contiguous(),
                            leaf_tris=tris.contiguous(),
                            max_depth=int(mesh.max_depth),
                            roots=tuple(mesh.slot_root.tolist()))
    return mesh.bvh_walk


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
        stats[:4] += torch.tensor(counts[:4], dtype=torch.int64,
                                  device=stats.device)
        stats[4] = torch.clamp(stats[4], min=counts[4])
    return t, face, front, ba, bb


def bvh_closest_hit(mesh, root: int, o: torch.Tensor, d: torch.Tensor,
                    t_init: torch.Tensor, stats=None):
    """Closest hit of local rays o, d [N, 3] float32 (rows of one stride,
    unit column stride) below t_init [N] against the BVH rooted at node
    `root` of the arena `mesh` (the slot's scene.mesh.slot_root entry).
    Launches csrc/bvh_hit.cu for CUDA tensors (counted in `launches`; a
    build or launch failure raises), or runs `bvh_closest_hit_plain` for
    CPU tensors.  Returns (t, face int32, front 0/1, ba, bb), each [N].

    stats: optional int64 tensor [NSTAT] on the rays' device that the walk
    adds its counts to (slot 4 takes the maximum)."""
    if o.device.type == "cpu":
        return bvh_closest_hit_plain(mesh, root, o, d, t_init, stats)
    return _launch(mesh, root, o, d, t_init, stats)


def _launch(mesh, root, o, d, t_init, stats):
    global launches
    if o.device.type != "cuda":
        raise ValueError(f"bvh_closest_hit: unsupported device {o.device}")
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
    walk = bvh_walk(mesh)
    for name in ("nodes", "leaf_tris"):
        x = getattr(walk, name)
        if x.device != dev or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"bvh_closest_hit: the BVH's {name} must be "
                             f"contiguous and 16-byte aligned on {dev}")
    if not 0 < int(root) < walk.nodes.shape[0]:
        raise ValueError(f"bvh_closest_hit: no node {root}")
    if stats is not None and (stats.device != dev
                              or stats.dtype != torch.int64
                              or stats.numel() < NSTAT):
        raise ValueError(f"bvh_closest_hit: stats must be an int64 "
                         f"[{NSTAT}] tensor on {dev}")
    from rtf_tpu_torch import _build
    lib = _build.load("bvh_hit")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    front, ba, bb = (torch.empty_like(t) for _ in range(3))

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rtf_bvh_hit_launch(
            ptr(o), ptr(d), o.stride(0), ptr(t_init), t_init.stride(0), n,
            ptr(walk.nodes), ptr(walk.leaf_tris), int(root), walk.max_depth,
            ptr(t), ptr(face), ptr(front), ptr(ba), ptr(bb),
            ctypes.c_void_p(0) if stats is None else ptr(stats),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"bvh_closest_hit kernel launch failed: "
                           f"{_build.error_string(rc, 'bvh_hit')} ({rc})")
    launches += 1
    return t, face, front, ba, bb
