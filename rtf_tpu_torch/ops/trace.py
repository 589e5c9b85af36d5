"""Wavefront scene tracing: closest hit over all instance groups
(rtf_tpu/ops/trace.py).

Spheres and planes: one broadcast intersection of the whole wavefront
against every instance of the group ([N rays, I instances]), then a min-t
reduction over instances.  Meshes: per mesh instance, the rays go to the
instance's local space and through the scene's mesh_algo:
* "auto" (and rtf_tpu's names "pallas", "pallas_interpret"):
  ops/mesh_hit.py::mesh_closest_hit_rays over the instance's slot of the
  packed triangle table, what rtf_tpu takes on its accelerator;
* "bvh": ops/bvh_hit.py::bvh_closest_hit over the slot's BVH (built at the
  first such trace, scene/build.py::ensure_bvh);
* "dense": `_dense_mesh`, every face of the slot in tiles, rtf_tpu's
  default on the CPU; torch ops on any device.
On the card the first two launch their CUDA kernels, on the CPU they run
their plain versions.  Hit attributes are reconstructed once, for the
winning primitive only; `footprint_duv` gives a primary hit's texture
footprint for filtering.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from rtf_tpu_torch.core.math import (
    BIGFLOAT, cross, dot, mat3_apply, mat3_apply_batched, normalize,
)
from rtf_tpu_torch.ops.intersect import (
    intersect_plane, intersect_sphere, intersect_triangle, plane_attributes,
    sphere_attributes,
)
from rtf_tpu_torch.ops import bvh_hit, mesh_hit
from rtf_tpu_torch.ops.texture import _sel_rows
from rtf_tpu_torch.scene.build import ensure_bvh

KIND_NONE, KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2, 3
# scene.mesh_algo values: the first three run ops/mesh_hit.py::
# mesh_closest_hit, "bvh" ops/bvh_hit.py, "dense" `_dense_mesh`
MESH_ALGOS = ("auto", "pallas", "pallas_interpret", "bvh", "dense")
# ray x face elements of one `_dense_mesh` step: torch does not fuse its
# [rays, faces] temporaries, so the rays go in chunks
_DENSE_CHUNK = 1 << 23


@dataclass
class Hit:
    """SoA hit record (HitInfo, scene.h:151-164, minus cached attributes)."""
    t: torch.Tensor        # [N] float32, BIGFLOAT = miss
    kind: torch.Tensor     # [N] int32
    inst: torch.Tensor     # [N] int32 group-local instance id
    face: torch.Tensor     # [N] int32 arena face id (meshes)
    ba: torch.Tensor       # [N] barycentric a (meshes)
    bb: torch.Tensor       # [N] barycentric b (meshes)
    front: torch.Tensor    # [N] bool

    @property
    def is_hit(self):
        return self.kind != KIND_NONE


def _empty_hit(n: int, device) -> Hit:
    return Hit(
        t=torch.full((n,), BIGFLOAT, dtype=torch.float32, device=device),
        kind=torch.zeros(n, dtype=torch.int32, device=device),
        inst=torch.zeros(n, dtype=torch.int32, device=device),
        face=torch.zeros(n, dtype=torch.int32, device=device),
        ba=torch.zeros(n, dtype=torch.float32, device=device),
        bb=torch.zeros(n, dtype=torch.float32, device=device),
        front=torch.ones(n, dtype=torch.bool, device=device))


def _to_local(itm, pos, o, d):
    """World ray -> instance local ray (ToNodeCoords, scene.h:502-508)."""
    return mat3_apply(itm, o - pos), mat3_apply(itm, d)


def _scan_group(group, o, d, hit: Hit, kind_code: int, intersect_fn) -> Hit:
    """Intersect the wavefront against every instance of a group at once:
    [N rays, I instances] broadcast, then a min-t reduction over I (the
    first instance among ties)."""
    if group.itm.shape[0] == 0:
        return hit
    rel = o[:, None, :] - group.pos[None, :, :]
    lo = (group.itm[None] * rel[:, :, None, :]).sum(-1)
    ld = (group.itm[None] * d[:, None, None, :]).sum(-1)
    tt, fr, valid = intersect_fn(lo, ld, hit.t[:, None])
    tt = torch.where(valid, tt, BIGFLOAT)
    j = torch.argmin(tt, dim=1)
    t_min = tt.gather(1, j[:, None])[:, 0]
    upd = t_min < hit.t
    return dataclasses.replace(
        hit, t=torch.where(upd, t_min, hit.t),
        kind=torch.where(upd, kind_code, hit.kind),
        inst=torch.where(upd, j.to(torch.int32), hit.inst),
        front=torch.where(upd, fr.gather(1, j[:, None])[:, 0], hit.front))


def _dense_mesh(mesh, o, d, t_init, face_init, front_init, ba_init,
                bb_init, face_range: tuple, tile: int = 512,
                chunk: int = None):
    """Dense tiled mesh intersection of rays already in the instance's
    local space (rtf_tpu/ops/trace.py::_dense_mesh): every ray against
    every face of the arena range `face_range`, in tiles of max(8, min(
    tile, F)) faces padded with degenerate faces that never validate,
    keeping per ray the least t (the first face among a tile's ties, as
    argmin).  Returns (t, face, front, ba, bb), the init values where no
    face beats t_init.  The rays go `chunk` at a time (default: as many as
    keep a [rays, tile] temporary within _DENSE_CHUNK elements), which
    changes no ray's result."""
    f0, f1 = face_range
    tris = [x[f0:f1] for x in (mesh.tri_a, mesh.tri_b, mesh.tri_c)]
    nf = f1 - f0
    t = max(8, min(tile, nf))
    pad = (-nf) % t
    if pad:
        tris = [torch.cat([x, x.new_zeros((pad, 3))]) for x in tris]
    ntiles = (nf + pad) // t
    step = chunk or max(1, _DENSE_CHUNK // t)
    out = [x.clone() for x in (t_init, face_init, front_init, ba_init,
                               bb_init)]
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        t_best, face, front, ba, bb = (x[sl] for x in out)
        o_b, d_b = o[sl, None, :], d[sl, None, :]
        for tix in range(ntiles):
            at, bt, ct = (x[None, tix * t:(tix + 1) * t] for x in tris)
            tt, fr, tba, tbb, valid = intersect_triangle(
                o_b, d_b, at, bt, ct, t_best[:, None])
            tt = torch.where(valid, tt, BIGFLOAT)
            j = torch.argmin(tt, dim=1, keepdim=True)
            t_min = tt.gather(1, j)[:, 0]
            upd = t_min < t_best
            t_best = torch.where(upd, t_min, t_best)
            face = torch.where(upd, (f0 + tix * t + j[:, 0])
                               .to(face.dtype), face)
            front = torch.where(upd, fr.gather(1, j)[:, 0], front)
            ba = torch.where(upd, tba.gather(1, j)[:, 0], ba)
            bb = torch.where(upd, tbb.gather(1, j)[:, 0], bb)
        for x, v in zip(out, (t_best, face, front, ba, bb)):
            x[sl] = v
    return tuple(out)


def _bvh_root(mesh, slot: int) -> int:
    """The BVH root node of a mesh slot (the arena's slot_root), read
    from the host copy kept with the kernel's tables on the card."""
    if mesh.slot_root.device.type == "cpu":
        return int(mesh.slot_root[slot])
    return bvh_hit.bvh_walk(mesh).roots[slot]


def _mesh_instances(scene, o, d, hit: Hit) -> Hit:
    """Closest mesh hit, one closest-hit call per mesh instance by the
    scene's mesh_algo."""
    algo = scene.mesh_algo
    if algo not in MESH_ALGOS:
        raise NotImplementedError(
            f"mesh_algo={algo!r} is not a mesh algorithm (the port runs "
            f"{', '.join(MESH_ALGOS)})")
    mesh = scene.mesh
    if algo == "bvh":
        ensure_bvh(mesh)
    nr = o.shape[0]
    perm = mesh.tri_perm.to(torch.int64)
    for i, slot in enumerate(scene.mesh_inst_slots):
        lo, ld = _to_local(scene.mesh_inst.itm[i], scene.mesh_inst.pos[i],
                           o, d)
        if algo == "bvh":
            t, face_a, fr, ba, bb = bvh_hit.bvh_closest_hit(
                mesh, _bvh_root(mesh, slot), lo, ld, hit.t)
            front = fr > 0.5
        elif algo == "dense":
            t, face_a, front, ba, bb = _dense_mesh(
                mesh, lo, ld, hit.t, hit.face, hit.front, hit.ba, hit.bb,
                mesh.slot_faces[slot])
        else:
            col0, fpad, ar0, nt, _ = mesh.slot_pack[slot]
            tp, face_p, fr_p, ba_p, bb_p = mesh_hit.mesh_closest_hit_rays(
                lo, ld, hit.t, mesh.tri_packed[:, col0:col0 + fpad],
                mesh.tile_aabb[ar0:ar0 + nt], face0=col0,
                tree=mesh.hit_tree, slot=slot)
            got = face_p[:nr] >= 0
            # packed (Morton) id -> arena face id
            face_a = perm[torch.clamp(face_p[:nr].to(torch.int64), 0,
                                      perm.shape[0] - 1)].to(torch.int32)
            t = torch.where(got, tp[:nr], BIGFLOAT)
            front, ba, bb = fr_p[:nr] > 0.5, ba_p[:nr], bb_p[:nr]
        upd = t < hit.t
        hit = Hit(
            t=torch.where(upd, t, hit.t),
            kind=torch.where(upd, KIND_MESH, hit.kind),
            inst=torch.where(upd, i, hit.inst),
            face=torch.where(upd, face_a, hit.face),
            ba=torch.where(upd, ba, hit.ba),
            bb=torch.where(upd, bb, hit.bb),
            front=torch.where(upd, front, hit.front))
    return hit


def trace(scene, o: torch.Tensor, d: torch.Tensor) -> Hit:
    """Closest hit of world rays (o, d) [N,3] against the whole scene."""
    hit = _empty_hit(o.shape[0], o.device)
    zero, tb, mr = (float(scene.isect_zero), bool(scene.ref_exact),
                    bool(scene.sphere_minroot))
    hit = _scan_group(scene.spheres, o, d, hit, KIND_SPHERE,
                      lambda lo, ld, tp: intersect_sphere(
                          lo, ld, tp, zero=zero, textbook=tb, minroot=mr))
    hit = _scan_group(scene.planes, o, d, hit, KIND_PLANE, intersect_plane)
    if scene.mesh is not None and scene.num_mesh_inst > 0:
        hit = _mesh_instances(scene, o, d, hit)
    return hit


@dataclass
class Surface:
    """Full shading-ready hit attributes (the rest of HitInfo)."""
    p: torch.Tensor      # [N,3] world hit position
    n: torch.Tensor      # [N,3] world shading normal (normalized)
    uvw: torch.Tensor    # [N,3] texture coords
    mtl: torch.Tensor    # [N] int32 global material id
    front: torch.Tensor  # [N] bool
    t: torch.Tensor      # [N]
    valid: torch.Tensor  # [N] bool


def resolve_surface(scene, o, d, hit: Hit) -> Surface:
    """Reconstruct p/N/uvw/material for the winning primitive
    (FromNodeCoords + per-object attribute code, scene.h:509-513)."""
    n_rays = o.shape[0]
    # missed lanes get a far sentinel position (rtf_tpu keeps dead lanes'
    # shadow and GI rays in blocks its kernel culls)
    p_world = torch.where(hit.is_hit[:, None],
                          o + hit.t[..., None] * d, 1.0e7)
    nrm_w = torch.zeros((n_rays, 3), dtype=o.dtype, device=o.device)
    uvw = torch.full((n_rays, 3), 0.5, dtype=o.dtype, device=o.device)
    mtl = torch.zeros(n_rays, dtype=torch.int32, device=o.device)

    def group_attrs(group, attr_fn):
        itm = _sel_rows(group.itm, hit.inst)
        lo = mat3_apply_batched(itm, o - _sel_rows(group.pos, hit.inst))
        ld = mat3_apply_batched(itm, d)
        _, ln, luv = attr_fn(lo, ld, hit.t)
        wn = normalize(mat3_apply_batched(_sel_rows(group.nrm, hit.inst),
                                          ln))
        return wn, luv, _sel_rows(group.mtl, hit.inst)

    for num, group, attr_fn, kind in (
            (scene.num_spheres, scene.spheres, sphere_attributes,
             KIND_SPHERE),
            (scene.num_planes, scene.planes, plane_attributes, KIND_PLANE)):
        if num > 0:
            wn, luv, m = group_attrs(group, attr_fn)
            mask = hit.kind == kind
            nrm_w = torch.where(mask[:, None], wn, nrm_w)
            uvw = torch.where(mask[:, None], luv, uvw)
            mtl = torch.where(mask, m, mtl)

    if scene.mesh is not None and scene.num_mesh_inst > 0:
        mesh = scene.mesh
        f = hit.face.to(torch.int64)
        ba = hit.ba[:, None]
        bb = hit.bb[:, None]
        bc = 1.0 - ba - bb
        an = mesh.attr_n[f]                       # [N,16]
        at = mesh.attr_t[f]
        ln = an[:, 0:3] * ba + an[:, 3:6] * bb + an[:, 6:9] * bc
        luv = at[:, 0:3] * ba + at[:, 3:6] * bb + at[:, 6:9] * bc
        wn = normalize(mat3_apply_batched(
            _sel_rows(scene.mesh_inst.nrm, hit.inst), ln))
        mask = (hit.kind == KIND_MESH)[:, None]
        nrm_w = torch.where(mask, wn, nrm_w)
        uvw = torch.where(mask, luv, uvw)
        mtl = torch.where(hit.kind == KIND_MESH, an[:, 9].to(torch.int32),
                          mtl)
        # the mesh hit POINT from the barycentric vertex combination in
        # node space, pushed to world through the forward transform (the
        # reference's alpha*A + beta*B + gamma*C + FromNodeCoords, Proj13
        # objects.h:199, scene.h:509-513): on the surface at any incidence
        p_node = mesh.tri_a[f] * ba + mesh.tri_b[f] * bb + mesh.tri_c[f] * bc
        pw = mat3_apply_batched(_sel_rows(scene.mesh_inst.tm, hit.inst),
                                p_node) \
            + _sel_rows(scene.mesh_inst.pos, hit.inst)
        p_world = torch.where(mask & hit.is_hit[:, None], pw, p_world)

    return Surface(p=p_world, n=nrm_w, uvw=uvw, mtl=mtl, front=hit.front,
                   t=hit.t, valid=hit.is_hit)


def footprint_duv(scene, o, d, hit: Hit, surf: Surface, xang: float,
                  yang: float):
    """Texture-space footprint derivatives (duv0, duv1), each [N,2]
    (rtf_tpu/ops/trace.py::footprint_duv, the analog of the reference's
    disabled `calculateduvw`, RayTracingProj7 objects.h:81-87, :152-158):
    the pixel's angular extent (xang, yang: per-pixel width and height at
    unit distance) projected onto the hit's tangent plane,
    f0 = t * yang * normalize(d x N), f1 = t * xang * normalize((d x N) x
    N) stretched by 1 / max(|N.d|, 0.05) at grazing incidence, then taken
    to uv space by each primitive's parameterization (plane uv =
    (local.xy + 1) / 2, the sphere's angular map, a mesh face's uv
    density, attr_t[:, 9]).  Head-on rays (d parallel to N) take any
    tangent frame of N.  Zero where nothing was hit."""
    n_rays = o.shape[0]
    nw = surf.n
    yhat = cross(d, nw)
    ylen = torch.linalg.vector_norm(yhat, dim=-1, keepdim=True)
    alt = torch.where(torch.abs(nw[:, :1]) < 0.9,
                      torch.tensor([1.0, 0.0, 0.0], device=o.device),
                      torch.tensor([0.0, 1.0, 0.0], device=o.device))
    fallback = normalize(cross(nw, alt))
    yhat = torch.where(ylen > 1e-6, yhat / torch.clamp(ylen, min=1e-12),
                       fallback)
    xhat = normalize(cross(yhat, nw))
    t = hit.t[:, None]
    stretch = 1.0 / torch.clamp(torch.abs(dot(d, nw))[:, None], min=0.05)
    f0 = t * yang * yhat
    f1 = t * xang * xhat * stretch
    duv0 = torch.zeros((n_rays, 2), dtype=o.dtype, device=o.device)
    duv1 = torch.zeros_like(duv0)

    def local_pair(group):
        itm = _sel_rows(group.itm, hit.inst)
        return mat3_apply_batched(itm, f0), mat3_apply_batched(itm, f1)

    if scene.num_planes > 0:
        lf0, lf1 = local_pair(scene.planes)
        m = (hit.kind == KIND_PLANE)[:, None]
        duv0 = torch.where(m, lf0[:, :2] * 0.5, duv0)
        duv1 = torch.where(m, lf1[:, :2] * 0.5, duv1)

    if scene.num_spheres > 0:
        itm = _sel_rows(scene.spheres.itm, hit.inst)
        lp = mat3_apply_batched(
            itm, surf.p - _sel_rows(scene.spheres.pos, hit.inst))
        lf0, lf1 = local_pair(scene.spheres)
        r2xy = torch.clamp(lp[:, 0] ** 2 + lp[:, 1] ** 2, min=1e-8)
        vden = math.pi * torch.sqrt(torch.clamp(1.0 - lp[:, 2] ** 2,
                                                min=1e-8))

        def sph_duv(lf):
            du = (lp[:, 0] * lf[:, 1] - lp[:, 1] * lf[:, 0]) \
                / (2.0 * math.pi * r2xy)
            return torch.stack([du, lf[:, 2] / vden], dim=-1)

        m = (hit.kind == KIND_SPHERE)[:, None]
        duv0 = torch.where(m, sph_duv(lf0), duv0)
        duv1 = torch.where(m, sph_duv(lf1), duv1)

    if scene.mesh is not None and scene.num_mesh_inst > 0:
        lf0, lf1 = local_pair(scene.mesh_inst)
        uvscale = scene.mesh.attr_t[hit.face.to(torch.int64), 9]
        s0 = torch.linalg.vector_norm(lf0, dim=-1) * uvscale
        s1 = torch.linalg.vector_norm(lf1, dim=-1) * uvscale
        z = torch.zeros_like(s0)
        m = (hit.kind == KIND_MESH)[:, None]
        duv0 = torch.where(m, torch.stack([s0, z], -1), duv0)
        duv1 = torch.where(m, torch.stack([z, s1], -1), duv1)

    ok = surf.valid[:, None]
    return torch.where(ok, duv0, 0.0), torch.where(ok, duv1, 0.0)


def trace_shadow(scene, o: torch.Tensor, d: torch.Tensor,
                 t_max) -> torch.Tensor:
    """Shadow factor: 1.0 lit, 0.0 occluded (GenLight::Shadow,
    Final/main.cpp:499-513; bias 1e-14, hit must satisfy bias < z <
    t_max), by a full closest-hit trace as in rtf_tpu.  `d` may be
    unnormalized: t is in units of |d| like the reference."""
    hit = trace(scene, o, d)
    occluded = hit.is_hit & (hit.t > 1e-14) & (hit.t < t_max)
    return torch.where(occluded, 0.0, 1.0)
