"""Wavefront scene tracing: closest hit over all instance groups
(rtf_tpu/ops/trace.py).

Spheres and planes: one broadcast intersection of the whole wavefront
against every instance of the group ([N rays, I instances]), then a min-t
reduction over instances.  Meshes: per mesh instance, the rays go to the
instance's local space and through ops/mesh_hit.py::mesh_closest_hit_rays
over the instance's slot of the packed triangle table (the CUDA kernel on
the card, its plain version on the CPU).  Hit attributes are reconstructed
once, for the winning primitive only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from rtf_tpu_torch.core.math import (
    BIGFLOAT, mat3_apply, mat3_apply_batched, normalize,
)
from rtf_tpu_torch.ops.intersect import (
    intersect_plane, intersect_sphere, plane_attributes, sphere_attributes,
)
from rtf_tpu_torch.ops import mesh_hit
from rtf_tpu_torch.ops.texture import _sel_rows

KIND_NONE, KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2, 3
# scene.mesh_algo values that run ops/mesh_hit.py::mesh_closest_hit
MESH_ALGOS = ("auto", "pallas", "pallas_interpret")


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


def _mesh_instances(scene, o, d, hit: Hit) -> Hit:
    """Closest mesh hit, one mesh_closest_hit call per mesh instance."""
    algo = scene.mesh_algo
    if algo not in MESH_ALGOS:
        raise NotImplementedError(
            f"mesh_algo={algo!r} is not ported (the port runs "
            f"{', '.join(MESH_ALGOS)})")
    mesh = scene.mesh
    nr = o.shape[0]
    perm = mesh.tri_perm.to(torch.int64)
    for i, slot in enumerate(scene.mesh_inst_slots):
        lo, ld = _to_local(scene.mesh_inst.itm[i], scene.mesh_inst.pos[i],
                           o, d)
        col0, fpad, ar0, nt, _ = mesh.slot_pack[slot]
        tp, face_p, fr_p, ba_p, bb_p = mesh_hit.mesh_closest_hit_rays(
            lo, ld, hit.t, mesh.tri_packed[:, col0:col0 + fpad],
            mesh.tile_aabb[ar0:ar0 + nt], face0=col0, tree=mesh.hit_tree,
            slot=slot)
        got = face_p[:nr] >= 0
        # packed (Morton) id -> arena face id
        face_a = perm[torch.clamp(face_p[:nr].to(torch.int64), 0,
                                  perm.shape[0] - 1)].to(torch.int32)
        t = torch.where(got, tp[:nr], BIGFLOAT)
        upd = t < hit.t
        hit = Hit(
            t=torch.where(upd, t, hit.t),
            kind=torch.where(upd, KIND_MESH, hit.kind),
            inst=torch.where(upd, i, hit.inst),
            face=torch.where(upd, face_a, hit.face),
            ba=torch.where(upd, ba_p[:nr], hit.ba),
            bb=torch.where(upd, bb_p[:nr], hit.bb),
            front=torch.where(upd, fr_p[:nr] > 0.5, hit.front))
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


def trace_shadow(scene, o: torch.Tensor, d: torch.Tensor,
                 t_max) -> torch.Tensor:
    """Shadow factor: 1.0 lit, 0.0 occluded (GenLight::Shadow,
    Final/main.cpp:499-513; bias 1e-14, hit must satisfy bias < z <
    t_max), by a full closest-hit trace as in rtf_tpu.  `d` may be
    unnormalized: t is in units of |d| like the reference."""
    hit = trace(scene, o, d)
    occluded = hit.is_hit & (hit.t > 1e-14) & (hit.t < t_max)
    return torch.where(occluded, 0.0, 1.0)
