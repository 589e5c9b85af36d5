"""Batched ray-primitive intersection (rtf_tpu/ops/intersect.py).

Each function maps rays [...] against one primitive in its LOCAL space and
returns per-ray hit fields, in the JAX package's operation order and with
the reference's epsilons:

* sphere: unit sphere quadratic with zero=1e-3, front/back cases
  (objects.h:24-70), with the `zero`, `textbook` and `minroot` variants;
* plane: unit square z=0 with zero=1e-3 (objects.h:84-111);
* triangle: dominant-axis barycentric with bias=1e-3, |dz|>=1e-7
  (objects.h:226-268);
* box: the slab test (Box::IntersectRay, Final/scene.cpp:11-65), with
  the entry distance for ordering a BVH node's children.
"""
from __future__ import annotations

import math

import torch

from rtf_tpu_torch.core.math import BIGFLOAT, dot, normalize

ZERO = 1e-3  # the reference's `zero`/`bias` epsilon for sphere/plane/triangle


def intersect_sphere(o: torch.Tensor, d: torch.Tensor, t_prev: torch.Tensor,
                     zero: float = ZERO, textbook: bool = False,
                     minroot: bool = False):
    """Unit sphere at origin.  Returns (t, front, valid).

    `textbook` evaluates b*b - 4ac in the reference's own op order
    (fidelity mode); otherwise the re-origined stable quadratic.  `zero`
    is the era's epsilon (Proj3/4: 0).  `minroot` is the Proj3 rule: the
    min root only, never a back hit."""
    a = dot(d, d)
    if textbook:
        c = dot(o, o) - 1.0
        b = 2.0 * dot(o, d)
        disc = b * b - 4.0 * a * c
        s = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = (-b + s) / (2.0 * a)
        t2 = (-b - s) / (2.0 * a)
    else:
        half_b = dot(o, d)
        tc = -half_b / a
        m = o + tc[..., None] * d
        disc = 4.0 * a * (1.0 - dot(m, m))
        s = torch.sqrt(torch.clamp(disc, min=0.0)) / (2.0 * a)
        t1 = tc + s
        t2 = tc - s
    has = disc >= zero
    if minroot:
        back = torch.zeros_like(has)
        frontal = has & (t2 >= zero) & (t2 < t_prev)
    else:
        back = has & (t1 > zero) & (t2 < zero) & (t1 < t_prev)
        frontal = has & (t1 > zero) & (t2 > zero) & (t2 < t_prev)
    t = torch.where(frontal, t2, torch.where(back, t1, BIGFLOAT))
    return t, frontal, frontal | back


def sphere_attributes(o, d, t):
    """Point, normal and uvw at a sphere hit: N = p normalized, spherical
    uv (objects.h:46-51)."""
    p = o + t[..., None] * d
    n = normalize(p)
    u = 0.5 - torch.atan2(p[..., 0], p[..., 1]) / (2.0 * math.pi)
    v = 0.5 + torch.asin(torch.clamp(p[..., 2], -1.0, 1.0)) / math.pi
    return p, n, torch.stack([u, v, torch.zeros_like(u)], dim=-1)


def intersect_plane(o: torch.Tensor, d: torch.Tensor, t_prev: torch.Tensor):
    """Unit plane z=0, |x|<=1, |y|<=1.  Returns (t, front, valid)."""
    dz = d[..., 2]
    safe_dz = torch.where(dz == 0, 1e-30, dz)
    t = -(o[..., 2] / safe_dz)
    px = o[..., 0] + t * d[..., 0]
    py = o[..., 1] + t * d[..., 1]
    valid = (dz != 0) & (t >= ZERO) & (t < t_prev) & (t < BIGFLOAT)
    valid &= (px >= -1) & (px <= 1) & (py >= -1) & (py <= 1)
    return torch.where(valid, t, BIGFLOAT), dz <= 0.0, valid


def plane_attributes(o, d, t):
    p = o + t[..., None] * d
    n = torch.zeros_like(p)
    n[..., 2] = 1.0
    u = (p[..., 0] + 1.0) * 0.5
    v = (p[..., 1] + 1.0) * 0.5
    return p, n, torch.stack([u, v, torch.zeros_like(u)], dim=-1)


def _area2(axis, p0, p1, p2):
    """Signed double area of (p0, p1, p2) (lists of 3 components)
    projected perpendicular to `axis`, with the reference's sign
    conventions (TriangleArea, objects.h:146-157)."""
    f1 = [p1[k] - p0[k] for k in range(3)]
    f2 = [p2[k] - p0[k] for k in range(3)]
    return torch.where(
        axis == 0, f1[1] * f2[2] - f2[1] * f1[2],
        torch.where(axis == 1, f1[0] * f2[2] - f2[0] * f1[2],
                    f1[0] * f2[1] - f2[0] * f1[1]))


def triangle_face(a, b, c):
    """The ray-independent part of intersect_triangle for faces given as
    lists of 3 components: (n, axis, total), the unit normal (a list of 3),
    the dominant axis and the projected double area.  ops/bvh_hit.py::
    face_rows keeps them per face for the wide walk."""
    e1 = [b[k] - a[k] for k in range(3)]
    e2 = [c[k] - a[k] for k in range(3)]
    n = [e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0]]
    # normalize (core/math.py), its sum written out
    x = torch.clamp(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], min=1e-30)
    r = torch.where(x > 0, 1.0 / torch.sqrt(x), 0.0)
    n = [nk * r for nk in n]
    an = [torch.abs(nk) for nk in n]
    # the first largest component, as argmax
    axis = torch.where(an[2] > torch.maximum(an[0], an[1]), 2,
                       torch.where(an[1] > an[0], 1, 0))
    return n, axis, _area2(axis, a, b, c)


def intersect_triangle(o, d, a, b, c, t_prev):
    """Ray vs triangle(s); shapes broadcast over leading dims.  Returns
    (t, front, bary_a, bary_b, valid) by the plane test and dominant-axis
    projected-area barycentrics of TriObj::IntersectTriangle.  Every sum
    is written out left to right, the order in which csrc/bvh_hit.cu
    computes it per ray and face, so the two round alike."""
    o, d, a, b, c = ([x[..., k] for k in range(3)] for x in (o, d, a, b, c))
    n, axis, total = triangle_face(a, b, c)
    dz = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    pz = (o[0] - a[0]) * n[0] + (o[1] - a[1]) * n[1] + (o[2] - a[2]) * n[2]
    safe_dz = torch.where(torch.abs(dz) < 1e-7, 1e-7, dz)
    t = -pz / safe_dz
    p = [o[k] + t * d[k] for k in range(3)]
    s = 1.0 / torch.where(total == 0, 1e-30, total)
    ba = _area2(axis, p, b, c) * s
    bb = _area2(axis, p, c, a) * s
    bc = 1.0 - ba - bb
    valid = (torch.abs(dz) >= 1e-7) & (t > ZERO) & (t < t_prev) & (total != 0)
    valid &= (ba >= 0) & (bb >= 0) & (bc >= 0)
    return torch.where(valid, t, BIGFLOAT), dz <= 0.0, ba, bb, valid


def intersect_box(o, d, bmin, bmax, t_max):
    """Slab test of rays against boxes [..., 3] (Box::IntersectRay,
    Final/scene.cpp:11-65).  Returns bool.  Unlike the reference it also
    asks texit >= 0, which only prunes boxes behind the origin."""
    return intersect_box_enter(o, d, bmin, bmax, t_max)[0]


def intersect_box_enter(o, d, bmin, bmax, t_max):
    """intersect_box and the entry distance (0 for an origin inside the
    box), for near-child ordering: (hit, tenter)."""
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tenter = torch.amax(torch.minimum(t0, t1), dim=-1)
    texit = torch.amin(torch.maximum(t0, t1), dim=-1)
    inside = torch.all((o >= bmin) & (o <= bmax), dim=-1)
    hit = inside | ((tenter <= texit) & (texit >= 0.0) & (tenter <= t_max))
    return hit, torch.where(inside, 0.0, tenter)
