"""Batched ray-primitive intersection (rtf_tpu/ops/intersect.py).

Each function maps rays [...] against one primitive in its LOCAL space and
returns per-ray hit fields, in the JAX package's operation order and with
the reference's epsilons:

* sphere: unit sphere quadratic with zero=1e-3, front/back cases
  (objects.h:24-70), with the `zero`, `textbook` and `minroot` variants;
* plane: unit square z=0 with zero=1e-3 (objects.h:84-111);
* triangle: dominant-axis barycentric with bias=1e-3, |dz|>=1e-7
  (objects.h:226-268).
"""
from __future__ import annotations

import math

import torch

from rtf_tpu_torch.core.math import BIGFLOAT, cross, dot, normalize

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


def intersect_triangle(o, d, a, b, c, t_prev):
    """Ray vs triangle(s); shapes broadcast over leading dims.  Returns
    (t, front, bary_a, bary_b, valid) by the plane test and dominant-axis
    projected-area barycentrics of TriObj::IntersectTriangle."""
    n = normalize(cross(b - a, c - a))
    dz = dot(d, n)
    pz = dot(o - a, n)
    safe_dz = torch.where(torch.abs(dz) < 1e-7, 1e-7, dz)
    t = -pz / safe_dz
    p = o + t[..., None] * d
    axis = torch.argmax(torch.abs(n), dim=-1)

    def area2(p0, p1, p2):
        # signed double area projected perpendicular to axis, with the
        # reference's sign conventions (TriangleArea, objects.h:146-157)
        e1 = p1 - p0
        e2 = p2 - p0
        ax = e1[..., 1] * e2[..., 2] - e2[..., 1] * e1[..., 2]
        ay = e1[..., 0] * e2[..., 2] - e2[..., 0] * e1[..., 2]
        az = e1[..., 0] * e2[..., 1] - e2[..., 0] * e1[..., 1]
        return torch.where(axis == 0, ax, torch.where(axis == 1, ay, az))

    total = area2(a, b, c)
    s = 1.0 / torch.where(total == 0, 1e-30, total)
    ba = area2(p, b, c) * s
    bb = area2(p, c, a) * s
    bc = 1.0 - ba - bb
    valid = (torch.abs(dz) >= 1e-7) & (t > ZERO) & (t < t_prev) & (total != 0)
    valid &= (ba >= 0) & (bb >= 0) & (bc >= 0)
    return torch.where(valid, t, BIGFLOAT), dz <= 0.0, ba, bb, valid
