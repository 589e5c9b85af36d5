"""Shading on the wavefront: Blinn-Phong direct lighting and the Fresnel
reflect/refract split (rtf_tpu/render/shade.py).

* direct term per light with front-face gating and the Final build's
  1/numLights averaging (main.cpp:544-572);
* soft shadows by disk sampling of the spherical point light with the
  4 -> 16 adaptive escalation (lights.h:67-130);
* Schlick Fresnel + total-internal-reflection split producing the
  reflect/refract child weights rK/tK (main.cpp:577-610), with the Proj10+
  glossy normal perturbation.

Where rtf_tpu draws with jax.random, these functions take their uniforms
as tensors (`draw_shadow_uniforms`, `draw_gloss_uniforms` make them from a
torch.Generator), in the shapes the JAX functions draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rtf_tpu_torch.core.math import (
    BIGFLOAT, cross, dot, length_sq, normalize, offset_origin, reflect,
)
from rtf_tpu_torch.ops.texture import _sel_rows, sample_textured_color
from rtf_tpu_torch.ops.trace import trace_shadow


class MtlSample(NamedTuple):
    """Material attributes sampled at the hit (textures resolved)."""
    kd: torch.Tensor          # [N,3] diffuse (textured)
    ks: torch.Tensor          # [N,3] specular (textured)
    gloss: torch.Tensor       # [N]
    emission: torch.Tensor    # [N,3]
    reflection: torch.Tensor  # [N,3] plain colors (Shade uses GetColor)
    refraction: torch.Tensor  # [N,3]
    absorption: torch.Tensor  # [N,3]
    ior: torch.Tensor         # [N]
    refl_gloss: torch.Tensor  # [N] glossy reflection radius (Proj10+)
    refr_gloss: torch.Tensor  # [N]


def sample_material(scene, tables, mtl_id: torch.Tensor,
                    uvw: torch.Tensor, duv=None,
                    n_filter: int = 32) -> MtlSample:
    """Per-lane material attributes; kd and ks are sampled through their
    texture maps (render/scene_tables.py's tables) only when some
    material maps that channel (scene.tm_channels).  duv = (duv0, duv1)
    [N,2] filters every textured channel over its footprint with n_filter
    taps (TexturedColor::Sample with hInfo.duvw, Final/main.cpp:531-532,
    scene.h:331-349)."""
    m = scene.materials

    def chan(color_tbl, tm_tbl, name):
        col = _sel_rows(color_tbl, mtl_id)
        if name not in scene.tm_channels:
            return col
        return sample_textured_color(tables, col, _sel_rows(tm_tbl, mtl_id),
                                     uvw, duv=duv, n_filter=n_filter)

    return MtlSample(
        kd=chan(m.diffuse, m.diffuse_tm, "diffuse"),
        ks=chan(m.specular, m.specular_tm, "specular"),
        gloss=_sel_rows(m.glossiness, mtl_id),
        emission=_sel_rows(m.emission, mtl_id),
        reflection=_sel_rows(m.reflection, mtl_id),
        refraction=_sel_rows(m.refraction, mtl_id),
        absorption=_sel_rows(m.absorption, mtl_id),
        ior=_sel_rows(m.ior, mtl_id),
        refl_gloss=_sel_rows(m.refl_gloss, mtl_id),
        refr_gloss=_sel_rows(m.refr_gloss, mtl_id))


def _point_light_basis(dirv: torch.Tensor):
    """Disk basis for the spherical light (lights.h:74-88): v1 from x or y
    axis by the reference's 0.8 dot test, v2 = v1 x dir."""
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dirv.device)
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=dirv.device)
    use_y = (dot(dirv, x_axis.expand_as(dirv)) > 0.8)[..., None]
    v1 = torch.where(use_y, cross(y_axis, dirv), cross(x_axis, dirv))
    v2 = cross(v1, dirv)
    return normalize(v1), normalize(v2)


def _point_shadow(scene, p, n, lpos, size, u=None):
    """Mean shadow over the disk samples of the light sphere
    (lights.h:92-107); u [nsamp, 2, N]: per sample the radius and angle
    uniforms (rtf_tpu's split(key, nsamp), then split per sample), or None
    for one hard sample toward the centre.  Shadow rays use the
    unnormalized dir = target - p with t_max = 1."""
    def off(p_, n_, d_):
        # ref_exact: the reference shoots from the hit point itself
        return p_ if scene.ref_exact else offset_origin(p_, n_, d_)
    if u is None:
        d = lpos - p
        return trace_shadow(scene, off(p, n, d), d, 1.0)
    v1, v2 = _point_light_basis(lpos - p)
    acc = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for i in range(u.shape[0]):
        r = torch.sqrt(u[i, 0]) * size
        ang = u[i, 1] * (2.0 * math.pi)
        off_ = v1 * (r * torch.cos(ang))[:, None] \
            + v2 * (r * torch.sin(ang))[:, None]
        d = lpos + off_ - p
        acc = acc + trace_shadow(scene, off(p, n, d), d, 1.0)
    return acc / float(u.shape[0])


def soft_shadows(scene, cfg) -> bool:
    """Point lights take disk samples (rtf_tpu's `nsamp > 1 and
    scene.any_soft_light`); then the escalation traces cfg.shadow_max
    more samples per point light whenever shadow_min < shadow_max."""
    return cfg.shadow_min > 1 and scene.any_soft_light


def draw_shadow_uniforms(scene, cfg, n, gen, device) -> dict:
    """{light index: (u_min [shadow_min, 2, n] or None, u_max
    [shadow_max, 2, n] or None)} for the point lights: the draws of
    `direct_lighting`'s first samples and of its escalation."""
    out = {}
    for li, kind in enumerate(scene.light_kinds):
        if kind != "point":
            continue
        u_min = u_max = None     # hard: no draws
        if soft_shadows(scene, cfg):
            u_min = torch.rand((cfg.shadow_min, 2, n), generator=gen,
                               device=device)
        if cfg.shadow_min < cfg.shadow_max and scene.any_soft_light:
            u_max = torch.rand((cfg.shadow_max, 2, n), generator=gen,
                               device=device)
        out[li] = (u_min, u_max)
    return out


def direct_lighting(scene, cfg, surf, mtl: MtlSample, view: torch.Tensor,
                    shadow_u=None) -> torch.Tensor:
    """Blinn-Phong sum over lights (main.cpp:544-572).  `view` = -ray.dir,
    normalized.  Only front hits receive light; ambient uses kd.
    shadow_u: `draw_shadow_uniforms`'s dict (needed when the shadows are
    soft).  The escalation traces cfg.shadow_max samples for every lane
    and keeps them where the first samples disagree (lights.h:110-129)."""
    color = torch.zeros_like(surf.p)
    nlights = max(len(scene.light_kinds), 1)
    coef = 1.0 / nlights if cfg.light_average else 1.0
    front = surf.front[:, None]
    lt = scene.lights
    for li, kind in enumerate(scene.light_kinds):
        intensity = lt.intensity[li]
        if kind == "ambient":
            color = color + torch.where(front, mtl.kd * intensity[None, :],
                                        0.0)
            continue
        if kind == "direct":
            sdir = (-lt.direction[li]).expand_as(surf.p)
            shadow = trace_shadow(
                scene, surf.p if scene.ref_exact
                else offset_origin(surf.p, surf.n, sdir), sdir, BIGFLOAT)
            illum = shadow[:, None] * intensity[None, :]
            l_vec = sdir
        else:  # point
            lpos = lt.position[li]
            u_min, u_max = (shadow_u or {}).get(li, (None, None))
            escalate = cfg.shadow_min < cfg.shadow_max \
                and scene.any_soft_light
            if (soft_shadows(scene, cfg) and u_min is None) \
                    or (escalate and u_max is None):
                raise ValueError(f"light {li}: soft shadows need uniforms "
                                 "(draw_shadow_uniforms)")
            shadow = _point_shadow(scene, surf.p, surf.n, lpos, lt.size[li],
                                   u_min)
            if escalate:
                penumbra = (shadow > 0.0) & (shadow < 1.0)
                shadow16 = _point_shadow(scene, surf.p, surf.n, lpos,
                                         lt.size[li], u_max)
                shadow = torch.where(penumbra, shadow16, shadow)
            illum = shadow[:, None] * intensity[None, :]
            if cfg.inverse_square:
                illum = illum / torch.clamp(length_sq(surf.p - lpos),
                                            min=1e-30)[:, None]
            l_vec = normalize(lpos - surf.p)
        illum = illum * coef
        h = normalize(l_vec + view)
        cos_nl = torch.clamp(dot(surf.n, l_vec), min=0.0)
        cos_nh = torch.clamp(dot(surf.n, h), min=0.0)
        spec = torch.pow(cos_nh, mtl.gloss)
        contrib = (mtl.kd + mtl.ks * spec[:, None]) * illum \
            * cos_nl[:, None]
        color = color + torch.where(front, contrib, 0.0)
    return color


class FresnelSplit(NamedTuple):
    r_dir: torch.Tensor   # [N,3] reflection direction (normalized)
    t_dir: torch.Tensor   # [N,3] refraction direction (normalized)
    r_k: torch.Tensor     # [N,3] reflection weight rK
    t_k: torch.Tensor     # [N,3] refraction weight tK


def _perturb_normal(n, gloss, u):
    """Glossy normal perturbation (Proj13 main.cpp:633-647): offset N
    inside its tangent disk by radius sqrt(u[0]) * glossiness at angle
    u[1] * 2pi, then renormalize (the tangent from N x x_axis, or N x
    z_axis when N is nearly parallel to x, normalized)."""
    par = (torch.abs(n[:, 0]) > 0.9)[:, None]
    axis = torch.where(par, torch.tensor([0.0, 0.0, 1.0], device=n.device),
                       torch.tensor([1.0, 0.0, 0.0], device=n.device))
    tx = normalize(cross(n, axis))
    ty = cross(n, tx)
    r = torch.sqrt(u[0]) * gloss
    th = u[1] * (2.0 * math.pi)
    return normalize(n + tx * (r * torch.cos(th))[:, None]
                     + ty * (r * torch.sin(th))[:, None])


def draw_gloss_uniforms(n, gen, device):
    """fresnel_split's draws: [2 (reflection, refraction), 2, n]."""
    return torch.rand((2, 2, n), generator=gen, device=device)


def fresnel_split(cfg, surf, mtl: MtlSample, view: torch.Tensor,
                  u=None, glossy: bool = False) -> FresnelSplit:
    """Schlick + TIR split (main.cpp:577-610).  glossy=True (with u from
    `draw_gloss_uniforms`) perturbs the child DIRECTIONS' normals
    independently (main.cpp:633-659); the Fresnel COEFFICIENTS use the
    true normal."""
    n = surf.n
    ior = torch.clamp(mtl.ior, min=1e-6)
    eta = torch.where(surf.front, 1.0 / ior, ior)   # ein/eout
    cos_i = dot(n, view)
    n_r = n_t = n
    if glossy and u is not None:
        n_r = torch.where((mtl.refl_gloss > 0)[:, None],
                          _perturb_normal(n, mtl.refl_gloss, u[0]), n)
        n_t = torch.where((mtl.refr_gloss > 0)[:, None],
                          _perturb_normal(n, mtl.refr_gloss, u[1]), n)
    cos_t = dot(n_t, view)
    y = torch.where((cos_t > 0.0)[:, None], n_t, -n_t)
    z = cross(view, y)
    x = normalize(cross(y, z))
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    sin_o = torch.clamp(sin_t * eta, 0.0, 1.0)
    cos_o = torch.sqrt(torch.clamp(1.0 - sin_o * sin_o, min=0.0))
    t_dir = -x * sin_o[:, None] - y * cos_o[:, None]
    r_dir = reflect(view, n_r)
    c0 = (eta - 1.0) ** 2 / (eta + 1.0) ** 2
    r_c = c0 + (1.0 - c0) * torch.pow(1.0 - torch.abs(cos_i), 5.0)
    t_c = 1.0 - r_c
    tot = ((eta * sin_i) > cfg.total_reflection_threshold)[:, None]
    t_k = torch.where(tot, 0.0, mtl.refraction * t_c[:, None])
    r_k = torch.where(tot, mtl.reflection + mtl.refraction,
                      mtl.reflection + mtl.refraction * r_c[:, None])
    return FresnelSplit(r_dir=normalize(r_dir), t_dir=normalize(t_dir),
                        r_k=r_k, t_k=t_k)
