"""Wavefront integrator: the iterative reflect/refract queue
(rtf_tpu/render/integrator.py).

The reference's recursive MtlBlinn::Shade (Final/main.cpp:516-707) spawns
up to two child rays per hit; here every live path is a lane of a
fixed-capacity SoA queue.  One bounce traces the whole queue
(ops/trace.py, whose mesh test is the mesh_closest_hit kernel on the
card), adds throughput x local shading into the frame, then emits child
candidates:

* split 'both' follows reflection AND refraction: the 2C candidates are
  compacted back to capacity C by throughput priority (`_compact`);
* split 'rr' keeps each lane on ONE Russian-roulette-chosen child with
  unbiased reweighting (`_rr_select`), so lane == pixel stays a static
  permutation.

Beer-Lambert absorption is deferred: each lane carries the spawning
material's absorption and applies it once its own hit distance is known.
The environment on a miss goes to refraction rays only (quirk of
main.cpp:613-638), and to reflection rays too with cfg.env_on_reflect_miss.
GI: the hemisphere fan-out at the first hit ('hemisphere', 'pathtrace',
'photon'; main.cpp:642-693, azimuth not stratified), the photon estimate
below the first hit for 'photon' and at every hit for 'pm_direct' (from
an irradiance volume, or the exact gather of gi/grid.py from a photon
grid), and the caustic map's exact gather at primary hits.

Randomness: where rtf_tpu draws with jax.random, these functions draw
the same shapes from a torch.Generator (shade_lanes: the soft-shadow and
glossy uniforms; `_rr_select` and `_hemisphere_chunk` take theirs as
tensors).  With split 'both', hard shadows, no glossy material and no GI
a wave draws nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from rtf_tpu_torch.core.math import cross, dot, luma, normalize, \
    offset_origin
from rtf_tpu_torch.gi.grid import estimate_irradiance
from rtf_tpu_torch.gi.volume import IrradianceVolume, sample_volume
from rtf_tpu_torch.ops.texture import sample_environment
from rtf_tpu_torch.ops.trace import footprint_duv, resolve_surface, trace
from rtf_tpu_torch.render.shade import (
    direct_lighting, draw_gloss_uniforms, draw_shadow_uniforms,
    fresnel_split, sample_material,
)

RT_PRIMARY, RT_REFLECT, RT_REFRACT = 0, 1, 2
SENTINEL = 1.0e7      # dead lanes trace from here


@dataclass
class RayQueue:
    o: torch.Tensor          # [C,3]
    d: torch.Tensor          # [C,3] normalized
    tput: torch.Tensor       # [C,3] accumulated throughput
    absorb: torch.Tensor     # [C,3] spawning material's absorption
    pixel: torch.Tensor      # [C] int64 framebuffer index
    rtype: torch.Tensor      # [C] int32 RT_* (controls env-on-miss)
    alive: torch.Tensor      # [C] bool

    @property
    def capacity(self):
        return self.o.shape[0]

    def map(self, fn) -> "RayQueue":
        return RayQueue(*(fn(getattr(self, f.name)) for f in fields(self)))


def _compact(cand: RayQueue, capacity: int) -> RayQueue:
    """Keep the top-`capacity` candidates by throughput priority.  A
    stable descending sort: among equal priorities the lower index
    survives, as with jax.lax.top_k."""
    pri = torch.where(cand.alive, luma(cand.tput), -1.0)
    idx = torch.sort(pri, descending=True, stable=True).indices[:capacity]
    return cand.map(lambda a: a[idx])


def _concat_queues(a: RayQueue, b: RayQueue) -> RayQueue:
    return RayQueue(*(torch.cat([getattr(a, f.name), getattr(b, f.name)])
                      for f in fields(a)))


class ShadeResult(NamedTuple):
    radiance: torch.Tensor   # [N,3] weighted contribution of these lanes
    children: RayQueue       # [2N] reflect+refract candidates
    hit_mask: torch.Tensor   # [N] bool
    hit_t: torch.Tensor      # [N]
    surf_p: torch.Tensor     # [N,3] (GI hooks need the hit point)
    surf_n: torch.Tensor     # [N,3]
    kd: torch.Tensor         # [N,3]
    k_eff: torch.Tensor      # [N,3] throughput after parent absorption


def shade_lanes(scene, cfg, tables, o, d, tput, absorb, pixel, alive, rtype,
                gen, gi_map=None, caustic_grid=None) -> ShadeResult:
    """Trace + locally shade one wavefront; return radiance & children.

    gen: the torch.Generator of the soft-shadow and glossy draws
    (render/shade.py::draw_shadow_uniforms, draw_gloss_uniforms).  gi_map:
    an irradiance volume or a photon grid, whose kd * E(p) * max(0, -N .
    meanDir) is added at every hit (main.cpp:694-705; a grid's E is the
    exact estimate_irradiance).  caustic_grid: a caustic photon grid,
    whose estimate (radius cfg.caustic_radius) is added at primary hits
    (the reference's commented-out caustic term, Proj13 main.cpp:517-534)."""
    n = o.shape[0]
    # dead lanes trace from a far sentinel (rtf_tpu's mesh kernel culls
    # whole dead blocks there)
    o = torch.where(alive[:, None], o, SENTINEL)
    hit = trace(scene, o, d)
    surf = resolve_surface(scene, o, d, hit)
    hit_mask = surf.valid & alive
    atten = torch.exp(-absorb * surf.t[:, None])
    k_eff = tput * torch.where(surf.front[:, None], 1.0, atten)
    duv = None
    if cfg.tex_filter and scene.tm_channels:
        # ray-differential footprint filtering, primary rays only (the
        # reference sets xangle/yangle on camera rays only, RayTracingProj7
        # main.cpp:141-142; a secondary ray's duvw stays 0)
        pix = 2.0 * math.tan(math.radians(scene.fov) * 0.5) / scene.height
        duv0, duv1 = footprint_duv(scene, o, d, hit, surf, pix, pix)
        prim = (rtype == RT_PRIMARY)[:, None]
        duv = (torch.where(prim, duv0, 0.0), torch.where(prim, duv1, 0.0))
    mtl = sample_material(scene, tables, surf.mtl, surf.uvw, duv=duv,
                          n_filter=cfg.tex_filter_samples)
    view = -d
    if cfg.gi_mode == "pm_direct":
        # the photon estimate is all of the diffuse lighting
        col = mtl.emission
    else:
        col = mtl.emission + direct_lighting(
            scene, cfg, surf, mtl, view,
            draw_shadow_uniforms(scene, cfg, n, gen, o.device))
    if gi_map is not None:
        if isinstance(gi_map, IrradianceVolume):
            irrad, mean_dir = sample_volume(gi_map, surf.p)
        else:
            irrad, mean_dir = estimate_irradiance(
                gi_map, surf.p, surf.n, cfg.knn_radius, cfg.knn_k)
        theta = torch.clamp(-dot(surf.n, mean_dir), min=0.0)
        col = col + mtl.kd * irrad * theta[:, None]
    if caustic_grid is not None:
        crad, cdir = estimate_irradiance(caustic_grid, surf.p, surf.n,
                                         cfg.caustic_radius, cfg.knn_k)
        cth = torch.clamp(-dot(surf.n, cdir), min=0.0)
        prim = (rtype == RT_PRIMARY)[:, None]
        col = col + torch.where(prim, mtl.kd * crad * cth[:, None], 0.0)
    radiance = torch.where(hit_mask[:, None], k_eff * col, 0.0)

    env_ok = rtype == RT_REFRACT
    if cfg.env_on_reflect_miss:
        env_ok = env_ok | (rtype == RT_REFLECT)
    env_mask = alive & ~surf.valid & env_ok
    env = sample_environment(tables, scene.env_color, d, l2=cfg.env_l2)
    radiance = radiance + torch.where(env_mask[:, None], tput * env, 0.0)

    fr = fresnel_split(cfg, surf, mtl, view,
                       u=draw_gloss_uniforms(n, gen, o.device)
                       if scene.any_glossy else None,
                       glossy=scene.any_glossy)
    thr = cfg.color_threshold
    r_go = hit_mask & (torch.amax(fr.r_k, dim=-1) > thr)
    t_go = hit_mask & (torch.amax(fr.t_k, dim=-1) > thr)

    def off(p, n_, d_):
        return p if scene.ref_exact else offset_origin(p, n_, d_)

    def child(dirv, k, rt, go):
        return RayQueue(o=off(surf.p, surf.n, dirv), d=dirv, tput=k_eff * k,
                        absorb=mtl.absorption, pixel=pixel,
                        rtype=torch.full_like(rtype, rt), alive=go)
    children = _concat_queues(child(fr.r_dir, fr.r_k, RT_REFLECT, r_go),
                              child(fr.t_dir, fr.t_k, RT_REFRACT, t_go))
    return ShadeResult(radiance=radiance, children=children,
                       hit_mask=hit_mask, hit_t=surf.t, surf_p=surf.p,
                       surf_n=surf.n, kd=mtl.kd, k_eff=k_eff)


def _splat(image, pixel, values, mask=None):
    """image + the per-pixel sums of values (jax.ops.segment_sum), each
    pixel's lanes summed in lane order: a stable sort of the lanes by
    pixel, then a segmented sum over the sorted lanes.  No atomics, so a
    frame on the card is the same bit for bit from run to run (index_add_
    on the card adds a pixel's lanes in no fixed order)."""
    if mask is not None:
        values = torch.where(mask[:, None], values, 0.0)
    px, order = torch.sort(pixel, stable=True)
    bounds = torch.searchsorted(px, torch.arange(
        image.shape[0] + 1, dtype=px.dtype, device=px.device))
    sums = torch.segment_reduce(values[order], "sum",
                                lengths=bounds.diff(), axis=0, unsafe=True)
    return image + sums


class WaveOutput(NamedTuple):
    radiance: torch.Tensor    # [P,3] sum of sample radiances
    hit_count: torch.Tensor   # [P] int32 primary samples that hit
    z_min: torch.Tensor       # [P] closest primary hit depth


def _rr_select(children: RayQueue, u: torch.Tensor) -> RayQueue:
    """Collapse the [2N] reflect+refract candidates to [N] lane-aligned
    continuations: per lane ONE child with probability proportional to
    its throughput luma, reweighted by the inverse probability.  u: [N]
    uniforms (rtf_tpu: jax.random.uniform(key, (n,)))."""
    n = children.capacity // 2
    refl = children.map(lambda x: x[:n])
    refr = children.map(lambda x: x[n:])
    wr = torch.where(refl.alive, luma(refl.tput), 0.0)
    wt = torch.where(refr.alive, luma(refr.tput), 0.0)
    wsum = wr + wt
    uu = u * torch.clamp(wsum, min=1e-30)
    take_r = ((uu < wr) | (wt <= 0.0)) & (wr > 0.0)
    w_chosen = torch.where(take_r, wr, wt)
    scale = (wsum / torch.clamp(w_chosen, min=1e-30))[:, None]

    def pick(a, b):
        m = take_r if a.dim() == 1 else take_r[:, None]
        return torch.where(m, a, b)
    return RayQueue(o=pick(refl.o, refr.o), d=pick(refl.d, refr.d),
                    tput=pick(refl.tput, refr.tput) * scale,
                    absorb=pick(refl.absorb, refr.absorb), pixel=refl.pixel,
                    rtype=pick(refl.rtype, refr.rtype),
                    alive=(wsum > 0.0) & (refl.alive | refr.alive))


def _run_bounces_rr(scene, cfg, tables, q: RayQueue, gen, gi_map=None,
                    bounces=None):
    """Lane-aligned bounce loop: returns summed radiance PER LANE."""
    nb = cfg.bounces if bounces is None else bounces
    lane_rad = torch.zeros_like(q.o)
    for b in range(nb):
        res = shade_lanes(scene, cfg, tables, q.o, q.d, q.tput, q.absorb,
                          q.pixel, q.alive, q.rtype, gen, gi_map=gi_map)
        lane_rad = lane_rad + res.radiance
        if b + 1 < nb:
            q = _rr_select(res.children, _uniform(gen, (q.capacity,), q.o))
    return lane_rad


def _run_bounces(scene, cfg, tables, q: RayQueue, image, gen, capacity,
                 gi_map=None, bounces=None):
    """The 'both' bounce loop: splat every bounce into the frame, compact
    the children.  It compacts while b + 1 < cfg.bounces (not the loop's
    own count), as rtf_tpu does."""
    nb = cfg.bounces if bounces is None else bounces
    for b in range(nb):
        res = shade_lanes(scene, cfg, tables, q.o, q.d, q.tput, q.absorb,
                          q.pixel, q.alive, q.rtype, gen, gi_map=gi_map)
        image = _splat(image, q.pixel, res.radiance)
        if b + 1 < cfg.bounces:
            q = _compact(res.children, capacity)
    return image, q


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, device=like.device)


def _hemisphere_chunk(scene, cfg, res: ShadeResult, pixel, u) -> RayQueue:
    """One hemisphere GI sample per first-hit lane (main.cpp:642-693),
    weighted kd * (N.wi) / S: phi = 2 pi u[0], sin(theta) = sqrt(u[1]),
    with the reference's basis rule.  u: [2, N] uniforms (rtf_tpu: k1, k2
    = split(key))."""
    n = res.surf_p.shape[0]
    nz = res.surf_n
    v1 = torch.tensor([1.0, 0.0, 0.0], device=nz.device)
    v2 = torch.tensor([0.0, 0.0, 1.0], device=nz.device)
    use1 = (dot(nz, v1.expand_as(nz)) < 0.4)[:, None]
    nx = normalize(torch.where(use1, cross(nz, v1), cross(nz, v2)))
    ny = cross(nz, nx)
    phi = u[0] * (2.0 * math.pi)
    ysq = u[1]
    sin_t = torch.sqrt(ysq)
    cos_t = torch.sqrt(1.0 - ysq)
    hdir = normalize(nx * (sin_t * torch.cos(phi))[:, None]
                     + ny * (sin_t * torch.sin(phi))[:, None]
                     + nz * cos_t[:, None])
    w = torch.clamp(dot(hdir, nz), min=0.0)[:, None]
    tput = res.k_eff * res.kd * w / float(cfg.hemisphere_samples)
    return RayQueue(
        o=offset_origin(res.surf_p, res.surf_n, hdir), d=hdir, tput=tput,
        absorb=torch.zeros_like(tput), pixel=pixel,
        rtype=torch.full((n,), RT_REFRACT, dtype=torch.int32,
                         device=nz.device),   # a GI miss samples the env
        alive=res.hit_mask & (torch.amax(tput, dim=-1) > 0))


def render_wave(scene, cfg, tables, o, d, pixel, sample_mask, gen,
                num_pixels: int, gi_map=None, inv_pixel=None,
                caustic_grid=None) -> WaveOutput:
    """Render one wave of primary samples through the full bounce queue.

    `sample_mask` disables lanes (the adaptive ladder's later rungs).
    Radiance is the SUM over samples.  gi_map: the photon volume or grid
    of gi_mode 'photon' (below the first hit) or 'pm_direct' (every hit);
    caustic_grid: the caustic photon grid, gathered at the primary hits.
    `inv_pixel`: when `pixel` is a permutation of arange(num_pixels), its
    inverse; the 'rr' split then runs lane-aligned, without scatters."""
    n = o.shape[0]
    dev = o.device
    hemi = cfg.gi_mode in ("hemisphere", "pathtrace", "photon") \
        and cfg.hemisphere_samples > 0
    res = shade_lanes(
        scene, cfg, tables, o, d,
        tput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        absorb=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pixel=pixel, alive=sample_mask,
        rtype=torch.full((n,), RT_PRIMARY, dtype=torch.int32, device=dev),
        gen=gen, gi_map=gi_map if cfg.gi_mode == "pm_direct" else None,
        caustic_grid=caustic_grid)
    hit = res.hit_mask & sample_mask
    z = torch.where(hit, res.hit_t, 1.0e30)

    if cfg.resolved_split_mode() == "rr" and inv_pixel is not None:
        lane_rad = res.radiance
        for _ in range(cfg.hemisphere_samples if hemi else 0):
            chunk = _hemisphere_chunk(scene, cfg, res, pixel,
                                      _uniform(gen, (2, n), o))
            res_c = shade_lanes(scene, cfg, tables, chunk.o, chunk.d,
                                chunk.tput, chunk.absorb, chunk.pixel,
                                chunk.alive, chunk.rtype, gen, gi_map=gi_map)
            lane_rad = lane_rad + res_c.radiance
            q_c = _rr_select(res_c.children, _uniform(gen, (n,), o))
            # hemisphere samples carry bounceCount-1 (main.cpp:678)
            lane_rad = lane_rad + _run_bounces_rr(
                scene, cfg, tables, q_c, gen, gi_map=gi_map,
                bounces=max(cfg.bounces - 1, 0))
        q = _rr_select(res.children, _uniform(gen, (n,), o))
        lane_rad = lane_rad + _run_bounces_rr(scene, cfg, tables, q, gen,
                                              gi_map=gi_map)
        return WaveOutput(radiance=lane_rad[inv_pixel],
                          hit_count=hit.to(torch.int32)[inv_pixel],
                          z_min=z[inv_pixel])

    image = torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)
    image = _splat(image, pixel, res.radiance, sample_mask)
    hit_count = torch.zeros(num_pixels, dtype=torch.int32, device=dev) \
        .index_add(0, pixel, hit.to(torch.int32))
    z_min = torch.full((num_pixels,), 1.0e30, device=dev).scatter_reduce(
        0, pixel, z, reduce="amin")
    capacity = max(int(n * cfg.queue_factor), 1)
    for _ in range(cfg.hemisphere_samples if hemi else 0):
        chunk = _hemisphere_chunk(scene, cfg, res, pixel,
                                  _uniform(gen, (2, n), o))
        image, _ = _run_bounces(scene, cfg, tables, chunk, image, gen,
                                capacity, gi_map=gi_map,
                                bounces=max(cfg.bounces - 1, 0))
    q = _compact(res.children, capacity)
    image, _ = _run_bounces(scene, cfg, tables, q, image, gen, capacity,
                            gi_map=gi_map)
    return WaveOutput(radiance=image, hit_count=hit_count, z_min=z_min)
