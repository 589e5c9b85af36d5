"""Photon shooting: batched emission + Russian-roulette bouncing
(rtf_tpu/gi/photon.py).

The reference's photon pass (generatePhotonMap / PhotonTracing,
Final/main.cpp:350-487, and MtlBlinn::RandomPhotonBounce,
materials.h:99-256) as a wavefront:

* photons are emitted from uniformly chosen non-ambient lights, direction
  the normalized uniform-cube sample (PointLight::RandomPhoton,
  main.cpp:489-497);
* each bounce traces the whole wavefront (ops/trace.py: mesh_closest_hit on
  the card) and STORES on diffuse surfaces (diffuse gray > 0,
  materials.h:97) from the second path segment on (the light -> first-hit
  segment never stores), then picks transmit / reflect / diffuse / absorb
  with probability proportional to channel luma and rescales the power by
  1/prob (normalized cumulative probabilities, as rtf_tpu does);
* stored powers are scaled by 4 pi / numStored (main.cpp:396).

Caustic variant: store only after >= 2 specular surfaces (CausticTracing,
Proj13 main.cpp:430-457).  Storing is a prefix-sum scatter into a
fixed-capacity buffer with one sink row that takes the lanes not stored.

Randomness goes through one seam, a `PhotonDraws`: per emission chunk the
light picks and cube directions, per bounce the (u, theta, phi) uniforms
of `_rr_bounce`.  The port draws them from a torch.Generator on the
device (`GeneratorDraws`); rtf_tpu's come from jax.random (threefry), and
its tests feed those in.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtf_tpu_torch.core.math import (
    cross, dot, luma, normalize, offset_origin, reflect,
)
from rtf_tpu_torch.ops.trace import resolve_surface, trace
from rtf_tpu_torch.render.shade import sample_material
from rtf_tpu_torch.scene.build import resolve_device

SENTINEL = 1.0e7      # dead photons trace from here (their kernel walk ends
                      # at the root box)


class PhotonMapData(NamedTuple):
    pos: torch.Tensor     # [CAP,3] float32
    dir: torch.Tensor     # [CAP,3] incoming photon direction
    power: torch.Tensor   # [CAP,3] RGB power (4 pi / N scaled once shot)
    count: torch.Tensor   # [] int32 number of valid photons


def photon_map_from_arrays(pos, dirs, power, count,
                           device="cuda") -> PhotonMapData:
    """A photon map from numpy arrays (pos, dir, power [CAP,3], count), as
    rtf_tpu's PhotonMapData holds them."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32).reshape(-1, 3),
                            device=dev)
    return PhotonMapData(t(pos), t(dirs), t(power), torch.tensor(
        int(count), dtype=torch.int32, device=dev))


class GeneratorDraws:
    """The shooter's draws from a torch.Generator, in a fixed order: per
    chunk the picks, then the cube, then each bounce's uniforms."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def emission(self, chunk: int, n: int, n_lights: int, device):
        """(light pick [n] int64 in [0, n_lights), cube [n,3] in [-1, 1))."""
        pick = torch.randint(0, n_lights, (n,), generator=self.gen,
                             device=device)
        cube = torch.rand((n, 3), generator=self.gen, device=device) \
            * 2.0 - 1.0
        return pick, cube

    def bounce(self, chunk: int, b: int, n: int, device):
        """[3, n] uniforms in [0, 1): the RR choice, theta, phi."""
        return torch.rand((3, n), generator=self.gen, device=device)


def _store(buf: PhotonMapData, pos, dirs, power, mask) -> PhotonMapData:
    """Append the masked lanes (prefix-sum order) into a buffer whose last
    row is a sink: lanes not stored, or past the capacity, land there."""
    cap = buf.pos.shape[0] - 1
    idx = buf.count + torch.cumsum(mask.to(torch.int32), 0,
                                   dtype=torch.int32) - 1
    ok = mask & (idx < cap)
    tgt = torch.where(ok, idx, cap).to(torch.int64)
    buf.pos[tgt] = pos
    buf.dir[tgt] = dirs
    buf.power[tgt] = power
    return buf._replace(count=buf.count + ok.sum(dtype=torch.int32))


def _random_photon_dirs(cube):
    """Normalized uniform-cube directions (PointLight::RandomPhoton)."""
    return normalize(cube)


def _rr_bounce(cfg, surf, mtl, d_in, u3):
    """RandomPhotonBounce (materials.h:99-256): pick one of transmit /
    reflect / diffuse / absorb; returns (new_dir, bxdf_over_prob, alive,
    is_specular).  u3: [3, n] uniforms (rtf_tpu: split(key, 3))."""
    v = -d_in
    nrm = surf.n
    ior = torch.clamp(mtl.ior, min=1e-6)
    eta = torch.where(surf.front, 1.0 / ior, ior)

    cos_i = dot(nrm, v)
    y = torch.where((cos_i > 0.0)[:, None], nrm, -nrm)
    z = cross(v, y)
    x = normalize(cross(y, z))
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_o = torch.clamp(sin_i * eta, 0.0, 1.0)
    cos_o = torch.sqrt(torch.clamp(1.0 - sin_o * sin_o, min=0.0))
    t_dir = -x * sin_o[:, None] - y * cos_o[:, None]
    r_dir = reflect(v, nrm)

    c0 = (eta - 1.0) ** 2 / (eta + 1.0) ** 2
    r_c = c0 + (1.0 - c0) * torch.pow(1.0 - torch.abs(cos_i), 5.0)
    t_c = 1.0 - r_c
    tot = (eta * sin_i) > cfg.total_reflection_threshold

    t_k = mtl.refraction
    r_k = mtl.reflection
    sample_refr = torch.where(tot[:, None], 0.0, t_k * t_c[:, None])
    sample_refl = torch.where(tot[:, None], r_k + t_k,
                              r_k + t_k * r_c[:, None])

    p_diff = luma(mtl.kd)
    p_refr = luma(sample_refr)
    p_refl = luma(sample_refl)
    p_abs = luma(mtl.absorption)
    total = p_diff + p_refr + p_refl + p_abs
    total = torch.clamp(total, min=1e-12)

    u = u3[0] * total
    sel_refr = u <= p_refr
    sel_refl = ~sel_refr & (u <= p_refr + p_refl)
    sel_diff = ~sel_refr & ~sel_refl & (u <= p_refr + p_refl + p_diff)
    # else absorb

    # diffuse: uniform-angle hemisphere (theta ~ U(0, pi/2), materials.h:227)
    v1 = torch.tensor([1.0, 0.0, 0.0], device=nrm.device)
    v2 = torch.tensor([0.0, 0.0, 1.0], device=nrm.device)
    use1 = (dot(nrm, v1.expand_as(nrm)) < 0.4)[:, None]
    nt = normalize(torch.where(use1, cross(nrm, v1.expand_as(nrm)),
                               cross(nrm, v2.expand_as(nrm))))
    nb = cross(nrm, nt)
    theta = u3[1] * (math.pi / 2.0)
    phi = u3[2] * (2.0 * math.pi)
    st = torch.sin(theta)
    d_diff = normalize(nt * (torch.cos(phi) * st)[:, None]
                       + nb * (torch.sin(phi) * st)[:, None]
                       + nrm * torch.cos(theta)[:, None])
    h = normalize(v + d_diff)
    cos_nh = torch.clamp(dot(nrm, h), min=0.0)
    bxdf_diff = mtl.kd + mtl.ks * torch.pow(cos_nh, mtl.gloss)[:, None]

    new_dir = torch.where(sel_refr[:, None], normalize(t_dir),
                          torch.where(sel_refl[:, None], normalize(r_dir),
                                      d_diff))
    bxdf = torch.where(sel_refr[:, None], sample_refr,
                       torch.where(sel_refl[:, None], sample_refl,
                                   bxdf_diff))
    prob = torch.where(sel_refr, p_refr,
                       torch.where(sel_refl, p_refl, p_diff)) / total
    scale = torch.clamp(prob, min=1e-12)

    alive = sel_refr | sel_refl | (sel_diff & surf.front)
    is_spec = sel_refr | sel_refl
    factor = bxdf / scale[:, None]
    # Beer absorption through the medium just crossed (materials.h:253)
    atten = torch.exp(-mtl.absorption * surf.t[:, None])
    factor = factor * torch.where(surf.front[:, None], 1.0, atten)
    return new_dir, factor, alive, is_spec


def shoot_photons(scene, cfg, n_emit: int, capacity: int, draws,
                  caustic_only: bool = False, chunk: int = 131072,
                  tables=None) -> PhotonMapData:
    """Emit n_emit photons and bounce them up to cfg.photon_bounces times
    (cfg.caustic_bounces with caustic_only), in emission chunks of
    `chunk` (rtf_tpu's chunk: its draws are per chunk).

    draws: a torch.Generator (on the scene's device) or a `PhotonDraws`
    such as GeneratorDraws.  tables: the scene's render/scene_tables.py
    tables (built here if None).  Returns a PhotonMapData on the scene's
    device with powers scaled by 4 pi / count; nothing waits for the
    device."""
    if isinstance(draws, torch.Generator):
        draws = GeneratorDraws(draws)
    if tables is None:
        from rtf_tpu_torch.render.scene_tables import scene_tables
        tables = scene_tables(scene)
    n_emit, capacity = int(n_emit), int(capacity)
    dev = scene.device

    def zeros():     # one sink row past the capacity
        return torch.zeros((capacity + 1, 3), dtype=torch.float32,
                           device=dev)
    buf = PhotonMapData(zeros(), zeros(), zeros(),
                        torch.zeros((), dtype=torch.int32, device=dev))
    done = 0
    i = 0
    while done < n_emit:
        nc = min(int(chunk), n_emit - done)
        buf = _shoot_photons_batch(scene, cfg, tables, nc, i, draws,
                                   bool(caustic_only), buf)
        done += nc
        i += 1
    buf = PhotonMapData(buf.pos[:capacity], buf.dir[:capacity],
                        buf.power[:capacity], buf.count)
    # ScalePhotonPowers(4 pi / numStored) (main.cpp:396)
    return _scale_powers(buf)


def _scale_powers(buf: PhotonMapData) -> PhotonMapData:
    cnt = torch.clamp(buf.count, min=1).to(torch.float32)
    return buf._replace(power=buf.power * (4.0 * math.pi / cnt))


def _shoot_photons_batch(scene, cfg, tables, n_emit: int, chunk: int,
                         draws, caustic_only: bool, buf: PhotonMapData):
    photon_lights = [i for i, k in enumerate(scene.light_kinds)
                     if k != "ambient"]
    if not photon_lights:
        raise ValueError("no photon-emitting lights in the scene")
    dev = scene.device
    light_idx = torch.tensor(photon_lights, dtype=torch.int64, device=dev)
    pick_u, cube = draws.emission(chunk, n_emit, len(photon_lights), dev)
    pick = light_idx[pick_u]
    o = scene.lights.position[pick]
    d = _random_photon_dirs(cube)
    power = scene.lights.intensity[pick]
    alive = torch.ones(n_emit, dtype=torch.bool, device=dev)
    spec_count = torch.zeros(n_emit, dtype=torch.int32, device=dev)

    bounces = cfg.caustic_bounces if caustic_only else cfg.photon_bounces
    for b in range(bounces + 1):
        o = torch.where(alive[:, None], o, SENTINEL)
        hit = trace(scene, o, d)
        surf = resolve_surface(scene, o, d, hit)
        live_hit = alive & surf.valid
        mtl = sample_material(scene, tables, surf.mtl, surf.uvw)
        is_photon_surface = luma(mtl.kd) > 0   # IsPhotonSurface

        if b == 0:
            if caustic_only:
                # the caustic pass continues off a specular first hit,
                # counting it (CausticTracing hitspec, Proj13
                # main.cpp:416-423)
                spec_count = spec_count + (~is_photon_surface).to(
                    torch.int32)
            else:
                # the global map abandons paths whose FIRST hit is
                # specular (main.cpp:378-393)
                alive = alive & is_photon_surface
                live_hit = live_hit & is_photon_surface
        else:  # light -> first-hit segment never stores (main.cpp:382-390)
            store = live_hit & is_photon_surface
            if caustic_only:
                # hitspec counts specular surfaces crossed (Proj13
                # main.cpp:430-457)
                store = store & (spec_count >= 2)
                spec_count = spec_count + (
                    live_hit & ~is_photon_surface).to(torch.int32)
            buf = _store(buf, surf.p, d, power, store)

        if b == bounces:
            break
        new_dir, factor, rr_alive, _ = _rr_bounce(
            cfg, surf, mtl, d, draws.bounce(chunk, b, n_emit, dev))
        power = power * factor
        alive = live_hit & rr_alive
        o = offset_origin(surf.p, surf.n, new_dir)
        d = new_dir
    return buf
