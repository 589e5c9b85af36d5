"""Progressive screen-space irradiance cache (rtf_tpu/gi/irradiance_cache.py).

The reference ships `cyIrradianceMap.h` (cyIrradianceMap.h:30-241), a
coarse-to-fine screen-space cache of first-hit irradiance that its
projects never wire in (RayTracingProj11/main.cpp:9); rtf_tpu makes it a
working, optional GI accelerator (the CLI's `render --gi-cache`), and this
is its port:

* level 0 evaluates every point of the max_spacing pixel grid; each
  halving level evaluates only its gated points: those whose 4 enclosing
  parents disagree in irradiance (spread > tol), depth (z_tol) or normal
  (n_tol), the ColorZNormal criteria of cyIrradianceMap.h:330-369.  The
  gated points are taken in grid order up to a fixed budget
  (budget_frac of the level, at least 256), as rtf_tpu's
  `jnp.nonzero(need, size=budget)` takes them; past the budget a point
  keeps its interpolated value and is not marked computed.  Every other
  point of the level is bilinearly interpolated from the parents
  (cyIrradianceMap.h:117-161).  Only the gated points are written back,
  so no scatter has duplicate indices;
* the cached quantity is incoming irradiance E (the sum of L_in cos / S
  over cosine-weighted hemisphere samples, main.cpp:643-654) without the
  kd factor, which `indirect_image` multiplies in per pixel.

Two evaluators compute E at a batch of points, each hemisphere ray
shaded through the bounce chain with one bounce fewer (main.cpp:678):
`_eval_irradiance` on the wavefront (render/integrator.py's shade_lanes
and Russian-roulette chain), and `_eval_irradiance_fused`, which sends the
hemisphere rays through render/gi.py::gi_chunks, i.e. the wave kernel's
GI variant, from a synthetic surface with kd = k_eff = 1.
evaluator="auto" takes the fused one wherever the port's wave kernel
takes the scene (`scene_tables.fused_reason` with gi_mode 'none' and the
'rr' split), on any device: `render` chooses its path as rtf_tpu does on
a TPU, and so does the cache.  A textured scene therefore runs the
kernel's textured GI variant here, where rtf_tpu's mono-only gate
(fused.py::fusable) would send it to the XLA chain: the mono/seg split is
a TPU layout that the port drops.

A level's points go through an evaluator as one batch: at 800x600 at most
168,000 lanes (35% of the spacing-1 level), fewer than the 480,000 of one
of `render`'s waves, so the card's memory needs no chunking.

Randomness goes through one seam, a `CacheDraws`: per level the
hemisphere uniforms [S, 2, B], per hemisphere sample the first
Russian-roulette choice's uniforms, and the fused evaluator's wave seed;
the wavefront's deeper draws (soft shadows, glossy normals, later
roulette choices) come from its generator.  rtf_tpu draws all of these
with jax.random from keys; the tests feed those in.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtf_tpu_torch.core.math import (
    BIGFLOAT, cross, dot, normalize, offset_origin,
)
from rtf_tpu_torch.ops.trace import resolve_surface, trace
from rtf_tpu_torch.render.camera import pixel_grid, primary_rays
from rtf_tpu_torch.render.gi import gi_chunks
from rtf_tpu_torch.render.integrator import (
    RT_REFRACT, _rr_select, _run_bounces_rr, shade_lanes,
)
from rtf_tpu_torch.render.renderer import (
    _on_device, finalize, render_device_host,
)
from rtf_tpu_torch.render.scene_tables import fused_reason
from rtf_tpu_torch.render.shade import sample_material
from rtf_tpu_torch.render.wave import wave
from rtf_tpu_torch.scene.build import resolve_device


class IrradianceCache(NamedTuple):
    E: torch.Tensor          # [P,3] irradiance at pixel-centre first hits
    computed: torch.Tensor   # [P] bool: traced (True) or interpolated
    kd: torch.Tensor         # [P,3] first-hit diffuse (textured)
    hit: torch.Tensor        # [P] bool
    front: torch.Tensor      # [P] bool
    z: torch.Tensor          # [P] first-hit depth (BIGFLOAT = miss)
    n: torch.Tensor          # [P,3] first-hit shading normal


def cache_from_arrays(E, computed, kd, hit, front, z, n,
                      device="cuda") -> IrradianceCache:
    """An IrradianceCache from numpy arrays, as rtf_tpu's holds them."""
    dev = resolve_device(device)

    def f32(x, cols=None):
        a = np.asarray(x, np.float32)
        return torch.tensor(a if cols is None else a.reshape(-1, cols),
                            device=dev)

    def flag(x):
        return torch.tensor(np.asarray(x, bool), device=dev)
    return IrradianceCache(f32(E, 3), flag(computed), f32(kd, 3), flag(hit),
                           flag(front), f32(z), f32(n, 3))


class CacheDraws:
    """The cache build's draws from a torch.Generator on the device, in
    call order.  `gen` also drives the wavefront evaluator's deeper draws
    (render/integrator.py)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def hemisphere(self, level: int, s: int, n: int, device):
        """[s, 2, n] uniforms in [0, 1) of level `level`'s n points: per
        sample the azimuth fraction and sin^2 theta."""
        return torch.rand((s, 2, n), generator=self.gen, device=device)

    def rr(self, level: int, i: int, n: int, device):
        """[n] uniforms of hemisphere sample i's first Russian-roulette
        choice (the wavefront evaluator)."""
        return torch.rand((n,), generator=self.gen, device=device)

    def wave_seed(self, level: int) -> int:
        """The fused evaluator's wave seed, in [0, 2^31 - 1)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.gen,
                                 device=self.gen.device))


def _first_hits(scene, tables):
    """Pixel-centre primary hits, pixel-id order: (p, n, z, kd, hit,
    front)."""
    px, py = pixel_grid(scene.width, scene.height, scene.device)
    o, d = primary_rays(scene, px, py, torch.zeros_like(px))
    surf = resolve_surface(scene, o, d, trace(scene, o, d))
    mtl = sample_material(scene, tables, surf.mtl, surf.uvw)
    z = torch.where(surf.valid, surf.t, BIGFLOAT)
    return surf.p, surf.n, z, mtl.kd, surf.valid, surf.front


def _eval_irradiance_fused(scene, cfg, tables, p, n, mask, draws, level,
                           wave_fn=None):
    """E at p, n [B,3] through the wave kernel: render/gi.py::gi_chunks
    from a synthetic surface (kd = k_eff = 1, so each child's weight is
    cos / S) with hit0 = alive = mask.  S = max(hemisphere_samples, 1):
    rtf_tpu's guard for a cache built with hemisphere_samples=0.
    wave_fn: the module's `wave` (the kernel on CUDA tensors) unless given;
    wave_plain gives the plain version."""
    b = p.shape[0]
    one = torch.ones(b, dtype=torch.float32, device=p.device)
    surf = torch.stack([p[:, 0], p[:, 1], p[:, 2], n[:, 0], n[:, 1],
                        n[:, 2], one, one, one, one, one, one])
    s = max(int(cfg.hemisphere_samples), 1)
    seed = draws.wave_seed(level)
    u = draws.hemisphere(level, s, b, p.device)
    gi3 = gi_chunks(cfg.with_(hemisphere_samples=s), tables, surf, mask,
                    mask, seed, u, wave_fn=wave_fn or wave)
    return gi3.T


def _eval_irradiance(scene, cfg, tables, p, n, mask, draws, level):
    """E at p, n [B,3] on the wavefront: S = max(hemisphere_samples, 1)
    cosine-weighted hemisphere rays, each shaded through the bounce chain
    (the first-bounce GI loop of main.cpp:642-693 with kd divided out)."""
    b = p.shape[0]
    dev = p.device
    s = max(int(cfg.hemisphere_samples), 1)
    lane = torch.arange(b, dtype=torch.int64, device=dev)
    u = draws.hemisphere(level, s, b, dev)
    v1 = torch.tensor([1.0, 0.0, 0.0], device=dev).expand_as(n)
    v2 = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(n)
    use1 = (dot(n, v1) < 0.4)[:, None]
    tx = normalize(torch.where(use1, cross(n, v1), cross(n, v2)))
    ty = cross(n, tx)
    # a true division like JAX's (CUDA divides by a Python scalar through
    # its reciprocal)
    s_t = torch.full((), float(s), device=dev)
    rtype = torch.full((b,), RT_REFRACT, dtype=torch.int32, device=dev)
    E = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    for i in range(s):
        phi = u[i, 0] * (2.0 * math.pi)
        sin_t = torch.sqrt(u[i, 1])
        cos_t = torch.sqrt(1.0 - u[i, 1])
        hdir = normalize(tx * (sin_t * torch.cos(phi))[:, None]
                         + ty * (sin_t * torch.sin(phi))[:, None]
                         + n * cos_t[:, None])
        wcos = torch.clamp(dot(hdir, n), min=0.0)
        tput = (wcos / s_t)[:, None].expand(b, 3)
        res = shade_lanes(scene, cfg, tables, offset_origin(p, n, hdir),
                          hdir, tput, torch.zeros_like(p), lane,
                          mask & (wcos > 0.0), rtype, draws.gen)
        E = E + res.radiance
        q = _rr_select(res.children, draws.rr(level, i, b, dev))
        # hemisphere samples carry bounceCount-1 (main.cpp:678), as the
        # integrator's fan-out and the fused evaluator do
        E = E + _run_bounces_rr(scene, cfg, tables, q, draws.gen,
                                bounces=max(cfg.bounces - 1, 0))
    return E


def _grid_points(w, h, s):
    """Pixel ids of the level-s grid (x and y multiples of s, the last row
    and column clamped so the grid always covers the image edge), and its
    columns xs and rows ys."""
    xs = np.unique(np.minimum(np.arange(0, w + s - 1, s), w - 1))
    ys = np.unique(np.minimum(np.arange(0, h + s - 1, s), h - 1))
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    return (gy * w + gx).reshape(-1), xs, ys


def _bilerp_from_level(E_img, z_img, n_img, w, h, xs, ys, qx, qy):
    """Bilinear E at pixels (qx, qy) from the grid columns xs and rows ys
    (numpy), and the 4 parents' spreads for the gate: (E [B,3], spread,
    z_spread, n_dot)."""
    dev = qx.device
    xs_t = torch.as_tensor(xs, device=dev)
    ys_t = torch.as_tensor(ys, device=dev)
    ix = torch.clamp(torch.searchsorted(xs_t, qx, right=True) - 1,
                     0, len(xs) - 2)
    iy = torch.clamp(torch.searchsorted(ys_t, qy, right=True) - 1,
                     0, len(ys) - 2)
    x0, x1 = xs_t[ix], xs_t[ix + 1]
    y0, y1 = ys_t[iy], ys_t[iy + 1]
    # integer over integer: jnp's true division, in float32
    fx = (qx - x0).to(torch.float32) \
        / torch.clamp(x1 - x0, min=1).to(torch.float32)
    fy = (qy - y0).to(torch.float32) \
        / torch.clamp(y1 - y0, min=1).to(torch.float32)
    corners = (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1)
    c = [E_img[k] for k in corners]
    wgt = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    E = c[0] * wgt[0][:, None]
    for ci, wi in zip(c[1:], wgt[1:]):
        E = E + ci * wi[:, None]
    stack = torch.stack(c)                                   # [4,B,3]
    spread = torch.amax(torch.amax(stack, 0) - torch.amin(stack, 0), -1)
    zc = torch.stack([z_img[k] for k in corners])
    z_lo, z_hi = torch.amin(zc, 0), torch.amax(zc, 0)
    z_spread = (z_hi - z_lo) / torch.clamp(z_lo, min=1e-6)
    nc = torch.stack([n_img[k] for k in corners])
    n_mean = normalize(torch.mean(nc, dim=0))
    n_dot = torch.amin(dot(nc, n_mean[None]), dim=0)
    return E, spread, z_spread, n_dot


def _cache_seeds(seed: int):
    """(the cache's generator seed, the direct pass's seed) from one seed:
    two streams, as rtf_tpu splits its key into kc and kr."""
    st = np.random.SeedSequence([int(seed)]).generate_state(2)
    return int(st[0]), int(st[1] & 0x7FFFFFFF)


def build_irradiance_cache(scene, cfg, seed=None, max_spacing: int = 16,
                           tol: float = 0.1, z_tol: float = 0.1,
                           n_tol: float = 0.9, budget_frac: float = 0.35,
                           evaluator: str = "auto", device="cuda",
                           tables=None, draws=None) -> IrradianceCache:
    """Coarse-to-fine cache build (see the module docstring).  Runs on the
    card unless device='cpu'.  evaluator: 'auto', 'fused' or 'wavefront'.
    draws: a CacheDraws (default: from a device generator seeded from
    `seed`, else cfg.seed)."""
    dev = resolve_device(device)
    # the scene's own intersection statics, as rtf_tpu's cache traces
    scene, tables = _on_device(scene, None, dev, tables)
    eval_fn = _eval_irradiance
    if evaluator == "fused" or (evaluator == "auto" and fused_reason(
            scene, cfg.with_(gi_mode="none", split_mode="rr")) is None):
        eval_fn = _eval_irradiance_fused
    if draws is None:
        draws = CacheDraws(torch.Generator(device=dev).manual_seed(
            _cache_seeds(cfg.seed if seed is None else seed)[0]))
    w, h = scene.width, scene.height
    p, n, z, kd, hitm, front = _first_hits(scene, tables)
    E_img = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    computed = torch.zeros(w * h, dtype=torch.bool, device=dev)

    spacings = []                 # max_spacing, /2, ..., 1
    s = max(int(max_spacing), 1)
    while s >= 1:
        spacings.append(s)
        s //= 2
    prev_xs = prev_ys = None
    for li, s in enumerate(spacings):
        ids_np, xs, ys = _grid_points(w, h, s)
        ids = torch.as_tensor(ids_np, device=dev)
        front_hit = hitm[ids] & front[ids]
        if li == 0:
            E_new = eval_fn(scene, cfg, tables, p[ids], n[ids], front_hit,
                            draws, li)
            E_img[ids] = torch.where(front_hit[:, None], E_new, 0.0)
            computed[ids] = front_hit
        else:
            E_interp, spread, z_spread, n_dot = _bilerp_from_level(
                E_img, z, n, w, h, prev_xs, prev_ys, ids % w, ids // w)
            fresh = ~computed[ids]
            need = ((spread > tol) | (z_spread > z_tol)
                    | (n_dot < n_tol)) & fresh & front_hit
            # every fresh point takes its interpolated value first ...
            E_img[ids] = torch.where(fresh[:, None], E_interp, E_img[ids])
            # ... then the first `budget` gated points in grid order are
            # traced
            budget = min(max(int(ids.shape[0] * budget_frac), 256),
                         int(ids.shape[0]))
            comp = ids[torch.nonzero(need).squeeze(1)[:budget]]
            if comp.numel():
                E_img[comp] = eval_fn(
                    scene, cfg, tables, p[comp], n[comp],
                    torch.ones(comp.shape[0], dtype=torch.bool,
                               device=dev), draws, li)
                computed[comp] = True
        prev_xs, prev_ys = xs, ys
    return IrradianceCache(E=E_img, computed=computed, kd=kd, hit=hitm,
                           front=front, z=z, n=n)


def indirect_image(cache: IrradianceCache) -> torch.Tensor:
    """Per-pixel indirect term kd * E (the reference's usage site would be
    the kd * irradiance product of main.cpp:700-705), zero where the pixel
    centre misses or sees a back face."""
    ok = (cache.hit & cache.front)[:, None]
    return torch.where(ok, cache.kd * cache.E, 0.0)


def render_with_cache(scene, cfg, seed=None, device="cuda", tables=None,
                      **cache_kw):
    """A full render with cached GI: the cache, then the direct pass
    (`render_device_host` with gi_mode 'none') with the cache's indirect
    image added once per hit sample.  Returns (RenderResult, cache)."""
    dev = resolve_device(device)
    scene, tables = _on_device(scene, None, dev, tables)
    _, direct_seed = _cache_seeds(cfg.seed if seed is None else seed)
    cache = build_irradiance_cache(scene, cfg, seed, device=dev,
                                   tables=tables, **cache_kw)
    ind = indirect_image(cache)
    rad, hits, z, ns = render_device_host(
        scene, cfg.with_(gi_mode="none"), direct_seed, device=dev,
        tables=tables)
    # rad is [3,P] in pixel-id order, summed over samples; the indirect
    # term is constant per pixel, so it counts once per hit sample
    rad = rad + ind.T * hits[None, :].to(torch.float32)
    return finalize(scene, cfg, tables, rad, hits, z, ns), cache
