# Frozen copy of rtf_tpu_torch/render/renderer.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
# Changed: cut to the fused path without GI, what the benchmark's cells
# render: the wavefront, the GI waves, photon maps, sharding, progress
# callbacks, render, finalize and preview are left out, and `_prepare`
# raises for anything else.
"""The renderer on the fused path: sample waves and adaptive AA.

The port of rtf_tpu/render/renderer.py: a wave is (all pixels, in
`pixel_order`) x (one Halton sample index), one launch of the wave kernel
(here its plain version, render/wave.py::wave) per wave.  Adaptive
antialiasing is the reference's two-phase scheme (main.cpp:266-307):
MIN_SAMPLE samples everywhere, then pixels whose per-channel sample
variance exceeds THRESHOLD get the remaining samples as masked waves.

Per-wave kernel seeds come from a torch.Generator seeded with cfg.seed,
and the lens from a second one on the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from rtbench.reference.frozen.core.math import BIGFLOAT
from rtbench.reference.frozen.render.camera import primary_rays_ch
from rtbench.reference.frozen.render.config import RenderConfig
from rtbench.reference.frozen.render.scene_tables import (
    WaveTables, fused_reason, scene_tables,
)
from rtbench.reference.frozen.render.wave import wave
from rtbench.reference.frozen.scene.build import Scene


class WaveInputs(NamedTuple):
    """What a sample wave needs besides the scene and its kernel seed: the
    photon and caustic maps (None on this path) and the device generator
    of the wave's draws (the lens)."""
    gi_map: Optional[object]
    caustic: Optional[object]
    generator: torch.Generator


def _need_mask(cfg, rad, rad2, hits):
    """Adaptive-AA refinement mask: per-pixel per-channel variance over the
    HIT samples exceeds the threshold (main.cpp:164-189)."""
    cnt = torch.clamp(hits, min=1).to(torch.float32)[None, :]
    mean = rad / cnt
    var = rad2 / cnt - mean * mean
    return (torch.amax(var, dim=0) > cfg.variance_threshold) & (hits > 0)


def _phase_bounds(cfg) -> list:
    """Cumulative sample counts at each adaptive rung's end.
    adaptive_factor=0: [min, max]; k>=2: min, min*k, ... max."""
    bounds = [cfg.min_samples]
    while bounds[-1] < cfg.max_samples:
        if cfg.adaptive_factor >= 2:
            bounds.append(min(bounds[-1] * cfg.adaptive_factor,
                              cfg.max_samples))
        else:
            bounds.append(cfg.max_samples)
    return bounds



def wave_contrib(scene, cfg, tables: WaveTables, px, py, mask, j, seed,
                 gi: WaveInputs, blk0: int = 0):
    """One sample wave over the lanes (px, py): (contrib [3,n], hit_count
    [n], z_min [n]) in lane space, one wave-kernel launch.  blk0: the
    lanes' first global 1024-lane block, which keys the wave kernel's
    random streams."""
    n = px.shape[0]
    j = torch.tensor(j, dtype=torch.int64)
    bases = (cfg.halton_base_x, cfg.halton_base_y)
    lens_u = None
    if scene.dof > 0:
        lens_u = torch.rand((2, n), generator=gi.generator,
                            device=mask.device)
    o3, d3 = primary_rays_ch(scene, px, py, j, halton_bases=bases,
                             lens_u=lens_u)
    rad3, hitl, zl = wave(cfg, tables, o3, d3, mask, seed, blk0=blk0)
    return rad3, hitl.to(torch.int32), torch.where(hitl, zl, BIGFLOAT)


def adaptive_ladder(scene: Scene, cfg: RenderConfig, tables: WaveTables,
                    order: torch.Tensor, seed: int, gi_map=None,
                    caustic=None, blk0: int = 0):
    """The adaptive ladder in lane space (rtf_tpu/render/renderer.py::
    adaptive_ladder): (rad [3,P], hits [P], z [P], nsamples [P]) with lane
    k = pixel order[k], every sample wave a `wave_contrib`.  blk0 goes to
    the wave kernel (see `wave_contrib`)."""
    dev = tables.device
    px, py = order % scene.width, order // scene.width
    n = order.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    gi = WaveInputs(gi_map, caustic,
                    torch.Generator(device=dev).manual_seed(int(seed)))
    rad = torch.zeros((3, n), dtype=torch.float32, device=dev)
    rad2 = torch.zeros_like(rad)
    hits = torch.zeros(n, dtype=torch.int32, device=dev)
    z = torch.full((n,), BIGFLOAT, dtype=torch.float32, device=dev)

    bounds = _phase_bounds(cfg)

    def run(mask, lo, hi):
        nonlocal rad, rad2, hits, z
        for j in range(lo, hi):
            s = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            contrib, hc, zm = wave_contrib(scene, cfg, tables, px, py,
                                           mask, j, s, gi, blk0)
            rad = rad + contrib
            rad2 = rad2 + contrib * contrib
            hits = hits + hc
            z = torch.minimum(z, zm)

    all_px = torch.ones(n, dtype=torch.bool, device=dev)
    run(all_px, 0, bounds[0])
    nsamples = torch.full((n,), bounds[0], dtype=torch.int32, device=dev)
    need = all_px
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        # variance over ALL accumulated hit samples (colorlist grows
        # across rungs, main.cpp:273); a pixel that stops never resumes
        need = need & _need_mask(cfg, rad, rad2, hits)
        run(need, lo, hi)
        nsamples = nsamples + torch.where(need, hi - lo, 0).to(torch.int32)
    return rad, hits, z, nsamples


def _scene_on(x, dev):
    """A copy of the scene (or one of its tables) with every tensor on
    `dev`; the wavefront reads the scene's own tensors."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if not dataclasses.is_dataclass(x):
        return x
    kw = {f.name: _scene_on(getattr(x, f.name), dev)
          for f in dataclasses.fields(x) if f.name != "device"}
    if isinstance(x, Scene):
        kw["device"] = dev
    return dataclasses.replace(x, **kw)


def _cached_volume(grid: PhotonGrid, radius, k, bounds_min, bounds_max):
    """The grid's irradiance volume, baked once per grid and kept on it
    (rtf_tpu/render/renderer.py::_cached_volume): a bake costs seconds and
    must happen once per photon pass, not once per frame."""
    key = (float(radius), int(k), tuple(bounds_min), tuple(bounds_max))
    vol = grid.volumes.get(key)
    if vol is None:
        vol = grid.volumes[key] = build_irradiance_volume(
            grid, radius, k, bounds_min, bounds_max)
    return vol


def _one_of(grid, vol, name):
    if grid is not None and vol is not None:
        raise ValueError(f"pass {name}_grid or {name}_vol, not both")
    return vol if grid is None else grid


def _on_device(scene: Scene, cfg: RenderConfig, dev: torch.device,
               tables: WaveTables = None):
    """The scene on `dev`, with the config's intersection statics unless
    cfg is None, and its tables (built when not given)."""
    if cfg is not None and (float(cfg.isect_zero), bool(cfg.ref_exact),
            bool(cfg.sphere_minroot)) != (float(scene.isect_zero),
                                          bool(scene.ref_exact),
                                          bool(scene.sphere_minroot)):
        # the era's intersection statics travel on the scene, so trace()
        # sees them without a cfg plumb-through (renderer.py:421-428)
        scene = dataclasses.replace(
            scene, isect_zero=float(cfg.isect_zero),
            ref_exact=bool(cfg.ref_exact),
            sphere_minroot=bool(cfg.sphere_minroot))
    if scene.device != dev:
        scene = _scene_on(scene, dev)
    if tables is None:
        tables = scene_tables(scene, dev)
    elif tables.device != dev:
        raise ValueError(f"tables live on {tables.device}, not {dev}")
    return scene, tables


def _prepare(scene: Scene, cfg: RenderConfig, seed, dev: torch.device,
             tables: WaveTables, gi_grid, caustic_grid, path=None):
    """What a frame's ladder needs: the scene on `dev` with its tables,
    the seed and the path ('fused'); no photon or caustic map."""
    if (gi_grid is not None or caustic_grid is not None
            or cfg.gi_mode != "none" or path not in (None, "fused")):
        raise NotImplementedError("the reference renders the fused path "
                                  "without GI only")
    seed = cfg.seed if seed is None else seed
    why = fused_reason(scene, cfg)
    if why:
        raise ValueError(f"the fused path does not take this scene and "
                         f"config: {why}")
    scene, tables = _on_device(scene, cfg, dev, tables)
    return scene, tables, seed, "fused", None, None
