"""Top-level renderer: sample waves, adaptive AA, finalize.

The port of the fused branch of rtf_tpu/render/renderer.py: a wave is
(all pixels, in `pixel_order`) x (one Halton sample index), traced by one
launch of the wave kernel.  Adaptive antialiasing is the reference's
two-phase scheme (main.cpp:266-307): MIN_SAMPLE samples everywhere, then
pixels whose per-channel sample variance exceeds THRESHOLD get the
remaining samples as masked waves.  Output conventions match RenderImage
(scene.h:540-656): gamma before `Clamp(int(c*255))`, misses show the
background (its colour times its map at uvw = (x/W, y/H, 0)), z-buffer and
sample-count AOVs.

Per-wave kernel seeds come from a torch.Generator seeded with cfg.seed
(JAX's threefry key stream is not reproduced).

GI (gi_mode 'hemisphere', 'pathtrace', or 'photon' with an irradiance
volume passed in, and a caustic volume in any mode): each sample wave is
render/gi.py::gi_wave, the primary launch and cfg.hemisphere_samples child
launches, with the hemisphere draws taken from a torch.Generator on the
device (rtf_tpu/render/renderer.py's `gi_host` loop, without its
per-dispatch chunking).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rtf_tpu_torch.core.math import BIGFLOAT
from rtf_tpu_torch.gi.volume import IrradianceVolume
from rtf_tpu_torch.ops.texture import sample_background
from rtf_tpu_torch.render.camera import pixel_order, primary_rays_ch
from rtf_tpu_torch.render.config import RenderConfig
from rtf_tpu_torch.render.gi import gi_wave
from rtf_tpu_torch.render.scene_tables import (
    WaveTables, scene_tables, unsupported_reason,
)
from rtf_tpu_torch.render.wave import wave
from rtf_tpu_torch.scene.build import Scene, resolve_device


class RenderResult(NamedTuple):
    image: np.ndarray         # [H,W,3] uint8 (gamma'd like the reference)
    radiance: np.ndarray      # [H,W,3] float32 linear
    z: np.ndarray             # [H,W] float32, BIGFLOAT = miss
    sample_count: np.ndarray  # [H,W] int32


class GiInputs(NamedTuple):
    """What a GI sample wave needs besides the scene: the photon volume
    (gi_mode 'photon'), the caustic volume and the generator of the
    hemisphere draws."""
    vol: Optional[IrradianceVolume]
    caustic: Optional[IrradianceVolume]
    generator: torch.Generator


def check_supported(scene: Scene, cfg: RenderConfig, gi_vol=None,
                    caustic_vol=None) -> None:
    """Raise NotImplementedError for anything outside the ported slice."""
    why = unsupported_reason(scene, cfg, gi_vol, caustic_vol)
    if why is not None:
        raise NotImplementedError(f"not supported by rtf_tpu_torch yet: "
                                  f"{why}")


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
                 gi: Optional[GiInputs] = None):
    """One sample wave over the lanes (px, py), with GI when `gi` is
    given: (contrib [3,n], hit_count [n], z_min [n]) in lane space."""
    o3, d3 = primary_rays_ch(
        scene, px, py, torch.tensor(j, dtype=torch.int64),
        halton_bases=(cfg.halton_base_x, cfg.halton_base_y))
    if gi is None:
        rad3, hitl, zl = wave(cfg, tables, o3, d3, mask, seed)
    else:
        # (u_phi, ysq) of each hemisphere sample
        uniforms = torch.rand((cfg.hemisphere_samples, 2, mask.shape[0]),
                              generator=gi.generator, device=mask.device)
        rad3, hitl, zl = gi_wave(cfg, tables, o3, d3, mask, seed, uniforms,
                                 gi_vol=gi.vol, caustic_vol=gi.caustic)
    return rad3, hitl.to(torch.int32), torch.where(hitl, zl, BIGFLOAT)


def render_lanes(scene: Scene, cfg: RenderConfig, tables: WaveTables,
                 order: torch.Tensor, seed: int, gi_vol=None,
                 caustic_vol=None):
    """The adaptive ladder in lane space: (rad [3,P], hits [P], z [P],
    nsamples [P]) with lane k = pixel order[k].  Every sample wave is a
    GI wave when cfg.gi_mode is not 'none' or a caustic volume is given
    (rtf_tpu's wave_contrib on the fused path)."""
    dev = tables.device
    px, py = order % scene.width, order // scene.width
    n = order.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    gi = None
    if cfg.gi_mode != "none" or caustic_vol is not None:
        gi = GiInputs(gi_vol, caustic_vol,
                      torch.Generator(device=dev).manual_seed(int(seed)))
    rad = torch.zeros((3, n), dtype=torch.float32, device=dev)
    rad2 = torch.zeros_like(rad)
    hits = torch.zeros(n, dtype=torch.int32, device=dev)
    z = torch.full((n,), BIGFLOAT, dtype=torch.float32, device=dev)

    def run(mask, lo, hi):
        nonlocal rad, rad2, hits, z
        for j in range(lo, hi):
            s = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            contrib, hc, zm = wave_contrib(scene, cfg, tables, px, py,
                                           mask, j, s, gi)
            rad = rad + contrib
            rad2 = rad2 + contrib * contrib
            hits = hits + hc
            z = torch.minimum(z, zm)

    all_px = torch.ones(n, dtype=torch.bool, device=dev)
    bounds = _phase_bounds(cfg)
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


def lanes_to_pixels(rad, hits, z, nsamples, order):
    """Lane -> pixel-id order: pixel p's accumulators live at lane inv[p]."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return rad[:, inv], hits[inv], z[inv], nsamples[inv]


def _finalize_device(scene, cfg, tables, rad, hits, z):
    """Average over hit samples, the background where no sample hit, gamma
    and byte conversion (main.cpp:309-338; rtf_tpu/render/renderer.py::
    _finalize_device)."""
    w, h = scene.width, scene.height
    avg = rad.T / torch.clamp(hits, min=1).to(torch.float32)[:, None]
    miss = hits == 0
    # uvw = (x/W, y/H, 0); W and H divide as tensors, a true division as
    # in rtf_tpu (CUDA divides by a Python scalar through its reciprocal)
    idx = torch.arange(w * h, dtype=torch.int64, device=avg.device)
    size = torch.tensor([float(w), float(h)], device=avg.device)
    bg = sample_background(tables, scene.bg_color,
                           (idx % w).to(torch.float32) / size[0],
                           (idx // w).to(torch.float32) / size[1])
    avg = torch.where(miss[:, None], bg, avg)
    zout = torch.where(miss, BIGFLOAT, z)
    if cfg.gamma and cfg.gamma > 0:
        avg_g = torch.pow(torch.clamp(avg, min=0.0), 1.0 / cfg.gamma)
    else:
        avg_g = avg
    img8 = torch.clamp(torch.floor(avg_g * 255.0), 0, 255).to(torch.uint8)
    return img8, avg, zout


def finalize(scene, cfg, tables, rad, hits, z, nsamples) -> RenderResult:
    w, h = scene.width, scene.height
    img8, avg, zout = _finalize_device(scene, cfg, tables, rad, hits, z)
    return RenderResult(
        image=img8.cpu().numpy().reshape(h, w, 3),
        radiance=avg.cpu().numpy().reshape(h, w, 3),
        z=zout.cpu().numpy().reshape(h, w),
        sample_count=nsamples.cpu().numpy().reshape(h, w),
    )


def render(scene: Scene, cfg: RenderConfig = RenderConfig(), seed=None,
           device="cuda", tables: WaveTables = None,
           gi_vol: IrradianceVolume = None,
           caustic_vol: IrradianceVolume = None) -> RenderResult:
    """Render a built scene.  Runs on the card unless device='cpu'; the
    scene's tensors are moved to `device` as needed.  Pass `tables`
    (render/scene_tables.py) to reuse them across frames.

    gi_vol: the photon irradiance volume that gi_mode 'photon' reads
    below the first hit (gi/volume.py: `load_volume`,
    `volume_from_arrays`); the photon pass that builds one is not ported.
    caustic_vol: a caustic volume, added at the first hit in any GI mode
    (rtf_tpu.render's caustic_grid, as a volume)."""
    dev = resolve_device(device)
    check_supported(scene, cfg, gi_vol, caustic_vol)
    if gi_vol is not None and cfg.gi_mode != "photon":
        raise ValueError(f"gi_vol is read only by gi_mode='photon', not "
                         f"{cfg.gi_mode!r}")
    gi_vol, caustic_vol = (None if v is None else v.to(dev)
                           for v in (gi_vol, caustic_vol))
    if tables is None:
        tables = scene_tables(scene, dev)
    elif tables.device != dev:
        raise ValueError(f"tables live on {tables.device}, not {dev}")
    order = torch.as_tensor(pixel_order(scene.width, scene.height),
                            device=dev).to(torch.int64)
    rad, hits, z, ns = render_lanes(scene, cfg, tables, order,
                                    cfg.seed if seed is None else seed,
                                    gi_vol, caustic_vol)
    rad, hits, z, ns = lanes_to_pixels(rad, hits, z, ns, order)
    return finalize(scene, cfg, tables, rad, hits, z, ns)
