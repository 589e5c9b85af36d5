"""Top-level renderer: sample waves, adaptive AA, finalize.

The port of rtf_tpu/render/renderer.py: a wave is (all pixels, in
`pixel_order`) x (one Halton sample index).  `render` takes the path
rtf_tpu takes on a TPU (render/scene_tables.py::render_path): one launch
of the wave kernel per wave where rtf_tpu's fused or segmented kernel path
runs the scene+config (a mesh over 512 faces on its MXU-table variant),
else the XLA wavefront's port (render/integrator.py::render_wave, lane ids
as pixels), whose mesh test is the mesh_closest_hit kernel.  The chosen
path is printed once per scene and path ("[rtf] render path: ...",
silenced by RTF_QUIET=1).  Adaptive
antialiasing is the reference's two-phase scheme (main.cpp:266-307):
MIN_SAMPLE samples everywhere, then pixels whose per-channel sample
variance exceeds THRESHOLD get the remaining samples as masked waves.
Output conventions match RenderImage (scene.h:540-656): gamma before
`Clamp(int(c*255))`, misses show the background (its colour times its map
at uvw = (x/W, y/H, 0)), z-buffer and sample-count AOVs.

`render` is `render_device_host` (the raw accumulators in pixel order;
the CLI's `watch` accumulates passes with its `sample_base` and
`progress_cb`) and `finalize`; `preview` is the flat-shaded single trace
the CLI writes before a render.  `adaptive_ladder` is the ladder of one
device or of one shard of parallel/mesh.py::render_sharded.  A frame's
parts are the spans rtf.frame, rtf.prepare, rtf.wave and rtf.finalize of
utils/tracing.py (off unless enabled).

Per-wave kernel seeds come from a torch.Generator seeded with cfg.seed,
and the wavefront's draws (soft shadows, glossy normals, Russian
roulette, hemisphere directions) and the lens from a second one on the
device (JAX's threefry key stream is not reproduced).

Photon GI as rtf_tpu renders it: 'photon' and 'pm_direct' read a photon
map, which `render` shoots itself when none is handed in
(`prepare_photon_grid`: gi/photon.py, gi/grid.py); the irradiance volumes
are baked from the grids where rtf_tpu bakes them (`_cached_volume`,
gi/volume.py::build_irradiance_volume, once per grid).  GI on the fused
path (gi_mode 'hemisphere', 'pathtrace', or 'photon' with photon_volume,
and a caustic map in any mode): each sample wave is render/gi.py::
gi_wave, the primary launch and cfg.hemisphere_samples child launches
(rtf_tpu/render/renderer.py's `gi_host` loop, without its per-dispatch
chunking).  On the wavefront GI is render_wave's own hemisphere fan-out,
volume term or exact gather, and the caustic grid's gather.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from rtf_tpu_torch.core.math import BIGFLOAT, dot
from rtf_tpu_torch.gi.grid import PhotonGrid, build_photon_grid
from rtf_tpu_torch.gi.photon import shoot_photons
from rtf_tpu_torch.gi.volume import IrradianceVolume, build_irradiance_volume
from rtf_tpu_torch.ops.texture import _sel_rows, sample_background
from rtf_tpu_torch.ops.trace import resolve_surface, trace
from rtf_tpu_torch.render.camera import (
    pixel_grid, pixel_order, primary_rays, primary_rays_ch,
)
from rtf_tpu_torch.render.config import RenderConfig
from rtf_tpu_torch.render.gi import gi_wave
from rtf_tpu_torch.render.integrator import render_wave
from rtf_tpu_torch.render.scene_tables import (
    MAX_FACES, WaveTables, fused_reason, mesh_mode, render_path,
    scene_tables, wavefront_reason,
)
from rtf_tpu_torch.render.wave import wave
from rtf_tpu_torch.scene.build import Scene, resolve_device
from rtf_tpu_torch.utils import tracing

_LOGGED_PATHS = set()


class RenderResult(NamedTuple):
    image: np.ndarray         # [H,W,3] uint8 (gamma'd like the reference)
    radiance: np.ndarray      # [H,W,3] float32 linear
    z: np.ndarray             # [H,W] float32, BIGFLOAT = miss
    sample_count: np.ndarray  # [H,W] int32


class WaveInputs(NamedTuple):
    """What a sample wave needs besides the scene and its kernel seed: the
    photon map (gi_mode 'photon' or 'pm_direct'; a volume, or on the
    wavefront a grid), the caustic map (a volume on the fused path, a grid
    on the wavefront) and the device generator of the wave's draws (the
    lens, the fused path's hemisphere directions, the wavefront's
    draws)."""
    gi_map: Optional[object]
    caustic: Optional[object]
    generator: torch.Generator


def _log_path(scene, path: str, why):
    """Print the path decision once per (scene, path), like
    rtf_tpu/render/renderer.py::_log_path; RTF_QUIET=1 silences it."""
    key = (id(scene), path)
    if key in _LOGGED_PATHS or os.environ.get("RTF_QUIET"):
        return
    _LOGGED_PATHS.add(key)
    print(f"[rtf] render path: {path}" + (f" ({why})" if why else ""),
          flush=True)


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
                 gi: WaveInputs, wavefront: bool = False, blk0: int = 0):
    """One sample wave over the lanes (px, py): (contrib [3,n], hit_count
    [n], z_min [n]) in lane space.  On the fused path one wave-kernel
    launch, or a GI sample wave when cfg.gi_mode is not 'none' or a
    caustic volume is given; on the wavefront render_wave with local lane
    ids as pixels, so its output is lane space.  blk0: the lanes' first
    global 1024-lane block, which keys the wave kernel's random streams
    (a tile of a sharded frame passes its own, as rtf_tpu does)."""
    n = px.shape[0]
    j = torch.tensor(j, dtype=torch.int64)
    bases = (cfg.halton_base_x, cfg.halton_base_y)
    lens_u = None
    if scene.dof > 0:
        lens_u = torch.rand((2, n), generator=gi.generator,
                            device=mask.device)
    if wavefront:
        ids = torch.arange(n, dtype=torch.int64, device=mask.device)
        o, d = primary_rays(scene, px, py, j, halton_bases=bases,
                            lens_u=lens_u)
        out = render_wave(scene, cfg, tables, o, d, ids, mask, gi.generator,
                          n, gi_map=gi.gi_map, inv_pixel=ids,
                          caustic_grid=gi.caustic)
        return out.radiance.T, out.hit_count, out.z_min
    o3, d3 = primary_rays_ch(scene, px, py, j, halton_bases=bases,
                             lens_u=lens_u)
    if cfg.gi_mode == "none" and gi.caustic is None:
        rad3, hitl, zl = wave(cfg, tables, o3, d3, mask, seed, blk0=blk0)
    else:
        # (u_phi, ysq) of each hemisphere sample
        uniforms = torch.rand((cfg.hemisphere_samples, 2, n),
                              generator=gi.generator, device=mask.device)
        rad3, hitl, zl = gi_wave(cfg, tables, o3, d3, mask, seed, uniforms,
                                 gi_vol=gi.gi_map, caustic_vol=gi.caustic)
    return rad3, hitl.to(torch.int32), torch.where(hitl, zl, BIGFLOAT)


def adaptive_ladder(scene: Scene, cfg: RenderConfig, tables: WaveTables,
                    order: torch.Tensor, seed: int, gi_map=None,
                    caustic=None, wavefront: bool = False,
                    sample_base: int = 0, progress_cb=None,
                    spp_rank: int = 0, n_spp: int = 1, group=None,
                    blk0: int = 0):
    """The adaptive ladder in lane space (rtf_tpu/render/renderer.py::
    adaptive_ladder): (rad [3,P], hits [P], z [P], nsamples [P]) with lane
    k = pixel order[k], every sample wave a `wave_contrib` on the fused
    path or on the wavefront.  Wave j of the ladder takes Halton index
    sample_base + j; progress_cb(done, total) is called after each wave
    (see `render_device_host`).

    Sharding (parallel/mesh.py::render_sharded): sample j runs on rank
    j % n_spp of the spp group.  Every rank draws the host seed of every
    j, so a wave's kernel seed does not depend on the rank that renders
    it; with n_spp > 1 each rank's device generator (the wavefront's
    draws, the lens, the hemisphere directions) is seeded from (seed,
    rank), so ranks do not repeat each other's draws.  Before every
    variance decision, and for the result, rad, rad2 and hits are summed
    and z minimised over `group` (a torch.distributed process group), so
    every rank takes the same refinement mask, as rtf_tpu's psum over its
    "spp" axis.  blk0 goes to the wave kernel (see `wave_contrib`).  With
    the defaults (n_spp 1, no group, blk0 0) it is the single-device
    frame."""
    dev = tables.device
    px, py = order % scene.width, order // scene.width
    n = order.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    dev_seed = int(seed) if n_spp == 1 else int(np.random.SeedSequence(
        [int(seed), int(spp_rank)]).generate_state(1)[0])
    gi = WaveInputs(gi_map, caustic,
                    torch.Generator(device=dev).manual_seed(dev_seed))
    rad = torch.zeros((3, n), dtype=torch.float32, device=dev)
    rad2 = torch.zeros_like(rad)
    hits = torch.zeros(n, dtype=torch.int32, device=dev)
    z = torch.full((n,), BIGFLOAT, dtype=torch.float32, device=dev)

    bounds = _phase_bounds(cfg)
    done = 0

    def host_seed():
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))

    def run(mask, lo, hi):
        nonlocal rad, rad2, hits, z, done
        for j in range(lo, hi):
            if j % n_spp != spp_rank:
                host_seed()          # every rank draws every wave's seed
                continue
            with tracing.span(tracing.WAVE, index=sample_base + j, lanes=n):
                s = host_seed()
                contrib, hc, zm = wave_contrib(scene, cfg, tables, px, py,
                                               mask, sample_base + j, s, gi,
                                               wavefront, blk0)
                rad = rad + contrib
                rad2 = rad2 + contrib * contrib
                hits = hits + hc
                z = torch.minimum(z, zm)
            if progress_cb is not None:
                hits[:1].cpu()        # a small fence: the wave has finished
                done += 1
                progress_cb(done, bounds[-1])

    def combined():
        if group is None:
            return rad, rad2, hits, z
        from torch import distributed as dist
        out = [x.clone() for x in (rad, rad2, hits, z)]
        for x in out[:3]:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(out[3], op=dist.ReduceOp.MIN, group=group)
        return out

    all_px = torch.ones(n, dtype=torch.bool, device=dev)
    run(all_px, 0, bounds[0])
    nsamples = torch.full((n,), bounds[0], dtype=torch.int32, device=dev)
    need = all_px
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        # variance over ALL accumulated hit samples (colorlist grows
        # across rungs, main.cpp:273); a pixel that stops never resumes
        c_rad, c_rad2, c_hits, _ = combined()
        need = need & _need_mask(cfg, c_rad, c_rad2, c_hits)
        run(need, lo, hi)
        nsamples = nsamples + torch.where(need, hi - lo, 0).to(torch.int32)
    c_rad, _, c_hits, c_z = combined()
    return c_rad, c_hits, c_z, nsamples


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
    the seed, the path ('fused' or 'wavefront': render_path's, or the
    caller's) and the photon and caustic maps in the form that path reads
    (a photon map shot here where photon GI gets none, volumes baked from
    grids where they are read)."""
    if gi_grid is not None and cfg.gi_mode not in ("photon", "pm_direct"):
        raise ValueError(f"a photon map is read only by gi_mode 'photon' "
                         f"and 'pm_direct', not {cfg.gi_mode!r}")
    seed = cfg.seed if seed is None else seed
    auto, why = render_path(scene, cfg, caustic_grid)
    if path is None:
        if auto is None:
            raise NotImplementedError(f"not supported by rtf_tpu_torch yet: "
                                      f"{why}")
        path = auto
    elif path == "fused" and fused_reason(scene, cfg, caustic_grid):
        raise ValueError(f"the fused path does not take this scene and "
                         f"config: {fused_reason(scene, cfg, caustic_grid)}")
    elif path == "wavefront" and wavefront_reason(scene, cfg, caustic_grid):
        raise NotImplementedError(
            f"not supported by rtf_tpu_torch yet: "
            f"{wavefront_reason(scene, cfg, caustic_grid)}")
    if path == "fused":
        label = ("fused, the wave kernel's MXU-table mesh variant "
                 f"({scene.mesh.tri_a.shape[0]} faces > {MAX_FACES})"
                 if mesh_mode(scene) == "mxu" else "fused")
    else:
        label = "XLA wavefront"
    _log_path(scene, label, why)
    scene, tables = _on_device(scene, cfg, dev, tables)
    if cfg.gi_mode in ("photon", "pm_direct") and gi_grid is None:
        gi_grid = prepare_photon_grid(scene, cfg, seed, tables=tables)

    def volume(m, radius):
        if m is None or isinstance(m, IrradianceVolume):
            return None if m is None else m.to(dev)
        return _cached_volume(m, radius, cfg.knn_k, scene.world_min,
                              scene.world_max)
    gi_map = gi_grid
    if cfg.photon_volume or isinstance(gi_grid, IrradianceVolume):
        gi_map = volume(gi_grid, cfg.knn_radius)
    # the caustic volume only where the fused path reads it (the wavefront
    # gathers from the caustic grid)
    caustic = volume(caustic_grid, cfg.caustic_radius) \
        if path == "fused" else caustic_grid
    return scene, tables, seed, path, gi_map, caustic


def _frame(frame_span, scene: Scene, cfg: RenderConfig, seed,
           dev: torch.device, tables: WaveTables, gi_grid, caustic_grid,
           path=None, lanes=slice(None), **ladder):
    """One frame's accumulators in lane space, with the scene on `dev` and
    its tables: (scene, tables, (rad, hits, z, nsamples), order).  The
    prologue of every frame (`render`, `render_device_host`,
    parallel/mesh.py::render_sharded) is the span rtf.prepare; the path
    (`_prepare`'s) goes on frame_span.  The ladder renders the lanes
    order[lanes] (a sharded frame's tile) with `ladder`'s arguments of
    `adaptive_ladder`."""
    with tracing.span(tracing.PREPARE):
        scene, tables, seed, path, gi_map, caustic = _prepare(
            scene, cfg, seed, dev, tables, gi_grid, caustic_grid, path)
        order = torch.as_tensor(pixel_order(scene.width, scene.height),
                                device=dev).to(torch.int64)
    frame_span.set(path=path)
    acc = adaptive_ladder(scene, cfg, tables, order[lanes], seed, gi_map,
                          caustic, wavefront=path == "wavefront", **ladder)
    return scene, tables, acc, order


def render_device_host(scene: Scene, cfg: RenderConfig, seed=None,
                       device="cuda", tables: WaveTables = None,
                       gi_grid=None, caustic_grid=None,
                       sample_base: int = 0, progress_cb=None) -> tuple:
    """The frame's raw accumulators in pixel-id order, on `device`: (rad
    [3,P] summed over samples, hits [P] int32, z [P], nsamples [P] int32)
    (rtf_tpu/render/renderer.py::render_device_host).  `render` is this
    and `finalize`; the arguments are render's, without its gi_vol and
    caustic_vol aliases.

    sample_base offsets the Halton index of every wave of both adaptive
    phases, so that a caller accumulating passes (the CLI's `watch`)
    continues the index stream instead of re-rendering index 0.
    progress_cb(done_waves, total_waves) is called after each wave, with
    total_waves = _phase_bounds(cfg)[-1]; each call first waits for the
    wave with a one-element device-to-host copy, which is paid only when
    a callback is given."""
    with tracing.span(tracing.FRAME, width=scene.width,
                      height=scene.height) as sp:
        _, _, acc, order = _frame(sp, scene, cfg, seed,
                                  resolve_device(device), tables, gi_grid,
                                  caustic_grid, sample_base=sample_base,
                                  progress_cb=progress_cb)
        with tracing.span(tracing.FINALIZE):
            return lanes_to_pixels(*acc, order)


def render(scene: Scene, cfg: RenderConfig = RenderConfig(), seed=None,
           device="cuda", tables: WaveTables = None,
           gi_vol: IrradianceVolume = None,
           caustic_vol: IrradianceVolume = None,
           gi_grid=None, caustic_grid=None) -> RenderResult:
    """Render a built scene.  Runs on the card unless device='cpu'; the
    scene's tensors are moved to `device` as needed.  Pass `tables`
    (render/scene_tables.py) to reuse them across frames.

    gi_grid: the photon map that gi_mode 'photon' reads below the first
    hit and 'pm_direct' (wavefront only) at every hit: a PhotonGrid
    (`prepare_photon_grid`) or an IrradianceVolume (gi/volume.py:
    `load_volume`, `volume_from_arrays`).  Where those modes get none,
    `render` shoots cfg.photon_count photons itself from the seed.  With
    cfg.photon_volume a grid is baked into a volume (once per grid);
    without, the wavefront gathers from the grid exactly.  caustic_grid: a
    caustic map (`prepare_caustic_grid`, or a volume), added at the first
    hit in any GI mode: the fused path reads it as a volume (baked with
    cfg.photon_volume), the wavefront gathers from a grid.  gi_vol and
    caustic_vol: the same maps, as volumes."""
    with tracing.span(tracing.FRAME, width=scene.width,
                      height=scene.height) as sp:
        scene, tables, acc, order = _frame(
            sp, scene, cfg, seed, resolve_device(device), tables,
            _one_of(gi_grid, gi_vol, "gi"),
            _one_of(caustic_grid, caustic_vol, "caustic"))
        with tracing.span(tracing.FINALIZE):
            return finalize(scene, cfg, tables,
                            *lanes_to_pixels(*acc, order))


def _preview_device(scene: Scene, tables: WaveTables, frames: int,
                    lens_u=None, gen=None):
    """The flat-shaded preview trace (rtf_tpu/render/renderer.py::
    _preview_device): material base colour x (0.25 + 0.75 |N.V|), no
    shadows, bounces or textures, the background where the ray misses,
    Halton index 0.  frames > 1 averages lens-jittered frames and keeps
    the least z; frame f's lens uniforms [2, P] are lens_u[f], else drawn
    from `gen`.  Returns (image [P,3] uint8, z [P]) on the scene's
    device."""
    w, h = scene.width, scene.height
    dev = scene.device
    px, py = pixel_grid(w, h, dev)
    size = torch.tensor([float(w), float(h)], device=dev)
    bg = sample_background(tables, scene.bg_color,
                           px.to(torch.float32) / size[0],
                           py.to(torch.float32) / size[1])

    def frame(lu):
        o, d = primary_rays(scene, px, py, torch.zeros_like(px),
                            lens_u=lu)
        surf = resolve_surface(scene, o, d, trace(scene, o, d))
        kd = _sel_rows(scene.materials.diffuse, surf.mtl)
        ndv = torch.abs(dot(surf.n, -d))[:, None]
        col = torch.where(surf.valid[:, None], kd * (0.25 + 0.75 * ndv), bg)
        return col, torch.where(surf.valid, surf.t, BIGFLOAT)

    if frames <= 1:
        col, z = frame(None)
    else:
        col = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
        z = torch.full((w * h,), BIGFLOAT, dtype=torch.float32, device=dev)
        for f in range(frames):
            lu = lens_u[f] if lens_u is not None else torch.rand(
                (2, w * h), generator=gen, device=dev)
            cf, zf = frame(lu)
            col, z = col + cf, torch.minimum(z, zf)
        col = col / torch.full((), float(frames), device=dev)
    img8 = torch.clamp(torch.floor(col * 255.0), 0, 255).to(torch.uint8)
    return img8, z


def preview(scene: Scene, dof_frames: int = 0, seed: int = 0,
            device="cuda", tables: WaveTables = None,
            lens_u=None) -> RenderResult:
    """Fast flat-shaded scene preview, the analog of the reference's
    GL-rasterized pre-render view (ShowViewport, viewport.cpp:93-268): one
    trace per pixel, material base colours with a headlight term, the
    background on a miss (rtf_tpu/render/renderer.py::preview).  Runs on
    the card unless device='cpu'.

    dof_frames: when the camera has a lens (scene.dof > 0), average this
    many lens-jittered frames, the reference's 32-frame jittered GL
    accumulation (viewport.cpp:76-80, 344-361); 0 means 32 with a lens.
    The lens uniforms come from a device generator seeded by `seed`, or
    from lens_u [frames, 2, P] when given."""
    dev = resolve_device(device)
    scene, tables = _on_device(scene, None, dev, tables)
    w, h = scene.width, scene.height
    if dof_frames == 0:
        dof_frames = 32 if float(scene.dof) > 0 else 1
    frames = dof_frames if float(scene.dof) > 0 else 1
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    img8, z = _preview_device(scene, tables, frames, lens_u, gen)
    image = img8.cpu().numpy().reshape(h, w, 3)
    return RenderResult(
        image=image, radiance=image.astype(np.float32) / 255.0,
        z=z.cpu().numpy().reshape(h, w),
        sample_count=np.ones((h, w), np.int32))


def _pass_generator(scene, seed, stream: int) -> torch.Generator:
    """The device generator of a photon pass: the render seed and the
    pass's stream (rtf_tpu folds 999 and 998 into its key) mixed by
    numpy's SeedSequence."""
    s = int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])
    return torch.Generator(device=scene.device).manual_seed(s)


def prepare_photon_grid(scene: Scene, cfg: RenderConfig, seed: int,
                        tables: WaveTables = None) -> PhotonGrid:
    """Photon pass: shoot cfg.photon_count photons on the scene's device and
    build their grid at cfg.knn_radius (generatePhotonMap,
    main.cpp:350-437)."""
    pm = shoot_photons(scene, cfg, cfg.photon_count, cfg.photon_count,
                       _pass_generator(scene, seed, 999), tables=tables)
    return build_photon_grid(pm, cfg.knn_radius, scene.world_min,
                             scene.world_max)


def prepare_caustic_grid(scene: Scene, cfg: RenderConfig, seed: int,
                         tables: WaveTables = None) -> PhotonGrid:
    """Caustic photon pass: cfg.caustic_count photons, stored only after
    >= 2 specular segments (CausticTracing, Proj13 main.cpp:430-457), in a
    grid at cfg.caustic_radius."""
    pm = shoot_photons(scene, cfg, cfg.caustic_count, cfg.caustic_count,
                       _pass_generator(scene, seed, 998), caustic_only=True,
                       tables=tables)
    return build_photon_grid(pm, cfg.caustic_radius, scene.world_min,
                             scene.world_max)
