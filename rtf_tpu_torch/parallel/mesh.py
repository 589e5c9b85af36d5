"""A frame sharded over pixel tiles and sample groups
(rtf_tpu/parallel/mesh.py).

The reference's parallel runtime is an atomic pixel queue consumed by
threads that write one framebuffer (Final/main.cpp:65-87, 984-998).
rtf_tpu shards a frame over a ("tile", "spp") device mesh; the port does
the same over a torch.distributed DeviceMesh of processes, one card (or
CPU rank) each:

* "tile": each tile rank renders a contiguous chunk of the frame's lanes
  (camera.pixel_order's order);
* "spp": the ranks of one tile render the same lanes, sample j on rank
  j % n_spp, and sum their accumulators before every variance decision
  (render/renderer.py::adaptive_ladder).

The scene and its tables are replicated: every rank holds its own (built
by the rank, or handed in as `render` takes them).  The only collectives
are the spp group's sums and the final gather over the tile group.  Start
the processes with parallel/distributed.py::init_multihost first.
"""
from __future__ import annotations

import torch
from torch import distributed as dist

from rtf_tpu_torch.render.renderer import _frame, lanes_to_pixels
from rtf_tpu_torch.render.wave import BLOCK
from rtf_tpu_torch.scene.build import resolve_device
from rtf_tpu_torch.utils import tracing


def make_mesh(n_tile: int = None, n_spp: int = 1, device_type="cuda"):
    """A ("tile", "spp") DeviceMesh over every process of the group
    (n_tile defaults to the world size over n_spp)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_tile is None:
        n_tile = n // n_spp
    if n_tile * n_spp != n:
        raise ValueError(f"{n_tile}x{n_spp} != {n} processes")
    return init_device_mesh(device_type, (n_tile, n_spp),
                            mesh_dim_names=("tile", "spp"))


def render_sharded(scene, cfg, mesh, seed: int = 0, fused: bool = None,
                   gi_grid=None, caustic_grid=None, device="cuda",
                   tables=None):
    """The full adaptive render, sharded over `mesh` (`make_mesh`).
    Returns (rad [3,P], hits [P], z [P], nsamples [P]) in pixel-id order
    on `device`, the same on every rank: the contract of
    render/renderer.py::render_device_host and of rtf_tpu's
    render_sharded, and its frame: the same prologue and spans (rtf.frame,
    rtf.prepare, rtf.wave, rtf.finalize around the gathered lanes).

    fused: None takes the path `render` takes (render_path), True the
    wave kernel (ValueError where its gate refuses the scene), False the
    wavefront.  gi_grid and caustic_grid follow `render`'s conventions; on
    the fused path with cfg.photon_volume they are baked into volumes, as
    rtf_tpu's render_sharded does (parallel/mesh.py:103-117).  tables:
    the scene's tables on `device` (render/scene_tables.py), reused as
    `render` reuses them; without, the rank builds them.  On the fused
    path a tile's first 1024-lane block, blk0, is its rank times the
    blocks a tile has, so the kernel's random streams are those of the
    single-device frame where a tile's lane count is a multiple of 1024.
    """
    num_px = scene.width * scene.height
    n_tile, n_spp = mesh["tile"].size(), mesh["spp"].size()
    if num_px % n_tile:
        raise ValueError(f"{num_px} pixels do not divide into {n_tile} "
                         f"tiles")
    tile, spp = mesh.get_local_rank("tile"), mesh.get_local_rank("spp")
    per = num_px // n_tile
    with tracing.span(tracing.FRAME, width=scene.width,
                      height=scene.height) as sp:
        _, _, acc, order = _frame(
            sp, scene, cfg, seed, resolve_device(device), tables, gi_grid,
            caustic_grid, None if fused is None
            else ("fused" if fused else "wavefront"),
            slice(tile * per, (tile + 1) * per), spp_rank=spp, n_spp=n_spp,
            group=mesh.get_group("spp"), blk0=tile * -(-per // BLOCK))
        tile_group = mesh.get_group("tile")
        full = []
        for x in acc:
            parts = [torch.empty_like(x) for _ in range(n_tile)]
            dist.all_gather(parts, x.contiguous(), group=tile_group)
            full.append(torch.cat(parts, dim=-1))
        with tracing.span(tracing.FINALIZE):
            return lanes_to_pixels(*full, order)
