"""The reference's frames: the frozen plain path (rtbench/reference/frozen,
the port's plain PyTorch path at commit 224dbd1, cut to the fused path)
rendering what a timed frame rendered, from the same description and
seeds.

It imports nothing of the program.  From the configuration it builds its
own description (rtbench/scenes.py with the frozen classes), scene and
tables, and renders a sample of whole 1024-lane blocks of the frame with
the plain wave (each block draws the random streams it draws in the whole
frame, and no lane depends on another block), through the whole adaptive
ladder.  A wavefront traffic has no reference here yet: it raises.

`lower=True` is the control: the same with the scene's floats and the
camera's rays rounded to bfloat16, the precision below the float32 the
configuration states.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from rtbench import manifest, scenes
from rtbench.reference.frozen.core import transform as _transform
from rtbench.reference.frozen.core.math import BIGFLOAT
from rtbench.reference.frozen.ops.texture import sample_background
from rtbench.reference.frozen.render import camera as _camera
from rtbench.reference.frozen.render import renderer as R
from rtbench.reference.frozen.render.config import PROFILES, RenderConfig
from rtbench.reference.frozen.render.scene_tables import scene_tables
from rtbench.reference.frozen.render.wave import BLOCK
from rtbench.reference.frozen.scene import model as _model
from rtbench.reference.frozen.scene.build import Scene, build_scene

KINDS = scenes.kinds_of(_model, _transform)


def render_config(traffic: dict) -> RenderConfig:
    base = PROFILES[traffic["profile"]] if "profile" in traffic \
        else RenderConfig()
    return base.with_(**traffic.get("render", {}))


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _lowered(x):
    """A copy of a scene (or part of it) with every float tensor rounded to
    bfloat16."""
    if isinstance(x, torch.Tensor):
        return _round_bf16(x) if x.dtype == torch.float32 else x
    if not dataclasses.is_dataclass(x) or isinstance(x, type):
        return x
    kw = {f.name: _lowered(getattr(x, f.name))
          for f in dataclasses.fields(x) if f.init}
    return dataclasses.replace(x, **kw)


class _LowerRays:
    """Rounds the camera's rays to bfloat16 while active (the renderer's
    own name for the camera function)."""

    def __enter__(self):
        self.saved = R.primary_rays_ch

        def rays_ch(*a, **k):
            return tuple(_round_bf16(x) for x in self.saved(*a, **k))
        R.primary_rays_ch = rays_ch
        return self

    def __exit__(self, *exc):
        R.primary_rays_ch = self.saved


def build(config: dict, device, width=None, height=None, lower=False,
          bench_dir: Path = manifest.BENCH_DIR):
    """The reference's scene and tables for a configuration file (its maker
    found under bench_dir)."""
    desc = scenes.make(config, KINDS, width, height, bench_dir)
    scene = build_scene(desc, device=device)
    algo = config.get("mesh_algo", "auto")
    if algo != scene.mesh_algo:
        scene = dataclasses.replace(scene, mesh_algo=algo)
    if lower:
        scene = _lowered(scene)
    return scene, scene_tables(scene, scene.device)


def sample_blocks(width: int, height: int, count: int, seed: int,
                  always=()) -> np.ndarray:
    """`count` distinct 1024-lane blocks of a frame drawn from the seed,
    with the blocks in `always` among them, sorted."""
    nblk = -(-width * height // BLOCK)
    rng = np.random.default_rng(seed)
    pick = set(int(b) for b in always)
    rest = [b for b in rng.permutation(nblk) if int(b) not in pick]
    pick.update(int(b) for b in rest[:max(0, count - len(pick))])
    return np.array(sorted(pick), np.int64)


def block_of_point(scene: Scene, point) -> int:
    """The block whose lanes hold the pixel a world point projects to (a
    sample that must see a given object)."""
    u, v, b = _camera.image_plane_params(scene)
    m = scene.cam_m.cpu().numpy().astype(np.float64)
    rel = np.asarray(point, np.float64) - scene.cam_pos.cpu().numpy()
    c = m.T @ rel
    c = c * (b[2] / c[2])
    px = int(round((c[0] - b[0]) / u))
    py = int(round((c[1] - b[1]) / v))
    px = min(max(px, 0), scene.width - 1)
    py = min(max(py, 0), scene.height - 1)
    inv = _camera.pixel_order_inv(scene.width, scene.height)
    return int(inv[py * scene.width + px]) // BLOCK


def _finalize_pixels(scene, cfg, tables, rad, hits, z, pix):
    """The renderer's finalize on the pixels `pix` alone: (image [n, 3]
    uint8, radiance [n, 3], z [n])."""
    avg = rad.T / torch.clamp(hits, min=1).to(torch.float32)[:, None]
    miss = hits == 0
    w, h = scene.width, scene.height
    size = torch.tensor([float(w), float(h)], device=avg.device)
    bg = sample_background(tables, scene.bg_color,
                           (pix % w).to(torch.float32) / size[0],
                           (pix // w).to(torch.float32) / size[1])
    avg = torch.where(miss[:, None], bg, avg)
    zout = torch.where(miss, BIGFLOAT, z)
    if cfg.gamma and cfg.gamma > 0:
        avg_g = torch.pow(torch.clamp(avg, min=0.0), 1.0 / cfg.gamma)
    else:
        avg_g = avg
    img8 = torch.clamp(torch.floor(avg_g * 255.0), 0, 255).to(torch.uint8)
    return img8, avg, zout


def fused_blocks(scene, tables, cfg, seed: int, blocks) -> dict:
    """The fused path's frame on the lanes of `blocks`: {"pixels": pixel
    ids [n], "image", "radiance", "z", "sample_count"}, numpy arrays."""
    dev = scene.device
    order = torch.as_tensor(_camera.pixel_order(scene.width, scene.height),
                            device=dev).to(torch.int64)
    blocks = torch.as_tensor(np.asarray(blocks), device=dev)
    lanes = (blocks[:, None] * BLOCK
             + torch.arange(BLOCK, device=dev)[None, :]).reshape(-1)
    lanes = lanes[lanes < order.shape[0]]
    pix = order[lanes]
    scene, tables, seed, path, gi_map, caustic = R._prepare(
        scene, cfg, seed, dev, tables, None, None, path="fused")
    rad, hits, z, ns = R.adaptive_ladder(scene, cfg, tables, pix, seed,
                                         gi_map, caustic, blk0=blocks)
    img8, avg, zout = _finalize_pixels(scene, cfg, tables, rad, hits, z, pix)
    return {"pixels": pix.cpu().numpy(), "image": img8.cpu().numpy(),
            "radiance": avg.cpu().numpy(), "z": zout.cpu().numpy(),
            "sample_count": ns.cpu().numpy()}


def reference(config: dict, traffic: dict, seed: int, device,
              block_seed: int = 0, width=None, height=None,
              lower=False, bench_dir: Path = manifest.BENCH_DIR) -> dict:
    """The reference's answer for one frame of a cell, over the traffic's
    count of blocks drawn from block_seed (with the blocks that see the
    configuration's "sample_points")."""
    if traffic["path"] != "fused":
        raise NotImplementedError(f"no reference for the {traffic['path']} "
                                  f"path yet")
    cfg = render_config(traffic)
    with torch.no_grad():
        scene, tables = build(config, device, width, height, lower,
                              bench_dir)
        always = [block_of_point(scene, p)
                  for p in config.get("sample_points", [])]
        blocks = sample_blocks(scene.width, scene.height,
                               traffic["check"]["blocks"], block_seed, always)
        with (_LowerRays() if lower else contextlib.nullcontext()):
            return fused_blocks(scene, tables, cfg, seed, blocks)
