"""Camera ray generation (rtf_tpu/render/camera.py).

The reference's pinhole camera (RenderPixel, Final/main.cpp:205-224):
image plane at the focal distance, pixel grid top-left origin with y
growing down, Halton-jittered subpixel offsets (main.cpp:147-162), and
the thin lens of depth of field (main.cpp:246-262): a point on a disk of
radius scene.dof in the camera plane, from two uniforms per ray that the
caller draws (rtf_tpu draws them with jax.random: r = sqrt(u[0]) * dof,
angle = 2 pi u[1]).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rtf_tpu_torch.core.halton import halton
from rtf_tpu_torch.core.math import mat3_apply, normalize
from rtf_tpu_torch.utils import tracing


def image_plane_params(scene):
    """(u, v, b): pixel steps and the center of pixel (0,0) in camera space
    (main.cpp:205-216)."""
    l = scene.focaldist
    h = 2.0 * l * np.tan(scene.fov / 2.0 * (np.pi / 180.0))
    w = h * float(scene.width) / float(scene.height)
    u = w / scene.width
    v = -h / scene.height
    b = np.array([-w / 2.0 + u / 2.0, h / 2.0 + v / 2.0, -l], np.float32)
    return float(u), float(v), b


_OFFSETS = {}          # (index, base, step) -> offset, oldest first
_OFFSETS_MAX = 4096   # the CLI's `watch` grows the index without end


def _offset(index: int, base: int, step: float) -> float:
    """halton(index, base) * step in float32, as a Python float, memoised
    (counters camera.offsets.hit and camera.offsets.miss)."""
    key = (index, base, step)
    off = _OFFSETS.get(key)
    if off is not None:
        tracing.count("camera.offsets.hit")
        return off
    tracing.count("camera.offsets.miss")
    if len(_OFFSETS) >= _OFFSETS_MAX:
        del _OFFSETS[next(iter(_OFFSETS))]
    off = _OFFSETS[key] = float(
        halton(torch.tensor(index, dtype=torch.int64), base)
        * torch.tensor(step, dtype=torch.float32))
    return off


def _focal_points(scene, px, py, sample_idx, halton_bases):
    """Camera-space points on the focal plane: (cx, cy, cz), each [N].

    A scalar sample_idx (one index for every lane, a sample wave) adds
    its sub-pixel offsets as Python scalars computed on the host, so a
    wave makes no copy from the host that would wait for the card; a
    float32 tensor plus a float32 value held in a Python float computes
    in float32, so the rays equal those of an offset tensor bit for bit.
    A per-lane sample_idx [N], on the lanes' device, computes them
    there."""
    u, v, b = image_plane_params(scene)
    f32 = torch.float32
    if sample_idx.dim() == 0:
        idx = int(sample_idx)
        sx = _offset(idx, halton_bases[0], u)
        sy = _offset(idx, halton_bases[1], v)
    else:
        sx = halton(sample_idx, halton_bases[0]) * torch.tensor(u, dtype=f32)
        sy = halton(sample_idx, halton_bases[1]) * torch.tensor(v, dtype=f32)
    cx = px.to(f32) * u + float(b[0]) + sx
    cy = py.to(f32) * v + float(b[1]) + sy
    return cx, cy, torch.full_like(cx, float(b[2]))


def _lens(scene, lens_u):
    """Camera-space lens offsets (lx, ly) from lens_u [2, N]."""
    r = torch.sqrt(lens_u[0]) * scene.dof
    ang = lens_u[1] * (2.0 * math.pi)
    return r * torch.cos(ang), r * torch.sin(ang)


def primary_rays(scene, px: torch.Tensor, py: torch.Tensor,
                 sample_idx: torch.Tensor, halton_bases=(2, 3),
                 lens_u: torch.Tensor = None):
    """World-space primary rays, [N,3] rows (the wavefront's layout):
    px, py [N] integer pixel coords, sample_idx [N] (or a scalar tensor)
    Halton index; lens_u [2, N] lens uniforms when scene.dof > 0.
    Returns (o [N,3], d [N,3] normalized)."""
    cx, cy, cz = _focal_points(scene, px, py, sample_idx, halton_bases)
    target = torch.stack([cx, cy, cz], dim=-1)
    m = scene.cam_m.to(px.device)
    if lens_u is not None and scene.dof > 0:
        lx, ly = _lens(scene, lens_u)
        d_campos = mat3_apply(m, torch.stack([lx, ly, torch.zeros_like(lx)],
                                             dim=-1))
    else:
        d_campos = torch.zeros_like(target)
    d_world = mat3_apply(m, target) - d_campos
    o = scene.cam_pos.to(px.device)[None, :] + d_campos
    return o, normalize(d_world)


def primary_rays_ch(scene, px: torch.Tensor, py: torch.Tensor,
                    sample_idx: torch.Tensor, halton_bases=(2, 3),
                    lens_u: torch.Tensor = None):
    """World-space primary rays, channel-major: px, py [N] integer pixel
    coords, sample_idx [N] (or a scalar tensor) Halton index, lens_u
    [2, N] lens uniforms when scene.dof > 0.  Returns (o3 [3,N], d3 [3,N])
    float32 with d normalized; without a lens o3 is a broadcast view of
    the camera position."""
    cx, cy, cz = _focal_points(scene, px, py, sample_idx, halton_bases)
    m = scene.cam_m.to(px.device)
    if lens_u is not None and scene.dof > 0:
        lx, ly = _lens(scene, lens_u)
        off = [m[i, 0] * lx + m[i, 1] * ly for i in range(3)]
        dw = [m[i, 0] * cx + m[i, 1] * cy + m[i, 2] * cz - off[i]
              for i in range(3)]
        o3 = torch.stack([scene.cam_pos[i].to(px.device) + off[i]
                          for i in range(3)])
    else:
        dw = [m[i, 0] * cx + m[i, 1] * cy + m[i, 2] * cz for i in range(3)]
        o3 = scene.cam_pos.to(px.device)[:, None].expand(3, px.shape[0])
    inv = torch.rsqrt(torch.clamp(dw[0] * dw[0] + dw[1] * dw[1]
                                  + dw[2] * dw[2], min=1e-30))
    d3 = torch.stack([dw[i] * inv for i in range(3)])
    return o3, d3


def pixel_grid(width: int, height: int, device="cpu"):
    """Flat [P] int64 pixel coordinates in pixel-id order (row-major like
    the pixel iterator, main.cpp:71-78: x = i % W, y = i / W)."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    return idx % width, idx // width


@functools.lru_cache(maxsize=32)
def pixel_order(width: int, height: int, tw: int = 32, th: int = 16):
    """Tile-coherent pixel permutation: flat pixel ids ordered so that
    consecutive lanes form tw x th screen tiles (ragged edges fold into
    their tile row).  Returns an int32 [P] numpy array; lane k handles
    pixel id order[k]."""
    idx = np.arange(width * height, dtype=np.int32)
    px = idx % width
    py = idx // width
    order = np.lexsort((px % tw, py % th, px // tw, py // th))
    return order.astype(np.int32)


@functools.lru_cache(maxsize=32)
def pixel_order_inv(width: int, height: int, tw: int = 32, th: int = 16):
    """Inverse of pixel_order: inv[pixel_id] = lane index."""
    return np.argsort(pixel_order(width, height, tw, th)).astype(np.int32)
