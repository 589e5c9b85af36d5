# Frozen copy of rtf_tpu_torch/ops/texture.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Texture sampling, channelwise: the plain PyTorch copy of the channelwise
samplers of rtf_tpu/ops/texture.py.

Semantics:
* TextureFile::Sample: tiled bilinear lookup (texture.cpp:95-121); v runs
  top-down like the lodepng row order the reference indexes.
* TextureChecker::Sample: 2x2 checker (texture.cpp:125-133).
* TextureMap: the per-map uvw transform applied first, then the tiling
  (scene.h:376-398).
* TexturedColor::SampleEnvironment: angular-map projection (scene.h:426-432).

Every function reads the flat texture tables of render/scene_tables.py
(`texmaps [T, 10]`, `textures [X, 10]`, `atlas [R*W, 4]` with `atlas_w`
and `has_file_tex`), which the CUDA wave kernel reads too.  Table rows are
picked with index gathers: rtf_tpu's where-chains over table rows exist
because a gather is slow on a TPU.  The row-wise `sample_texture` and
`sample_texmap` ([N,3] uvw in, [N,3] colours out) are the channelwise ones
stacked.  The reference samples once per hit (its footprint filter is dead
code); rtf_tpu's cfg.tex_filter revives it on primary rays
(`sample_texmap_filtered`, with ops/trace.py::footprint_duv).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference.frozen.core.halton import halton_np

from rtbench.reference.frozen.scene.build import TEX_FILE


def _tile(u):
    """TileClamp (scene.h:356-366): fractional part in [0, 1)."""
    return u - torch.floor(u)


def sample_texture_ch(tables, tex_id, u, v):
    """Texture(s) `tex_id` [N] at (u, v) [N] -> (r, g, b), each [N]."""
    X = tables.textures[tex_id]
    u = _tile(u)
    v = _tile(v)
    odd = (u <= 0.5) ^ (v <= 0.5)
    chk = [torch.where(odd, X[:, 7 + c], X[:, 4 + c]) for c in range(3)]
    if not tables.has_file_tex:
        return tuple(chk)
    w, h = X[:, 1], X[:, 2]
    x = w * u
    y = h * v
    fl_x = torch.floor(x)
    fl_y = torch.floor(y)
    fx = x - fl_x
    fy = y - fl_y
    wi, hi = w.to(torch.int64), h.to(torch.int64)
    ix = torch.minimum(torch.clamp(fl_x.to(torch.int64), min=0), wi - 1)
    iy = torch.minimum(torch.clamp(fl_y.to(torch.int64), min=0), hi - 1)
    ixp = torch.where(ix + 1 >= wi, 0, ix + 1)
    iyp = torch.where(iy + 1 >= hi, 0, iy + 1)
    r0 = X[:, 3].to(torch.int64)
    aw = tables.atlas_w
    atlas = tables.atlas
    c00 = atlas[(r0 + iy) * aw + ix]
    c10 = atlas[(r0 + iy) * aw + ixp]
    c01 = atlas[(r0 + iyp) * aw + ix]
    c11 = atlas[(r0 + iyp) * aw + ixp]
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    is_file = X[:, 0] == TEX_FILE
    return tuple(
        torch.where(is_file, c00[:, c] * w00 + c10[:, c] * w10
                    + c01[:, c] * w01 + c11[:, c] * w11, chk[c])
        for c in range(3))


def sample_texmap_ch(tables, tm_id, u, v, w=None):
    """Texture map(s) `tm_id` [N] (int, -1 = none) at uvw = (u, v, 0), or
    at (u, v, w) when `w` is given (the wavefront's [N,3] uvw): the map's
    transform, then the texture; lanes without a map give 1."""
    T = tables.texmaps[torch.clamp(tm_id, min=0)]
    du = u - T[:, 6]
    dv = v - T[:, 7]
    # w = 0: x + T2 * (-pos_w) rounds exactly as the kernel's x - T2 * pos_w
    dw = -T[:, 8] if w is None else w - T[:, 8]
    lu = T[:, 0] * du + T[:, 1] * dv + T[:, 2] * dw
    lv = T[:, 3] * du + T[:, 4] * dv + T[:, 5] * dw
    cols = sample_texture_ch(tables, T[:, 9].to(torch.int64), lu, lv)
    no_map = tm_id < 0
    return tuple(torch.where(no_map, 1.0, c) for c in cols)


def sample_texture(tables, tex_id, uvw):
    """Texture(s) `tex_id` [N] at uvw [N,3] -> [N,3]
    (rtf_tpu/ops/texture.py::sample_texture)."""
    return torch.stack(sample_texture_ch(tables, tex_id, uvw[:, 0],
                                         uvw[:, 1]), dim=-1)


def sample_texmap(tables, tm_id, uvw):
    """Texture map(s) `tm_id` [N] at uvw [N,3] -> [N,3], 1 where tm_id =
    -1 (rtf_tpu/ops/texture.py::sample_texmap)."""
    return torch.stack(sample_texmap_ch(tables, tm_id, uvw[:, 0], uvw[:, 1],
                                        uvw[:, 2]), dim=-1)


def sample_texmap_filtered(tables, tm_id, uvw, duv0, duv1,
                           n_samples: int = 32):
    """Elliptic footprint filtering, Texture::Sample(uvw, duvw)
    (scene.h:331-349, TEXTURE_SAMPLE_COUNT = 32): the mean of `n_samples`
    taps of `sample_texmap` over the ellipse spanned by duv0 and duv1
    ([N,2] uv-space footprint vectors, ops/trace.py::footprint_duv), tap 0
    at uvw and tap i at Halton_2(i), Halton_3(i) mapped to a radius-0.5
    disk, the reference's mapping (rtf_tpu/ops/texture.py::
    sample_texmap_filtered)."""
    zero = torch.zeros_like(uvw[:, :1])
    d0 = torch.cat([duv0, zero], dim=-1)
    d1 = torch.cat([duv1, zero], dim=-1)
    acc = sample_texmap(tables, tm_id, uvw)
    for i in range(1, n_samples):
        hx = float(halton_np(i, 2))
        hy = float(halton_np(i, 3))
        r = math.sqrt(hx) * 0.5
        x = r * math.sin(2.0 * math.pi * hy)
        y = r * math.cos(2.0 * math.pi * hy)
        acc = acc + sample_texmap(tables, tm_id, uvw + x * d0 + y * d1)
    return acc / float(n_samples)


def _sel_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with the ids clamped into the table (rtf_tpu's
    where-chain over rows, which exists because a gather is slow on a
    TPU, selects the same rows for ids in range)."""
    return table[torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)]


def sample_textured_color(tables, color, tm_id, uvw, duv=None,
                          n_filter: int = 32):
    """TexturedColor::Sample: `color` [3] or [N,3] times texture map(s)
    `tm_id` [N] at uvw [N,3] (1 where tm_id = -1); duv = (duv0, duv1)
    filters each sample over its footprint (`sample_texmap_filtered`,
    n_filter taps)."""
    tm_id = tm_id.to(torch.int64)
    if duv is not None:
        return color * sample_texmap_filtered(tables, tm_id, uvw, duv[0],
                                              duv[1], n_samples=n_filter)
    return color * sample_texmap(tables, tm_id, uvw)


def env_uvw(direction: torch.Tensor, l2: bool = False) -> torch.Tensor:
    """[N,3] directions -> [N,3] angular-map uvw (w = 0)."""
    u, v = env_uv_ch(direction[:, 0], direction[:, 1], direction[:, 2],
                     l2=l2)
    return torch.stack([u, v, torch.zeros_like(u)], dim=-1)


def sample_environment(tables, env_color, direction: torch.Tensor,
                       l2: bool = False) -> torch.Tensor:
    """environment.SampleEnvironment(dir) [N,3]: the environment colour
    [3], times its map (tables.env_tm) when it has one."""
    n = direction.shape[0]
    env_color = env_color.to(device=direction.device, dtype=torch.float32)
    if tables.env_tm < 0:
        return env_color[None, :].expand(n, 3)
    tm = torch.full((n,), tables.env_tm, dtype=torch.int64,
                    device=direction.device)
    return sample_textured_color(tables, env_color, tm,
                                 env_uvw(direction, l2=l2))


def env_uv_ch(dx, dy, dz, l2=False):
    """Angular-map uv of directions (scene.h:426-432).  The xy
    normalisation is the L1 norm (Proj8 to Final); `l2` selects Proj7's
    Euclidean norm (cfg.env_l2).  The true arcsine, as the reference.
    pi divides as a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently."""
    pi = torch.tensor(np.pi, dtype=torch.float32, device=dz.device)
    z = torch.asin(torch.clamp(-dz, -1.0, 1.0)) / pi + 0.5
    if l2:
        denom = torch.sqrt(dx * dx + dy * dy) + 1e-10
    else:
        denom = torch.abs(dx) + torch.abs(dy)
        denom = torch.where(denom == 0, 1e-30, denom)
    x = dx / denom
    y = dy / denom
    return 0.5 + z * 0.5 * (x - y), 0.5 + z * 0.5 * (x + y)


def sample_background(tables, bg_color, u, v):
    """The background at uvw = (u, v, 0) [N] -> [N, 3]: its colour times
    its map (tables.bg_tm), or the plain colour without one."""
    n = u.shape[0]
    bg_color = bg_color.to(device=u.device, dtype=torch.float32)
    if tables.bg_tm < 0:
        return bg_color[None, :].expand(n, 3)
    tm = torch.full((n,), tables.bg_tm, dtype=torch.int64, device=u.device)
    tex = sample_texmap_ch(tables, tm, u, v)
    return torch.stack([bg_color[c] * tex[c] for c in range(3)], dim=1)
