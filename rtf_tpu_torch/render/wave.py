"""One sample wave, all bounces: the plain PyTorch version and the CUDA
kernel's wrapper.

`wave` is the port of rtf_tpu/render/fused.py::fused_wave and its Pallas
kernel `_wave_kernel` (immediates mesh variant, with its surf_out/gi_from
rows and child-wave inputs), and of rtf_tpu/render/fused_seg.py::
fused_wave_seg, whose two Pallas kernels (`_seg_hit_kernel`,
`_seg_shade_kernel` with its gi_out rows) and XLA texture segment
(`_seg_texture`, `_seg_env`) it folds into the same per-bounce loop.
For each ray it runs closest hit with uv (spheres, planes, then mesh faces
in packed order with a strict `t < best`), kd/ks as the material colour
times its texture map (checker or bilinear file texture), Blinn direct
light with hard or adaptive disk soft shadows, Beer absorption, the
environment (colour or angular map) on a miss, glossy perturbation,
Schlick Fresnel/TIR and one Russian-roulette child per bounce.  For GI
(render/gi.py) a wave also returns the first-hit surface rows (p, n, kd,
k_eff) and per-bounce photon-query rows (p, n, kd * k_eff), and a child
wave starts from a per-lane throughput, absorption and ray type.

`wave_plain` computes the same function with one tensor lane per ray and
is what the CPU runs; `wave` launches csrc/wave_kernel.cu for CUDA
tensors, in its textured variant when the scene has file textures or an
environment map, and in its MXU variant when the mesh is on rtf_tpu's
MXU tables (more than 512 faces; render/scene_tables.py): the Plücker
pair test of fused.py::_mesh_closest_mxu and _mesh_anyhit_mxu in place of
the projected-barycentric one.  Both read the same tables
(render/scene_tables.py) and the same per-lane hash RNG as the TPU kernel
(`_rand01`, fused.py:1136-1150): lane
i draws from the 1024-lane group i // 1024 with per-group seed
seed + (blk0 + i // 1024) * 7919 in int32, so lane order is the caller's
ray order and results are per lane comparable with the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtf_tpu_torch import _build
from rtf_tpu_torch.ops.mesh_hit import _tri_test
from rtf_tpu_torch.ops.mxu_pack import (
    MXU_TILE, cross_od, plucker_bary, plucker_pair,
)
from rtf_tpu_torch.ops.pack import ZERO
from rtf_tpu_torch.ops.texture import env_uv_ch, sample_texmap_ch
from rtf_tpu_torch.render.scene_tables import WaveTables
from rtf_tpu_torch.utils import tracing

BIG = 1.0e30
SENTINEL = 1.0e7      # dead-lane origin, far from everything
BLOCK = 1024          # lanes per RNG group (the TPU kernel's block)
RT_PRIMARY, RT_REFLECT, RT_REFRACT = 0, 1, 2
SURF_ROWS = 12        # first-hit p(3) n(3) kd(3) k_eff(3)
GI_ROWS = 9           # per-bounce photon query: p(3) n(3) kd * k_eff(3)
_M32 = 0xFFFFFFFF
_CHUNK = 1 << 20      # ray x face elements per plain mesh step (CPU)
_CHUNK_CUDA = 1 << 24  # the same on the card, where the plain version runs
                       # only to be compared with the kernel

NSTAT = 26            # work counters of the kernel (csrc/wave_kernel.cu)
THREADS = 128         # the kernel's block size
# shared memory of a launch (bytes): the walk's roots and groups, and the
# small scene tables, up to this, else they stay in device memory; at most
# the 48 KB a launch gets without raising its limit
SMEM_BYTES = 48 * 1024


def smem_staged(tables: WaveTables) -> bool:
    """Whether a launch stages the walk's roots and groups in shared memory
    (the kernel sizes its shared memory from them): where there is a mesh
    instance and they fit in SMEM_BYTES."""
    return tables.roots.numel() > 0 and 4 * (
        tables.roots.numel() + tables.groups.numel()) <= SMEM_BYTES


def scene_staged(tables: WaveTables) -> bool:
    """Whether a launch stages the small scene tables that every lane reads
    per bounce (spheres, planes, mesh instances, lights) in shared memory:
    where they fit in SMEM_BYTES beside the roots and groups it stages."""
    small = sum(getattr(tables, k).numel() for k in (
        "spheres", "planes", "mesh_insts", "lights"))
    tree = tables.roots.numel() + tables.groups.numel() \
        if smem_staged(tables) else 0
    return 0 < small and 4 * (small + tree) <= SMEM_BYTES


def stats_size(n: int) -> int:
    """Entries of a stats tensor that also takes each block's cycles (see
    `wave`)."""
    return NSTAT + (n + THREADS - 1) // THREADS


# ---------------------------------------------------------------------------
# shared helpers


def pack_rays(o3, d3, alive, tput3=None, absorb3=None,
              rtype=None) -> torch.Tensor:
    """Float32 ray rows (fused.py::fused_wave's packing, without lane
    padding): origin (SENTINEL on dead lanes), direction and alive flag,
    [7, N]; when any of tput3, absorb3 or rtype is given, [14, N] with
    rows 7-9 the throughput (default 1), 10-12 the absorption (default 0)
    and 13 the ray type (default RT_PRIMARY), as a child wave starts.
    o3, d3, tput3, absorb3: [3, N] tensors; alive: [N]; rtype: an int."""
    n = alive.shape[0]
    for name, x in (("o3", o3), ("d3", d3), ("tput3", tput3),
                    ("absorb3", absorb3)):
        if x is not None and tuple(x.shape) != (3, n):
            raise ValueError(f"{name} must be [3, {n}] channel-major, got "
                             f"{tuple(x.shape)}")
    alive = alive.to(torch.bool)
    o3 = o3.to(torch.float32)
    rows = [torch.where(alive, o3, torch.full_like(o3, SENTINEL)),
            d3.to(torch.float32), alive.to(torch.float32)[None]]
    if tput3 is not None or absorb3 is not None or rtype is not None:
        # a fill, not a copy from the host (which would sync the stream)
        rt = torch.full((1, n), float(RT_PRIMARY if rtype is None
                                      else rtype), device=o3.device)
        rows += [torch.ones_like(o3) if tput3 is None
                 else tput3.to(torch.float32),
                 torch.zeros_like(o3) if absorb3 is None
                 else absorb3.to(torch.float32), rt]
    return torch.cat(rows).contiguous()


def out_rows(nbounce, surf_out, gi_from) -> int:
    """Output rows of a wave (fused.py::_out_rows without the TPU's 11 pad
    rows): rad rgb, hit, z; with surf_out the 12 first-hit surface rows;
    with gi_from=k one 9-row query per bounce b >= k."""
    rows = 5 + (SURF_ROWS if surf_out else 0)
    if gi_from is not None:
        rows += GI_ROWS * max(nbounce - gi_from, 0)
    return rows


def split_rows(out, nbounce, surf_out, gi_from):
    """A wave's [rows, N] output -> (rad3 [3, N], hit [N] bool, z [N]) or,
    with rows, (rad3, hit, z, surf [12, N] or None, queries): one
    (p3, n3, w3) of [3, N] views per bounce b >= gi_from."""
    rad3, hit, z = out[0:3], out[3] > 0.0, out[4]
    if not surf_out and gi_from is None:
        return rad3, hit, z
    surf = out[5:5 + SURF_ROWS] if surf_out else None
    base = 5 + (SURF_ROWS if surf_out else 0)
    queries = []
    if gi_from is not None:
        for q in range(max(nbounce - gi_from, 0)):
            r = base + q * GI_ROWS
            queries.append((out[r:r + 3], out[r + 3:r + 6],
                            out[r + 6:r + 9]))
    return rad3, hit, z, surf, queries


def shade_params(cfg, tables: WaveTables) -> dict:
    """Config knobs of one launch (fused.py::fused_wave's cfg_c)."""
    n_lights = tables.lights.shape[0]
    return dict(
        coef=(1.0 / max(n_lights, 1)) if cfg.light_average else 1.0,
        inverse_square=bool(cfg.inverse_square),
        env_on_reflect_miss=bool(cfg.env_on_reflect_miss),
        env_l2=bool(cfg.env_l2),
        total_reflection_threshold=float(cfg.total_reflection_threshold),
        color_threshold=float(cfg.color_threshold),
        shadow_max=int(cfg.shadow_max), shadow_min=int(cfg.shadow_min))


def _i32(x: int) -> int:
    """Python int -> the int32 two's-complement value of its low 32 bits."""
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


# ---------------------------------------------------------------------------
# the plain version


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values held in int64, without int64
    overflow."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rand01(seed, idx):
    """fused.py::_rand01: per-lane uniform [0,1) from (seed, lane % 1024);
    `seed` is an int64 tensor of uint32 values."""
    x = ((idx * 2654435761) & _M32) ^ (seed & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _norm3(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def _atan_poly(r):
    r2 = r * r
    return r * (0.99997726 + r2 * (-0.33262347 + r2 * (
        0.19354346 + r2 * (-0.11643287 + r2 * (
            0.05265332 + r2 * -0.01172120)))))


def _atan2(y, x):
    """fused.py::_atan2: quadrant-correct atan2 from the [0,1] polynomial
    (sphere uv must use it, not atan2, or checker edges flip)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = _atan_poly(mn / torch.clamp(mx, min=1e-30))
    a = torch.where(ay > ax, 0.5 * np.pi - a, a)
    a = torch.where(x < 0.0, np.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def _asin(x):
    return _atan2(x, torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)))


def _mat3(m, x, y, z):
    """Row-major 3x3 (9 python floats) times channel vectors."""
    return (m[0] * x + m[1] * y + m[2] * z,
            m[3] * x + m[4] * y + m[5] * z,
            m[6] * x + m[7] * y + m[8] * z)


def _to_local(row, o3, d3):
    lo3 = _mat3(row[0:9], o3[0] - row[9], o3[1] - row[10], o3[2] - row[11])
    ld3 = _mat3(row[0:9], d3[0], d3[1], d3[2])
    return lo3, ld3


def _offset_origin(p3, n3, d3, eps=1e-4):
    px, py, pz = p3
    nx, ny, nz = n3
    scale = eps * (1.0 + torch.maximum(torch.maximum(torch.abs(px),
                                                     torch.abs(py)),
                                       torch.abs(pz)))
    side = torch.where(d3[0] * nx + d3[1] * ny + d3[2] * nz >= 0.0,
                       scale, -scale)
    return px + nx * side, py + ny * side, pz + nz * side


class _Host:
    """Host copies (python floats) of the small tables: the plain version
    loops over instances and lights like the TPU kernel's unrolled
    immediates did."""

    def __init__(self, tables: WaveTables):
        self.spheres = tables.spheres.tolist()
        self.planes = tables.planes.tolist()
        self.insts = tables.mesh_insts.tolist()
        # each tile's face range (first row, count)
        self.ranges = tables.tnodes[:, 6:8].tolist()
        self.lights = tables.lights.tolist()
        self.faces = tables.faces
        self.shade = tables.shade
        self.mats = tables.materials
        self.mxu = tables.mxu
        if self.mxu:
            dev = tables.faces.device
            self.roots = tables.roots.tolist()
            self.boxes = tables.tnodes[:, 0:6]
            # the pair test's face columns per tile, [T, 128, 22]
            self.pair_cols = tables.faces[:, 0:22].reshape(
                -1, MXU_TILE, 22).permute(2, 0, 1).contiguous()
            # rank[o, j]: tile j's place in octant o's visit order (its
            # row in the order's column; ranks compare within a slot), the
            # table the kernel reads
            self.rank = tables.tnodes[:, 8:16].T.to(torch.int64)
            self.chunk = _CHUNK_CUDA if dev.type == "cuda" else _CHUNK


def _face_slice(h: _Host, inst):
    t0, nt = int(inst[22]), int(inst[23])
    if nt == 0:
        return h.faces[:0]
    f0 = int(h.ranges[t0][0])
    f1 = int(h.ranges[t0 + nt - 1][0] + h.ranges[t0 + nt - 1][1])
    return h.faces[f0:f1]


def _tri_block(F, lo3, ld3):
    """_tri_test of rays [n] against every face of F [f, 40]: [n, f]."""
    return _tri_test([F[:, k][None, :] for k in range(12)],
                     tuple(v[:, None] for v in lo3),
                     tuple(v[:, None] for v in ld3))


def _chunks(n, f):
    step = max(1, _CHUNK // max(f, 1))
    return range(0, n, step), step


def _mesh_closest(h, o3, d3, st, need_uv):
    """Closest mesh hit, merged into st = [t, nx, ny, nz, mtl, front, u, v]
    with the strict `t < best` of the TPU kernel: the first face (in packed
    order) at the minimum t wins, and only if it beats the current best."""
    if h.mxu:
        _mesh_closest_mxu(h, o3, d3, st, need_uv)
        return
    for inst in h.insts:
        F = _face_slice(h, inst)
        if F.shape[0] == 0:
            continue
        lo3, ld3 = _to_local(inst, o3, d3)
        n = o3[0].shape[0]
        starts, step = _chunks(n, F.shape[0])
        for s in starts:
            sl = slice(s, min(n, s + step))
            l3 = tuple(v[sl] for v in lo3)
            r3 = tuple(v[sl] for v in ld3)
            t, *_, valid = _tri_block(F, l3, r3)
            tmin, idx = torch.min(torch.where(valid, t, torch.inf), dim=1)
            ok = tmin < st[0][sl]
            # re-evaluate the winning face alone: same elementwise ops,
            # so the same values as in the [n, f] block
            Fw = F[idx]
            tw, dn, ba, bb, bc, _ = _tri_test(
                [Fw[:, k] for k in range(12)], l3, r3)
            lnx = Fw[:, 12] * ba + Fw[:, 15] * bb + Fw[:, 18] * bc
            lny = Fw[:, 13] * ba + Fw[:, 16] * bb + Fw[:, 19] * bc
            lnz = Fw[:, 14] * ba + Fw[:, 17] * bb + Fw[:, 20] * bc
            w3 = _mat3(inst[12:21], lnx, lny, lnz)
            vals = [tw, w3[0], w3[1], w3[2], Fw[:, 30],
                    (dn <= 0.0).to(torch.float32)]
            if need_uv:
                vals += [Fw[:, 21] * ba + Fw[:, 24] * bb + Fw[:, 27] * bc,
                         Fw[:, 22] * ba + Fw[:, 25] * bb + Fw[:, 28] * bc]
            for k, v in enumerate(vals):
                st[k][sl] = torch.where(ok, v, st[k][sl])


def _mesh_anyhit(h, o3, d3, t_cap):
    """Mesh occlusion of shadow rays (1e-14 < t < t_cap)."""
    if h.mxu:
        return _mesh_anyhit_mxu(h, o3, d3, t_cap)
    occ = torch.zeros_like(o3[0], dtype=torch.bool)
    for inst in h.insts:
        F = _face_slice(h, inst)
        if F.shape[0] == 0:
            continue
        lo3, ld3 = _to_local(inst, o3, d3)
        n = o3[0].shape[0]
        starts, step = _chunks(n, F.shape[0])
        for s in starts:
            sl = slice(s, min(n, s + step))
            t, *_, valid = _tri_block(F, tuple(v[sl] for v in lo3),
                                      tuple(v[sl] for v in ld3))
            hit = valid & (t > 1e-14) & (t < t_cap[sl][:, None])
            occ[sl] |= hit.any(dim=1)
    return occ


def _inv_dir(ld3):
    """Per-lane 1/d for slab tests, a huge signed finite for zero
    components (fused.py::_inv_dir)."""
    return tuple(torch.where(torch.abs(v) < 1e-30,
                             torch.where(v < 0.0, -1e30, 1e30), 1.0 / v)
                 for v in ld3)


def _slab(lo, hi, lo3, ild3, cap):
    """The kernel's slab test of the segments [0, cap) against boxes
    (lo, hi): three values each, broadcastable against the rays."""
    tmin = torch.zeros_like(lo3[0] * lo[0])
    tmax = torch.full_like(tmin, BIG)
    for a in range(3):
        t0 = (lo[a] - lo3[a]) * ild3[a]
        t1 = (hi[a] - lo3[a]) * ild3[a]
        tmin = torch.maximum(tmin, torch.minimum(t0, t1))
        tmax = torch.minimum(tmax, torch.maximum(t0, t1))
    return (tmax >= tmin) & (tmin < cap)


def _mxu_pairs(h, k, o3, d3, cap):
    """The (lane, tile) pairs of mesh instance k whose segments [0, cap)
    enter the instance's root box and the tile's box: (lanes, local o, d,
    o x d of those lanes, pair lane positions, pair tiles).  The culls are
    the kernel's and conservative (padded boxes): a face they drop has
    t >= cap, so neither a closest hit nor an occluder."""
    inst = h.insts[k]
    t0, nt = int(inst[22]), int(inst[23])
    lo3, ld3 = _to_local(inst, o3, d3)
    ild3 = _inv_dir(ld3)
    root = h.roots[k]
    lanes = torch.nonzero(_slab(root[0:3], root[3:6], lo3, ild3, cap))[:, 0]
    lo3, ld3, ild3 = (tuple(v[lanes] for v in x) for x in (lo3, ld3, ild3))
    box = h.boxes[t0:t0 + nt]
    enter = _slab([box[:, a] for a in range(3)],
                  [box[:, 3 + a] for a in range(3)],
                  tuple(v[:, None] for v in lo3),
                  tuple(v[:, None] for v in ild3), cap[lanes][:, None])
    pl, pj = torch.nonzero(enter, as_tuple=True)
    return lanes, lo3, ld3, cross_od(lo3, ld3), pl, pj + t0


def _pair_block(h, tiles, lo3, ld3, c3):
    """The pair test of rays [p] against every face of their tile [p]:
    (t, valid) [p, 128]."""
    col = [h.pair_cols[c][tiles] for c in range(22)]
    t, valid, *_ = plucker_pair(col, *(tuple(v[:, None] for v in x)
                                       for x in (ld3, c3, lo3)))
    return t, valid


def _mesh_closest_mxu(h, o3, d3, st, need_uv):
    """Closest mesh hit on the MXU tables (fused.py::_mesh_closest_mxu),
    merged into st like `_mesh_closest`.  Per instance the winner is the
    least t below the current best; among exact ties the earliest face in
    the lane's visit order: its tiles in the order of its local direction's
    octant (fused.py::_octant_col for one lane), a tile's faces by column.
    That is the kernel's walk with a strict `t < best`."""
    cols = torch.arange(MXU_TILE, device=o3[0].device)
    for k in range(len(h.insts)):
        lanes, lo3, ld3, c3, pl, pj = _mxu_pairs(h, k, o3, d3, st[0])
        if pl.numel() == 0:
            continue
        # each pair's least t and the lowest column at it
        step = max(1, h.chunk // MXU_TILE)
        tp, cp = [], []
        for s in range(0, pl.numel(), step):
            sl = slice(s, s + step)
            t, valid = _pair_block(h, pj[sl], *(tuple(v[pl[sl]] for v in x)
                                                for x in (lo3, ld3, c3)))
            tt = torch.where(valid, t, torch.inf)
            tmin = torch.amin(tt, dim=1)
            tp.append(tmin)
            cp.append(torch.amin(torch.where(tt == tmin[:, None], cols,
                                             MXU_TILE), dim=1))
        tp, cp = torch.cat(tp), torch.cat(cp)
        # per lane: the least t, then the earliest (tile rank, column)
        m = lanes.numel()
        lmin = torch.full((m,), torch.inf, device=tp.device).scatter_reduce(
            0, pl, tp, "amin")
        octant = ((ld3[0] >= 0.0).to(torch.int64) * 4
                  + (ld3[1] >= 0.0).to(torch.int64) * 2
                  + (ld3[2] >= 0.0).to(torch.int64))
        key = torch.where((tp == lmin[pl]) & (tp < torch.inf),
                          h.rank[octant[pl], pj] * MXU_TILE + cp,
                          torch.iinfo(torch.int64).max)
        lkey = torch.full((m,), torch.iinfo(torch.int64).max,
                          device=tp.device).scatter_reduce(0, pl, key, "amin")
        ok = lmin < st[0][lanes]
        win = torch.nonzero(ok & (lkey < torch.iinfo(torch.int64).max))[:, 0]
        if win.numel() == 0:
            continue
        # the winning pair of each lane: its tile and column
        wp = torch.nonzero(key == lkey[pl])[:, 0]
        wtile = torch.empty(m, dtype=torch.int64, device=tp.device)
        wcol = torch.empty_like(wtile)
        wtile[pl[wp]] = pj[wp]
        wcol[pl[wp]] = cp[wp]
        # re-evaluate each winner alone: the same elementwise ops, so the
        # same values as in the block
        fw = wtile[win] * MXU_TILE + wcol[win]
        Fw, Sw = h.faces[fw], h.shade[fw]
        l3, r3, x3 = (tuple(v[win] for v in x) for x in (lo3, ld3, c3))
        tw, _, sa, sb, sc, dn = plucker_pair(
            [Fw[:, c] for c in range(22)], r3, x3, l3)
        ba, bb = plucker_bary(sa, sb, sc)
        ln3 = [Sw[:, c] + ba * Sw[:, 3 + c] + bb * Sw[:, 6 + c]
               for c in range(3)]
        w3 = _mat3(h.insts[k][12:21], *ln3)
        vals = [tw, w3[0], w3[1], w3[2], Sw[:, 9],
                (dn <= 0.0).to(torch.float32)]
        if need_uv:
            vals += [Sw[:, 10 + c] + ba * Sw[:, 12 + c] + bb * Sw[:, 14 + c]
                     for c in range(2)]
        idx = lanes[win]
        for j, v in enumerate(vals):
            st[j] = st[j].index_put((idx,), v)


def _mesh_anyhit_mxu(h, o3, d3, t_cap):
    """Mesh occlusion of shadow rays on the MXU tables
    (fused.py::_mesh_anyhit_mxu): some valid t with 1e-14 < t < t_cap."""
    occ = torch.zeros_like(o3[0], dtype=torch.bool)
    for k in range(len(h.insts)):
        lanes, lo3, ld3, c3, pl, pj = _mxu_pairs(h, k, o3, d3, t_cap)
        step = max(1, h.chunk // MXU_TILE)
        for s in range(0, pl.numel(), step):
            sl = slice(s, s + step)
            li = pl[sl]
            t, valid = _pair_block(h, pj[sl], *(tuple(v[li] for v in x)
                                                for x in (lo3, ld3, c3)))
            cap = t_cap[lanes[li]][:, None]
            hit = (valid & (t > 1e-14) & (t < cap)).any(dim=1)
            occ[lanes[li[hit]]] = True
    return occ


def _sphere(row, o3, d3):
    lo3, ld3 = _to_local(row, o3, d3)
    lox, loy, loz = lo3
    ldx, ldy, ldz = ld3
    a = torch.clamp(ldx * ldx + ldy * ldy + ldz * ldz, min=1e-30)
    half_b = lox * ldx + loy * ldy + loz * ldz
    tc = -half_b / a
    mx = lox + tc * ldx
    my = loy + tc * ldy
    mz = loz + tc * ldz
    disc = 4.0 * a * (1.0 - (mx * mx + my * my + mz * mz))
    s = torch.sqrt(torch.clamp(disc, min=0.0)) / (2.0 * a)
    return lo3, ld3, tc + s, tc - s, disc >= ZERO


def _plane(row, o3, d3):
    (lox, loy, loz), (ldx, ldy, ldz) = _to_local(row, o3, d3)
    nz_ok = ldz != 0.0
    tp = -(loz / torch.where(nz_ok, ldz, torch.full_like(ldz, 1e-30)))
    hx = lox + tp * ldx
    hy = loy + tp * ldy
    inside = (hx >= -1.0) & (hx <= 1.0) & (hy >= -1.0) & (hy <= 1.0)
    return tp, hx, hy, ldz, nz_ok, inside


def _closest_hit(h, o3, d3, need_uv):
    """fused.py::_closest_hit: primitives first, then the mesh.  Returns
    (t, normalized n3, mtl, front, (u, v)), the rows that
    fused_seg.py::_seg_hit_kernel writes (without its deferred-resolve fid);
    u, v stay 0.5 on misses and when `need_uv` is False."""
    t = torch.full_like(o3[0], BIG)
    # separate tensors: _mesh_closest updates them in place
    nx, ny, nz, mtl, front = (torch.zeros_like(t) for _ in range(5))
    uu = torch.full_like(t, 0.5)
    vv = torch.full_like(t, 0.5)
    for sp in h.spheres:
        lo3, ld3, t1, t2, has = _sphere(sp, o3, d3)
        back = has & (t1 > ZERO) & (t2 < ZERO) & (t1 < t)
        frontal = has & (t1 > ZERO) & (t2 > ZERO) & (t2 < t)
        ts = torch.where(frontal, t2, t1)
        vs = frontal | back
        hx = lo3[0] + ts * ld3[0]
        hy = lo3[1] + ts * ld3[1]
        hz = lo3[2] + ts * ld3[2]
        w3 = _mat3(sp[12:21], hx, hy, hz)
        t = torch.where(vs, ts, t)
        nx = torch.where(vs, w3[0], nx)
        ny = torch.where(vs, w3[1], ny)
        nz = torch.where(vs, w3[2], nz)
        mtl = torch.where(vs, sp[21], mtl)
        front = torch.where(vs, frontal.to(torch.float32), front)
        if need_uv:
            su = 0.5 - _atan2(hx, hy) * (0.5 / np.pi)
            sv = 0.5 + _asin(torch.clamp(hz, -1.0, 1.0)) * (1.0 / np.pi)
            uu = torch.where(vs, su, uu)
            vv = torch.where(vs, sv, vv)
    for pln in h.planes:
        tp, hx, hy, ldz, nz_ok, inside = _plane(pln, o3, d3)
        vp = nz_ok & (tp >= ZERO) & (tp < t) & inside
        t = torch.where(vp, tp, t)
        nx = torch.where(vp, pln[14], nx)
        ny = torch.where(vp, pln[17], ny)
        nz = torch.where(vp, pln[20], nz)
        mtl = torch.where(vp, pln[21], mtl)
        front = torch.where(vp, (ldz <= 0.0).to(torch.float32), front)
        if need_uv:
            uu = torch.where(vp, (hx + 1.0) * 0.5, uu)
            vv = torch.where(vp, (hy + 1.0) * 0.5, vv)
    st = [t, nx, ny, nz, mtl, front, uu, vv]
    _mesh_closest(h, o3, d3, st, need_uv)
    t, nx, ny, nz, mtl, front, uu, vv = st
    return t, _norm3(nx, ny, nz), mtl, front, (uu, vv)


def _primitive_anyhit(h, o3, d3, t_cap):
    occ = torch.zeros_like(o3[0], dtype=torch.bool)
    for sp in h.spheres:
        _, _, t1, t2, has = _sphere(sp, o3, d3)
        ts = torch.where(t2 > ZERO, t2, t1)
        occ |= has & (t1 > ZERO) & (ts > 1e-14) & (ts < t_cap)
    for pln in h.planes:
        tp, _, _, _, nz_ok, inside = _plane(pln, o3, d3)
        occ |= nz_ok & (tp >= ZERO) & (tp > 1e-14) & (tp < t_cap) & inside
    return occ


def _surface_color(tables, M, mrow, base, tm_col, uv, need_uv):
    """kd or ks: the material colour times its texture map
    (fused_seg.py::_seg_texture; TexturedColor::Sample, main.cpp:531-532);
    a lane without a map keeps the colour (its sample is 1)."""
    col = [M[:, base + c][mrow] for c in range(3)]
    if not need_uv:
        return col
    tex = sample_texmap_ch(tables, M[:, tm_col][mrow].to(torch.int64), *uv)
    return [col[c] * tex[c] for c in range(3)]


def _bounce(h, tables, prm, state, seed, lane):
    """fused.py::_bounce_core + _shade_from_hit for every lane: returns
    (rad3, hit, t_z, surf, qw, next state).  surf is this bounce's surface
    rows (p, n, kd, k_eff) and qw = kd * k_eff, both zero where the lane
    did not hit (fused.py:1613-1616 leaves them undefined there)."""
    o3, d3, tput, absorb, alive_f, rtype = state
    alive = alive_f > 0.0
    t, (nx, ny, nz), mtl, front, uv = _closest_hit(h, o3, d3, tables.need_uv)
    M = h.mats
    mrow = mtl.to(torch.long)
    kd = _surface_color(tables, M, mrow, 0, 22, uv, tables.need_uv)
    ks = _surface_color(tables, M, mrow, 3, 23, uv, tables.need_uv)

    def mat(col, dims=3):
        if dims == 1:
            return M[:, col][mrow]
        return [M[:, col + c][mrow] for c in range(3)]

    hit = alive & (t < BIG)
    frontb = front > 0.5
    px = o3[0] + t * d3[0]
    py = o3[1] + t * d3[1]
    pz = o3[2] + t * d3[2]
    one = torch.ones_like(t)
    k_eff = [tput[c] * torch.where(
        frontb, one, torch.exp(-absorb[c] * torch.clamp(t, max=1e4)))
        for c in range(3)]
    gloss = mat(6, 1)
    refl = mat(7)
    refr = mat(10)
    ior = torch.clamp(mat(13, 1), min=1e-6)
    m_abs = mat(14)
    emis = mat(17)
    vx, vy, vz = -d3[0], -d3[1], -d3[2]

    rad = list(emis)
    coef = prm["coef"]
    zero = torch.zeros_like(t)
    for lt in h.lights:
        kind = int(lt[0])
        inten = lt[1:4]
        if kind == 0:   # ambient
            for c in range(3):
                rad[c] = rad[c] + torch.where(frontb, kd[c] * inten[c] * coef,
                                              zero)
            continue
        if kind == 1:   # direct
            lx = -lt[4] + zero
            ly = -lt[5] + zero
            lz = -lt[6] + zero
            sdx, sdy, sdz = lx, ly, lz
            tmax_v = torch.where(hit, BIG, 0.0)
            inv_r2 = 1.0
        else:           # point
            lx = lt[7] - px
            ly = lt[8] - py
            lz = lt[9] - pz
            sdx, sdy, sdz = lx, ly, lz
            tmax_v = torch.where(hit, 1.0, 0.0)
            inv_r2 = (1.0 / torch.clamp(lx * lx + ly * ly + lz * lz,
                                        min=1e-30)
                      if prm["inverse_square"] else 1.0)
            lx, ly, lz = _norm3(lx, ly, lz)
        hx_, hy_, hz_ = _norm3(lx + vx, ly + vy, lz + vz)
        cos_nl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
        cos_nh = torch.clamp(nx * hx_ + ny * hy_ + nz * hz_, min=0.0)
        spec = torch.pow(cos_nh, gloss)

        nsamp_min = nsamp_max = 1
        if kind == 2 and lt[10] > 0.0:
            nsamp_max = max(prm["shadow_max"], 1)
            nsamp_min = min(max(prm["shadow_min"], 1), nsamp_max)
        soft = nsamp_max > 1
        if soft:
            ux, uy, uz = _norm3(sdx, sdy, sdz)
            use_y = ux > 0.8
            v1x = torch.where(use_y, uz, 0.0 * ux)
            v1y = torch.where(use_y, 0.0 * ux, uz)
            v1z = torch.where(use_y, -ux, -uy)
            v1x, v1y, v1z = _norm3(v1x, v1y, v1z)
            v2x = v1y * uz - v1z * uy
            v2y = v1z * ux - v1x * uz
            v2z = v1x * uy - v1y * ux

        def shadow_sample(si):
            if not soft:
                s3 = (sdx, sdy, sdz)
            else:
                r = torch.sqrt(_rand01(seed + 811 * si + 17, lane)) * lt[10]
                ang = _rand01(seed + 811 * si + 631, lane) * (2.0 * np.pi)
                ca, sa = torch.cos(ang), torch.sin(ang)
                s3 = (sdx + (v1x * r * ca + v2x * r * sa),
                      sdy + (v1y * r * ca + v2y * r * sa),
                      sdz + (v1z * r * ca + v2z * r * sa))
            so3 = _offset_origin((px, py, pz), (nx, ny, nz), s3)
            so3 = tuple(torch.where(hit, v, SENTINEL) for v in so3)
            occ = _mesh_anyhit(h, so3, s3, tmax_v) \
                | _primitive_anyhit(h, so3, s3, tmax_v)
            return 1.0 - occ.to(torch.float32)

        if not soft:
            vis = shadow_sample(0)
        else:
            vis1 = zero
            for si in range(nsamp_min):
                vis1 = vis1 + shadow_sample(si)
            if nsamp_max > nsamp_min:
                # penumbra lanes (first samples disagree) take the rest
                # (lights.h:108-115); the escalation is per lane, as the
                # TPU's per-block branch gives per lane
                pen = hit & (vis1 > 0.0) & (vis1 < float(nsamp_min))
                extra = zero
                if bool(pen.any()):
                    for si in range(nsamp_min, nsamp_max):
                        extra = extra + shadow_sample(si)
                vis = torch.where(pen, (vis1 + extra) * (1.0 / nsamp_max),
                                  vis1 * (1.0 / nsamp_min))
            else:
                vis = vis1 * (1.0 / nsamp_max)
        for c in range(3):
            lit_c = ((kd[c] + ks[c] * spec) * inten[c] * coef * inv_r2
                     * cos_nl)
            rad[c] = rad[c] + torch.where(frontb & hit, lit_c * vis, zero)

    for c in range(3):
        rad[c] = torch.where(hit, rad[c] * k_eff[c], zero)
    env_ok = rtype == float(RT_REFRACT)
    if prm["env_on_reflect_miss"]:
        env_ok = env_ok | (rtype == float(RT_REFLECT))
    env_mask = alive & (t >= BIG) & env_ok
    env3 = tables.env
    if tables.env_tm >= 0:
        # the angular map at the ray's direction (fused_seg.py::_seg_env)
        eu, ev = env_uv_ch(d3[0], d3[1], d3[2], l2=prm["env_l2"])
        tex = sample_texmap_ch(
            tables, torch.full_like(mrow, tables.env_tm), eu, ev)
        env3 = [tables.env[c] * tex[c] for c in range(3)]
    for c in range(3):
        rad[c] = rad[c] + torch.where(env_mask, tput[c] * env3[c], zero)
    hitf = hit.to(torch.float32)
    tz = torch.where(hit, t, BIG)
    surf = [torch.where(hit, v, zero)
            for v in [px, py, pz, nx, ny, nz, *kd, *k_eff]]
    qw = [torch.where(hit, kd[c] * k_eff[c], zero) for c in range(3)]

    # ---- Fresnel split (main.cpp:577-610), glossy children (Proj13
    # main.cpp:633-659): coefficients use the true normal, directions the
    # perturbed ones
    eta = torch.where(frontb, 1.0 / ior, ior)
    cos_i = nx * vx + ny * vy + nz * vz
    if tables.has_gloss:
        rg = mat(20, 1)
        tg = mat(21, 1)

        def perturb(gl, soff):
            par = torch.abs(nx) > 0.9
            ax = torch.where(par, 0.0, 1.0)
            az = torch.where(par, 1.0, 0.0)
            t1x, t1y, t1z = _norm3(ny * az, nz * ax - nx * az, -ny * ax)
            t2x = ny * t1z - nz * t1y
            t2y = nz * t1x - nx * t1z
            t2z = nx * t1y - ny * t1x
            r = torch.sqrt(_rand01(seed + soff, lane)) * gl
            th = _rand01(seed + soff + 977, lane) * (2.0 * np.pi)
            rc, rs = r * torch.cos(th), r * torch.sin(th)
            return _norm3(nx + t1x * rc + t2x * rs,
                          ny + t1y * rc + t2y * rs,
                          nz + t1z * rc + t2z * rs)

        prx, pry, prz = perturb(rg, 2617)
        use_r = rg > 0.0
        nrx = torch.where(use_r, prx, nx)
        nry = torch.where(use_r, pry, ny)
        nrz = torch.where(use_r, prz, nz)
        ptx, pty, ptz = perturb(tg, 3499)
        use_t = tg > 0.0
        ntx = torch.where(use_t, ptx, nx)
        nty = torch.where(use_t, pty, ny)
        ntz = torch.where(use_t, ptz, nz)
        cos_r = nrx * vx + nry * vy + nrz * vz
        cos_t = ntx * vx + nty * vy + ntz * vz
    else:
        nrx, nry, nrz = nx, ny, nz
        ntx, nty, ntz = nx, ny, nz
        cos_r = cos_t = cos_i
    sgn = torch.where(cos_t > 0.0, 1.0, -1.0)
    yx, yy, yz = ntx * sgn, nty * sgn, ntz * sgn
    zx = vy * yz - vz * yy
    zy = vz * yx - vx * yz
    zz = vx * yy - vy * yx
    xx = yy * zz - yz * zy
    xy = yz * zx - yx * zz
    xz = yx * zy - yy * zx
    xx, xy, xz = _norm3(xx, xy, xz)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    sin_o = torch.clamp(sin_t * eta, 0.0, 1.0)
    cos_o = torch.sqrt(torch.clamp(1.0 - sin_o * sin_o, min=0.0))
    tdx, tdy, tdz = _norm3(-xx * sin_o - yx * cos_o,
                           -xy * sin_o - yy * cos_o,
                           -xz * sin_o - yz * cos_o)
    rdx, rdy, rdz = _norm3(2.0 * cos_r * nrx - vx,
                           2.0 * cos_r * nry - vy,
                           2.0 * cos_r * nrz - vz)
    em1 = eta - 1.0
    ep1 = eta + 1.0
    c0 = (em1 * em1) / (ep1 * ep1)
    r_c = c0 + (1.0 - c0) * torch.pow(1.0 - torch.abs(cos_i), 5.0)
    t_c = 1.0 - r_c
    tot = (eta * sin_i) > prm["total_reflection_threshold"]
    rk = [torch.where(tot, refl[c] + refr[c], refl[c] + refr[c] * r_c)
          for c in range(3)]
    tk = [torch.where(tot, zero, refr[c] * t_c) for c in range(3)]

    thr = prm["color_threshold"]
    r_w = [k_eff[c] * rk[c] for c in range(3)]
    t_w = [k_eff[c] * tk[c] for c in range(3)]
    r_go = hit & ((rk[0] > thr) | (rk[1] > thr) | (rk[2] > thr))
    t_go = hit & ((tk[0] > thr) | (tk[1] > thr) | (tk[2] > thr))

    # ---- Russian-roulette continuation (integrator._rr_select)
    wr = torch.where(r_go, (r_w[0] + r_w[1] + r_w[2]) * (1.0 / 3.0), zero)
    wt = torch.where(t_go, (t_w[0] + t_w[1] + t_w[2]) * (1.0 / 3.0), zero)
    wsum = wr + wt
    u = _rand01(seed, lane) * torch.clamp(wsum, min=1e-30)
    take_r = ((u < wr) | (wt <= 0.0)) & (wr > 0.0)
    w_chosen = torch.where(take_r, wr, wt)
    scale = wsum / torch.clamp(w_chosen, min=1e-30)
    child = wsum > 0.0
    c3 = (torch.where(take_r, rdx, tdx), torch.where(take_r, rdy, tdy),
          torch.where(take_r, rdz, tdz))
    co3 = _offset_origin((px, py, pz), (nx, ny, nz), c3)
    next_state = (
        [torch.where(child, v, SENTINEL) for v in co3],
        [torch.where(child, c3[0], 1.0), torch.where(child, c3[1], 0.0),
         torch.where(child, c3[2], 0.0)],
        [torch.where(child, torch.where(take_r, r_w[c], t_w[c]) * scale,
                     zero) for c in range(3)],
        [torch.where(child, m_abs[c], zero) for c in range(3)],
        child.to(torch.float32),
        torch.where(take_r, float(RT_REFLECT), float(RT_REFRACT)),
    )
    return rad, hitf, tz, surf, qw, next_state


def _lane_seeds(n, seed, blk0, device):
    """Per-lane (uint32 seed of its 1024-lane group, index in the group)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    grp = lane // BLOCK
    seed0 = (_i32(seed) + (blk0 + grp) * 7919) & _M32
    return seed0, lane % BLOCK


def wave_plain(cfg, tables: WaveTables, o3, d3, alive, seed, bounces=None,
               blk0=0, tput3=None, absorb3=None, rtype=None, surf_out=False,
               gi_from=None):
    """Plain PyTorch wave, with `wave`'s arguments and returns."""
    rays = pack_rays(o3, d3, alive, tput3, absorb3, rtype)
    n = rays.shape[1]
    h = _Host(tables)
    prm = shade_params(cfg, tables)
    nbounce = (cfg.bounces if bounces is None else bounces) + 1
    seed0, lane = _lane_seeds(n, int(seed), int(blk0), rays.device)
    one = torch.ones(n, dtype=torch.float32, device=rays.device)
    zero = torch.zeros_like(one)
    if rays.shape[0] > 7:
        state = (list(rays[0:3]), list(rays[3:6]), list(rays[7:10]),
                 list(rays[10:13]), rays[6], rays[13])
    else:
        state = (list(rays[0:3]), list(rays[3:6]), [one, one, one],
                 [zero, zero, zero], rays[6], zero)
    out = torch.zeros((out_rows(nbounce, surf_out, gi_from), n),
                      dtype=torch.float32, device=rays.device)
    out[4] = BIG
    qbase = 5 + (SURF_ROWS if surf_out else 0)
    for b in range(nbounce):
        if not bool((state[4] > 0.0).any()):
            break
        rad, hitf, tz, surf, qw, state = _bounce(
            h, tables, prm, state, (seed0 + b * 101) & _M32, lane)
        out[0:3] += torch.stack(rad)
        if b == 0:
            out[3], out[4] = hitf, tz
            if surf_out:
                out[5:5 + SURF_ROWS] = torch.stack(surf)
        if gi_from is not None and b >= gi_from:
            r = qbase + (b - gi_from) * GI_ROWS
            out[r:r + GI_ROWS] = torch.stack(surf[0:6] + qw)
    return split_rows(out, nbounce, surf_out, gi_from)


# ---------------------------------------------------------------------------
# the kernel wrapper


def wave(cfg, tables: WaveTables, o3, d3, alive, seed, bounces=None,
         blk0=0, tput3=None, absorb3=None, rtype=None, surf_out=False,
         gi_from=None, stats=None):
    """One sample wave through csrc/wave_kernel.cu for CUDA tensors, or
    `wave_plain` for CPU tensors.  Same arguments and returns as
    rtf_tpu/render/fused.py::fused_wave (lane order in = lane order out):
    (rad3 [3, N], hit [N] bool, z [N]), and with surf_out or gi_from
    (rad3, hit, z, surf [12, N] or None, queries), one (p3, n3, w3) of
    [3, N] per bounce b >= gi_from (see `split_rows`).  On lanes that did
    not hit at a bounce its rows are zero.  tput3, absorb3 and rtype seed
    a child wave (`pack_rays`).  Scenes with file textures or an
    environment map launch the kernel's textured variant, others the
    untextured one, each in its MXU-table form for a mesh over 512 faces;
    each launch is counted under its variant's key in the tracing
    registry (`launch_counter`, utils/tracing.py), and the call is the
    span rtf.launch.

    stats: optional CUDA int64 tensor [NSTAT] that the kernel adds its
    work counts to (see csrc/wave_kernel.cu, STAT_*); with `stats_size(N)`
    entries the launch also writes each block's cycles after them.
    Without it, while tracing's kernel counters are on, the launch adds
    its counts to the registry's tensor of its variant."""
    key = launch_counter(tables)
    nbounce = (cfg.bounces if bounces is None else bounces) + 1
    with tracing.span(tracing.LAUNCH, counter=key, lanes=int(o3.shape[1]),
                      state=not (tput3 is None and absorb3 is None
                                 and rtype is None),
                      surf_out=bool(surf_out),
                      gi_bounces=0 if gi_from is None
                      else max(0, nbounce - gi_from)):
        if o3.device.type == "cpu":
            return wave_plain(cfg, tables, o3, d3, alive, seed, bounces,
                              blk0, tput3, absorb3, rtype, surf_out,
                              gi_from)
        if o3.device.type != "cuda":
            raise ValueError(f"wave: unsupported device {o3.device}")
        if stats is None:
            stats = tracing.kernel_stats(key, NSTAT, o3.device)
        out = _launch(cfg, tables, o3, d3, alive, seed, nbounce, blk0,
                      tput3, absorb3, rtype, surf_out, gi_from, stats)
        tracing.count(key)
        return out


def _launch(cfg, tables, o3, d3, alive, seed, nbounce, blk0, tput3,
            absorb3, rtype, surf_out, gi_from, stats):
    """`wave`'s launch of csrc/wave_kernel.cu on CUDA tensors (the tables
    were checked when they were built: WaveTables.__post_init__)."""
    rays = pack_rays(o3, d3, alive, tput3, absorb3, rtype)
    dev = rays.device
    if tables.device != dev:
        raise ValueError(f"wave: the tables live on {tables.device}, the "
                         f"rays on {dev}")
    _build.check_stats("wave", stats, NSTAT, dev)
    n = rays.shape[1]
    prm = shade_params(cfg, tables)
    # on the MXU tables the launch orders its blocks (csrc/wave_kernel.cu::
    # block_order) in this scratch: a slot a block and two counters
    order = torch.empty((n + THREADS - 1) // THREADS + 2, dtype=torch.int32,
                        device=dev) if tables.mxu else None
    out = torch.empty((out_rows(nbounce, surf_out, gi_from), n),
                      dtype=torch.float32, device=dev)
    p = _build.pointer
    args = _build.WaveArgs(
        rays=p(rays), has_state=int(rays.shape[0] > 7), out=p(out),
        surf_out=int(surf_out), gi_from=-1 if gi_from is None
        else int(gi_from), stats=p(stats), n=n, seed=int(seed) & _M32,
        blk0=int(blk0), nbounce=nbounce,
        spheres=p(tables.spheres), ns=tables.spheres.shape[0],
        planes=p(tables.planes), np=tables.planes.shape[0],
        insts=p(tables.mesh_insts), ni=tables.mesh_insts.shape[0],
        roots=p(tables.roots), faces=p(tables.faces),
        groups=p(tables.groups), ng=tables.groups.shape[0],
        tnodes=p(tables.tnodes), leaves=p(tables.leaves),
        shade=p(tables.shade), staged=int(smem_staged(tables)),
        scene_staged=int(scene_staged(tables)),
        stats_blocks=int(stats is not None
                         and stats.numel() >= stats_size(n)),
        mats=p(tables.materials), lights=p(tables.lights),
        nl=tables.lights.shape[0], texmaps=p(tables.texmaps),
        textures=p(tables.textures), atlas=p(tables.atlas),
        atlas_w=tables.atlas_w, env_tm=tables.env_tm,
        env_l2=int(prm["env_l2"]), env=tables.env, coef=prm["coef"],
        inverse_square=int(prm["inverse_square"]),
        env_on_reflect_miss=int(prm["env_on_reflect_miss"]),
        tot_thr=prm["total_reflection_threshold"],
        col_thr=prm["color_threshold"], shadow_max=prm["shadow_max"],
        shadow_min=prm["shadow_min"], need_uv=int(tables.need_uv),
        has_gloss=int(tables.has_gloss))
    # the launch is asynchronous: `rays` may be freed when this returns,
    # which is safe because the caching allocator reuses it only for work
    # queued after the kernel on the same stream
    _build.launch("wave", "rtf_wave_launch", dev, ctypes.byref(args),
                  int(tables.textured), int(tables.mxu), order)
    return split_rows(out, nbounce, surf_out, gi_from)


def launch_counter(tables: WaveTables) -> str:
    """The tracing registry's key that `wave` counts a launch under for
    these tables: the kernel variant (textured or not, the MXU tables or
    not), launches.wave_kernel[.textured|.mxu|.textured_mxu]."""
    if tables.textured:
        suffix = ".textured_mxu" if tables.mxu else ".textured"
    else:
        suffix = ".mxu" if tables.mxu else ""
    return "launches.wave_kernel" + suffix
