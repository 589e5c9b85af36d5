"""Global illumination on the wave: the hemisphere fan-out as re-launches of
the wave kernel, and irradiance-volume terms on its query rows.

The port of rtf_tpu/render/fused.py:1779-2028 (`_volume_terms`,
`_hemisphere_dirs_ch`, `fused_gi_primary`, `fused_gi_chunks`,
`fused_gi_wave`), the hybrid GI of the reference's MtlBlinn::Shade: at the
first hit a loop of hemisphere samples (main.cpp:642-693), each a child
wave shaded with one bounce fewer, and below it the photon-map estimate
(main.cpp:694-705), read here from an irradiance volume
(gi/volume.py).  As in JAX, everything outside the wave kernel is plain
tensor code: a primary launch returns the first-hit surface rows, then
each hemisphere sample is one launch of the same kernel.

Randomness: jax.random's draws cannot be reproduced, so the two uniforms
of each hemisphere sample (azimuth, sin^2 theta) are inputs; the renderer
draws them from a torch.Generator on the device.  The kernel's per-lane
hash RNG is reproduced bit for bit, child i running on
seed + (i + 1) * 104729 in int32.  With the MXU mesh tables each child
wave's lanes are permuted first (`gi_mesh_perm`, fused.py:1976-1983), as
rtf_tpu does: the permutation relabels the per-lane hash-RNG streams, so
it is reproduced exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from rtf_tpu_torch.gi.volume import sample_volume_ch
from rtf_tpu_torch.render.wave import (
    RT_REFRACT, _i32, _mat3, _norm3, _offset_origin, wave,
)

CHILD_SEED_STRIDE = 104729


def volume_terms(queries, vol):
    """Photon-map GI from a wave's query rows (fused.py::_volume_terms):
    the sum over the queried bounces of w * E(p) * max(0, -n . D(p)), one
    batched volume lookup over all of them.  [3, N], or None without
    queries."""
    if not queries:
        return None
    nb, n = len(queries), queries[0][0].shape[1]
    p3, n3, w3 = (torch.cat([q[k] for q in queries], dim=1)
                  for k in range(3))
    e3, dir3 = sample_volume_ch(vol, p3)
    cos = torch.clamp(-(n3[0] * dir3[0] + n3[1] * dir3[1]
                        + n3[2] * dir3[2]), min=0.0)
    return (w3 * e3 * cos).reshape(3, nb, n).sum(dim=1)


def hemisphere_dirs(n3, u_phi, ysq, stratum=None):
    """fused.py::_hemisphere_dirs_ch with its uniforms passed in: the
    reference's tangent basis (main.cpp:643-654), phi = 2 pi u_phi and
    sin theta = sqrt(ysq).  stratum=(i, s) puts phi in the i-th of s
    azimuth strata.  n3: [3, M]; u_phi, ysq: [M].  Returns (d [3, M],
    max(0, d . n) [M])."""
    nx, ny, nz = n3[0], n3[1], n3[2]
    use1 = nx < 0.4
    zero = torch.zeros_like(nx)
    tx, ty, tz = _norm3(torch.where(use1, zero, ny),
                        torch.where(use1, nz, -nx),
                        torch.where(use1, -ny, zero))
    bx = ny * tz - nz * ty
    by = nz * tx - nx * tz
    bz = nx * ty - ny * tx
    if stratum is not None:
        i, s = stratum
        # a true division like JAX's (CUDA divides by a Python scalar
        # through its reciprocal)
        u_phi = (u_phi + float(i)) / torch.full((), float(s),
                                                device=u_phi.device)
    phi = u_phi * (2.0 * np.pi)
    sin_t = torch.sqrt(ysq)
    cos_t = torch.sqrt(1.0 - ysq)
    ca = torch.cos(phi) * sin_t
    sa = torch.sin(phi) * sin_t
    d = _norm3(tx * ca + bx * sa + nx * cos_t,
               ty * ca + by * sa + ny * cos_t,
               tz * ca + bz * sa + nz * cos_t)
    w = torch.clamp(d[0] * nx + d[1] * ny + d[2] * nz, min=0.0)
    return torch.stack(d), w


def primary_gi_from(gi_vol, caustic_vol):
    """The primary launch's first queried bounce: 0 with a caustic
    volume, 1 with only a photon volume, None without volumes."""
    if caustic_vol is not None:
        return 0
    return 1 if gi_vol is not None else None


def gi_primary(cfg, tables, o3, d3, alive, seed, gi_vol=None,
               caustic_vol=None, wave_fn=wave):
    """fused.py::fused_gi_primary: the primary launch with the first-hit
    surface rows, plus the photon volume's terms at bounces >= 1 and the
    caustic volume's at bounce 0.  Returns (rad3, hit, z, surf [12, N]).
    wave_fn: `wave` (the kernel on CUDA tensors) or `wave_plain`."""
    rad3, hit0, z0, surf, queries = wave_fn(
        cfg, tables, o3, d3, alive, seed, surf_out=True,
        gi_from=primary_gi_from(gi_vol, caustic_vol))
    if caustic_vol is not None and queries:
        # caustics at camera-visible hits only (the bounce-0 query)
        rad3 = rad3 + volume_terms(queries[:1], caustic_vol)
        queries = queries[1:]
    if gi_vol is not None and queries:
        rad3 = rad3 + volume_terms(queries, gi_vol)
    return rad3, hit0, z0, surf


def child_wave_args(cfg, surf, hit0, alive, seed, i, u_phi, ysq):
    """The inputs of hemisphere sample i's child wave (fused_gi_chunks's
    gi_chunk): (o3, d3, alive, seed) and the keywords of `wave`.  The
    child starts at the first hit with throughput k_eff * kd * w / S as
    a refraction-typed ray, and the reference shades it with
    bounceCount - 1 (main.cpp:678): one Fresnel level fewer than the
    camera ray."""
    s = max(cfg.hemisphere_samples, 1)
    p3, n3, kd3, ke3 = surf[0:3], surf[3:6], surf[6:9], surf[9:12]
    dirs, w = hemisphere_dirs(
        n3, u_phi, ysq, stratum=(i, s) if cfg.gi_stratify else None)
    tput3 = ke3 * kd3 * w * (1.0 / s)
    alive_c = alive & hit0 & (tput3.amax(dim=0) > 0.0)
    o3c = torch.stack(_offset_origin(p3, n3, dirs))
    return ((o3c, dirs, alive_c,
             _i32(int(seed) + (i + 1) * CHILD_SEED_STRIDE)),
            dict(bounces=max(cfg.bounces - 1, 0), tput3=tput3,
                 rtype=RT_REFRACT))


def gi_mesh_perm(tables, o3, d3, alive):
    """fused.py::_gi_mesh_perm: the lane permutation that groups child rays
    by mesh interest, (perm, inv) [N] int64; inputs go through perm and
    per-lane outputs come back through inv.  Lanes whose ray enters some
    mesh instance's root box (its slot's unpadded bounds, in the
    instance's local space) sort first, by the 4x4x4 Morton cell of their
    origin over the live origins' bounds, then by the octant of their
    world direction; then the other live lanes, then the dead ones.  The
    sort is stable.  On the TPU it makes 1024-lane blocks homogeneous so
    that their tile culls skip work; here it is kept because it decides
    which lane, and so which hash-RNG stream, traces each child ray."""
    n = o3.shape[1]
    enters = torch.zeros(n, dtype=torch.bool, device=o3.device)
    for inst, (mlo, mhi) in zip(tables.mesh_insts.tolist(),
                                tables.mesh_bounds):
        lo3 = _mat3(inst[0:9], o3[0] - inst[9], o3[1] - inst[10],
                    o3[2] - inst[11])
        ld3 = _mat3(inst[0:9], d3[0], d3[1], d3[2])
        tmin = torch.zeros(n, device=o3.device)
        tmax = torch.full((n,), torch.inf, device=o3.device)
        for c in range(3):
            idc = torch.where(torch.abs(ld3[c]) < 1e-20,
                              torch.where(ld3[c] < 0.0, -1e30, 1e30),
                              1.0 / ld3[c])
            a = (mlo[c] - lo3[c]) * idc
            b = (mhi[c] - lo3[c]) * idc
            tmin = torch.maximum(tmin, torch.minimum(a, b))
            tmax = torch.minimum(tmax, torch.maximum(a, b))
        enters = enters | (tmax >= tmin)
    octant = ((d3[0] < 0).to(torch.int64) + 2 * (d3[1] < 0).to(torch.int64)
              + 4 * (d3[2] < 0).to(torch.int64))
    # a 2-bit Morton cell per axis of the origin over the live origins'
    # bounds; bit b of axis c goes to bit 3 b + c
    cell = torch.zeros(n, dtype=torch.int64, device=o3.device)
    for c in range(3):
        oc = torch.where(alive, o3[c], 0.0)
        olo = torch.amin(torch.where(alive, o3[c], 1e29))
        ohi = torch.amax(torch.where(alive, o3[c], -1e29))
        q = torch.clamp(((oc - olo) / torch.clamp(ohi - olo, min=1e-6)
                         * 4.0).to(torch.int32), 0, 3).to(torch.int64)
        cell = cell | ((q & 1) << c) | (((q >> 1) & 1) << (3 + c))
    bucket = torch.where(alive, torch.where(enters, cell * 8 + octant, 512),
                         513)
    perm = torch.argsort(bucket, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=o3.device)
    return perm, inv


def gi_chunks(cfg, tables, surf, hit0, alive, seed, uniforms, gi_vol=None,
              wave_fn=wave):
    """fused.py::fused_gi_chunks over all cfg.hemisphere_samples samples
    (rtf_tpu splits them into dispatches only for a TPU runtime limit):
    each a child wave from the first-hit surface rows, weighted 1/S, its
    lanes permuted by `gi_mesh_perm` when cfg.gi_mesh_sort and the mesh is
    on the MXU tables.  uniforms[i] = (u_phi [N], ysq [N]) of sample i.
    Returns their radiance summed, [3, N]."""
    acc = torch.zeros_like(surf[0:3])
    for i in range(cfg.hemisphere_samples):
        (o3, d3, alive_c, seed_c), kw = child_wave_args(
            cfg, surf, hit0, alive, seed, i, *uniforms[i])
        inv = None
        if cfg.gi_mesh_sort and tables.mxu:
            perm, inv = gi_mesh_perm(tables, o3, d3, alive_c)
            o3, d3, alive_c = o3[:, perm], d3[:, perm], alive_c[perm]
            kw["tput3"] = kw["tput3"][:, perm]
        out = wave_fn(cfg, tables, o3, d3, alive_c, seed_c, **kw,
                      gi_from=0 if gi_vol is not None else None)
        rad = out[0]
        if gi_vol is not None:
            rad = rad + volume_terms(out[4], gi_vol)
        acc = acc + (rad if inv is None else rad[:, inv])
    return acc


def gi_wave(cfg, tables, o3, d3, alive, seed, uniforms=None, gi_vol=None,
            caustic_vol=None, wave_fn=wave):
    """fused.py::fused_gi_wave: one GI sample wave, the primary launch and
    cfg.hemisphere_samples child launches.  uniforms: the hemisphere
    draws, uniforms[i] = (u_phi [N], ysq [N]) in [0, 1); gi_vol: the
    photon volume of gi_mode 'photon', None for 'hemisphere' and
    'pathtrace'.  wave_fn=wave_plain gives the plain version of the whole
    sample wave on any device, which chip_smoke.py holds the kernel's
    against.  Returns (rad3 [3, N], hit [N], z [N]) like `wave`."""
    rad3, hit0, z0, surf = gi_primary(cfg, tables, o3, d3, alive, seed,
                                      gi_vol, caustic_vol, wave_fn)
    if cfg.hemisphere_samples > 0:
        rad3 = rad3 + gi_chunks(cfg, tables, surf, hit0, alive, seed,
                                uniforms, gi_vol=gi_vol, wave_fn=wave_fn)
    return rad3, hit0, z0
