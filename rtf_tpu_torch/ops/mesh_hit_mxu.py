"""Dense closest ray-triangle hit over a Plücker triangle matrix: the plain
PyTorch version and the CUDA kernel's wrapper.

The port of rtf_tpu/ops/pallas_mesh_mxu.py (`pack_tri_matrix`,
`pack_rays16`, `mesh_closest_hit_mxu` and its Pallas kernel `_kernel`),
which nothing in rtf_tpu calls: every ray against every face, no culling.
The matrix [n_tiles, 16, 5 * tile] holds per tile the column blocks
[s_a | s_b | s_c | dn | on] of the bilinear factorization
(ops/mxu_pack.py); rays16 [N, 16] rows are d, o x d, o, 1, t_init.  Both
versions return (t, face, front, ba, bb), each [N]: face = face0 +
tile * tile_width + column, -1 where no face beats t_init (t is then
t_init and the rest zero); among exact t ties the lowest column of a tile
wins and tiles compare strictly, the Pallas kernel's rule.

`mesh_closest_hit_mxu_plain` runs the pair test of ops/mxu_pack.py over
[rays, tile] blocks; `mesh_closest_hit_mxu` launches csrc/mesh_hit_mxu.cu
for CUDA tensors and runs the plain version for CPU tensors.  The kernel
filters the pairs' edge signs on the tensor cores and tests the few pairs
it cannot reject exactly in FP32, on face tables that `pack_faces` packs
once per matrix; `ray_frags`, `filter_margins` and `filter_survivors` are
its filter in plain PyTorch, for the tests.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from rtf_tpu_torch import _build
from rtf_tpu_torch.ops.mxu_pack import plucker_bary, plucker_pair
from rtf_tpu_torch.ops.pack import ZERO
from rtf_tpu_torch.utils import tracing

RAY_BLOCK = 512       # rays per Pallas program: pack_rays16 pads to it
TRI_LANES = 512       # faces per tile of pack_tri_matrix
_CHUNK = 1 << 20      # ray x face elements per plain step (CPU)
_CHUNK_CUDA = 1 << 24  # the same on the card
EPS = 2.0 ** -7       # the filter's margin (csrc/mesh_hit_mxu.cu)
GROUP = 8             # faces per mma B fragment
STAGE_FACES = 128     # the fragments are padded to whole 128-face stages
EXP_MIN = -60         # the least scale exponent of a face or a ray

NSTAT = 4             # the kernel's counters (`mesh_closest_hit_mxu`)

_PACK = {}            # "last": (weakref to a matrix, its version, its pack)


def pack_tri_matrix(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                    tile: int = TRI_LANES) -> np.ndarray:
    """pallas_mesh_mxu.py::pack_tri_matrix: the [n_tiles, 16, 5 * tile]
    float32 Plücker matrix of faces (a, b, c) [F, 3], in their order.  Per
    tile j, columns [0:tile] s_a (edge b->c), [tile:2t] s_b (c->a),
    [2t:3t] s_c (a->b), [3t:4t] dn, [4t:5t] on; rows 0-2 of the sign
    blocks pair with d and rows 3-5 with o x d, the dn block's rows 0-2
    hold n, the on block's rows 6-8 -n and row 9 n.a.  Padding columns are
    zero and never hit."""
    f = len(a)
    nt = max(1, (f + tile - 1) // tile)
    out = np.zeros((nt, 16, 5 * tile), np.float32)
    if f == 0:
        return out
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(ln > 0, ln, 1.0)
    na = np.sum(n * a, axis=-1)

    def plucker(p, q):
        return np.concatenate([np.cross(p, q), q - p], axis=-1)

    w_a, w_b, w_c = plucker(b, c), plucker(c, a), plucker(a, b)
    for j in range(nt):
        lo, hi = j * tile, min(f, (j + 1) * tile)
        w = hi - lo
        out[j, 0:6, 0 * tile:0 * tile + w] = w_a[lo:hi].T
        out[j, 0:6, 1 * tile:1 * tile + w] = w_b[lo:hi].T
        out[j, 0:6, 2 * tile:2 * tile + w] = w_c[lo:hi].T
        out[j, 0:3, 3 * tile:3 * tile + w] = n[lo:hi].T
        out[j, 6:9, 4 * tile:4 * tile + w] = -n[lo:hi].T
        out[j, 9, 4 * tile:4 * tile + w] = na[lo:hi]
    return out


def pack_rays16(o: torch.Tensor, d: torch.Tensor, t_init: torch.Tensor):
    """pallas_mesh_mxu.py::pack_rays16: [N, 3] x 2 + [N] -> ([N_pad, 16],
    N_pad), N_pad a multiple of RAY_BLOCK; rows 0-2 d, 3-5 o x d, 6-8 o,
    9 = 1, 10 t_init.  Padding rays get t_init = 0 so nothing validates."""
    n = o.shape[0]
    npad = ((max(n, RAY_BLOCK) + RAY_BLOCK - 1) // RAY_BLOCK) * RAY_BLOCK
    r = torch.zeros((npad, 16), dtype=torch.float32, device=o.device)
    r[:n, 0:3] = d
    r[:n, 3:6] = torch.linalg.cross(o, d)
    r[:n, 6:9] = o
    r[:n, 9] = 1.0
    r[:n, 10] = t_init
    return r, npad


def _matrix_cols(trim: torch.Tensor):
    """The 22 face rows of the pair test (ops/mxu_pack.py's order: w_a,
    w_b, w_c, n, n.a), each [n_tiles, tile], from the matrix."""
    tile = trim.shape[2] // 5
    cols = [trim[:, r, k * tile:(k + 1) * tile]
            for k in range(3) for r in range(6)]
    cols += [trim[:, r, 3 * tile:4 * tile] for r in range(3)]
    cols.append(trim[:, 9, 4 * tile:5 * tile])
    return cols


@dataclass(frozen=True)
class FacePack:
    """The kernel's face tables, packed from the matrix by `pack_faces`:
    frags [G, 192] float32, G groups of 8 faces (G * 8 the faces rounded
    up to whole STAGE_FACES) as mma.sync.m16n8k8 TF32 B fragments: per
    group, lane l = 4 g + q of face g holds (w_a[q], w_a[q + 4], w_b[q],
    w_b[q + 4]) at floats 4 l.., then (w_c[q], w_c[q + 4]) at 128 + 2 l..
    Rows 0-5 of w_k are the face's sign 6-vector scaled by 2^-exps and
    rounded to TF32 (ties away from zero), zero where the scale cannot be
    formed; row 6 is -EPS (a live ray's column 6 is 1, so the product is
    s_k - EPS) and row 7 is (1, -1, 0) for w_a, w_b, w_c (a dead ray's
    column 7 is 1: every pair rejected); a padding face has zero rows 0-5
    and (1, -1, 0) in rows 6 and 7: rejected for every ray.  rows [F, 24]
    float32, the 22 rows of the pair test (plucker.cuh's layout) and two
    zeros, exact; fmap [F] int32, each face's matrix index tile *
    tile_width + column, increasing; exps [F] int32."""
    frags: torch.Tensor
    rows: torch.Tensor
    fmap: torch.Tensor
    exps: torch.Tensor

    def __post_init__(self):
        _build.check_tables("FacePack", {
            "frags": self.frags, "rows": self.rows, "fmap": self.fmap},
            int32=("fmap",))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 stored mantissa bits), ties
    away from zero: cvt.rna.tf32.f32 for |x| < 2^127."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_faces(trim: torch.Tensor) -> FacePack:
    """The kernel's face tables from the matrix, on trim's device.  A face
    whose normal rows (18-20) are all zero (padding columns, degenerate
    faces) is dropped: its dn is 0, or NaN for a non-finite direction, so
    it never hits.  Each kept face's 18 sign entries are scaled by
    2^-b, b the frexp exponent of their largest magnitude (at least
    EXP_MIN), so every entry is below 1 in magnitude; a power of two
    changes no sign and, above the subnormals, no rounding."""
    cols = torch.stack([c.reshape(-1) for c in _matrix_cols(trim)], 1)
    keep = torch.nonzero((cols[:, 18:21] != 0).any(1)).squeeze(1)
    rows = cols[keep]
    f = rows.shape[0]
    w = rows[:, :18]
    mx = w.abs().amax(1)
    ok = torch.isfinite(w).all(1) & (mx > 0)
    _, e = torch.frexp(torch.where(ok, mx, 1.0))
    e = e.clamp(min=EXP_MIN)
    scaled = torch.ldexp(w.double(), -e[:, None].double()).float()
    scaled = tf32_round(torch.where(ok[:, None], scaled, 0.0))
    g = -(-f // STAGE_FACES) * STAGE_FACES // GROUP
    dev = trim.device
    wk = torch.zeros((g * GROUP, 3, 8), dtype=torch.float32, device=dev)
    wk[:f, :, :6] = scaled.view(f, 3, 6)
    reject = torch.tensor([1.0, -1.0, 0.0], device=dev)
    wk[:f, :, 6] = -EPS
    wk[f:, :, 6] = reject
    wk[:, :, 7] = reject
    wk = wk.view(g, GROUP, 3, 8)
    lane = torch.arange(32, device=dev)
    fg, q = lane // 4, lane % 4
    frags = torch.cat([
        torch.stack([wk[:, fg, 0, q], wk[:, fg, 0, q + 4],
                     wk[:, fg, 1, q], wk[:, fg, 1, q + 4]], -1).view(g, 128),
        torch.stack([wk[:, fg, 2, q], wk[:, fg, 2, q + 4]], -1).view(g, 64)],
        1)
    pad = torch.zeros((f, 2), dtype=torch.float32, device=dev)
    return FacePack(frags.contiguous(), torch.cat([rows, pad], 1).contiguous(),
                    keep.to(torch.int32), e.to(torch.int32))


def unpack_frags(frags: torch.Tensor, f: int) -> torch.Tensor:
    """The scaled TF32 sign blocks [f, 3, 6] back from `FacePack.frags`."""
    g = frags.shape[0]
    p0 = frags[:, :128].reshape(g, GROUP, 4, 4)    # [group, face, q, 4]
    p1 = frags[:, 128:].reshape(g, GROUP, 4, 2)
    wk = torch.zeros((g, GROUP, 3, 8), dtype=frags.dtype, device=frags.device)
    for k, (part, i) in enumerate(((p0, 0), (p0, 2), (p1, 0))):
        wk[:, :, k, 0:4] = part[..., i]
        wk[:, :, k, 4:8] = part[..., i + 1]
    return wk.reshape(g * GROUP, 3, 8)[:f, :, :6]


def ray_frags(rays16: torch.Tensor):
    """What the kernel makes of each ray for the filter, in its arithmetic:
    (a [N, 6] float32, the row (d, o x d) scaled by 2^-a_r, a_r the frexp
    exponent of its L1 norm summed left to right (at least EXP_MIN), and
    rounded to TF32; zero where the norm is zero or not finite (such a ray
    meets every face in the exact test), live [N] bool: t_init > 1e-3, the
    rays that can hit at all)."""
    r = rays16[:, 0:6]
    l1 = r[:, 0].abs()
    for k in range(1, 6):
        l1 = l1 + r[:, k].abs()
    ok = torch.isfinite(l1) & (l1 > 0)
    _, e = torch.frexp(torch.where(ok, l1, 1.0))
    e = e.clamp(min=EXP_MIN)
    a = torch.ldexp(r.double(), -e[:, None].double()).float()
    a = tf32_round(torch.where(ok[:, None], a, 0.0))
    return a, rays16[:, 10] > ZERO


def filter_margins(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact sums the tensor cores approximate: a [N, 6] (`ray_frags`)
    against w [F, 3, 6] (`unpack_frags`), [N, F, 3] float64.  Every
    product of two TF32 values is exact in float64, and so is a sum of six
    of them that stays in range."""
    return torch.einsum("nk,fsk->nfs", a.double(), w.double())


def filter_survivors(s: torch.Tensor, live: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    """[N, F] bool, the pairs the filter passes to the exact test, from
    the sums s of `filter_margins`: a live ray's pair is rejected where
    one sum is at least eps and another below -eps."""
    rej = (s.amax(2) >= eps) & (s.amin(2) < -eps)
    return live[:, None] & ~rej


def mesh_closest_hit_mxu_plain(rays16: torch.Tensor, trim: torch.Tensor,
                               face0: int = 0):
    """The plain version: every ray against every face, [rays, tile]
    blocks in chunks of rays; a strict `<` against the running best over
    tiles in order, and the lowest column among a tile's exact ties."""
    n = rays16.shape[0]
    ntiles, tile = trim.shape[0], trim.shape[2] // 5
    dev = rays16.device
    cols = _matrix_cols(trim)
    t_best = rays16[:, 10].clone()
    face = torch.full((n,), -1, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.float32, device=dev)
    ba = torch.zeros_like(front)
    bb = torch.zeros_like(front)
    col_ids = torch.arange(tile, device=dev)
    step = max(1, (_CHUNK_CUDA if dev.type == "cuda" else _CHUNK) // tile)
    for s in range(0, n, step):
        sl = slice(s, min(n, s + step))
        d3, c3, o3 = (tuple(rays16[sl, k:k + 1] for k in range(b, b + 3))
                      for b in (0, 3, 6))
        for j in range(ntiles):
            t, valid, sa, sb, sc, dn = plucker_pair(
                [x[j][None, :] for x in cols], d3, c3, o3)
            tv = torch.where(valid, t, torch.inf)
            t_min = torch.amin(tv, dim=1)
            c = torch.amin(torch.where(tv == t_min[:, None], col_ids, tile),
                           dim=1).clamp(max=tile - 1)
            upd = t_min < t_best[sl]
            pick = c[:, None]
            wa, wb = plucker_bary(*(x.gather(1, pick)[:, 0]
                                    for x in (sa, sb, sc)))
            t_best[sl] = torch.where(upd, t_min, t_best[sl])
            face[sl] = torch.where(upd, (face0 + j * tile + c)
                                   .to(torch.int32), face[sl])
            front[sl] = torch.where(
                upd, (dn.gather(1, pick)[:, 0] <= 0.0).to(torch.float32),
                front[sl])
            ba[sl] = torch.where(upd, wa, ba[sl])
            bb[sl] = torch.where(upd, wb, bb[sl])
    return t_best, face, front, ba, bb


def _face_pack(trim: torch.Tensor) -> FacePack:
    """`pack_faces(trim)`, packed once per matrix: the last matrix's pack
    is kept while that tensor lives and is not written to."""
    hit = _PACK.get("last")
    if hit is not None and hit[0]() is trim and hit[1] == trim._version:
        return hit[2]
    pack = pack_faces(trim)
    _PACK["last"] = (weakref.ref(trim), trim._version, pack)
    return pack


def mesh_closest_hit_mxu(rays16: torch.Tensor, trim: torch.Tensor,
                         face0: int = 0, stats=None):
    """rays16 [N, 16] float32 (`pack_rays16`), trim [n_tiles, 16, 5 * tile]
    float32 (`pack_tri_matrix`).  Returns (t, face int32, front 0/1, ba,
    bb), each [N].  Launches csrc/mesh_hit_mxu.cu for CUDA tensors on the
    matrix's `pack_faces` tables (counted in the tracing registry as
    launches.mesh_closest_hit_mxu; a build or launch failure raises), or
    runs `mesh_closest_hit_mxu_plain` for CPU tensors.
    stats: optional CUDA int64 tensor [NSTAT] to which the kernel's
    counting instantiation adds the pairs filtered (live rays x faces
    kept), the pairs re-checked in FP32, the valid pairs among them and
    the 16-ray x 8-face tiles that held a pair to re-check."""
    if rays16.device.type == "cpu":
        return mesh_closest_hit_mxu_plain(rays16, trim, face0)
    if rays16.device.type != "cuda":
        raise ValueError(f"mesh_closest_hit_mxu: unsupported device "
                         f"{rays16.device}")
    dev = rays16.device
    for name, x, dim in (("rays16", rays16, 2), ("trim", trim, 3)):
        if x.device != dev or x.dtype != torch.float32 or x.dim() != dim \
                or not x.is_contiguous():
            raise ValueError(f"mesh_closest_hit_mxu: {name} must be a "
                             f"contiguous {dim}-D float32 tensor on {dev}")
    if rays16.shape[1] != 16:
        raise ValueError("mesh_closest_hit_mxu: rays16 must be [N, 16]")
    if trim.shape[1] != 16 or trim.shape[2] % 5:
        raise ValueError("mesh_closest_hit_mxu: trim must be "
                         "[n_tiles, 16, 5 * tile]")
    _build.check_stats("mesh_closest_hit_mxu", stats, NSTAT, dev)
    pack = _face_pack(trim)
    n = rays16.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    front, ba, bb = (torch.empty_like(t) for _ in range(3))
    _build.launch("mesh_hit_mxu", "rtf_mesh_hit_mxu_launch", dev,
                  rays16, n, pack.frags, pack.rows, pack.fmap,
                  pack.rows.shape[0], int(face0), t, face, front, ba, bb,
                  stats)
    tracing.count("launches.mesh_closest_hit_mxu")
    return t, face, front, ba, bb
