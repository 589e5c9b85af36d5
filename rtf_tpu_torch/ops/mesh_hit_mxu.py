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
for CUDA tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtf_tpu_torch.ops.mxu_pack import plucker_bary, plucker_pair

RAY_BLOCK = 512       # rays per Pallas program: pack_rays16 pads to it
TRI_LANES = 512       # faces per tile of pack_tri_matrix
_CHUNK = 1 << 20      # ray x face elements per plain step (CPU)
_CHUNK_CUDA = 1 << 24  # the same on the card

# kernel launches made by `mesh_closest_hit_mxu` (the plain version never
# counts)
launches = 0


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


def mesh_closest_hit_mxu(rays16: torch.Tensor, trim: torch.Tensor,
                         face0: int = 0):
    """rays16 [N, 16] float32 (`pack_rays16`), trim [n_tiles, 16, 5 * tile]
    float32 (`pack_tri_matrix`).  Returns (t, face int32, front 0/1, ba,
    bb), each [N].  Launches csrc/mesh_hit_mxu.cu for CUDA tensors
    (counted in `launches`; a build or launch failure raises), or runs
    `mesh_closest_hit_mxu_plain` for CPU tensors."""
    global launches
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
    from rtf_tpu_torch import _build
    lib = _build.load("mesh_hit_mxu")
    n = rays16.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    front, ba, bb = (torch.empty_like(t) for _ in range(3))

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rtf_mesh_hit_mxu_launch(
            ptr(rays16), n, ptr(trim), trim.shape[0], trim.shape[2] // 5,
            int(face0), ptr(t), ptr(face), ptr(front), ptr(ba), ptr(bb),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"mesh_closest_hit_mxu kernel launch failed: "
            f"{_build.error_string(rc, 'mesh_hit_mxu')} ({rc})")
    launches += 1
    return t, face, front, ba, bb
