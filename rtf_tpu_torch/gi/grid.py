"""Photon hash grid + batched irradiance estimation (rtf_tpu/gi/grid.py).

The replacement for the reference's balanced kd-tree and bounded-heap kNN
walk (cyPhotonMap.h:196-284 BalanceSegment, :288-336 EstimateIrradiance,
:365-440 LocatePhotons):

* photons are binned into a uniform grid with cell size = search radius,
  stably sorted by cell id, with per-cell [start, count) ranges;
* a query's candidates are the photons of its 27 neighbour cells.  rtf_tpu
  walks them in a masked loop of 27 x max_per_cell steps (the TPU's shape);
  here they are one flat list per chunk of queries, query-major, then
  cell-major in rtf_tpu's dz-major visit order, then in sorted photon
  order, so the work is the photons actually there, however skewed the
  occupancy.  Per-query sums are segmented sums over that list (in list
  order, no atomics: deterministic on the card), and the exact k-th
  nearest distance is read from a stable sort of the list by (query, d2);
* it accumulates sum(filter * power) and the power-weighted mean incoming
  direction, the quantities the reference sums (cyPhotonMap.h:308-336),
  with the normal-disc test (photon dir . N >= 0 rejected,
  cyPhotonMap.h:385-387) per photon.

exact=True selects the radius of the k nearest accepted photons where more
than k lie within the search radius (the reference heap's dist2[0]);
exact=False keeps rtf_tpu's legacy shrink r2 * k / count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from rtf_tpu_torch.core.math import dot, normalize
from rtf_tpu_torch.gi.photon import PhotonMapData

FILTER_CONSTANT, FILTER_LINEAR, FILTER_QUADRATIC = 0, 1, 2
# candidates (query, photon pairs) per chunk: about 100 bytes each at peak
CANDIDATES_PER_CHUNK = 1 << 24
# queries whose 27 cell ranges are looked up at once
QUERIES_PER_BLOCK = 1 << 17
# the 27 neighbour cells in rtf_tpu's visit order (dz-major)
_OFFS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)]


@dataclass
class PhotonGrid:
    pos: torch.Tensor         # [CAP,3] sorted by cell
    dir: torch.Tensor         # [CAP,3]
    power: torch.Tensor       # [CAP,3]
    cell_start: torch.Tensor  # [NC] int32
    cell_count: torch.Tensor  # [NC] int32
    origin: torch.Tensor      # [3] grid min corner
    n_valid: torch.Tensor     # [] int32
    dims: tuple = (1, 1, 1)
    cell_size: float = 1.0
    # the TRUE max photons in any one cell, measured at build time: the
    # gathers' default per-cell bound, so no photon is dropped
    max_occupancy: int = 128
    # irradiance volumes baked from this grid (render/renderer.py::
    # _cached_volume), keyed by (radius, k, bounds)
    volumes: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)


def _base_cell(origin, cell_size, p):
    """floor((p - origin) / cell_size) as int32, a true division (a scalar
    divisor on the card would be a product by its reciprocal)."""
    cs = torch.tensor(cell_size, dtype=torch.float32, device=p.device)
    return torch.floor((p - origin) / cs).to(torch.int32)


def _cell_of(grid_origin, cell_size, dims, p):
    ijk = _base_cell(grid_origin, cell_size, p)
    nx, ny, nz = dims
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                      device=p.device)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    return (ijk[..., 2] * ny + ijk[..., 1]) * nx + ijk[..., 0]


def build_photon_grid(pm: PhotonMapData, cell_size: float,
                      bounds_min, bounds_max) -> PhotonGrid:
    """Sort photons into a dense uniform grid over the (host) bounds;
    photons outside are clamped to border cells.  One device-to-host
    scalar: the measured max occupancy."""
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)
    ext = np.maximum(bounds_max - bounds_min, 1e-3)
    dims = tuple(int(x) for x in np.maximum(1, np.ceil(ext / cell_size)))
    nc = dims[0] * dims[1] * dims[2]
    origin = torch.as_tensor(bounds_min, device=pm.pos.device)
    pos, dirs, power, cell_start, cell_count = _grid_sort(
        pm, origin, dims, float(cell_size), nc)
    max_occ = max(1, int(cell_count.max()))
    return PhotonGrid(pos=pos, dir=dirs, power=power, cell_start=cell_start,
                      cell_count=cell_count, origin=origin, n_valid=pm.count,
                      dims=dims, cell_size=float(cell_size),
                      max_occupancy=max_occ)


def _grid_sort(pm, origin, dims, cell_size, nc):
    """The stable sort by cell id (invalid photons to the sentinel bin nc)
    and each cell's [start, end) by binary search."""
    cap = pm.pos.shape[0]
    dev = pm.pos.device
    valid = torch.arange(cap, device=dev) < pm.count
    cell = _cell_of(origin, cell_size, dims, pm.pos)
    cell = torch.where(valid, cell, nc)
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    idx = torch.arange(nc, dtype=torch.int32, device=dev)
    cell_start = torch.searchsorted(cell_sorted, idx).to(torch.int32)
    cell_end = torch.searchsorted(cell_sorted, idx, right=True) \
        .to(torch.int32)
    return (pm.pos[order], pm.dir[order], pm.power[order], cell_start,
            cell_end - cell_start)


def _cap_arrays(grid: PhotonGrid, cap: int):
    counts = grid.cell_count.to(torch.int64)
    starts = grid.cell_start.to(torch.int64)
    kept = torch.clamp(counts, max=cap)
    cum = torch.cumsum(kept, 0)
    new_start = torch.cat([torch.zeros(1, dtype=torch.int64,
                                       device=cum.device), cum[:-1]])
    total = cum[-1]
    capn = grid.pos.shape[0]
    t = torch.arange(capn, dtype=torch.int64, device=cum.device)
    cell = torch.clamp(torch.searchsorted(new_start, t, right=True) - 1,
                       0, counts.shape[0] - 1)
    j = t - new_start[cell]
    k_c = torch.clamp(kept[cell], min=1)
    valid = (j < kept[cell]) & (t < total)
    # strided pick: floor(j*c/kept) visits kept distinct offsets of the
    # cell's [0, c) range (strictly increasing since c >= kept)
    src = torch.clamp(starts[cell] + (j * counts[cell]) // k_c, 0, capn - 1)
    scale = counts[cell].to(torch.float32) / k_c.to(torch.float32)
    power = grid.power[src] * torch.where(valid, scale, 0.0)[:, None]
    return (grid.pos[src], grid.dir[src], power, new_start.to(torch.int32),
            kept.to(torch.int32), total.to(torch.int32))


def cap_occupancy(grid: PhotonGrid, cap: int) -> PhotonGrid:
    """Unbiased occupancy cap (photon relaxation, rtf_tpu/gi/grid.py::
    cap_occupancy): cells holding more than `cap` photons are thinned to
    `cap` by strided subsampling and each kept photon's power is scaled by
    count/kept, which preserves flux density in both regimes of the
    estimator; what is lost is resolution inside the thinned cells.  The
    volume bake uses it; exact gathers keep the measured occupancy."""
    if grid.max_occupancy <= cap:
        return grid
    pos, dirs, power, new_start, kept, total = _cap_arrays(grid, cap)
    return replace(grid, pos=pos, dir=dirs, power=power,
                   cell_start=new_start, cell_count=kept, n_valid=total,
                   max_occupancy=min(grid.max_occupancy, int(cap)))


def _cell_ranges(grid: PhotonGrid, q_pos, max_per_cell: int):
    """Per query and neighbour cell (rtf_tpu's order): the first photon
    and the photon count (0 outside the grid, at most max_per_cell),
    [M, 27] int64 each."""
    nx, ny, nz = grid.dims
    dev = q_pos.device
    base = _base_cell(grid.origin, grid.cell_size, q_pos)
    ijk = base[:, None, :] + torch.tensor(_OFFS, dtype=torch.int32,
                                          device=dev)[None]
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                      device=dev)
    in_grid = ((ijk >= 0) & (ijk <= hi)).all(-1)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    cid = ((ijk[..., 2] * ny + ijk[..., 1]) * nx + ijk[..., 0]).to(
        torch.int64)
    start = grid.cell_start[cid].to(torch.int64)
    cnt = torch.where(in_grid, grid.cell_count[cid], 0).to(torch.int64)
    return start, torch.clamp(cnt, max=max_per_cell)


class _Candidates:
    """The flat candidate list of a chunk of queries: query id and photon
    row of every (query, photon) pair, query-major, the per-query lengths,
    and each pair's squared distance."""

    def __init__(self, grid, q_pos, start, cnt, total: int):
        m = q_pos.shape[0]
        dev = q_pos.device
        seg = torch.repeat_interleave(
            torch.arange(m * 27, device=dev), cnt.reshape(-1),
            output_size=total)
        first = torch.cumsum(cnt.reshape(-1), 0) - cnt.reshape(-1)
        lane = torch.arange(total, device=dev) - first[seg]
        self.q = seg // 27
        self.idx = torch.clamp(start.reshape(-1)[seg] + lane,
                               max=grid.pos.shape[0] - 1)
        self.lengths = cnt.sum(1)
        diff = grid.pos[self.idx] - q_pos[self.q]
        self.d2 = (diff * diff).sum(-1)

    def sums(self, values):
        """Per-query sums of [total, C] values, in list order."""
        return torch.segment_reduce(values, "sum", lengths=self.lengths,
                                    axis=0, unsafe=True)


def _gather_pass(grid: PhotonGrid, cand: _Candidates, front, radius2,
                 filter_type: int, inclusive: bool = False):
    """One accumulation sweep over the candidates (rtf_tpu's masked loop
    over the 27 neighbour cells).  front: [total] bool, the normal-disc
    test (None: normal-free queries, e.g. volume corners); radius2: [M]
    per-query squared radius; inclusive accepts d2 == radius2 (the exact
    kNN keeps the k-th photon itself).  (irrad_sum [M,3], dir_sum [M,3],
    count [M] int32)."""
    r2 = radius2[cand.q]
    ok = (cand.d2 <= r2) if inclusive else (cand.d2 < r2)
    if front is not None:
        ok = ok & front
    if filter_type == FILTER_LINEAR:
        filt = 1.0 - torch.sqrt(cand.d2 / torch.clamp(r2, min=1e-30))
    elif filter_type == FILTER_QUADRATIC:
        filt = 1.0 - cand.d2 / torch.clamp(r2, min=1e-30)
    else:
        filt = torch.ones_like(cand.d2)
    w = torch.where(ok, filt, 0.0)
    pw = grid.power[cand.idx]
    maxp = torch.amax(pw, dim=-1)
    # direction weighted by filter * max-channel power
    rows = torch.cat([pw * w[:, None], grid.dir[cand.idx]
                      * (w * maxp)[:, None], ok.to(torch.float32)[:, None]],
                     dim=1)
    s = cand.sums(rows)
    return s[:, 0:3], s[:, 3:6], s[:, 6].to(torch.int32)


def _kth_r2(cand: _Candidates, front, r_cap2, kk: int):
    """The EXACT kk-th smallest squared distance per query among the
    candidates accepted within the cap radius (strict) and by the normal
    test, +inf where fewer pass (the reference heap's dist2[0] once full,
    cyPhotonMap.h:425-437; rtf_tpu's top_k over its [27 P] padded row)."""
    if cand.d2.shape[0] == 0:
        return torch.full_like(r_cap2, math.inf)
    ok = cand.d2 < r_cap2[cand.q]
    if front is not None:
        ok = ok & front
    d2 = torch.where(ok, cand.d2, math.inf)
    order = torch.argsort(d2, stable=True)
    order = order[torch.argsort(cand.q[order], stable=True)]
    d2s = d2[order]
    first = torch.cumsum(cand.lengths, 0) - cand.lengths
    at = torch.clamp(first + kk - 1, max=d2s.shape[0] - 1)
    return torch.where(cand.lengths >= kk, d2s[at], math.inf)


def _chunks(lengths: np.ndarray, budget: int):
    """[lo, hi) query ranges whose candidates stay within the budget (a
    query with more than the budget gets a chunk of its own)."""
    cum = np.cumsum(lengths)
    out, lo = [], 0
    while lo < len(lengths):
        base = cum[lo - 1] if lo else 0
        hi = max(int(np.searchsorted(cum, base + budget, side="right")),
                 lo + 1)
        out.append((lo, hi))
        lo = hi
    return out


def _estimate(grid: PhotonGrid, q_pos, q_normal, r2, k: int,
              filter_type: int, max_per_cell: int, exact: bool):
    """(irradiance sum [M,3], direction sum [M,3], r2_eff [M]): the
    estimator's passes over the candidates, in blocks of queries and
    chunks of candidates.  One device-to-host copy a block: its queries'
    candidate counts, which size the chunks."""
    if q_pos.shape[0] == 0:
        z = torch.zeros((0, 3), dtype=torch.float32, device=q_pos.device)
        return z, z, r2
    outs = []
    for b0 in range(0, q_pos.shape[0], QUERIES_PER_BLOCK):
        qp = q_pos[b0:b0 + QUERIES_PER_BLOCK]
        start, cnt = _cell_ranges(grid, qp, max_per_cell)
        per_q = cnt.sum(1).cpu().numpy()
        for lo, hi in _chunks(per_q, CANDIDATES_PER_CHUNK):
            q = slice(b0 + lo, b0 + hi)
            cand = _Candidates(grid, q_pos[q], start[lo:hi], cnt[lo:hi],
                               int(per_q[lo:hi].sum()))
            outs.append(_estimate_chunk(
                grid, cand, None if q_normal is None else q_normal[q],
                r2[q], k, filter_type, max_per_cell, exact))
    return tuple(torch.cat(x) for x in zip(*outs))


def _estimate_chunk(grid, cand, q_normal, r2, k, filter_type, max_per_cell,
                    exact):
    front = None
    if q_normal is not None:
        # photon must arrive from the front (dir . N < 0 accepted)
        front = dot(grid.dir[cand.idx], q_normal[cand.q]) < 0.0
    irrad, dsum, count = _gather_pass(grid, cand, front, r2, filter_type)
    if k <= 0:
        return irrad, dsum, r2
    over = count > k
    if exact:
        r2k = _kth_r2(cand, front, r2, min(k, 27 * max_per_cell))
        r2_eff = torch.where(over & torch.isfinite(r2k), r2k, r2)
        irrad2, dsum2, _ = _gather_pass(grid, cand, front, r2_eff,
                                        filter_type, inclusive=True)
    else:
        # legacy shrink (uniform-density approximation)
        r2_eff = torch.where(over, r2 * (k / torch.clamp(count, min=1)), r2)
        irrad2, dsum2, _ = _gather_pass(grid, cand, front, r2_eff,
                                        filter_type)
    return (torch.where(over[:, None], irrad2, irrad),
            torch.where(over[:, None], dsum2, dsum), r2_eff)


def _area(filter_type, r2_eff):
    if filter_type == FILTER_LINEAR:
        return (math.pi / 3.0) * r2_eff
    if filter_type == FILTER_QUADRATIC:
        return (math.pi * 0.5) * r2_eff
    return math.pi * r2_eff


def estimate_irradiance(grid: PhotonGrid, q_pos, q_normal, radius: float,
                        k: int, filter_type: int = FILTER_CONSTANT,
                        max_per_cell: int = None, exact: bool = True):
    """Batched EstimateIrradiance (cyPhotonMap.h:288-336): (irradiance
    [M,3], unit mean direction [M,3]).  max_per_cell defaults to the
    grid's measured max occupancy (truncation-free, like the reference
    kd-tree).  exact=True: where more than k accepted photons lie within
    the radius, the area radius is the TRUE k-th nearest distance and the
    k nearest (ties included) are summed; exact=False: rtf_tpu's legacy
    shrink r2 * k / count.  q_normal None skips the normal test."""
    if max_per_cell is None:
        max_per_cell = grid.max_occupancy
    m = q_pos.shape[0]
    r2 = torch.full((m,), radius * radius, dtype=torch.float32,
                    device=q_pos.device)
    irrad, dsum, r2_eff = _estimate(grid, q_pos, q_normal, r2, int(k),
                                    filter_type, int(max_per_cell), exact)
    area = _area(filter_type, r2_eff)
    irrad = irrad / torch.clamp(area, min=1e-30)[:, None]
    return irrad, normalize(dsum)


def nearest_photon(grid: PhotonGrid, q_pos, photon_chunk: int = 4096):
    """The single nearest photon per query point (cy::PhotonMap::
    GetNearestPhoton, cyPhotonMap.h:340-361, unbounded): an exact chunked
    scan over the photon array, the first photon winning ties.  (pos, dir,
    power [M,3], d2 [M]); d2 = +inf and zero payloads on an empty map."""
    cap = grid.pos.shape[0]
    m = q_pos.shape[0]
    dev = q_pos.device
    best_d2 = torch.full((m,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros(m, dtype=torch.int64, device=dev)
    chunk = min(photon_chunk, cap)
    for i0 in range(0, cap, max(chunk, 1)):
        idx = torch.clamp(torch.arange(i0, i0 + chunk, device=dev),
                          max=cap - 1)
        d2 = ((grid.pos[idx][None, :, :] - q_pos[:, None, :]) ** 2).sum(-1)
        d2 = torch.where((idx < grid.n_valid)[None, :], d2, math.inf)
        j = torch.argmin(d2, dim=1)
        dmin = d2.gather(1, j[:, None])[:, 0]
        better = dmin < best_d2
        best_d2 = torch.where(better, dmin, best_d2)
        best_i = torch.where(better, idx[j], best_i)
    found = torch.isfinite(best_d2)[:, None]
    return (torch.where(found, grid.pos[best_i], 0.0),
            torch.where(found, grid.dir[best_i], 0.0),
            torch.where(found, grid.power[best_i], 0.0), best_d2)
