"""Irradiance volume: the photon-map estimate baked on a world grid
(rtf_tpu/gi/volume.py).

The reference calls EstimateIrradiance<400>(radius=1) at every shaded
point below the first bounce (Final/main.cpp:694-705).  The estimate is a
smooth field, so `build_irradiance_volume` evaluates it once at every
corner of a world grid (cell = the search radius, normal-free: the
shading-time factor max(0, -N . meanDir) gates direction), and a shading
query is a trilinear gather of the 8 corners around the point, points
outside clamped to the border.  A volume is also data: handed in as
arrays or as the npz that tools/flagship.py writes (keys table, origin,
dims, cell).  The deep-bounce term is kd * E(p) * max(0, -N . meanDir)
(main.cpp:700-705, render/gi.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtf_tpu_torch.gi.grid import PhotonGrid, _area, _estimate, cap_occupancy
from rtf_tpu_torch.scene.build import resolve_device


@dataclass
class IrradianceVolume:
    table: torch.Tensor   # [6, n_corners] float32: E rgb, mean direction xyz
    origin: torch.Tensor  # [3] float32, the position of corner (0, 0, 0)
    dims: tuple           # cells per axis; corners are dims + 1 per axis
    cell: float           # cell edge length

    def to(self, device) -> "IrradianceVolume":
        return IrradianceVolume(self.table.to(device), self.origin.to(device),
                                self.dims, self.cell)


def volume_from_arrays(table, origin, dims, cell,
                       device="cuda") -> IrradianceVolume:
    """A volume from its arrays: table [6, (dx+1)(dy+1)(dz+1)] with corner
    id (i * (dy+1) + j) * (dz+1) + k, origin [3], dims (dx, dy, dz)."""
    dev = resolve_device(device)
    dims = tuple(int(x) for x in np.asarray(dims).reshape(-1))
    table = torch.as_tensor(np.asarray(table, np.float32), device=dev)
    n_corners = int(np.prod([d + 1 for d in dims]))
    if len(dims) != 3 or tuple(table.shape) != (6, n_corners):
        raise ValueError(f"table must be [6, {n_corners}] for dims {dims}, "
                         f"got {tuple(table.shape)}")
    origin = torch.as_tensor(np.asarray(origin, np.float32).reshape(3),
                             device=dev)
    return IrradianceVolume(table.contiguous(), origin, dims, float(cell))


def load_volume(path, device="cuda") -> IrradianceVolume:
    """A volume saved as npz with keys table, origin, dims and cell
    (tools/flagship.py::_bake_sceneb_volume's layout)."""
    with np.load(path) as d:
        return volume_from_arrays(d["table"], d["origin"], d["dims"],
                                  float(d["cell"]), device)


def build_irradiance_volume(grid: PhotonGrid, radius: float, k: int,
                            bounds_min, bounds_max, cell: float = None,
                            filter_type: int = 0,
                            occ_cap: int = 2048) -> IrradianceVolume:
    """The exact normal-free estimate (`_estimate_corners`) at every corner
    of a world grid over the bounds, (dims + 1) corners per axis, on the
    grid's device.  cell defaults to the search radius.  occ_cap: cells
    denser than max(occ_cap, 2k) are first thinned by the unbiased,
    power-rescaled cap (gi/grid.py::cap_occupancy), as rtf_tpu does; the
    cap stays above k so a capped cell keeps the estimator in its kNN
    regime.  None disables it."""
    if occ_cap is not None and grid.max_occupancy > occ_cap:
        grid = cap_occupancy(grid, max(int(occ_cap), 2 * int(k)))
    if cell is None:
        cell = float(radius)
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)
    ext = np.maximum(bounds_max - bounds_min, 1e-3)
    dims = tuple(int(x) for x in np.maximum(1, np.ceil(ext / cell)))
    nx, ny, nz = (d + 1 for d in dims)
    dev = grid.pos.device
    # corner id = (i * ny + j) * nz + kk (x-major, as sample_volume_ch
    # reads it); position = index * cell + bounds_min in float32
    gx, gy, gz = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev)
          for n in (nx, ny, nz)), indexing="ij")
    corners = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                          dim=-1) * float(cell) \
        + torch.as_tensor(bounds_min, device=dev)
    irrad, mean_dir = _estimate_corners(grid, corners, float(radius),
                                        int(k), int(filter_type))
    # channel-major [6, NC]: corner gathers ride the long dim
    table = torch.cat([irrad, mean_dir], dim=-1).T.contiguous()
    return IrradianceVolume(table=table,
                            origin=torch.as_tensor(bounds_min, device=dev),
                            dims=dims, cell=float(cell))


def _normalize_dir(dsum):
    n = torch.sqrt(torch.clamp((dsum * dsum).sum(-1, keepdim=True),
                               min=1e-30))
    return dsum / n


def _estimate_corners(grid: PhotonGrid, qp, radius: float, k: int,
                      filter_type: int):
    """The normal-free exact bounded-k irradiance estimate at the points
    qp (rtf_tpu/gi/volume.py::_estimate_corners): strict d2 < r^2
    acceptance, the k nearest (d2 <= r_k^2) where more than k pass, pi r^2
    family area normalization, every photon of the 27 neighbour cells (the
    grid's measured occupancy)."""
    r2 = torch.full((qp.shape[0],), radius * radius, dtype=torch.float32,
                    device=qp.device)
    irrad, dsum, r2_eff = _estimate(grid, qp, None, r2, k, filter_type,
                                    grid.max_occupancy, True)
    area = _area(filter_type, r2_eff)
    irrad = irrad / torch.clamp(area, min=1e-30)[:, None]
    return irrad, _normalize_dir(dsum)


def sample_volume_ch(vol: IrradianceVolume, p3):
    """Trilinear sample at the points p3 ([3, M] or three [M] tensors):
    (E [3, M], unit mean direction [3, M]).  Points outside the volume
    clamp to its border (rtf_tpu/gi/volume.py::sample_volume_ch, in its
    operation order)."""
    ny, nz = vol.dims[1] + 1, vol.dims[2] + 1
    f, i, w = [], [], []
    for a, dim in enumerate(vol.dims):
        fa = torch.clamp((p3[a] - vol.origin[a]) * (1.0 / vol.cell),
                         0.0, dim - 1e-4)
        fl = torch.floor(fa)
        f.append(fa)
        i.append(fl.to(torch.int64))
        w.append(fa - fl)
    acc = torch.zeros((6,) + tuple(f[0].shape), dtype=torch.float32,
                      device=f[0].device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cid = ((i[0] + dx) * ny + (i[1] + dy)) * nz + (i[2] + dz)
                wt = ((w[0] if dx else 1.0 - w[0])
                      * (w[1] if dy else 1.0 - w[1])
                      * (w[2] if dz else 1.0 - w[2]))
                acc = acc + vol.table[:, cid] * wt
    dlen = torch.sqrt(torch.clamp(
        acc[3] * acc[3] + acc[4] * acc[4] + acc[5] * acc[5], min=1e-30))
    return acc[0:3], acc[3:6] / dlen


def sample_volume(vol: IrradianceVolume, p: torch.Tensor):
    """[M,3] form of sample_volume_ch (rtf_tpu/gi/volume.py::sample_volume):
    (irradiance [M,3], unit mean direction [M,3])."""
    e3, d3 = sample_volume_ch(vol, (p[:, 0], p[:, 1], p[:, 2]))
    return e3.T, d3.T
