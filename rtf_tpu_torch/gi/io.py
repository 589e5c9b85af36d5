"""Photon map (de)serialization in the reference's binary .dat layout.

Byte-compatible with cy::PhotonMap::Photon (cyPhotonMap.h:47-65):
  float32 position[3]; float32 power (max channel);
  uint8 color[3] (rgb / power); uint8 planeAndDirZ;
  int16 dirX, dirY  (dir.xy * 0x7FFF; z sign in bit 3 of planeAndDirZ)
= 24 bytes/photon, written raw (main.cpp:398-400), so our dumps load in
the reference's PhotonMapViz tool and vice versa.  A copy of
rtf_tpu/gi/io.py: the two packages read each other's files.
"""
from __future__ import annotations

import numpy as np

PHOTON_DTYPE = np.dtype([
    ("pos", "<3f4"),
    ("power", "<f4"),
    ("color", "3u1"),
    ("plane", "u1"),
    ("dirx", "<i2"),
    ("diry", "<i2"),
])


def save_photon_dat(path: str, pos, dirs, power, count: int = None):
    """Write photons (numpy arrays or tensors on any device) to a
    reference-compatible .dat file."""
    pos, dirs, power = (np.asarray(x.cpu() if hasattr(x, "cpu") else x,
                                   np.float32) for x in (pos, dirs, power))
    n = len(pos) if count is None else int(count)
    rec = np.zeros(n, PHOTON_DTYPE)
    rec["pos"] = pos[:n]
    maxp = np.maximum(power[:n].max(axis=1), 1e-30)
    rec["power"] = maxp
    rec["color"] = np.clip((power[:n] / maxp[:, None]) * 255, 0, 255).astype(np.uint8)
    d = dirs[:n]
    rec["dirx"] = np.clip(d[:, 0] * 0x7FFF, -32767, 32767).astype(np.int16)
    rec["diry"] = np.clip(d[:, 1] * 0x7FFF, -32767, 32767).astype(np.int16)
    rec["plane"] = np.where(d[:, 2] > 0, 0, 8).astype(np.uint8)
    rec.tofile(path)


def load_photon_dat(path: str):
    """Read a .dat photon dump. Returns (pos [N,3], dir [N,3], power [N,3])."""
    rec = np.fromfile(path, PHOTON_DTYPE)
    pos = rec["pos"].astype(np.float32)
    power = rec["color"].astype(np.float32) / 255.0 * rec["power"][:, None]
    dx = rec["dirx"].astype(np.float32) / 0x7FFF
    dy = rec["diry"].astype(np.float32) / 0x7FFF
    dz2 = np.maximum(0.0, 1.0 - dx * dx - dy * dy)
    dz = np.sqrt(dz2)
    dz = np.where(rec["plane"] & 8, -dz, dz)
    return pos, np.stack([dx, dy, dz], axis=1), power
