"""Image comparison and AOV post-processing (rtf_tpu/utils/image.py), in
numpy.

The z-buffer and sample-count visualizations mirror
RenderImage::ComputeZBufferImage (scene.h:591-613) and
ComputeSampleCountImage (scene.h:615-637).
"""
from __future__ import annotations

import numpy as np

from rtf_tpu_torch.core.math import BIGFLOAT


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Per-pixel RMSE over images scaled to [0,1]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.dtype != np.float64 or a.max() > 1.5:
        a = a / 255.0
    if b.max() > 1.5:
        b = b / 255.0
    return float(np.sqrt(np.mean((a - b) ** 2)))


def zbuffer_image(z: np.ndarray) -> np.ndarray:
    """Map a float z-buffer to uint8 like the reference: BIGFLOAT (miss) -> 0,
    nearest -> 255, farthest hit -> 0 (scene.h:591-613)."""
    z = np.asarray(z, np.float64)
    hit = z < BIGFLOAT / 2
    if not hit.any():
        return np.zeros(z.shape, np.uint8)
    zmin = z[hit].min()
    zmax = z[hit].max()
    if zmax == zmin:
        f = np.ones_like(z)
    else:
        f = (zmax - z) / (zmax - zmin)
    img = np.clip((f * 255).astype(np.int32), 0, 255).astype(np.uint8)
    img[~hit] = 0
    return img


def sample_count_image(sc: np.ndarray) -> np.ndarray:
    """Normalize sample counts to 0..255 (scene.h:615-637)."""
    sc = np.asarray(sc)
    smin, smax = int(sc.min()), int(sc.max())
    if smax == smin:
        return np.zeros(sc.shape, np.uint8)
    return ((255 * (sc.astype(np.int32) - smin)) // (smax - smin)).clip(
        0, 255).astype(np.uint8)
