"""The comparison that decides `correct`: a frame the timed path produced
against the reference's frame of the same seeds, on the reference's pixels.

Numbers (each compared where the traffic file lists a limit for it):
  radiance_gap  mean |radiance - reference| over the pixels and channels,
                as a share of the reference's mean |radiance|;
  z_gap         share of pixels whose first hit differs: a hit against a
                miss, or a depth off by more than 1e-5 of max(1, depth);
  samples_gap   share of pixels whose sample count differs (exact: the
                samples a pixel takes are counted, not computed);
  image_gap     mean |image - reference| over the pixels and channels of
                finalize's 8-bit image, in levels (1/255), so a fault of
                the tone map, gamma or quantisation shows.
"""
from __future__ import annotations

import numpy as np

Z_REL = 1e-5
MISS = 1e29   # the renderer's z of a miss is BIGFLOAT (1e30)


def numbers(program: dict, ref: dict) -> dict:
    """program: a finished frame's arrays over the whole image (`image`
    [H, W, 3], `radiance` [H, W, 3], `z` [H, W], `sample_count` [H, W]);
    ref: the reference's answer (rtbench/reference/frames.py) on its
    `pixels`."""
    pix = np.asarray(ref["pixels"])
    rad = np.asarray(program["radiance"], np.float64).reshape(-1, 3)[pix]
    rrad = np.asarray(ref["radiance"], np.float64)
    z = np.asarray(program["z"], np.float64).reshape(-1)[pix]
    rz = np.asarray(ref["z"], np.float64)
    ns = np.asarray(program["sample_count"]).reshape(-1)[pix]
    img = np.asarray(program["image"], np.float64).reshape(-1, 3)[pix]
    rimg = np.asarray(ref["image"], np.float64).reshape(-1, 3)
    denom = max(float(np.mean(np.abs(rrad))), 1e-30)
    hit, rhit = z < MISS, rz < MISS
    zbad = (hit != rhit) | (hit & rhit & (
        np.abs(z - rz) > Z_REL * np.maximum(1.0, np.abs(rz))))
    gap = np.abs(rad - rrad)
    return {
        "radiance_gap": float(np.mean(gap)) / denom
        if np.isfinite(gap).all() else float("inf"),
        "z_gap": float(np.mean(zbad)),
        "samples_gap": float(np.mean(ns != np.asarray(ref["sample_count"]))),
        "image_gap": float(np.mean(np.abs(img - rimg))),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a missing or non-finite number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        out[name] = {"value": v, "limit": limit}
    return ok, out
