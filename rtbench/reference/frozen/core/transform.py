# Frozen copy of rtf_tpu_torch/core/transform.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Affine transforms (3x3 linear part + translation) with cached inverse.

Host-side (NumPy) mirror of the reference's `Transformation`
(scene.h:224-262): `m` maps LOCAL -> PARENT space (`TransformFrom`),
`inv = m^-1` maps parent -> local (`TransformTo`), and normals transform
local -> parent with `inv^T` (`VectorTransformFrom`).

The scene builder composes these down the node hierarchy so that on device
every instance is a single world<->local pair — the recursive
`ToNodeCoords`/`FromNodeCoords` crossings (scene.h:502-513) disappear.
Flattening is exact: ray parameters are affine-invariant because both the
origin and the (unnormalized) direction are transformed, so the hit `t` in
any node space equals the world-space `t` (the reference relies on this in
TraceNode, Final/main.cpp:108-130).  A copy of rtf_tpu/core/transform.py.
"""
from __future__ import annotations

import numpy as np


class Transform:
    __slots__ = ("m", "pos")

    def __init__(self, m=None, pos=None):
        self.m = np.eye(3, dtype=np.float64) if m is None else np.asarray(m, np.float64)
        self.pos = np.zeros(3) if pos is None else np.asarray(pos, np.float64)

    # --- mutation in the reference's style (Transform(m): tm=m*tm; pos=m*pos)
    def apply_linear(self, m):
        m = np.asarray(m, np.float64)
        self.m = m @ self.m
        self.pos = m @ self.pos
        return self

    def translate(self, t):
        self.pos = self.pos + np.asarray(t, np.float64)
        return self

    def scale(self, sx, sy=None, sz=None):
        if sy is None:
            sy = sz = sx
        return self.apply_linear(np.diag([sx, sy, sz]).astype(np.float64))

    def rotate(self, axis, degrees):
        """Rodrigues rotation, matching cyMatrix3f::SetRotation
        (cyMatrix.h:412-445)."""
        a = np.asarray(axis, np.float64)
        n = np.linalg.norm(a)
        if n == 0:
            return self
        a = a / n
        ang = np.deg2rad(degrees)
        c, s = np.cos(ang), np.sin(ang)
        t = 1.0 - c
        ax, ay, az = a
        m = np.array([
            [t * ax * ax + c, t * ax * ay - s * az, t * ax * az + s * ay],
            [t * ax * ay + s * az, t * ay * ay + c, t * ay * az - s * ax],
            [t * ax * az - s * ay, t * ay * az + s * ax, t * az * az + c],
        ])
        return self.apply_linear(m)

    # --- composition: self ∘ child (child applied first)
    def compose(self, child: "Transform") -> "Transform":
        return Transform(self.m @ child.m, self.m @ child.pos + self.pos)

    # --- queries
    @property
    def inv(self) -> np.ndarray:
        return np.linalg.inv(self.m)

    def transform_from(self, p):  # local -> parent
        return self.m @ np.asarray(p, np.float64) + self.pos

    def transform_to(self, p):  # parent -> local
        return self.inv @ (np.asarray(p, np.float64) - self.pos)

    def copy(self) -> "Transform":
        return Transform(self.m.copy(), self.pos.copy())
