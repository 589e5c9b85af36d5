# Frozen copy of rtf_tpu_torch/core/math.py at commit 224dbd1 (the benchmark's
# reference; imports rewritten to this tree, kernel launches removed).
"""Vector math on batched [..., 3] tensors (rtf_tpu/core/math.py).

Every function is batched over leading dims and works on the trailing
axis, in the JAX package's operation order.  Matrix-vector products are
explicit multiply-adds, never `torch.matmul` or `einsum`: the reference
keeps ray transforms off the matrix unit (rtf_tpu/ops/trace.py:84-87), and
on the card a matmul may take another precision path.
"""
from __future__ import annotations

import torch

# Matches BIGFLOAT in the reference (scene.h:56) — the "no hit" sentinel z.
BIGFLOAT = 1.0e30


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis; keeps no trailing dim."""
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return (a * a).sum(-1)


def normalize(a: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Safe normalize; zero vectors stay (near) zero instead of NaN."""
    x = torch.clamp(length_sq(a), min=eps)
    return a * torch.where(x > 0, 1.0 / torch.sqrt(x), 0.0)[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror direction of view vector v (pointing AWAY from surface)
    about n: rDir = 2 N (N.V) - V (ref: Final/main.cpp:597)."""
    return 2.0 * n * dot(n, v)[..., None] - v


def luma(c: torch.Tensor) -> torch.Tensor:
    """Gray() of the reference color type: plain channel average
    (cyColor.h:83)."""
    return c.mean(-1)


def mat3_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[3,3] matrix times batched [..., 3] vectors, as multiply-adds."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
    ], dim=-1)


def mat3_apply_batched(ms: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row [N,3,3] matrices times [N,3] vectors, as multiply-adds."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        ms[..., 0, 0] * x + ms[..., 0, 1] * y + ms[..., 0, 2] * z,
        ms[..., 1, 0] * x + ms[..., 1, 1] * y + ms[..., 1, 2] * z,
        ms[..., 2, 0] * x + ms[..., 2, 1] * y + ms[..., 2, 2] * z,
    ], dim=-1)


def offset_origin(p: torch.Tensor, n: torch.Tensor, d: torch.Tensor,
                  eps: float = 1e-4) -> torch.Tensor:
    """Nudge a secondary-ray origin off the surface along the normal,
    toward the side the new direction d leaves through (a
    magnitude-relative offset, rtf_tpu/core/math.py::offset_origin)."""
    scale = eps * (1.0 + torch.amax(torch.abs(p), dim=-1, keepdim=True))
    side = torch.where(dot(n, d)[..., None] >= 0, 1.0, -1.0)
    return p + n * scale * side
