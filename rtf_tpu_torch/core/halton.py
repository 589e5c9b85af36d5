"""Halton low-discrepancy sequence (rtf_tpu/core/halton.py::halton).

Semantics of the reference's scalar generator (scene.h:131-140):

    float Halton(int index, int base) {
        r = 0; f = 1/base;
        for (i = index; i > 0; i /= base) { r += f * (i % base); f /= base; }
        return r;
    }

The digit loop runs a fixed count and accumulates in float32 in the same
order as the JAX version, so camera rays agree with it to rounding.
`halton_np` is the host version (float64 digits, rounded to float32 at
the end), which places the footprint filter's taps.
"""
from __future__ import annotations

import numpy as np
import torch


def _num_digits(base: int, max_index: int) -> int:
    n, v = 0, 1
    while v <= max_index:
        v *= base
        n += 1
    return max(n, 1)


def halton(index: torch.Tensor, base: int,
           max_index: int = 1 << 16) -> torch.Tensor:
    """Radical inverse of integer tensor `index` in `base` (float32)."""
    i = index.to(torch.int64)
    # the digit weight is a float32 computed on the host and passed as a
    # Python scalar: a weight tensor copied to the index's device would
    # be a blocking copy per digit
    inv_base = np.float32(1.0 / base)
    r = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = inv_base
    for _ in range(_num_digits(base, max_index)):
        r = r + float(f) * (i % base).to(torch.float32)
        f = f * inv_base
        i = i // base
    return r


def halton_np(index, base: int):
    """NumPy host version (rtf_tpu/core/halton.py::halton_np); accepts a
    scalar or an array index."""
    index = np.asarray(index, np.int64)
    r = np.zeros(index.shape, np.float64)
    f = np.full(index.shape, 1.0 / base)
    i = index.copy()
    while np.any(i > 0):
        r += f * (i % base)
        f /= base
        i //= base
    return r.astype(np.float32)
