"""ctypes binding to the port's host library, native/bvh_builder.cpp (the
C++ BVH builder and PNG unfilter; rtf_tpu/native/binding.py's
counterpart).

`_build.load_host` compiles the library into build/ at first use.  Unlike
rtf_tpu's binding, nothing here returns None or falls back to Python: a
build or load failure raises RuntimeError, so a broken toolchain shows
instead of a load that runs many times slower.  ops/bvh.py::build_bvh and
utils/png.py::read_png call these.
"""
from __future__ import annotations

import numpy as np

from rtf_tpu_torch import _build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def native_build_bvh(centers, bmin, bmax, max_elems: int):
    """The C++ build over n > 0 element boxes `bmin`, `bmax` [n, 3] with
    split keys `centers` [n, 3]: (node_min, node_max, child, elem_off,
    elem_cnt, elems), ops/bvh.py::build_bvh's arrays."""
    lib = _build.load_host()
    n = len(centers)
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    centers = np.ascontiguousarray(centers, np.float64)
    cap = 2 * n + 1          # at most 2n - 1 nodes and node 0
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    child, eoff, ecnt = (np.empty(cap, np.int32) for _ in range(3))
    elems = np.empty(n, np.int32)
    nodes = lib.rtf_bvh_build(
        _ptr(bmin), _ptr(bmax), _ptr(centers), n, max_elems, _ptr(node_min),
        _ptr(node_max), _ptr(child), _ptr(eoff), _ptr(ecnt), _ptr(elems))
    return (node_min[:nodes].copy(), node_max[:nodes].copy(),
            child[:nodes].copy(), eoff[:nodes].copy(), ecnt[:nodes].copy(),
            elems)


def native_png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int):
    """Undo the scanline filters of `raw` [h, stride + 1] (a filter byte,
    then the row): [h, stride] uint8.  A filter byte past 4 raises
    ValueError, as utils/png.py::unfilter_plain does."""
    lib = _build.load_host()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    bad = lib.rtf_png_unfilter(_ptr(raw), _ptr(out), h, stride, bpp)
    if bad >= 0:
        raise ValueError(f"bad filter {raw[bad, 0]}")
    return out
