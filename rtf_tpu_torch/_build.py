"""Build the wave kernel with nvcc and load it with ctypes.

csrc/wave_kernel.cu becomes one shared library with a plain C interface,
compiled for sm_90a (Hopper) at first use into build/ at the root of the
checkout; the library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD_DIR = ROOT.parent / "build"
SOURCE = ROOT / "csrc" / "wave_kernel.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of rtf_wave_launch
LAUNCH_ARGTYPES = [
    _P, _I, _P, _I, _I,      # rays, has_state, out, surf_out, gi_from
    _P, _I,                  # stats, n
    _I, _I, _I,              # seed, blk0, nbounce
    _P, _I, _P, _I, _P, _I,  # spheres, ns, planes, np, insts, ni
    _P, _P, _P, _P, _I,      # tiles, faces, mats, lights, nl
    _P, _P, _P, _I,          # texmaps, textures, atlas, atlas_w
    _I, _I, _I,              # env_tm, env_l2, textured
    _F, _F, _F,              # env rgb
    _F, _I, _I, _F, _F,      # coef, inv-square, env-on-reflect, thr x2
    _I, _I, _I, _I,          # shadow max/min, need_uv, has_gloss
    _P]                      # stream

_LIB = None


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwave_{h}.so"


def build() -> str:
    """Build the library unless it is cached; returns nvcc's output (with
    ptxas's register and spill report), or '' when it was cached."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE}:\n{res.stdout}")
    os.replace(tmp, out)
    return res.stdout


def load():
    """The kernel's ctypes library, built on first use."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.rtf_wave_launch.argtypes = LAUNCH_ARGTYPES
        lib.rtf_wave_launch.restype = ctypes.c_int
        lib.rtf_error_string.argtypes = [ctypes.c_int]
        lib.rtf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(code: int) -> str:
    return load().rtf_error_string(code).decode()
