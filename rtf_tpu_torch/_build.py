"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in csrc/ becomes its own shared library with a plain C
interface, compiled for sm_90a (Hopper) at first use into build/ at the
root of the checkout; a library's file name carries a hash of its source,
the shared headers (csrc/*.cuh) and the flags, so an edited source is
rebuilt and a stale library is never loaded.  `build()` starts one nvcc
per source, all at once.

  wave          csrc/wave_kernel.cu   rtf_wave_launch     (render/wave.py)
  mesh_hit      csrc/mesh_hit.cu      rtf_mesh_hit_launch (ops/mesh_hit.py)
  mesh_hit_mxu  csrc/mesh_hit_mxu.cu  rtf_mesh_hit_mxu_launch
                                                  (ops/mesh_hit_mxu.py)
  bvh_hit       csrc/bvh_hit.cu       rtf_bvh_hit_launch, rtf_bvh_wide_launch
                                                  (ops/bvh_hit.py)

The host library native/bvh_builder.cpp (rtf_bvh_build, rtf_png_unfilter;
native/binding.py) builds the same way with the system C++ compiler
(`build_host`, `load_host`), on any host: a failed build or load raises
RuntimeError with the compiler's output, and nothing falls back.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
HOST_SOURCE = ROOT / "native" / "bvh_builder.cpp"
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# per library: its source, its launch function and that function's argtypes
KERNELS = {
    "wave": ("wave_kernel.cu", "rtf_wave_launch", [
        _P, _I, _P, _I, _I,      # rays, has_state, out, surf_out, gi_from
        _P, _I,                  # stats, n
        _I, _I, _I,              # seed, blk0, nbounce
        _P, _I, _P, _I, _P, _I,  # spheres, ns, planes, np, insts, ni
        _P, _P, _P, _P, _I,      # roots, faces, mats, lights, nl
        _P, _P, _P, _I,          # texmaps, textures, atlas, atlas_w
        _I, _I, _I,              # env_tm, env_l2, textured
        _F, _F, _F,              # env rgb
        _F, _I, _I, _F, _F,      # coef, inv-square, env-on-reflect, thr x2
        _I, _I, _I, _I, _I,      # shadow max/min, need_uv, has_gloss, mxu
        _P, _I, _P, _P,          # groups, ng, tnodes, leaves
        _I, _I,                  # roots and groups staged, block cycles
        _I,                      # scene tables staged
        _P, _P,                  # shade rows, block order scratch
        _P]),                    # stream
    "mesh_hit": ("mesh_hit.cu", "rtf_mesh_hit_launch", [
        _P, _P, _I, _P, _I, _I,  # origins, directions, their row stride,
                                 # t_init, its stride, n
        _P, _I, _I,              # the slot's face rows, their count, staged
        _P, _P, _P, _P,          # the slot's root, groups, tnodes, leaves
        _I, _I,                  # the slot's first face row, face0
        _P, _P, _P, _P, _P,      # t, face, front, ba, bb
        _P, _P]),                # stats, stream
    "mesh_hit_mxu": ("mesh_hit_mxu.cu", "rtf_mesh_hit_mxu_launch", [
        _P, _I,                  # rays16, n
        _P, _P, _P, _I, _I,      # frags, rows, fmap, faces, face0
        _P, _P, _P, _P, _P,      # t, face, front, ba, bb
        _P, _P]),                # stats, stream
    "bvh_hit": ("bvh_hit.cu", "rtf_bvh_hit_launch", [
        _P, _P, _I, _P, _I, _I,  # origins, directions, their row stride,
                                 # t_init, its stride, n
        _P, _P, _I, _I,          # nodes, leaf faces, root, stack depth
        _P, _P, _P, _P, _P,      # t, face, front, ba, bb
        _P, _P]),                # stats, stream
}
# a library's further launch functions and their argtypes
MORE = {
    "bvh_hit": {"rtf_bvh_wide_launch": [
        _P, _P, _I, _P, _I, _I,  # origins, directions, their row stride,
                                 # t_init, its stride, n
        _P, _P, _I, _I,          # wide nodes, face rows, wide root, stack
                                 # need
        _P, _P, _P, _P, _P,      # t, face, front, ba, bb
        _P, _P]},                # stats, stream
}

# the host library's functions: (argtypes, restype)
HOST_FUNCS = {
    "rtf_bvh_build": ([
        _P, _P, _P, _I, _I,      # bmin, bmax, centers, n, max_elems
        _P, _P, _P, _P, _P,      # node_min, node_max, child, eoff, ecnt
        _P],                     # elems
        ctypes.c_int),
    "rtf_png_unfilter": ([_P, _P, _I, _I, _I],  # raw, out, h, stride, bpp
                         ctypes.c_int),
}

_LIBS = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def source(name: str) -> Path:
    return ROOT / "csrc" / KERNELS[name][0]


def library_path(name: str) -> Path:
    headers = b"".join(p.read_bytes()
                       for p in sorted((ROOT / "csrc").glob("*.cuh")))
    h = hashlib.sha256(source(name).read_bytes() + headers
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build() -> dict:
    """Build every library that is not cached, one nvcc each, all started
    together; returns {name: nvcc's output (with ptxas's register and
    spill report), or '' when it was cached}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in KERNELS:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
             str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source(name)}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str = "wave"):
    """The kernel library `name`, built on first use."""
    if name not in _LIBS:
        if not library_path(name).exists():
            build()
        lib = ctypes.CDLL(str(library_path(name)))
        _, fn, argtypes = KERNELS[name]
        for f, a in {fn: argtypes, **MORE.get(name, {})}.items():
            getattr(lib, f).argtypes = a
            getattr(lib, f).restype = ctypes.c_int
        lib.rtf_error_string.argtypes = [ctypes.c_int]
        lib.rtf_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def error_string(code: int, name: str = "wave") -> str:
    return load(name).rtf_error_string(code).decode()


def cxx() -> str:
    """The system C++ compiler: $CXX, else c++, else g++."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError(f"no C++ compiler found ($CXX, c++, g++): the host "
                       f"library {HOST_SOURCE} builds with one")


def host_library_path() -> Path:
    h = hashlib.sha256(HOST_SOURCE.read_bytes()
                       + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librtf_native_{h}.so"


def build_host() -> str:
    """Compile the host library into build/ (written to a temporary file and
    renamed, so processes that build at once never load half a file);
    returns the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = host_library_path()
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx(), *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} did not run: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_host():
    """The host library, built on first use."""
    if "native" not in _LIBS:
        path = host_library_path()
        if not path.exists():
            build_host()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the host library {path}: "
                               f"{e}") from None
        for f, (argtypes, restype) in HOST_FUNCS.items():
            getattr(lib, f).argtypes = argtypes
            getattr(lib, f).restype = restype
        _LIBS["native"] = lib
    return _LIBS["native"]
