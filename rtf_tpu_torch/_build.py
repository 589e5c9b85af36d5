"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in csrc/ becomes its own shared library with a plain C
interface, compiled for sm_90a (Hopper) at first use into build/ at the
root of the checkout; a library's file name carries a hash of its source,
the shared headers (csrc/*.cuh) and the flags, so an edited source is
rebuilt and a stale library is never loaded.  `build()` starts one nvcc
per source, all at once.

This module is the port's one boundary to compiled code.  `launch` makes
every kernel call (the device, the current stream, tensors as pointers,
a failed launch as RuntimeError); `check_tables` holds a kernel's tables
to what it reads in place, once, where they are built; `check_stats` the
work counters a launch is handed.  The wave kernel takes its inputs as
one struct, csrc/wave_kernel.cu's `Args`, mirrored here as `WaveArgs`
(the other launch functions are short enough to take them positionally).

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

import torch

ROOT = Path(__file__).resolve().parent
BUILD_DIR = ROOT.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
HOST_SOURCE = ROOT / "native" / "bvh_builder.cpp"
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class WaveArgs(ctypes.Structure):
    """csrc/wave_kernel.cu's `struct Args`, field by field: one launch's
    inputs, which render/wave.py fills by name and rtf_wave_launch takes by
    pointer (see that struct for each field)."""
    _fields_ = [
        ("rays", _P), ("has_state", _I), ("out", _P), ("surf_out", _I),
        ("gi_from", _I), ("stats", _P), ("n", _I),
        ("seed", ctypes.c_uint32), ("blk0", ctypes.c_uint32),
        ("nbounce", _I),
        ("spheres", _P), ("ns", _I), ("planes", _P), ("np", _I),
        ("insts", _P), ("ni", _I),
        ("roots", _P), ("faces", _P), ("groups", _P), ("ng", _I),
        ("tnodes", _P), ("leaves", _P), ("shade", _P), ("order", _P),
        ("staged", _I), ("scene_staged", _I), ("stats_blocks", _I),
        ("mats", _P), ("lights", _P), ("nl", _I),
        ("texmaps", _P), ("textures", _P), ("atlas", _P), ("atlas_w", _I),
        ("env_tm", _I), ("env_l2", _I), ("env", _F * 3), ("coef", _F),
        ("inverse_square", _I), ("env_on_reflect_miss", _I),
        ("tot_thr", _F), ("col_thr", _F),
        ("shadow_max", _I), ("shadow_min", _I),
        ("need_uv", _I), ("has_gloss", _I)]


# per library: its source, its launch function and that function's argtypes
KERNELS = {
    "wave": ("wave_kernel.cu", "rtf_wave_launch", [
        ctypes.POINTER(WaveArgs), _I, _I,  # args, textured, mxu
        _P, _P]),                # block order scratch, stream
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
    """The kernel library `name`, built on first use.  A wave library whose
    `struct Args` has another size than WaveArgs raises RuntimeError."""
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
        if name == "wave" and lib.rtf_wave_args_size() != ctypes.sizeof(
                WaveArgs):
            raise RuntimeError(
                f"{library_path(name)}: struct Args takes "
                f"{lib.rtf_wave_args_size()} bytes, its mirror WaveArgs "
                f"{ctypes.sizeof(WaveArgs)}")
        _LIBS[name] = lib
    return _LIBS[name]


def pointer(x) -> int:
    """A tensor's data pointer for a kernel; None or an empty tensor is
    NULL (the kernels read no table that is empty)."""
    return x.data_ptr() if x is not None and x.numel() else 0


def launch(name: str, fn: str, dev, *args):
    """Call the launch function `fn` of the kernel library `name` on the
    current stream of the CUDA device `dev`: each tensor or None of `args`
    passed as its `pointer`, the rest as they are, the stream last.  A
    nonzero return raises RuntimeError with the library's error string."""
    lib = load(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(
            *(pointer(a) if a is None or isinstance(a, torch.Tensor) else a
              for a in args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn} failed: "
                           f"{lib.rtf_error_string(rc).decode()} ({rc})")


def check_stats(owner: str, stats, nstat: int, dev):
    """Refuse (ValueError) a work-counter tensor that is not int64 with at
    least `nstat` entries on `dev`; None (no counting) passes."""
    if stats is not None and (stats.device != dev
                              or stats.dtype != torch.int64
                              or stats.numel() < nstat):
        raise ValueError(f"{owner}: stats must be an int64 [{nstat}] tensor "
                         f"on {dev}")


def check_tables(owner: str, tables: dict, int32=()):
    """What a kernel needs of the tables it reads in place, checked once by
    their constructor: every tensor of `tables` ({name: tensor or None})
    float32 (int32 where its name is in `int32`), contiguous, on one
    device, and its data 16-byte aligned (the kernels read rows as float4;
    an empty table is passed as NULL).  Raises ValueError."""
    dev = None
    for name, x in tables.items():
        if x is None:
            continue
        dev = x.device if dev is None else dev
        dtype = torch.int32 if name in int32 else torch.float32
        if x.dtype != dtype or x.device != dev or not x.is_contiguous() \
                or pointer(x) % 16:
            raise ValueError(f"{owner}: the {name} table must be a "
                             f"contiguous 16-byte aligned {dtype} tensor on "
                             f"{dev}")


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
