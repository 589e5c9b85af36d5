#!/usr/bin/env python3
"""Compare versions of the wave kernel, and the wavefront's splat, in turns
on one card.

    python3 chip_ab.py [PARENT_DIR] [--flat-counters] [--out FILE]

Run from the root of a checkout (the change), on a host with a CUDA card
and nvcc.  The change's kernels build as chip_smoke.py builds them.  On
the same inputs:

1. staging: the change's MXU launches (phase 8's: the untextured variant
   at 800x600 on the 20,480-face ball, box_scene(800, 600,
   mesh_subdiv=5), 4 bounces, hard shadows, seed 11; phase 9's primary and
   child: the textured variant with GI rows on the textured box with the
   ball, phase 6's config and volumes, a child wave of stratum 0 from
   uniforms of seed 5) with the walk's roots and groups staged in shared
   memory and in device memory (SMEM_BYTES 0, as the card tests force
   it), in turns staged, not, not, staged, staged, not, not, staged; the
   outputs equal bit for bit;
2. splat: render/integrator.py::_splat against `index_add` (the atomic
   splat it replaced) on the inputs of every splat call of one frame of
   phase 7's config (RenderConfig() on box_scene(800, 600,
   light_size=1.0)), in turns: per call and per frame; the sorted splat
   equal to itself bit for bit on a second call and to index_add's within
   float32 rounding;
3. with PARENT_DIR (another checkout of the repository, for example
   `git archive` of the parent commit unpacked in a directory that
   .gitignore lists): the parent's csrc/wave_kernel.cu, built with the
   parent's own nvcc flags into build/ab/, and the change's in turns,
   parent, change, change, parent, on phase 8's launch, phase 9's primary
   and child launches and the main path's launch (the immediates variant,
   box_scene(800, 600)), outputs equal bit for bit; then the large-mesh
   main frame (phase 8) and the large-mesh hybrid frame (phase 9) through
   `render`.  The parent's library is called through the change's
   wrapper: the change's arguments past the parent's count are dropped but
   the stream, the last (a version appends its new arguments before the
   stream); on the MXU tables it gets the change's tables with
   ops/mxu_pack.py's padded tile rows [T, 16] in `tiles`, which the flat
   walk reads there.  The MXU walk's counters (STAT_* 11-22 and each block's
   cycles) come from one launch of each side with the counters on; the
   parent's counters are its own where its layout is the change's.
   --flat-counters: the parent's MXU walk is the flat tile walk that the
   box hierarchy replaced (wave_kernel.cu at commit caa87e5); its counters
   are written into a copy of its source (FLAT_PATCH, each edit checked to
   apply as often as it should), which is built a second time and takes
   its own turns beside the parent (parent, counted parent, change,
   change, counted parent, parent).

A launch's time is the mean of 20 by CUDA events (the queue filled first)
and of 5 by the profiler (kernel only); a splat's the mean of 20 by CUDA
events; a frame's the best of 3 (the hybrid frame: of 2).  Prints the
card, one line per figure and one JSON object with every figure as the
last line (also written to --out, default build/chip_ab.json).
"""
import ctypes
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H = 800, 600

# (old, new, occurrences): edits of wave_kernel.cu at commit caa87e5 that
# count, in its flat MXU walk, what the hierarchy's walk counts (the same
# STAT_* indices); the instance loop and tile test are the same text in
# its closest-hit and any-hit functions
FLAT_PATCH = [
    ("  STAT_ROOT = 11,        // root-box slab tests (MXU variants)\n"
     "  NSTAT_MXU = 12\n};",
     "  STAT_ROOT = 11,\n  STAT_GROUPS = 12,\n  STAT_LEAVES = 13,\n"
     "  STAT_CYC_ROOT = 14,\n  STAT_CYC_WALK = 15,\n  STAT_CYC_PAIR = 16,\n"
     "  STAT_CYC_BOUNCES = 17,\n  STAT_WALK_ITERS = 18,\n"
     "  STAT_WALK_LANES = 19,\n  STAT_PAIR_ITERS = 20,\n"
     "  STAT_PAIR_LANES = 21,\n  STAT_ROOT_IN = 22,\n  NSTAT_MXU = 23\n};",
     1),
    ("// fused.py::_mesh_closest_mxu for one ray",
     "__device__ __forceinline__ void warp_step(unsigned long long* cnt,\n"
     "                                          int it) {\n"
     "  const unsigned m = __activemask();\n"
     "  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {\n"
     "    cnt[it] += 1;\n    cnt[it + 1] += __popc(m);\n  }\n}\n\n"
     "// fused.py::_mesh_closest_mxu for one ray", 1),
    ("    to_local(I, o, d, lo, l);\n    float ild[3];\n    inv_dir(l, ild);\n"
     "    if (cnt) { cnt[STAT_INST] += 1; cnt[STAT_ROOT] += 1; }\n",
     "    const long long c0_ = cnt ? clock64() : 0;\n"
     "    to_local(I, o, d, lo, l);\n    float ild[3];\n    inv_dir(l, ild);\n"
     "    if (cnt) { cnt[STAT_INST] += 1; cnt[STAT_ROOT] += 1; }\n", 2),
    ("    if (!slab(A.roots + ROOT_W * k, lo, ild, h.t)) continue;\n",
     "    const bool in_ = slab(A.roots + ROOT_W * k, lo, ild, h.t);\n"
     "    if (cnt) cnt[STAT_CYC_ROOT] += clock64() - c0_;\n"
     "    if (cnt) cnt[STAT_ROOT_IN] += in_;\n"
     "    if (!in_) continue;\n"
     "    const long long c1_ = cnt ? clock64() : 0;\n"
     "    long long cpair_ = 0;\n", 1),
    ("    if (!slab(A.roots + ROOT_W * k, lo, ild, cap)) continue;\n",
     "    const bool in_ = slab(A.roots + ROOT_W * k, lo, ild, cap);\n"
     "    if (cnt) cnt[STAT_CYC_ROOT] += clock64() - c0_;\n"
     "    if (cnt) cnt[STAT_ROOT_IN] += in_;\n"
     "    if (!in_) continue;\n"
     "    const long long c1_ = cnt ? clock64() : 0;\n"
     "    long long cpair_ = 0;\n", 1),
    ("      const float* T = A.tiles + MXU_TILE_W * j;\n"
     "      if (cnt) cnt[STAT_TILES] += 1;\n",
     "      const float* T = A.tiles + MXU_TILE_W * j;\n"
     "      if (cnt) cnt[STAT_TILES] += 1;\n"
     "      if (cnt) warp_step(cnt, STAT_WALK_ITERS);\n", 2),
    ("nf = (int)ld(T + 15);\n      if (cnt) cnt[STAT_TRI_CLOSEST] += nf;\n"
     "      for (int f = f0; f < f0 + nf; ++f) {\n",
     "nf = (int)ld(T + 15);\n      if (cnt) cnt[STAT_TRI_CLOSEST] += nf;\n"
     "      const long long p0_ = cnt ? clock64() : 0;\n"
     "      for (int f = f0; f < f0 + nf; ++f) {\n"
     "        if (cnt) warp_step(cnt, STAT_PAIR_ITERS);\n", 1),
    ("        bsa = sa; bsb = sb; bsc = sc; bdn = dn;\n      }\n    }\n"
     "    if (best < 0) continue;\n",
     "        bsa = sa; bsb = sb; bsc = sc; bdn = dn;\n      }\n"
     "      if (cnt) cpair_ += clock64() - p0_;\n    }\n"
     "    if (cnt) {\n      cnt[STAT_CYC_PAIR] += cpair_;\n"
     "      cnt[STAT_CYC_WALK] += clock64() - c1_ - cpair_;\n    }\n"
     "    if (best < 0) continue;\n", 1),
    ("      const int f0 = (int)ld(T + 14), nf = (int)ld(T + 15);\n"
     "      for (int f = f0; f < f0 + nf; ++f) {\n"
     "        if (cnt) cnt[STAT_TRI_SHADOW] += 1;\n",
     "      const int f0 = (int)ld(T + 14), nf = (int)ld(T + 15);\n"
     "      const long long p0_ = cnt ? clock64() : 0;\n"
     "      for (int f = f0; f < f0 + nf; ++f) {\n"
     "        if (cnt) warp_step(cnt, STAT_PAIR_ITERS);\n"
     "        if (cnt) cnt[STAT_TRI_SHADOW] += 1;\n", 1),
    ("        if (plucker::pair(F4, true, l, c, lo, t, sa, sb, sc, dn)\n"
     "            && t > 1e-14f && t < cap)\n          return true;\n"
     "      }\n    }\n  }\n  return false;\n}",
     "        if (plucker::pair(F4, true, l, c, lo, t, sa, sb, sc, dn)\n"
     "            && t > 1e-14f && t < cap) {\n"
     "          if (cnt) {\n            cpair_ += clock64() - p0_;\n"
     "            cnt[STAT_CYC_PAIR] += cpair_;\n"
     "            cnt[STAT_CYC_WALK] += clock64() - c1_ - cpair_;\n"
     "          }\n          return true;\n        }\n      }\n"
     "      if (cnt) cpair_ += clock64() - p0_;\n    }\n"
     "    if (cnt) {\n      cnt[STAT_CYC_PAIR] += cpair_;\n"
     "      cnt[STAT_CYC_WALK] += clock64() - c1_ - cpair_;\n    }\n"
     "  }\n  return false;\n}", 1),
    ("  int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (i >= A.n) return;\n  const int n = A.n;\n",
     "  int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  long long k0_ = 0;\n  if constexpr (MXU) {\n"
     "    if (A.stats) k0_ = clock64();\n  }\n"
     "  if (i >= A.n) return;\n  const int n = A.n;\n", 1),
    ("  for (int b = 0; b < A.nbounce && alive; ++b) {\n",
     "  long long cb_ = 0;\n  if constexpr (MXU) {\n"
     "    if (cnt) cb_ = clock64();\n  }\n"
     "  for (int b = 0; b < A.nbounce && alive; ++b) {\n", 1),
    ("    rtype = take_r ? RT_REFLECT : RT_REFRACT;\n  }\n",
     "    rtype = take_r ? RT_REFLECT : RT_REFRACT;\n  }\n"
     "  if constexpr (MXU) {\n"
     "    if (cnt) cnt_[STAT_CYC_BOUNCES] += clock64() - cb_;\n  }\n", 1),
    ("      if (cnt_[s]) atomicAdd(A.stats + s, cnt_[s]);\n}\n",
     "      if (cnt_[s]) atomicAdd(A.stats + s, cnt_[s]);\n"
     "  if constexpr (MXU) {\n    if (cnt)\n"
     "      atomicMax(A.stats + NSTAT_MXU + blockIdx.x,\n"
     "                (unsigned long long)(clock64() - k0_));\n  }\n}\n", 1),
]


def fail(msg):
    print(f"[chip_ab] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def flat_counters_source(src: str) -> str:
    for k, (old, new, count) in enumerate(FLAT_PATCH):
        check(src.count(old) == count,
              f"edit {k} of FLAT_PATCH does not apply to the parent's "
              "source (it is written for the flat walk of commit caa87e5)")
        src = src.replace(old, new)
    return src


class ParentLib:
    """The parent's wave library behind the change's `_build.load` call:
    the change's launch arguments past the parent's count dropped, the
    stream (the last) kept."""

    def __init__(self, lib, nargs):
        self.lib, self.nargs = lib, nargs

    def rtf_wave_launch(self, *args):
        return self.lib.rtf_wave_launch(*args[:self.nargs - 1], args[-1])

    def rtf_error_string(self, code):
        return self.lib.rtf_error_string(code)


def parent_tables(scene, tab, dev):
    """The change's tables for the parent's kernel: on the MXU tables with
    ops/mxu_pack.py's padded tile rows [T, 16] in `tiles`."""
    if not tab.mxu:
        return tab
    import torch
    from rtf_tpu_torch.ops.mxu_pack import mesh_mxu_pack
    from rtf_tpu_torch.render.scene_tables import _pad_boxes
    tiles = _pad_boxes(mesh_mxu_pack(scene.mesh)["tiles"])
    return dataclasses.replace(tab, tiles=torch.as_tensor(tiles, device=dev))


def build_parent(parent, flat, nvcc):
    """The parent's wave library, and with `flat` its counted copy, built
    with the parent's own flags into build/ab/: {tag: ParentLib}, logs."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "rtf_tpu_torch" / "_build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    csrc = parent / "rtf_tpu_torch" / "csrc"
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"parent": csrc / "wave_kernel.cu"}
    if flat:
        sources["parent_counters"] = out / "wave_kernel_counters.cu"
        sources["parent_counters"].write_text(
            flat_counters_source(sources["parent"].read_text()))
    procs = {tag: subprocess.Popen(
        [nvcc, *pb.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-o",
         str(out / f"lib{tag}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for tag, src in sources.items()}
    libs, logs = {}, {}
    argtypes = pb.KERNELS["wave"][2]
    for tag, proc in procs.items():
        logs[tag] = proc.communicate()[0]
        check(proc.returncode == 0,
              f"nvcc failed for the {tag}:\n{logs[tag]}")
        dll = ctypes.CDLL(str(out / f"lib{tag}.so"))
        dll.rtf_wave_launch.argtypes = argtypes
        dll.rtf_wave_launch.restype = ctypes.c_int
        dll.rtf_error_string.argtypes = [ctypes.c_int]
        dll.rtf_error_string.restype = ctypes.c_char_p
        libs[tag] = ParentLib(dll, len(argtypes))
    return libs, logs


def main(argv):
    flat = "--flat-counters" in argv
    out_path = Path(argv[argv.index("--out") + 1]) if "--out" in argv \
        else ROOT / "build" / "chip_ab.json"
    rest = [a for k, a in enumerate(argv) if not a.startswith("--")
            and (k == 0 or argv[k - 1] != "--out")]
    parent = Path(rest[0]).resolve() if rest else None
    check(not flat or parent, "--flat-counters needs PARENT_DIR")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    check(parent is None
          or (parent / "rtf_tpu_torch" / "csrc" / "wave_kernel.cu").is_file(),
          f"{parent} holds no checkout of the port")
    sys.path.insert(0, str(ROOT))

    import chip_smoke as CS
    from rtf_tpu_torch import _build
    from rtf_tpu_torch.render import integrator as I_
    from rtf_tpu_torch.render import wave as W_
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.gi import child_wave_args, primary_gi_from
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene

    dev = torch.device("cuda")
    card = CS.card_line()
    print(f"[chip_ab] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)

    # ---- build: the change's libraries and the parent's wave library
    t0 = time.perf_counter()
    logs = _build.build()
    libs = {}
    if parent is not None:
        libs, plogs = build_parent(parent, flat, _build.nvcc())
        logs.update(plogs)
    print(f"[chip_ab] built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "entry function")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    change_load = _build.load
    change_load("wave")

    tabs = {}      # the tables of each side, by name (see use)
    cur = {}       # the tables that the launches read

    def use(tag):
        """Route `wave`'s launches to the parent's or the change's library
        and tables."""
        side = "change" if tag == "change" else "parent"
        cur.update(tabs.get(side, tabs["change"]))
        _build.load = (change_load if tag == "change" else
                       (lambda name="wave", _l=libs[tag]:
                        _l if name == "wave" else change_load(name)))

    def events_ms(fn, reps=20):
        for _ in range(3):
            fn()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def profiled_ms(fn, reps=5):
        """The kernel's device time per launch over the records the
        profiler delivered: late in a process it delivers fewer than reps,
        at times none (then NaN; the events time stands)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and "wave_kernel" in ev.key]
        count = sum(ev.count for ev in evs)
        if count < reps:
            print(f"[chip_ab] profiler: {count} of {reps} launches recorded",
                  flush=True)
        return (sum(ev.self_device_time_total for ev in evs) / count / 1e3
                if count else float("nan"))

    def frame_s(fn, reps):
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0_)
        return best

    def rays(scene):
        order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
        return primary_rays_ch(scene, order % W, order // W, torch.tensor(0))

    def flat_out(out):
        """Every output of a wave (radiance, hit, z, rows) as one vector."""
        parts = [out[0].reshape(-1), out[1].reshape(-1).float(),
                 out[2].reshape(-1)]
        if len(out) > 3:
            parts += [] if out[3] is None else [out[3].reshape(-1)]
            parts += [r.reshape(-1) for q in out[4] for r in q]
        return torch.cat(parts)

    def walk(fn, n):
        """One launch of fn with the counters on: the MXU walk's counts and
        figures, and that launch's time (CUDA events, mean of 5)."""
        stats = torch.zeros(W_.stats_size(n), dtype=torch.int64, device=dev)
        fn(stats=stats)
        st = stats.tolist()
        work = dict(zip(CS.STATS, st))
        return {"work": work, "walk": CS.walk_figures(work, st[W_.NSTAT:]),
                "ms_counters_on": events_ms(lambda: fn(stats=stats), reps=5)}

    def fmt(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "staging": {}, "splat": {}, "launches": {}, "frames": {}}

    # ---- the launches
    cfg = RenderConfig(min_samples=64, max_samples=64, bounces=4,
                       shadow_min=1, shadow_max=1, gi_mode="none")
    hyb = RenderConfig(min_samples=8, max_samples=8, bounces=4,
                       shadow_min=4, shadow_max=16, gi_mode="photon",
                       hemisphere_samples=30)
    main_scene = build_scene(box_scene(W, H, with_mesh=True), device=dev)
    mxu_scene = build_scene(box_scene(W, H, with_mesh=True, mesh_subdiv=5),
                            device=dev)
    hyb_scene = build_scene(CS.textured_desc(box_scene, W, H, mesh_subdiv=5),
                            device=dev)
    tabs["change"] = {k: scene_tables(s) for k, s in (
        ("main", main_scene), ("mxu", mxu_scene), ("hyb", hyb_scene))}
    if parent is not None:
        tabs["parent"] = {k: parent_tables(s, tabs["change"][k], dev)
                          for k, s in (("main", main_scene),
                                       ("mxu", mxu_scene),
                                       ("hyb", hyb_scene))}
    use("change")
    alive = torch.ones(W * H, dtype=torch.bool, device=dev)
    gi_vol = CS.box_volume(hyb_scene, 0, dev)
    caustic_vol = CS.box_volume(hyb_scene, 1, dev)
    gf = primary_gi_from(gi_vol, caustic_vol)
    o_m, d_m = rays(main_scene)
    o_x, d_x = rays(mxu_scene)
    o_h, d_h = rays(hyb_scene)
    _, hit0, _, surf, _ = W_.wave(hyb, cur["hyb"], o_h, d_h, alive, 11,
                                  surf_out=True, gi_from=gf)
    u = torch.rand((2, W * H), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    cargs, ckw = child_wave_args(hyb, surf, hit0, alive, 11, 0, u[0], u[1])
    ckw["gi_from"] = 0
    n_child = cargs[0].shape[1]
    mxu_launches = {
        "mxu": (lambda **k: W_.wave(cfg, cur["mxu"], o_x, d_x, alive, 11,
                                    **k), W * H),
        "hybrid_mxu primary": (lambda **k: W_.wave(
            hyb, cur["hyb"], o_h, d_h, alive, 11, surf_out=True, gi_from=gf,
            **k), W * H),
        "hybrid_mxu child": (lambda **k: W_.wave(
            hyb, cur["hyb"], *cargs, **ckw, **k), n_child),
    }

    # ---- 1. the change's MXU launches, roots and groups staged or not
    smem = W_.SMEM_BYTES
    for name, (fn, n) in mxu_launches.items():
        rec = {k: {"ms": [], "ms_profiler": []}
               for k in ("staged", "device memory")}
        outs = {}
        try:
            for k in ("staged", "device memory", "device memory",
                      "staged") * 2:
                W_.SMEM_BYTES = smem if k == "staged" else 0
                check(W_.smem_staged(cur["hyb" if "hybrid" in name
                                         else "mxu"]) == (k == "staged"),
                      f"{name}: not {k}")
                outs.setdefault(k, flat_out(fn()))
                rec[k]["ms"].append(events_ms(fn))
                rec[k]["ms_profiler"].append(profiled_ms(fn))
        finally:
            W_.SMEM_BYTES = smem
        check(torch.equal(outs["staged"], outs["device memory"]),
              f"{name}: the outputs depend on the staging")
        for k, v in rec.items():
            print(f"[chip_ab] staging {name} {k}: {fmt(v['ms'])} ms "
                  f"(events), {fmt(v['ms_profiler'])} ms (profiler)",
                  flush=True)
        result["staging"][name] = rec

    # ---- 2. the wavefront's splat against index_add, on one frame's calls
    wf_scene = build_scene(box_scene(W, H, with_mesh=True, light_size=1.0),
                           device=dev)
    wf_tab = scene_tables(wf_scene)
    change_splat = I_._splat
    calls = []

    def recorded(image, pixel, values, mask=None):
        calls.append((image.clone(), pixel.clone(), values.clone(),
                      None if mask is None else mask.clone()))
        return change_splat(image, pixel, values, mask)

    def atomic_splat(image, pixel, values, mask=None):
        if mask is not None:
            values = torch.where(mask[:, None], values, 0.0)
        return image.index_add(0, pixel, values)
    render(wf_scene, RenderConfig(), tables=wf_tab, device=dev)   # warm-up
    I_._splat = recorded
    try:
        render(wf_scene, RenderConfig(), tables=wf_tab, device=dev)
    finally:
        I_._splat = change_splat
    check(len(calls) > 0, "the wavefront frame made no splat call")
    per = {"sorted": [], "index_add": []}
    for args in calls:
        a, b = change_splat(*args), change_splat(*args)
        check(torch.equal(a, b), "the sorted splat differs between calls")
        ref = atomic_splat(*args)
        check(torch.allclose(a, ref, rtol=1e-5, atol=1e-6),
              "the sorted splat disagrees with index_add")
        ms = {}
        for tag in ("sorted", "index_add", "index_add", "sorted"):
            f = change_splat if tag == "sorted" else atomic_splat
            ms.setdefault(tag, []).append(events_ms(lambda: f(*args)))
        for tag, v in ms.items():
            per[tag].append(sum(v) / len(v))
    lanes = [int(c[1].numel()) for c in calls]
    result["splat"] = {
        "calls_per_frame": len(calls), "lanes": lanes,
        **{f"{tag}_ms_per_call": sum(v) / len(v) for tag, v in per.items()},
        **{f"{tag}_ms_per_frame": sum(v) for tag, v in per.items()}}
    sp = result["splat"]
    print(f"[chip_ab] splat: {len(calls)} calls a frame, {min(lanes)}-"
          f"{max(lanes)} lanes; " + "; ".join(
              f"{tag} {sp[tag + '_ms_per_call']:.4f} ms a call, "
              f"{sp[tag + '_ms_per_frame']:.4f} ms a frame"
              for tag in per) + " (CUDA events)", flush=True)
    del calls

    # ---- 3. the parent's wave kernel against the change's
    if parent is not None:
        # the parent's own counters only where its layout is the change's
        nstat = re.search(r"^NSTAT = (\d+)", (
            parent / "rtf_tpu_torch" / "render" / "wave.py").read_text(),
            re.M)
        counted = "parent_counters" if flat else (
            "parent" if nstat and int(nstat[1]) == W_.NSTAT else None)
        order_tags = (["parent", "parent_counters", "change", "change",
                       "parent_counters", "parent"] if flat else
                      ["parent", "change", "change", "parent"])
        launches = {**mxu_launches, "main": (
            lambda **k: W_.wave(cfg, cur["main"], o_m, d_m, alive, 11, **k),
            W * H)}
        for name, (fn, n) in launches.items():
            rec = {t: {"ms": [], "ms_profiler": []} for t in set(order_tags)}
            outs = {}
            for tag in order_tags:
                use(tag)
                outs.setdefault(tag, flat_out(fn()))
                rec[tag]["ms"].append(events_ms(fn))
                rec[tag]["ms_profiler"].append(profiled_ms(fn))
            for tag in outs:
                check(torch.equal(outs[tag], outs["parent"]),
                      f"{name}: the {tag}'s outputs differ from the parent's")
            if name != "main":
                for tag in filter(None, (counted, "change")):
                    use(tag)
                    rec[tag].update(walk(fn, n))
                    print(f"[chip_ab] {name} {tag}: work "
                          f"{json.dumps(rec[tag]['work'])}; "
                          f"{json.dumps(rec[tag]['walk'])}", flush=True)
            use("change")
            for tag in rec:
                print(f"[chip_ab] {name} {tag}: {fmt(rec[tag]['ms'])} ms "
                      f"(events), {fmt(rec[tag]['ms_profiler'])} ms "
                      "(profiler)", flush=True)
            result["launches"][name] = rec

        frames = {
            "mxu main": (lambda: render(mxu_scene, cfg, tables=cur["mxu"],
                                        device=dev), 3),
            "mxu hybrid": (lambda: render(
                hyb_scene, hyb, tables=cur["hyb"], gi_vol=gi_vol,
                caustic_vol=caustic_vol, device=dev), 2),
        }
        for name, (fn, reps) in frames.items():
            rec = {}
            for tag in ("parent", "change", "change", "parent"):
                use(tag)
                rec.setdefault(tag, []).append(frame_s(fn, reps))
            use("change")
            print(f"[chip_ab] frame {name}: " + "; ".join(
                f"{t} {fmt(v)} s" for t, v in rec.items()), flush=True)
            result["frames"][name] = rec

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
