#!/usr/bin/env python3
"""Compare versions of the port's kernels in turns on one card.

    python3 chip_ab.py [PARENT_DIR] [--dense] [--out FILE]
    python3 chip_ab.py [PARENT_DIR] --bvh [--out FILE]
    python3 chip_ab.py --emulate

Run from the root of a checkout (the change), on a host with a CUDA card
and nvcc.  The change's kernels build as chip_smoke.py builds them.  The
launches are chip_smoke.py's, on the same inputs:

  dense primary, scattered  phase 8: mesh_closest_hit_mxu on its two sets
                      of 480,256 rows16 against the 20,480-face ball;

  main, textured      phases 3-4: the wave kernel's immediates variants at
                      800x600 (the 320-face ball), 4 bounces, seed 11;
  gi primary, child   phase 5 (box 400x300, hemisphere GI): the primary
                      launch with its rows and a child launch (uniforms of
                      seed 5);
  hybrid primary, child  phase 6 (the textured box, photon GI, two
                      volumes): the same two launch kinds;
  mxu, hybrid_mxu primary, child  phases 8-9 on the 20,480-face ball;
  mxu fill            phase 8's launch with the camera's field of view
                      cut to the ball, which then fills the view: nearly
                      every block walks the mesh;
  ball                phase 8's launch on the benchmark's ball
                      (box_scene(800, 600, light_size=1.0, mesh_subdiv=7),
                      327,680 faces), where few blocks walk and long;
  mesh primary, shadow, bounce 1  phase 7: mesh_closest_hit on the
                      inputs of one wavefront wave of RenderConfig() on
                      box_scene(800, 600, light_size=1.0): its primary
                      rays, its first shadow trace, the first bounce's
                      compacted queue.

0. the dense closest hit: the hot loop of each side's mesh_hit_mxu
   library in cuobjdump's SASS (instructions a pair of a lane, and the
   issue floor: that times the pairs over 132 SMs x 4 x 32 lanes at the
   card's top SM clock), the change's counters (pairs filtered,
   re-checked, valid; tiles with a survivor) and, with PARENT_DIR, both
   sides in turns parent, change, change, parent on both sets, outputs
   equal bit for bit on every ray; with --dense the script stops here;
1. counters: one launch of each wave launch with the counters on (the
   walk's slab tests by level, face tests, SIMT efficiency, lane cycles by
   part, each block's cycles; csrc/wave_kernel.cu STAT_*), its time with
   them on and the bound on its counts (chip_smoke.py::bound); for
   mesh_closest_hit its slab tests and ray-face pairs;
2. scene tables in shared memory: the change's immediates launches with
   the small tables that every lane reads per bounce (spheres, planes,
   mesh instances, lights) staged in shared memory, as the kernel stages
   them, against the same launches with them in device memory (the
   fallback of scenes whose tables do not fit, forced through
   render/wave.py::scene_staged), in turns staged, device memory, device
   memory, staged, twice; outputs equal bit for bit; then the MXU
   launches with and without the block order pass that runs before each
   (the launch's order scratch passed as null: blocks in their own
   order), in turns ordered, unordered, unordered, ordered, twice, with
   block_order's own time (profiler); outputs equal bit for bit;
3. with PARENT_DIR (another checkout of the repository, for example
   `git archive` of the parent commit unpacked in a directory that
   .gitignore lists): the parent's csrc/wave_kernel.cu, csrc/mesh_hit.cu
   and csrc/mesh_hit_mxu.cu (the last run through the parent's own
   ops/mesh_hit_mxu.py, in step 0), built with the parent's own nvcc
   flags into build/ab/, against the
   change's in turns parent, change, change, parent on every launch above,
   outputs equal bit for bit; the parent's work counters (STAT 0-10, the
   same layout in both); for mesh_closest_hit the kernel alone (profiler)
   and what a trace calls (events: on a parent without
   mesh_closest_hit_rays, pack_rays and mesh_closest_hit), and, where the
   parent's kernel walks the tiles
   flat (PR 6's launch takes a tile count), that kernel launched with no
   tiles (nt = 0: reading the rays and writing the outputs, its floor);
   then the frames of phases 3-7 through `render`.  The parent's wave
   library is launched by the parent's own render/wave.py (its `_launch`
   behind the change's `wave`) on the change's tables; a parent whose MXU face rows are whole (its
   csrc/wave_kernel.cu without SHADE_W) gets them back, the change's pair
   columns 0-21, its shade rows and two zero columns: 40 floats a face.
   The parent's mesh_closest_hit(_rays) is its own ops/mesh_hit.py on its
   own library, with the change's arguments that it takes.

--bvh runs only this: bvh_closest_hit on phase 12's three ray sets
(chip_smoke.py::bvh_sets: one wave's primary rays and first shadow batch
of RenderConfig() with mesh_algo="bvh" on box_scene(800, 600,
mesh_subdiv=5, light_size=1.0), 480,000 scattered rays) and a fourth
set, "miss" (the scattered rays moved 300 units out along their
directions, each missing the root's boxes: the launch's floor) in turns:
with PARENT_DIR the parent's bvh_closest_hit (its own ops/bvh_hit.py on
its own csrc/bvh_hit.cu, built with its own flags) and the change's walk as
the wrapper launches it, in the order parent, change, change, parent; each
side's outputs held against the lock-step plain walk's under the tie rule
(hit masks and t equal, other differences only at near ties, ops/bvh_hit.py::
near_ties); each side's counters (pops, box and face tests; the most pops
of a ray) and profiler time; one wave of that frame (105 walks) per side,
in turns, the walk kernel's device time over it (profiler; a pass whose
profile caught another count of launches than the wave's walks is taken
again, up to 3 times, else the script fails); and with PARENT_DIR the
`"bvh"` frame in turns parent, change, change, parent (best of 2 each).
The design steps that this walk does not keep (persistent threads, the
stack in shared memory, one face at a time, no leaf prefetch, the top
levels staged, an 8-wide tree) were measured in the same way, as launch
options of an earlier version of the kernel (PERF.md §6).

A launch's time is the mean of 20 by CUDA events (the queue filled first;
5 for the dense closest hit) and of 5 by the profiler (kernel only); a
frame's the best of 2.  --emulate runs on the CPU alone: the dense
closest hit's filter emulated in plain torch on phase 8's ray sets at
160 x 120, its share of surviving pairs and of 16 x 8 tiles with a
survivor.  Prints
the card, one line per figure and one JSON object with every figure as the
last line (also written to --out, default build/chip_ab.json).
"""
import ctypes
import dataclasses
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H = 800, 600


def fail(msg):
    print(f"[chip_ab] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


class NoOrder:
    """The change's wave library with the launch's block order scratch
    passed as None: no block_order pass, the blocks in their own order."""

    def __init__(self, lib):
        self.lib = lib

    def rtf_wave_launch(self, args, textured, mxu, order, stream):
        return self.lib.rtf_wave_launch(args, textured, mxu, None, stream)

    def rtf_error_string(self, code):
        return self.lib.rtf_error_string(code)


def nvcc_all(jobs, out):
    """Build {tag: (source, flags)} into out/lib{tag}.so, one nvcc each,
    all started together: {tag: ctypes library}, {tag: log}."""
    out.mkdir(parents=True, exist_ok=True)
    from rtf_tpu_torch import _build
    procs = {tag: subprocess.Popen(
        [_build.nvcc(), *flags, "-Xptxas", "-v", "-I", str(src.parent),
         "-o", str(out / f"lib{tag}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for tag, (src, flags) in jobs.items()}
    libs, logs = {}, {}
    for tag, proc in procs.items():
        logs[tag] = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc failed for {tag}:\n{logs[tag]}")
        libs[tag] = ctypes.CDLL(str(out / f"lib{tag}.so"))
    return libs, logs


def bind(dll, fn, argtypes):
    getattr(dll, fn).argtypes = argtypes
    getattr(dll, fn).restype = ctypes.c_int
    dll.rtf_error_string.argtypes = [ctypes.c_int]
    dll.rtf_error_string.restype = ctypes.c_char_p
    return dll


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def emulate():
    """The dense closest hit's filter emulated on the CPU
    (ops/mesh_hit_mxu.py: ray_frags, filter_margins, filter_survivors) on
    phase 8's two ray sets at 160 x 120 against the 20,480-face ball: the
    share of pairs that survive, and of 16-ray x 8-face tiles that hold a
    survivor.  What the kernel's counters should show on the card."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from rtf_tpu_torch.ops import mesh_hit_mxu as X_
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    cpu = torch.device("cpu")
    scene = build_scene(box_scene(160, 120, with_mesh=True, mesh_subdiv=5),
                        device=cpu)
    trim, sets, _ = CS.dense_inputs(X_, scene, cpu)
    pack = X_.pack_faces(trim)
    f = pack.rows.shape[0]
    w = X_.unpack_frags(pack.frags, f)
    for name, rays16 in sets.items():
        a, live = X_.ray_frags(rays16)
        surv = tiles = 0
        for s in range(0, rays16.shape[0], 512):
            sv = X_.filter_survivors(X_.filter_margins(a[s:s + 512], w),
                                     live[s:s + 512])
            surv += int(sv.sum())
            tiles += int(sv.reshape(-1, 16, f // 8, 8).any(3).any(1).sum())
        pairs = int(live.sum()) * f
        print(f"[chip_ab] emulated {name}: {rays16.shape[0]} rays x {f} "
              f"faces, survivors {surv} = {surv / pairs:.6f} of pairs, "
              f"16x8 tiles with a survivor {tiles} = "
              f"{tiles * 128 / (rays16.shape[0] * f):.6f}", flush=True)


def bvh_ab(parent, out_path):
    """--bvh: the BVH walk's A/B (the module docstring)."""

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    check(parent is None
          or (parent / "rtf_tpu_torch" / "csrc" / "bvh_hit.cu").is_file(),
          f"{parent} holds no checkout of the port with csrc/bvh_hit.cu")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from rtf_tpu_torch import _build
    from rtf_tpu_torch.ops import bvh_hit as B_
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.integrator import render_wave
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene, ensure_bvh
    from rtf_tpu_torch.scene.procedural import box_scene

    dev = torch.device("cuda")
    card = CS.card_line()
    print(f"[chip_ab] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    jobs = {}
    if parent is not None:
        pb = load_module("parent_build",
                         parent / "rtf_tpu_torch" / "_build.py")
        jobs["parent_bvh_hit"] = (parent / "rtf_tpu_torch" / "csrc"
                                  / "bvh_hit.cu", pb.NVCC_FLAGS)
    dlls, plogs = nvcc_all(jobs, ROOT / "build" / "ab")
    logs.update(plogs)
    print(f"[chip_ab] built in {time.perf_counter() - t0:.2f} s", flush=True)
    regs = {}
    for name in ("bvh_hit", "parent_bvh_hit"):
        fn = None
        for line in logs.get(name, "").splitlines():
            if "entry function" in line:
                fn = line.split("'")[1]
            if fn and ("registers" in line or "spill" in line):
                regs.setdefault(f"{name} {fn}", []).append(line.strip())
                print(f"[build] {name} {fn}: {line.strip()}", flush=True)
    orig_load = _build.load
    PB = pdll = None
    if parent is not None:
        pdll = bind(dlls["parent_bvh_hit"], "rtf_bvh_hit_launch",
                    pb.KERNELS["bvh_hit"][2])
        PB = load_module("parent_bvh_hit",
                         parent / "rtf_tpu_torch" / "ops" / "bvh_hit.py")

    def as_parent(fn):
        """fn() with the parent's library behind _build.load."""
        def call(*a, **k):
            _build.load = (lambda name="wave": pdll if name == "bvh_hit"
                           else orig_load(name))
            try:
                return fn(*a, **k)
            finally:
                _build.load = orig_load
        return call

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

    def profiled_ms(fn, key, reps=5):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and key in ev.key]
        count = sum(ev.count for ev in evs)
        return (sum(ev.self_device_time_total for ev in evs) / count / 1e3
                if count else float("nan"))

    wcfg = RenderConfig()
    scene = dataclasses.replace(build_scene(box_scene(
        W, H, with_mesh=True, mesh_subdiv=5, light_size=1.0), device=dev),
        mesh_algo="bvh")
    tables = scene_tables(scene)
    mesh = ensure_bvh(scene.mesh)
    walk = B_.bvh_walk(mesh)
    root = walk.roots[0]
    pmesh = dataclasses.replace(mesh, bvh_walk=None)
    order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
    o, d = primary_rays(scene, order % W, order // W, torch.tensor(0))
    ids = torch.arange(W * H, device=dev)
    per_wave = (1 + wcfg.shadow_min + wcfg.shadow_max) * (1 + wcfg.bounces)

    def one_wave():
        return render_wave(
            scene, wcfg, tables, o, d, ids,
            torch.ones(W * H, dtype=torch.bool, device=dev),
            torch.Generator(device=dev).manual_seed(3), W * H, inv_pixel=ids)
    sets = CS.bvh_sets(B_, scene, one_wave, per_wave, dev)
    # the launch's floor: as many rays, each missing the ball's root boxes
    # (origins 100 ball radii out, pointing away): one pop, its box tests,
    # the rays read and the outputs written
    lo, ld, _ = sets["scattered"]
    far = ld * 300.0
    sets["miss"] = (lo + far, ld, torch.full_like(lo[:, 0], 1e30))
    print(f"[chip_ab] bvh: {mesh.bvh_min.shape[0]} binary nodes, "
          f"{walk.levels} levels; {B_.WIDTH}-wide {walk.wnodes.shape[0]} "
          f"nodes, stack {walk.stack}", flush=True)
    # name: (launch(o, d, t_init, stats=None), profiler key)
    sides = {
        "change": (lambda *a, **k: B_.bvh_closest_hit(mesh, root, *a, **k),
                   "bvh_wide_kernel"),
    }
    if parent is not None:
        sides = {"parent": (as_parent(lambda *a, **k: PB.bvh_closest_hit(
            pmesh, root, *a, **k)), "bvh_hit_kernel"), **sides}
    names = list(sides)
    turns = names + names[::-1]
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "registers": regs, "bvh": {}}
    for label, (lo, ld, t_init) in sets.items():
        n = lo.shape[0]
        ref = B_.bvh_closest_hit_plain(mesh, root, lo, ld, t_init)
        rec = {"rays": n, "hits": int((ref[1] >= 0).sum())}
        outs = {}
        for name, (fn, key) in sides.items():
            stats = torch.zeros(max(B_.NSTAT, 6), dtype=torch.int64,
                                device=dev)
            out = fn(lo, ld, t_init, stats=stats)
            torch.cuda.synchronize()
            outs[name] = out
            st = stats.tolist()
            check(torch.equal(out[1] >= 0, ref[1] >= 0)
                  and torch.equal(out[0], ref[0]),
                  f"bvh {label} {name}: hit masks or t differ from the "
                  f"lock-step walk's")
            idx, tie = B_.near_ties(mesh, lo, ld, out, ref)
            check(bool(tie.all()), f"bvh {label} {name}: "
                  f"{int((~tie).sum())} rays differ beyond a near tie")
            boxes = st[5] if name != "parent" else st[0] + 2 * st[1]
            rec[name] = {"pops": st[0], "pops_a_ray": st[0] / n,
                         "most_pops": st[4], "box_tests": boxes,
                         "box_tests_a_ray": boxes / n, "face_tests": st[3],
                         "face_tests_a_ray": st[3] / n,
                         "near_ties": idx.numel(), "ms": [],
                         "ms_profiler": profiled_ms(
                             lambda _f=fn: _f(lo, ld, t_init), key)}
        for name in turns:
            fn = sides[name][0]
            rec[name]["ms"].append(events_ms(
                lambda _f=fn: _f(lo, ld, t_init)))
        for name in names:
            r = rec[name]
            print(f"[chip_ab] bvh {label} {name}: {fmt(r['ms'])} ms "
                  f"(events), {r['ms_profiler']:.4f} ms (profiler); "
                  f"{r['pops_a_ray']:.3f} pops a ray (most "
                  f"{r['most_pops']}), {r['box_tests_a_ray']:.3f} box "
                  f"tests, {r['face_tests_a_ray']:.3f} face tests a ray; "
                  f"{r['near_ties']} near ties against the lock-step walk",
                  flush=True)
        result["bvh"][label] = rec
        del outs, ref
    # one wave of the "bvh" frame (105 walks) per side, in turns: the walk
    # kernel's device time summed over the wave (profiler)
    kernel_fn = B_.bvh_closest_hit
    parent_walk = None if parent is None else as_parent(
        lambda mesh_, root_, *a, **k: PB.bvh_closest_hit(pmesh, root_, *a,
                                                         **k))

    def route(name):
        B_.bvh_closest_hit = parent_walk if name == "parent" else kernel_fn

    def wave_ms(name):
        """One wave's walks on side `name`: (device ms, launches the
        profile caught), taken again until it caught all per_wave."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        route(name)
        try:
            one_wave()
            torch.cuda.synchronize()
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    one_wave()
                    torch.cuda.synchronize()
                evs = [ev for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA
                       and sides[name][1] in ev.key]
                count = sum(ev.count for ev in evs)
                ms = sum(ev.self_device_time_total for ev in evs) / 1e3
                if count == per_wave:
                    break
                print(f"[chip_ab] bvh one wave {name}: the profile caught "
                      f"{count} of {per_wave} launches; again", flush=True)
        finally:
            route("change")
        check(count == per_wave, f"bvh one wave {name}: the profile caught "
              f"{count} of {per_wave} launches in 3 tries")
        return ms, count
    wave = {}
    for name in names + names[::-1]:
        ms, count = wave_ms(name)
        w = wave.setdefault(name, {"ms": [], "launches": [],
                                   "ms_a_launch": []})
        w["ms"].append(ms)
        w["launches"].append(count)
        w["ms_a_launch"].append(ms / count)
    for name in names:
        w = wave[name]
        print(f"[chip_ab] bvh one wave {name}: the walk's device time "
              f"{fmt(w['ms'])} ms over {w['launches']} launches "
              f"({fmt(w['ms_a_launch'])} ms a launch)", flush=True)
    result["bvh"]["wave"] = wave
    if parent is not None:
        frames = {}
        render(scene, wcfg, device=dev, tables=tables)      # warm-up
        for tag in ("parent", "change", "change", "parent"):
            route(tag)
            try:
                best = float("inf")
                for rep in range(2):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    render(scene, wcfg, seed=1 + rep, device=dev,
                           tables=tables)
                    best = min(best, time.perf_counter() - t1)
            finally:
                route("change")
            frames.setdefault(tag, []).append(best)
        print(f"[chip_ab] bvh frame {W}x{H} RenderConfig(): parent "
              f"{fmt(frames['parent'])} s, change {fmt(frames['change'])} s",
              flush=True)
        result["bvh"]["frame_s"] = frames
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    print(json.dumps(result), flush=True)


def fill_view(desc):
    """The scene with its camera turned to the mesh ball of box_scene
    (centre (1, 4, 3), radius 3) and its field of view cut to the ball's
    angular size, so that the ball covers every pixel of a 4:3 view."""
    import numpy as np
    cam = desc.camera
    d = np.array([1.0, 4.0, 3.0]) - cam.pos
    dist = float(np.linalg.norm(d))
    cam.dir = d / dist
    x = np.cross(cam.dir, np.array([0.0, 0.0, 1.0]))
    up = np.cross(x, cam.dir)
    cam.up = up / np.linalg.norm(up)
    cam.fov = float(np.degrees(2 * np.arcsin(3.0 / dist)) * 0.6)
    return desc


def fmt(xs):
    return ", ".join(f"{x:.4f}" for x in xs)


def main(argv):
    if "--emulate" in argv:
        return emulate()
    out_path = Path(argv[argv.index("--out") + 1]) if "--out" in argv \
        else ROOT / "build" / "chip_ab.json"
    rest = [a for k, a in enumerate(argv) if not a.startswith("--")
            and (k == 0 or argv[k - 1] != "--out")]
    parent = Path(rest[0]).resolve() if rest else None
    if "--bvh" in argv:
        return bvh_ab(parent, out_path)
    dense_only = "--dense" in argv
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    check(parent is None
          or (parent / "rtf_tpu_torch" / "csrc" / "wave_kernel.cu").is_file(),
          f"{parent} holds no checkout of the port")
    sys.path.insert(0, str(ROOT))

    import chip_smoke as CS
    from rtf_tpu_torch import _build
    from rtf_tpu_torch.ops import mesh_hit as M_
    from rtf_tpu_torch.ops import mesh_hit_mxu as X_
    from rtf_tpu_torch.render import wave as W_
    from rtf_tpu_torch.render.camera import (
        pixel_order, primary_rays, primary_rays_ch)
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.gi import child_wave_args, primary_gi_from
    from rtf_tpu_torch.render.integrator import render_wave
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene

    dev = torch.device("cuda")
    card = CS.card_line()
    print(f"[chip_ab] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)

    # ---- build: the change's libraries and the parent's
    t0 = time.perf_counter()
    logs = _build.build()
    jobs = {}
    pb = None
    if parent is not None:
        pb = load_module("parent_build",
                         parent / "rtf_tpu_torch" / "_build.py")
        csrc = parent / "rtf_tpu_torch" / "csrc"
        jobs["parent"] = (csrc / "wave_kernel.cu", pb.NVCC_FLAGS)
        jobs["parent_mesh_hit"] = (csrc / "mesh_hit.cu", pb.NVCC_FLAGS)
        jobs["parent_mesh_hit_mxu"] = (csrc / "mesh_hit_mxu.cu",
                                       pb.NVCC_FLAGS)
    dlls, plogs = nvcc_all(jobs, ROOT / "build" / "ab")
    logs.update(plogs)
    print(f"[chip_ab] built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "entry function")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    change_load = _build.load
    libs = {"change": {}, "device memory": {},
            "unordered": {"wave": NoOrder(change_load("wave"))}}
    change_load("mesh_hit")
    PM = PX = None
    # each side's render/wave.py::_launch, which the change's `wave` calls
    wave_launch = {"change": W_._launch}
    flat_mesh = False    # the parent's mesh kernel walks its tiles flat
    whole_faces = False  # the parent's MXU face rows are 40 floats
    if parent is not None:
        whole_faces = "SHADE_W" not in (parent / "rtf_tpu_torch" / "csrc"
                                        / "wave_kernel.cu").read_text()
        wave_types = pb.KERNELS["wave"][2]
        if hasattr(pb, "WaveArgs"):
            # the parent's render/wave.py fills this process's WaveArgs
            # (its `_build` is the change's module): bind to that type
            check(pb.WaveArgs._fields_ == _build.WaveArgs._fields_,
                  "the parent's struct Args differs from the change's")
            wave_types = _build.KERNELS["wave"][2]
        libs["parent"] = {
            "wave": bind(dlls["parent"], "rtf_wave_launch", wave_types),
            "mesh_hit": bind(dlls["parent_mesh_hit"], "rtf_mesh_hit_launch",
                             pb.KERNELS["mesh_hit"][2]),
            "mesh_hit_mxu": bind(dlls["parent_mesh_hit_mxu"],
                                 "rtf_mesh_hit_mxu_launch",
                                 pb.KERNELS["mesh_hit_mxu"][2])}
        PX = load_module("parent_mesh_hit_mxu", parent / "rtf_tpu_torch"
                         / "ops" / "mesh_hit_mxu.py")
        PM = load_module("parent_mesh_hit",
                         parent / "rtf_tpu_torch" / "ops" / "mesh_hit.py")
        wave_launch["parent"] = load_module(
            "parent_wave", parent / "rtf_tpu_torch" / "render"
            / "wave.py")._launch
        flat_mesh = "tree" not in inspect.signature(
            PM.mesh_closest_hit).parameters

    tabs = {}      # each side's tables, by launch group
    cur = {}       # the tables the launches read now
    change_mesh_hit = M_.mesh_closest_hit_rays

    change_scene_staged = W_.scene_staged

    def parent_mesh_hit(lo, ld, t_init, tris, aabb, face0=0, stats=None,
                        **k):
        """What a trace calls on the parent: its mesh_closest_hit_rays, or
        pack_rays and its mesh_closest_hit, cut to the rays."""
        if hasattr(PM, "mesh_closest_hit_rays"):
            return PM.mesh_closest_hit_rays(lo, ld, t_init, tris, aabb, face0,
                                            stats, **k)
        rays8, _ = PM.pack_rays(lo, ld, t_init)
        return tuple(x[:lo.shape[0]] for x in PM.mesh_closest_hit(
            rays8, tris, aabb, face0, stats, **({} if flat_mesh else k)))

    def use(tag):
        """Route the launches to a side's libraries and tables; "device
        memory": the change with its scene tables in device memory."""
        side = "parent" if tag == "parent" else "change"
        cur.clear()
        cur.update(tabs.get(side, {}))
        got = libs[tag]
        _build.load = (lambda name="wave": got[name] if name in got
                       else change_load(name))
        W_._launch = wave_launch[side]
        M_.mesh_closest_hit_rays = (parent_mesh_hit if tag == "parent"
                                    else change_mesh_hit)
        W_.scene_staged = ((lambda tables: False) if tag == "device memory"
                           else change_scene_staged)

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

    def profiled_ms(fn, key, reps=5):
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
               if ev.device_type == DeviceType.CUDA and key in ev.key]
        count = sum(ev.count for ev in evs)
        if count < reps:
            print(f"[chip_ab] profiler: {count} of {reps} launches recorded",
                  flush=True)
        return (sum(ev.self_device_time_total for ev in evs) / count / 1e3
                if count else float("nan"))

    def frame_s(fn, reps=2):
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0_)
        return best

    def rays_ch(scene):
        w, h = scene.width, scene.height
        order = torch.as_tensor(pixel_order(w, h), device=dev).to(torch.int64)
        return primary_rays_ch(scene, order % w, order // w, torch.tensor(0))

    def flat_out(out):
        """Every output (a wave's radiance, hit, z, rows; a closest hit's
        t, face, front, ba, bb) as one float vector."""
        parts = []
        for x in out:
            if isinstance(x, list):
                parts += [r.reshape(-1) for q in x for r in q]
            elif x is not None:
                parts.append(x.reshape(-1).float())
        return torch.cat(parts)

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "counters": {}, "scene_smem": {}, "launches": {},
              "mesh_closest_hit": {}, "frames": {}, "dense": {}}

    # ---- 0. the dense closest hit (phase 8's two ray sets)
    libs["change"]["mesh_hit_mxu"] = change_load("mesh_hit_mxu")
    sass_dir = ROOT / "build" / "ab"
    sass_dir.mkdir(parents=True, exist_ok=True)
    dscene = build_scene(box_scene(W, H, with_mesh=True, mesh_subdiv=5),
                         device=dev)
    trim, dsets, _ = CS.dense_inputs(X_, dscene, dev)
    pairs = dsets["primary"].shape[0] * trim.shape[0] * (trim.shape[2] // 5)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0]) * 1e6
    for tag, lib in (("change", _build.library_path("mesh_hit_mxu")),
                     ("parent", sass_dir / "libparent_mesh_hit_mxu.so")):
        if not lib.exists():
            continue
        code = CS.sass(lib)
        (sass_dir / f"sass_{tag}_mesh_hit_mxu.txt").write_text(code)
        # the hot loop's instructions, per pair of one lane: a vote of the
        # change covers 1,024 pairs of a warp, an iteration of the parent
        # one pair of each lane
        loop, votes, hmma = CS.sass_fast_path(code, "mesh_hit_mxu_kernel")
        per_pair = loop / max(votes, 1) * 32 / 1024 if votes else loop
        floor_ms = per_pair * pairs / (132 * 4 * 32 * clock) * 1e3
        result["dense"][f"sass_{tag}"] = {
            "instructions_a_pair": per_pair, "loop": loop, "votes": votes,
            "hmma": hmma, "clock_hz": clock, "issue_floor_ms": floor_ms}
        print(f"[chip_ab] dense {tag} hot loop: {loop} instructions, "
              f"{votes} votes, {hmma} HMMA an iteration: {per_pair:.4f} "
              f"instructions a pair of a lane; issue floor on {pairs} "
              f"pairs {floor_ms:.4f} ms at {clock / 1e6:.0f} MHz",
              flush=True)
    for name, rays16 in dsets.items():
        stats = torch.zeros(X_.NSTAT, dtype=torch.int64, device=dev)
        X_.mesh_closest_hit_mxu(rays16, trim, stats=stats)
        filtered, rechecked, valid, tiles = stats.tolist()
        rec = {"filtered": filtered, "rechecked": rechecked, "valid": valid,
               "tiles": tiles,
               "survivor_share": rechecked / max(filtered, 1)}
        print(f"[chip_ab] dense {name}: {json.dumps(rec)}", flush=True)
        if parent is not None:
            turns = ("parent", "change", "change", "parent")
            outs = {}
            for tag in turns:
                use(tag)
                mod = PX if tag == "parent" else X_

                def call(_m=mod, _r=rays16):
                    return _m.mesh_closest_hit_mxu(_r, trim)
                outs.setdefault(tag, flat_out(call()))
                rec.setdefault(tag, {"ms": [], "ms_profiler": []})
                rec[tag]["ms"].append(events_ms(call, reps=5))
                rec[tag]["ms_profiler"].append(profiled_ms(
                    call, "mesh_hit_mxu_kernel"))
            use("change")
            check(torch.equal(outs["change"], outs["parent"]),
                  f"dense {name}: the change's outputs differ from the "
                  "parent's")
            for tag in ("parent", "change"):
                print(f"[chip_ab] dense {name} {tag}: {fmt(rec[tag]['ms'])}"
                      f" ms (events), {fmt(rec[tag]['ms_profiler'])} ms "
                      f"(profiler); {rays16.shape[0]} rays, outputs "
                      "bit-equal", flush=True)
        result["dense"][name] = rec
    if dense_only:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
        print(card, flush=True)
        print(json.dumps(result), flush=True)
        return

    # ---- the scenes, tables and launches
    main_cfg = RenderConfig(min_samples=64, max_samples=64, bounces=4,
                            shadow_min=1, shadow_max=1, gi_mode="none")
    gi_cfg = RenderConfig(min_samples=8, max_samples=8, bounces=2,
                          shadow_min=1, shadow_max=1, gi_mode="hemisphere",
                          hemisphere_samples=4, queue_factor=1.0)
    hyb_cfg = RenderConfig(min_samples=8, max_samples=8, bounces=4,
                           shadow_min=4, shadow_max=16, gi_mode="photon",
                           hemisphere_samples=30)
    wf_cfg = RenderConfig()
    scenes = {
        "main": build_scene(box_scene(W, H, with_mesh=True), device=dev),
        "textured": build_scene(CS.textured_desc(box_scene, W, H),
                                device=dev),
        "gi": build_scene(box_scene(400, 300, with_mesh=True), device=dev),
        "hybrid": build_scene(CS.textured_desc(box_scene, W, H), device=dev),
        "mxu": build_scene(box_scene(W, H, with_mesh=True, mesh_subdiv=5),
                           device=dev),
        "hybrid_mxu": build_scene(CS.textured_desc(box_scene, W, H,
                                                   mesh_subdiv=5),
                                  device=dev),
        "wavefront": build_scene(box_scene(W, H, with_mesh=True,
                                           light_size=1.0), device=dev),
        "mxu fill": build_scene(fill_view(box_scene(
            W, H, with_mesh=True, mesh_subdiv=5)), device=dev),
        "ball": build_scene(box_scene(W, H, with_mesh=True, light_size=1.0,
                                      mesh_subdiv=7), device=dev),
    }
    tabs["change"] = {k: scene_tables(s) for k, s in scenes.items()}
    if parent is not None:
        tabs["parent"] = dict(tabs["change"])
        for k, tab in tabs["change"].items():
            if tab.mxu and whole_faces:
                f = tab.faces
                tabs["parent"][k] = dataclasses.replace(tab, faces=torch.cat(
                    [f[:, 0:22], tab.shade, f[:, 22:24]], 1).contiguous())
    vols = {k: (CS.box_volume(scenes[k], 0, dev),
                CS.box_volume(scenes[k], 1, dev))
            for k in ("hybrid", "hybrid_mxu")}

    def cur_tab(key):
        """The current side's tables of `key`."""
        return cur[key]

    launches = {}     # name: (fn(**kw), lanes, group, rows in, rows out)
    alive = {}
    for key, cfg in (("main", main_cfg), ("textured", main_cfg),
                     ("mxu", main_cfg), ("mxu fill", main_cfg),
                     ("ball", main_cfg)):
        o3, d3 = rays_ch(scenes[key])
        al = torch.ones(o3.shape[1], dtype=torch.bool, device=dev)
        launches[key] = (
            lambda _c=cfg, _k=key, _o=o3, _d=d3, _a=al, **kw:
            W_.wave(_c, cur_tab(_k), _o, _d, _a, 11, **kw),
            o3.shape[1], key, 7, 5)
    for key, cfg, vol in (("gi", gi_cfg, False), ("hybrid", hyb_cfg, True),
                          ("hybrid_mxu", hyb_cfg, True)):
        gv, cv = vols[key] if vol else (None, None)
        gf = primary_gi_from(gv, cv)
        o3, d3 = rays_ch(scenes[key])
        n = o3.shape[1]
        al = torch.ones(n, dtype=torch.bool, device=dev)
        use("change")
        _, hit0, _, surf, _ = W_.wave(cfg, cur_tab(key), o3, d3, al, 11,
                                      surf_out=True, gi_from=gf)
        u = torch.rand((2, n), generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        cargs, ckw = child_wave_args(cfg, surf, hit0, al, 11, 0, u[0], u[1])
        ckw["gi_from"] = 0 if gv is not None else None
        launches[f"{key} primary"] = (
            lambda _c=cfg, _k=key, _o=o3, _d=d3, _a=al, _g=gf, **kw:
            W_.wave(_c, cur_tab(_k), _o, _d, _a, 11, surf_out=True,
                    gi_from=_g, **kw),
            n, key, 7, W_.out_rows(cfg.bounces + 1, True, gf))
        launches[f"{key} child"] = (
            lambda _c=cfg, _k=key, _a=cargs, _kw=ckw, **kw:
            W_.wave(_c, cur_tab(_k), *_a, **_kw, **kw),
            n, key, 14, W_.out_rows(ckw["bounces"] + 1, False,
                                     ckw["gi_from"]))
    imm = [k for k, v in launches.items() if not tabs["change"][v[2]].mxu]

    # the mesh kernel's inputs: one wavefront wave's first three traces
    wscene = scenes["wavefront"]
    per_shade = (1 + wf_cfg.shadow_min + wf_cfg.shadow_max) \
        * wscene.num_mesh_inst
    order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
    o, d = primary_rays(wscene, order % W, order // W, torch.tensor(0))
    ids = torch.arange(W * H, device=dev)
    captured, calls = {}, [0]

    def capture(lo, ld, t_init, tris, aabb, face0=0, stats=None, **k):
        if calls[0] in (0, 1, per_shade):
            captured[calls[0]] = ((lo, ld, t_init, tris, aabb, face0), k)
        calls[0] += 1
        return change_mesh_hit(lo, ld, t_init, tris, aabb, face0, stats, **k)
    use("change")
    M_.mesh_closest_hit_rays = capture
    try:
        render_wave(wscene, wf_cfg, cur_tab("wavefront"), o, d, ids,
                    torch.ones(W * H, dtype=torch.bool, device=dev),
                    torch.Generator(device=dev).manual_seed(3), W * H,
                    inv_pixel=ids)
    finally:
        M_.mesh_closest_hit_rays = change_mesh_hit
    mesh = {label: captured[key] for key, label in (
        (0, "mesh primary"), (1, "mesh shadow"), (per_shade, "mesh bounce 1"))}

    # ---- 1. counters
    use("change")
    for name, (fn, n, key, rin, rout) in launches.items():
        stats = torch.zeros(W_.stats_size(n), dtype=torch.int64, device=dev)
        fn(stats=stats)
        st = stats.tolist()
        work = dict(zip(CS.STATS, st))
        rec = {"work": work, "walk": CS.walk_figures(work, st[W_.NSTAT:]),
               "ms_counters_on": events_ms(lambda: fn(stats=stats), reps=5),
               "bound": CS.bound(cur_tab(key), work, n, rin, rout)}
        result["counters"][name] = {"change": rec}
        print(f"[chip_ab] counters {name} change: work {json.dumps(work)}; "
              f"{json.dumps(rec['walk'])}; counters on "
              f"{rec['ms_counters_on']:.4f} ms; bound "
              f"{rec['bound']['bound_ms']:.5f} ms by "
              f"{rec['bound']['bound_by']}", flush=True)
    for name, (a, k) in mesh.items():
        stats = torch.zeros(M_.NSTAT, dtype=torch.int64, device=dev)
        change_mesh_hit(*a, **{**k, "stats": stats})
        result["counters"][name] = {"change": dict(zip(
            ("slab_tests", "pairs", "root_tests", "walks", "group_tests",
             "tile_tests", "leaf_tests"), stats.tolist()))}
        print(f"[chip_ab] counters {name} change: "
              f"{json.dumps(result['counters'][name]['change'])}",
              flush=True)

    # ---- 2. the small scene tables in shared memory or device memory
    for name in imm:
        fn = launches[name][0]
        check(W_.scene_staged(cur_tab(launches[name][2])),
              f"{name}: the scene tables are not staged")
        rec = {t: {"ms": [], "ms_profiler": []}
               for t in ("change", "device memory")}
        outs = {}
        for tag in ("change", "device memory", "device memory",
                    "change") * 2:
            use(tag)
            outs.setdefault(tag, flat_out(fn()))
            rec[tag]["ms"].append(events_ms(fn))
            rec[tag]["ms_profiler"].append(profiled_ms(fn, "wave_kernel"))
        use("change")
        check(torch.equal(outs["change"], outs["device memory"]),
              f"{name}: staging the scene tables changes the outputs")
        for tag, v in rec.items():
            print(f"[chip_ab] scene tables {name} "
                  f"{'shared memory' if tag == 'change' else tag}: "
                  f"{fmt(v['ms'])} ms (events), {fmt(v['ms_profiler'])} ms "
                  "(profiler)", flush=True)
        result["scene_smem"][name] = rec

    # ---- 2b. the MXU launches with and without the block order pass
    result["block_order"] = {}
    for name, (fn, n, key, _, _) in launches.items():
        if not tabs["change"][key].mxu:
            continue
        rec = {t: {"ms": [], "ms_profiler": []}
               for t in ("change", "unordered")}
        outs = {}
        for tag in ("change", "unordered", "unordered", "change") * 2:
            use(tag)
            outs.setdefault(tag, flat_out(fn()))
            rec[tag]["ms"].append(events_ms(fn))
            rec[tag]["ms_profiler"].append(profiled_ms(fn, "wave_kernel"))
        use("change")
        check(torch.equal(outs["change"], outs["unordered"]),
              f"{name}: the block order changes the outputs")
        rec["block_order_ms_profiler"] = profiled_ms(fn, "block_order")
        for tag in ("change", "unordered"):
            print(f"[chip_ab] block order {name} {tag}: {fmt(rec[tag]['ms'])}"
                  f" ms (events), {fmt(rec[tag]['ms_profiler'])} ms "
                  "(profiler, wave_kernel)", flush=True)
        print(f"[chip_ab] block order {name}: block_order "
              f"{rec['block_order_ms_profiler']:.4f} ms (profiler)",
              flush=True)
        result["block_order"][name] = rec

    # ---- 3. the parent against the change
    if parent is not None:
        turns = ("parent", "change", "change", "parent")
        for name, (fn, n, key, _, _) in launches.items():
            rec = {t: {"ms": [], "ms_profiler": []} for t in turns}
            outs = {}
            for tag in turns:
                use(tag)
                outs.setdefault(tag, flat_out(fn()))
                rec[tag]["ms"].append(events_ms(fn))
                rec[tag]["ms_profiler"].append(profiled_ms(fn,
                                                           "wave_kernel"))
            check(torch.equal(outs["change"], outs["parent"]),
                  f"{name}: the change's outputs differ from the parent's")
            use("parent")
            stats = torch.zeros(W_.NSTAT, dtype=torch.int64, device=dev)
            fn(stats=stats)
            torch.cuda.synchronize()
            pst = dict(zip(CS.STATS[:11], stats.tolist()[:11]))
            result["counters"][name]["parent"] = {"work": pst}
            use("change")
            for tag in ("parent", "change"):
                print(f"[chip_ab] {name} {tag}: {fmt(rec[tag]['ms'])} ms "
                      f"(events), {fmt(rec[tag]['ms_profiler'])} ms "
                      "(profiler)", flush=True)
            print(f"[chip_ab] counters {name} parent: work "
                  f"{json.dumps(pst)}", flush=True)
            result["launches"][name] = rec

        for name, (a, k) in mesh.items():
            rec = {t: {"ms_kernel_profiler": [], "ms_trace_call": []}
                   for t in turns}
            outs = {}
            for tag in turns:
                use(tag)

                def call(_a=a, _k=k):
                    return M_.mesh_closest_hit_rays(*_a, **_k)
                outs.setdefault(tag, flat_out(call()))
                rec[tag]["ms_trace_call"].append(events_ms(call))
                rec[tag]["ms_kernel_profiler"].append(
                    profiled_ms(call, "mesh_hit_kernel"))
            use("change")
            check(torch.equal(outs["change"], outs["parent"]),
                  f"{name}: the change's outputs differ from the parent's")
            use("parent")
            stats = torch.zeros(M_.NSTAT, dtype=torch.int64, device=dev)
            parent_mesh_hit(*a, stats=stats, **k)
            use("change")
            result["counters"][name]["parent"] = dict(zip(
                ("slab_tests", "pairs"), stats.tolist()[:2]))
            result["mesh_closest_hit"][name] = rec
            for tag in ("parent", "change"):
                print(f"[chip_ab] {name} {tag}: kernel "
                      f"{fmt(rec[tag]['ms_kernel_profiler'])} ms (profiler);"
                      f" as a trace calls it {fmt(rec[tag]['ms_trace_call'])}"
                      " ms (events)", flush=True)
            print(f"[chip_ab] counters {name} parent: "
                  f"{json.dumps(result['counters'][name]['parent'])}",
                  flush=True)
            if not flat_mesh:
                continue
            # the parent's kernel over no tiles (rays packed once): its
            # floor
            lib = libs["parent"]["mesh_hit"]
            rays8, n = PM.pack_rays(*a[0:3])
            tris, aabb, face0 = a[3:6]
            outb = [torch.empty(n, device=dev) for _ in range(5)]
            outb[1] = torch.empty(n, dtype=torch.int32, device=dev)

            def floor(_r=rays8, _t=tris, _b=aabb, _f=face0, _o=outb, _n=n):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.rtf_mesh_hit_launch(
                    ctypes.c_void_p(_r.data_ptr()), _n,
                    ctypes.c_void_p(_t.data_ptr()), _t.stride(0), 0,
                    ctypes.c_void_p(_b.data_ptr()), int(_f),
                    *(ctypes.c_void_p(x.data_ptr()) for x in _o),
                    ctypes.c_void_p(0), ctypes.c_void_p(stream))
                check(rc == 0, f"the parent's mesh kernel failed ({rc})")
            rec["parent_nt0"] = {"ms": events_ms(floor),
                                 "ms_profiler": profiled_ms(
                                     floor, "mesh_hit_kernel")}
            print(f"[chip_ab] {name} parent with nt = 0: "
                  f"{rec['parent_nt0']['ms']:.4f} ms (events), "
                  f"{rec['parent_nt0']['ms_profiler']:.4f} ms (profiler); "
                  f"{n} rays", flush=True)

        frames = {
            "main": lambda: render(scenes["main"], main_cfg,
                                   tables=cur_tab("main"), device=dev),
            "textured": lambda: render(scenes["textured"], main_cfg,
                                       tables=cur_tab("textured"),
                                       device=dev),
            "gi": lambda: render(scenes["gi"], gi_cfg, tables=cur_tab("gi"),
                                 device=dev),
            "hybrid": lambda: render(
                scenes["hybrid"], hyb_cfg, tables=cur_tab("hybrid"),
                gi_vol=vols["hybrid"][0], caustic_vol=vols["hybrid"][1],
                device=dev),
            "wavefront": lambda: render(scenes["wavefront"], wf_cfg,
                                        tables=cur_tab("wavefront"),
                                        device=dev),
            "mxu": lambda: render(scenes["mxu"], main_cfg,
                                  tables=cur_tab("mxu"), device=dev),
            "hybrid_mxu": lambda: render(
                scenes["hybrid_mxu"], hyb_cfg, tables=cur_tab("hybrid_mxu"),
                gi_vol=vols["hybrid_mxu"][0],
                caustic_vol=vols["hybrid_mxu"][1], device=dev),
            "ball": lambda: render(scenes["ball"], main_cfg,
                                   tables=cur_tab("ball"), device=dev),
        }
        for name, fn in frames.items():
            rec = {}
            for tag in turns:
                use(tag)
                rec.setdefault(tag, []).append(frame_s(fn))
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
