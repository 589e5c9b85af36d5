#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtf_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with a CUDA card and nvcc.  It
imports only the port, torch and numpy, and exits nonzero on any failure:

1. build    builds the wave kernel (both variants) from the sources in the
            checkout and prints the build time;
2. kernel   holds the kernel against its plain PyTorch version on the card
            at 160x120 (box scene at bounces 0 and 4, soft shadows, a
            checker scene, glossy materials, waves with every other lane
            dead; the textured box at bounces 0 and 4, with the
            environment map on reflection misses in L1 and L2 form, and
            half dead) and at the main path's shape;
3. main     renders the main path (bench.py's scene and config: the box
            scene at 800x600, 64 spp, 4 bounces, hard shadows) through
            `render` on the card: one warm-up frame, best of 3, each frame
            counted (64 launches of the untextured variant); then the
            kernel's time per launch (CUDA events), the plain version's
            time per wave, and the kernel's work counts for its bound;
4. textured the same for the textured box (file textures on the walls'
            and the ball's kd, a checker on the mirror's ks, a file
            environment map) at 800x600, 64 spp, 4 bounces: 64 launches
            of the textured variant per frame.

Tolerances: at bounce 0 the hit masks are equal, radiance within atol
2e-4 and z within rtol 1e-4 on hits; past bounce 0 a rounding difference
may flip a Russian-roulette choice, so at most 1% of lanes may lie outside
atol 2e-4 and the mean radiance agrees within 1%.  Dead lanes give
exactly zero radiance and no hit.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  The frames are written to
build/chip_smoke_main.png and build/chip_smoke_textured.png.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, SPP, BOUNCES = 800, 600, 64, 4
SMALL = (160, 120)
ATOL, ZTOL, FLIP_SHARE, MEAN_TOL = 2e-4, 1e-4, 0.01, 0.01

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# FP32 operations per unit of kernel work, counted by hand from
# rtf_tpu_torch/csrc/wave_kernel.cu (add, mul, div, sqrt, floor, min/max
# and compare count 1 each; expf/powf/sinf/cosf/asinf count 1): a lower
# bound.  A texture sample includes its map's transform, the tiling and
# the product with the colour it scales; env is the angular-map uv.
OPS = dict(sphere=73, plane=46, inst=42, slab=26, tri=40, shade=250,
           shadow=12, tex_file=62, tex_checker=22, env=19)
STATS = ["rays", "hits", "shadow", "tiles", "tri_closest", "tri_shadow",
         "prim_shadow", "inst", "tex_file", "tex_checker", "env"]


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def checker_desc(box_scene, w, h):
    """The box scene with scaled checker maps on the walls' kd (plane uv)
    and the mirror's ks (sphere uv), as the CPU tests use."""
    import numpy as np
    from rtf_tpu_torch.core.transform import Transform
    from rtf_tpu_torch.scene.model import (
        TexMapDesc, TextureDesc, TexturedColorDesc)
    desc = box_scene(w, h, with_mesh=False)
    chk = TextureDesc(kind="checker", name="c",
                      color1=np.array([0.1, 0.1, 0.1]),
                      color2=np.array([0.9, 0.8, 0.2]))
    wall = desc.materials["wall"]
    wall.diffuse = TexturedColorDesc(
        wall.diffuse.color, TexMapDesc(chk, Transform().scale(0.25)))
    mirror = desc.materials["mirror"]
    mirror.specular = TexturedColorDesc(
        mirror.specular.color,
        TexMapDesc(chk, Transform().scale(0.125).translate([0.1, 0, 0])))
    return desc


def textured_desc(box_scene, w, h, seed=0):
    """The textured box (tests/test_torch_common.py::textured_desc builds
    the same): file texture A (512x512) on the walls' kd through
    Transform().scale(0.25), B (256x256) on the ball's kd (spherical
    vertex uv), the scaled checker on the mirror's ks and C (512x512) as
    the environment map with colour (1, 1, 1); texels float32 in [0, 1)
    from np.random.RandomState(seed), drawn A, B, C."""
    import numpy as np
    from rtf_tpu_torch.core.transform import Transform
    from rtf_tpu_torch.scene.model import (
        TexMapDesc, TextureDesc, TexturedColorDesc)
    desc = box_scene(w, h, with_mesh=True)
    rng = np.random.RandomState(seed)
    tex_a, tex_b, tex_c = (
        TextureDesc(kind="file", name=name,
                    data=rng.rand(n, n, 3).astype(np.float32))
        for name, n in (("A", 512), ("B", 256), ("C", 512)))
    chk = TextureDesc(kind="checker", name="c",
                      color1=np.array([0.1, 0.1, 0.1]),
                      color2=np.array([0.9, 0.8, 0.2]))
    wall = desc.materials["wall"]
    wall.diffuse = TexturedColorDesc(
        wall.diffuse.color, TexMapDesc(tex_a, Transform().scale(0.25)))
    ball = desc.materials["redball"]
    ball.diffuse = TexturedColorDesc(ball.diffuse.color, TexMapDesc(tex_b))
    mirror = desc.materials["mirror"]
    mirror.specular = TexturedColorDesc(
        mirror.specular.color,
        TexMapDesc(chk, Transform().scale(0.125).translate([0.1, 0.0, 0.0])))
    desc.environment = TexturedColorDesc(np.ones(3), TexMapDesc(tex_c))
    mesh = next(n.mesh for n in desc.root.children if n.obj_kind == "mesh")
    v = mesh.v.astype(np.float64)
    mesh.vt = np.stack([0.5 + np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi),
                        0.5 + np.arcsin(np.clip(v[:, 2], -1, 1)) / np.pi,
                        np.zeros(len(v))], axis=1).astype(np.float32)
    mesh.ft = mesh.f.copy()
    return desc


def compare(name, plain, kern, alive, bounces):
    """Kernel vs plain on the same lanes; returns (max abs err, share of
    lanes outside ATOL)."""
    import torch
    (pr, ph, pz), (kr, kh, kz) = plain, kern
    check(bool(torch.isfinite(kr).all()), f"{name}: kernel output not finite")
    dead = ~alive
    check(not bool(kh[dead].any()) and bool((kr[:, dead] == 0).all()),
          f"{name}: a dead lane hit or has radiance")
    check(bool((ph == kh).all()),
          f"{name}: hit masks differ on {int((ph != kh).sum())} lanes")
    err = (kr - pr).abs()
    max_err = float(err.max())
    share = float((err > ATOL).any(dim=0).float().mean())
    mean_p, mean_k = float(pr.mean()), float(kr.mean())
    print(f"[kernel] {name}: max_abs_err={max_err:.3e} "
          f"share_outside_{ATOL:g}={share:.5f} mean plain={mean_p:.6f} "
          f"kernel={mean_k:.6f}", flush=True)
    if bounces == 0:
        check(max_err <= ATOL, f"{name}: max abs err {max_err} > {ATOL}")
        zrel = ((kz - pz).abs() / pz.abs().clamp(min=1e-30))[ph]
        check(zrel.numel() == 0 or float(zrel.max()) <= ZTOL,
              f"{name}: z differs beyond rtol {ZTOL}")
    else:
        check(share <= FLIP_SHARE,
              f"{name}: {share:.4f} of lanes outside {ATOL} > {FLIP_SHARE}")
        check(abs(mean_k - mean_p) <= MEAN_TOL * abs(mean_p),
              f"{name}: mean radiance {mean_k} vs {mean_p}")
    check(mean_p > 0.0, f"{name}: black image")
    return max_err, share


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not (ROOT / "rtf_tpu_torch" / "csrc").is_dir():
        fail(f"rtf_tpu_torch/ not found beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from rtf_tpu_torch import _build
    from rtf_tpu_torch.render import wave as W_
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays_ch
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    from rtf_tpu_torch.utils.png import write_png

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}"
          f" on {kind} ({card})", flush=True)

    # ---- phase 1: build
    t0 = time.perf_counter()
    log = _build.build()
    build_s = time.perf_counter() - t0
    for line in log.splitlines():
        # per variant: wave_kernel<false> (Lb0) and wave_kernel<true> (Lb1)
        if any(k in line for k in ("registers", "spill", "entry function")):
            print(f"[build] wave: {line.strip()}", flush=True)
    print(f"[build] built {_build.library_path().name} in {build_s:.2f} s",
          flush=True)
    _build.load()

    def rays(scene, j=0):
        order = torch.as_tensor(pixel_order(scene.width, scene.height),
                                device=dev).to(torch.int64)
        return primary_rays_ch(scene, order % scene.width,
                               order // scene.width, torch.tensor(j))

    def both(cfg, tables, o3, d3, seed, dead_every_other=False):
        alive = torch.ones(o3.shape[1], dtype=torch.bool, device=dev)
        if dead_every_other:
            alive[::2] = False
        plain = W_.wave_plain(cfg, tables, o3, d3, alive, seed)
        kern = W_.wave(cfg, tables, o3, d3, alive, seed)
        torch.cuda.synchronize()
        return plain, kern, alive

    # ---- phase 2: kernel against its plain version
    base = RenderConfig(min_samples=SPP, max_samples=SPP, bounces=0,
                        shadow_min=1, shadow_max=1, gi_mode="none")
    glossy = box_scene(*SMALL, with_mesh=False)
    glossy.materials["mirror"].reflection_glossiness = 0.15
    glossy.materials["glass"].refraction_glossiness = 0.15
    soft = base.with_(shadow_min=4, shadow_max=16)
    env = base.with_(bounces=4, env_on_reflect_miss=True)
    textured = textured_desc(box_scene, *SMALL)
    cases = [
        ("box b0", box_scene(*SMALL), base, 123, False),
        ("box b4", box_scene(*SMALL), base.with_(bounces=4), 2 ** 31 - 5,
         False),
        ("soft b0", box_scene(*SMALL, light_size=1.0), soft, 2 ** 31 - 5,
         False),
        ("soft b4", box_scene(*SMALL, light_size=1.0),
         soft.with_(bounces=4), 77, False),
        ("checker b0", checker_desc(box_scene, *SMALL), base, 1, False),
        ("glossy b4", glossy, base.with_(bounces=4), 5, False),
        # the adaptive ladder's later rungs run waves with masked lanes
        ("box b4 half dead", box_scene(*SMALL), base.with_(bounces=4), 31,
         True),
        ("soft b0 half dead", box_scene(*SMALL, light_size=1.0), soft, 8,
         True),
        # the textured variant: file textures, checker, environment map
        ("textured b0", textured, base, 3, False),
        ("textured b4", textured, base.with_(bounces=4), 2 ** 31 - 5, False),
        ("textured env b4", textured, env, 41, False),
        ("textured env l2 b4", textured, env.with_(env_l2=True), 43, False),
        ("textured b4 half dead", textured, env, 47, True),
    ]
    for name, desc, cfg, seed, dead in cases:
        scene = build_scene(desc, device=dev)
        tables = scene_tables(scene)
        check(tables.textured == name.startswith("textured"),
              f"{name}: wrong kernel variant")
        o3, d3 = rays(scene, 3)
        plain, kern, al = both(cfg, tables, o3, d3, seed, dead)
        compare(f"{name} {SMALL[0]}x{SMALL[1]}", plain, kern, al,
                cfg.bounces)
    print("[kernel] phase passed", flush=True)

    cfg = RenderConfig(min_samples=SPP, max_samples=SPP, bounces=BOUNCES,
                       shadow_min=1, shadow_max=1, gi_mode="none")
    check(cfg.resolved_split_mode() == "rr", "main path must run split rr")
    counters = ("launches", "launches_textured")

    def drive(tag, desc, small_desc, counter):
        """Render one path at W x H through `render`, counting the
        kernel's launches in `counter`; then the kernel against the plain
        version at this shape, its time per launch, its work counts and
        bound, and the plain version's time per wave."""
        scene = build_scene(desc, device=dev)
        tables = scene_tables(scene)
        check(tables.textured == (counter == "launches_textured"),
              f"{tag}: wrong kernel variant")
        o3, d3 = rays(scene, 0)
        n = W * H
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        err0, _ = compare(f"{tag} b0 {W}x{H}",
                          *both(cfg.with_(bounces=0), tables, o3, d3, 11), 0)
        err4, share4 = compare(f"{tag} b{BOUNCES} {W}x{H}",
                               *both(cfg, tables, o3, d3, 11), BOUNCES)

        render(scene, cfg, device=dev, tables=tables)     # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            for c in counters:
                setattr(W_, c, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, cfg, seed=1 + rep, device=dev, tables=tables)
            dt = time.perf_counter() - t0
            counts = {c: getattr(W_, c) for c in counters}
            launches = counts[counter]
            check(launches == SPP and sum(counts.values()) == SPP,
                  f"{tag} frame {rep}: launches {counts}, expected {SPP} "
                  f"of {counter}")
            check(np.isfinite(out.radiance).all(), "non-finite radiance")
            check(out.image.shape == (H, W, 3),
                  f"image shape {out.image.shape}")
            check((out.sample_count == SPP).all(), "sample counts != spp")
            check(out.image.mean() > 5.0, "frame is black")
            if dt < frame_s:
                frame_s, res = dt, out
        mrays = 2.0 * W * H * SPP / frame_s / 1e6
        (ROOT / "build").mkdir(exist_ok=True)
        png = ROOT / "build" / f"chip_smoke_{tag}.png"
        write_png(str(png), res.image)
        print(f"[{tag}] frame {W}x{H} {SPP}spp {BOUNCES} bounces: best of 3 "
              f"{frame_s:.4f} s, {mrays:.2f} Mrays/s (2*W*H*spp/t), "
              f"{launches} launches/frame, mean byte {res.image.mean():.2f}, "
              f"png {png.relative_to(ROOT)}", flush=True)

        # where one frame's device time goes (torch.profiler over one frame)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render(scene, cfg, seed=9, device=dev, tables=tables)
        dev_us, kern_us, kern_n = {}, 0.0, 0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                dev_us[ev.key] = us
                if "wave_kernel" in ev.key:
                    kern_us, kern_n = kern_us + us, kern_n + ev.count
        total_us = sum(dev_us.values())
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
        prof_ms = kern_us / max(kern_n, 1) / 1e3
        print(f"[{tag}] profiled frame: device busy {total_us / 1e3:.3f} ms "
              f"= {total_us / 1e4 / frame_s:.2f}% of the best frame; wave "
              f"kernel {kern_n} launches, {prof_ms:.4f} ms each; top: "
              + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top),
              flush=True)

        # kernel time per launch (CUDA events) and its work counts.  The
        # device first sleeps while the host queues every launch, so the
        # host's per-wave work leaves no gaps in the timed run (what is
        # timed is the kernel and the wrapper's small ray-packing ops).
        reps = 20
        for _ in range(3):
            W_.wave(cfg, tables, o3, d3, alive, 11)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        e0.record()
        for _ in range(reps):
            W_.wave(cfg, tables, o3, d3, alive, 11)
        e1.record()
        torch.cuda.synchronize()
        kern_ms = e0.elapsed_time(e1) / reps
        stats = torch.zeros(W_.NSTAT, dtype=torch.int64, device=dev)
        W_.wave(cfg, tables, o3, d3, alive, 11, stats=stats)
        st = dict(zip(STATS, stats.tolist()))
        ns, np_ = tables.spheres.shape[0], tables.planes.shape[0]
        flops = (st["rays"] * (ns * OPS["sphere"] + np_ * OPS["plane"])
                 + st["inst"] * OPS["inst"] + st["tiles"] * OPS["slab"]
                 + (st["tri_closest"] + st["tri_shadow"]) * OPS["tri"]
                 + st["prim_shadow"] * OPS["plane"]
                 + st["hits"] * OPS["shade"] + st["shadow"] * OPS["shadow"]
                 + st["tex_file"] * OPS["tex_file"]
                 + st["tex_checker"] * OPS["tex_checker"]
                 + st["env"] * OPS["env"])
        # each input once: 7 floats in and 5 out per ray, the tables, and
        # the atlas's texels at 12 bytes (its float4 padding is the
        # kernel's choice, not the function's)
        table_bytes = sum(getattr(tables, k).numel() * 4 for k in (
            "spheres", "planes", "mesh_insts", "tiles", "faces", "materials",
            "lights", "texmaps", "textures"))
        texels = tables.atlas.shape[0] if tables.has_file_tex else 0
        nbytes = n * 7 * 4 + n * 5 * 4 + table_bytes + texels * 12
        # the same with four 16-byte texel reads per file-texture sample
        # instead of the atlas once
        nbytes_reads = nbytes - texels * 12 + st["tex_file"] * 4 * 16
        bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_reads_ms = max(nbytes_reads / HBM_BPS * 1e3, ops_ms)
        print(f"[{tag}] kernel {kern_ms:.4f} ms/launch at {W}x{H} (mean of "
              f"{reps}, CUDA events); work {json.dumps(st)}; {flops:.4e} "
              f"FP32 ops, {nbytes} bytes; bound {bound_ms:.4f} ms "
              f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f}); with four texel "
              f"reads per sample {nbytes_reads} bytes, bound "
              f"{bound_reads_ms:.4f} ms", flush=True)

        # the plain version's time per wave, at this shape and at 160x120
        def plain_ms(tables_, o3_, d3_, reps_):
            al = torch.ones(o3_.shape[1], dtype=torch.bool, device=dev)
            W_.wave_plain(cfg, tables_, o3_, d3_, al, 11)
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            for _ in range(reps_):
                W_.wave_plain(cfg, tables_, o3_, d3_, al, 11)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0_) / reps_ * 1e3
        plain_main = plain_ms(tables, o3, d3, 2)
        small = build_scene(small_desc, device=dev)
        plain_small = plain_ms(scene_tables(small), *rays(small, 0), 5)
        print(f"[{tag}] plain wave {plain_main:.2f} ms at {W}x{H}, "
              f"{plain_small:.2f} ms at {SMALL[0]}x{SMALL[1]}", flush=True)
        print(f"[{tag}] phase passed", flush=True)
        return {
            "launches": launches, "max_abs_err": err4,
            "max_abs_err_bounce0": err0, "share_outside_atol": share4,
            "ms": kern_ms, "ms_profiler": prof_ms, "plain_ms": plain_main,
            "plain_ms_160x120": plain_small, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_texel_reads": bound_reads_ms,
            "library_ms": None, "frame_s": frame_s, "mrays_per_s": mrays,
            "work": st}

    # ---- phase 3: the main path (untextured variant)
    main_k = drive("main", box_scene(W, H, with_mesh=True),
                   box_scene(*SMALL, with_mesh=True), "launches")
    # ---- phase 4: the textured box at full width (textured variant)
    tex_k = drive("textured", textured_desc(box_scene, W, H),
                  textured_desc(box_scene, *SMALL), "launches_textured")

    print(card, flush=True)
    kernels = [
        {"name": "wave", "route": "cuda",
         "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
         "replaces": "rtf_tpu/render/fused.py:1741", **main_k,
         "build_s": build_s},
        {"name": "wave_textured", "route": "cuda",
         "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
         "replaces": "rtf_tpu/render/fused_seg.py:482 and :516", **tex_k,
         "build_s": build_s}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
