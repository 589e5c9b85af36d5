#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtf_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [phase ...]

Run from the root of a checkout, on a host with a CUDA card and nvcc.  It
imports only the port, torch and numpy, and exits nonzero on any failure.
With no arguments it runs every phase; given phase numbers, the build and
those phases only (for iterating on one path):

1. build    builds the four kernel libraries (one nvcc per source, started
            together): the wave kernel (its eight variants: untextured or
            textured, with or without GI rows, the immediates mesh or the
            MXU tables), mesh_closest_hit, mesh_closest_hit_mxu and
            bvh_closest_hit, from the sources in the checkout, and prints
            the build time and register counts; then loads the host
            library (native/bvh_builder.cpp, built with the system C++
            compiler if missing);
2. kernel   holds the kernel against its plain PyTorch version on the card
            at 160x120 (box scene at bounces 0 and 4, soft shadows, a
            checker scene, glossy materials, waves with every other lane
            dead; the textured box at bounces 0 and 4, with the
            environment map on reflection misses in L1 and L2 form, and
            half dead) and at the main path's shape; then the GI rows in
            both variants at 160x120 and 800x600: first-hit surface rows,
            query rows from bounce 1 and from bounce 0, and a hemisphere
            child wave (non-unit throughput, RT_REFRACT, every other lane
            dead) without and with query rows;
3. main     renders the main path (bench.py's scene and config: the box
            scene at 800x600, 64 spp, 4 bounces, hard shadows) through
            `render` on the card: one warm-up frame, best of 3, each frame
            counted (64 launches of the untextured variant); then the
            kernel against its plain version at bounces 0 and 4 at full
            width (exact), the kernel's time per launch (CUDA events,
            profiler), the plain version's time per wave, and the kernel's
            counters (work for its bound; the walk's slab tests per level,
            face tests, SIMT efficiency, lane cycles by part, each block's
            cycles);
4. textured the same for the textured box (file textures on the walls'
            and the ball's kd, a checker on the mirror's ks, a file
            environment map) at 800x600, 64 spp, 4 bounces: 64 launches
            of the textured variant per frame;
5. gi       bench.py's GI cell (bench.py:177-192): the box at 400x300,
            8 spp, 2 bounces, gi_mode "hemisphere" with 4 hemisphere
            samples: one warm-up frame, best of 3, each frame counted
            (8 x (1 + 4) = 40 launches of the untextured variant); then
            at the path's own shape, per launch kind (the primary launch
            with its rows, a child launch), the kernel against its plain
            version, its time, work counts and bound, and the whole GI
            sample wave (`gi_wave` on the kernel against `gi_wave` on the
            plain version, the same uniforms and volumes) with its time;
6. hybrid   the reference's Final structure at full width: the textured
            box at 800x600, 8 spp, 4 bounces, shadow samples 4/16 (the
            box's light has no size, so the shadows stay hard and the
            4-16 escalation does not run here; phase 2's "soft" cases
            hold it against the plain version), gi_mode "photon" with 30
            hemisphere samples, a photon volume and a caustic volume (each
            60x60x45 cells, 171,166 corners, spanning the box, table from
            a numpy seed): 8 x 31 = 248 launches of the textured variant
            per frame, and the checks and figures of phase 5;
7. wavefront the XLA wavefront's port with the mesh_closest_hit kernel:
            the kernel against its plain version on one wave's own inputs
            (the 480,000 primary rays of the 800x600 box, a batch of its
            shadow rays, the first bounce's compacted queue with dead
            lanes; exact), then
            RenderConfig() (4 -> 8 spp, 4 bounces, the 'both' split, soft
            shadows 4 -> 16) on box_scene(800, 600, light_size=1.0) through
            `render`: one warm-up frame, best of 3, each frame's launches
            counted (per shade_lanes 1 + 4 + 16 traces, 5 shade_lanes a
            wave, 8 waves: 840); one wave profiled; the kernel's time per
            launch (CUDA events, profiler), work counts (slab tests per
            level of its box hierarchy, pairs) and bound, and the plain
            version's; a 160x120 frame with the kernel against the
            same frame with the plain version put in the kernel's place
            (exact: the splat sums each pixel's lanes in lane order), and a
            wavefront GI frame (400x300, 4 spp, 2 bounces, 4 hemisphere
            samples) that must add light;
8. mxu      the main path's config (800x600, 64 spp, 4 bounces, hard
            shadows) on box_scene(800, 600, mesh_subdiv=5): a 20,480-face
            ball (160 tiles in 20 groups) on the MXU tables, so the
            untextured MXU variant: phase 3's checks and figures (kernel
            against plain at bounce 0 and 4 at full width, exact; 64
            launches a frame, best of 3, profile, events, work counters
            and bound), the walk's counters (slab tests of each level,
            pairs, SIMT efficiency of the walk and of the pair loops, the
            bounce loop's cycles by part, each block's cycles) with the
            bound on these counts, a 160x120 frame at mesh_subdiv=6
            (81,920 faces) with the kernel against the same frame with the
            plain wave put in the kernel's place (exact); then
            mesh_closest_hit_mxu against the ball's Plücker matrix (40
            tiles of 512 faces) on two sets of 480,000 rays in the ball's
            local space, the frame's primary rays and a seeded scattered
            set (origins in twice the ball's box, uniform directions):
            each against its plain version on every 7th ray (68,608,
            exact), its counters (pairs filtered, re-checked and valid;
            tiles with a survivor), its time (CUDA events, profiler), its
            bound (TF32 products, the FP32 filter and re-checks, bytes;
            beside it the FP32-only bound and the issue floor of the hot
            loop in the library's SASS); the primary rays against
            mesh_closest_hit (the same hit mask, faces equal but for a
            stated share of shared-edge rays);
9. hybrid_mxu phase 6's hybrid frame (800x600, 8 spp, 4 bounces, photon GI
            with 30 hemisphere samples, photon and caustic volumes) on the
            textured box with the 20,480-face ball: the textured MXU
            variant with GI rows and, on every child wave, the lane
            permutation of render/gi.py::gi_mesh_perm; phase 6's checks
            and figures (every kernel-against-plain case exact), and per
            launch kind the walk's counters as in phase 8;
10. photons a scene-file set written into build/photon_scene (an XML with
            the box's 5 planes, a mirror and a glass sphere and two point
            lights; the 320-face icosphere as an OBJ whose MTL gives two
            sub-materials; a PNG and a PPM texture), loaded with the
            port's load_scene and built at 800x600, rendered with the
            Final structure as rtf_tpu's CLI runs it (PROFILES["final"],
            split rr, 8 spp): prepare_caustic_grid (1,000,000 caustic
            photons) handed to `render` as caustic_grid, `render` given no
            global map, so it shoots 1,000,000 photons, builds both grids
            and bakes both volumes itself (8 x 9 + 8 x 6 = 120 launches of
            mesh_closest_hit and 8 x 31 = 248 of the textured variant,
            counted); then each step timed alone (the passes, the grid
            builds, the bakes; stored photons, occupancy before and after
            the bake's cap, each volume's corners), the frame with both
            grids handed in (best of 3 after a warm-up, profiled), the GI
            launch kinds as in phase 6, one chunk of 131,072 photons with
            mesh_closest_hit against its plain version (the maps and the
            volumes baked from them equal), a 160x120 hybrid frame (2 spp,
            4 hemisphere samples) against the plain wave (exact), and the
            exact-gather wavefront frame at 160x120 (photon_volume=False,
            the caustic grid at primary hits): finite, lit, the time of
            estimate_irradiance a call and of _gather_pass alone;
11. cli     the port's command line as a user runs it on phase 10's scene
            files at 800x600, each call a fresh `python -m
            rtf_tpu_torch.cli` process with a timeout of its own: `render
            --profile proj11 --gi-cache --zbuffer --samplecount`, `render
            --profile final --caustics --photon-dump --spp 8` and `watch
            --spp 4 --resume --state` one at a time, then `photons --count
            1000000`, `preview`, `probe --pixel 400,300` and `view` in its
            three modes on watch's state at once, then `viz` on the .dat;
            each exit code, wall time and "Render time" line, every PNG
            read back (800x600, not constant; watch's sample-count view is
            constant, every pixel having 4 samples), each .dat reloaded
            with its count; then the irradiance cache in-process (proj11):
            the counted render_with_cache (the fused evaluator's textured
            GI launches, 20 a level, and mesh_closest_hit's first-hit and
            direct-pass launches), the build and the cached frame (best of
            3 after a warm-up, synchronised host clock), one profiled
            build, the evaluator's child launch at each level's shape
            (events, plain, bound), and, bit for bit, the evaluator at
            every level (20 hemisphere samples) against gi_chunks on
            the plain wave, `_first_hits` and the direct pass's first
            shadow trace against the plain mesh test and a 160x120
            render_with_cache against the plain wave;
12. bvh     the BVH walk, the dense mesh test, footprint filtering and the
            sharded render on box_scene(800, 600, mesh_subdiv=5,
            light_size=1.0), the 20,480-face ball: bvh_closest_hit
            (csrc/bvh_hit.cu's wide walk, the walk the depth rule takes
            on the ball) on one wave's 480,000 primary rays and first
            shadow batch and on a seeded scattered set about the ball
            against its plain twin bvh_wide_closest_hit_plain (every
            output and the counters equal) and against the lock-step
            walk bvh_closest_hit_plain (hit masks and t equal; faces,
            front, ba and bb equal but at near ties, each printed with
            both faces, at most 1 in 10^5 rays), and against
            mesh_closest_hit (hit masks equal, t within rtol 1e-4 and
            atol 1e-6, faces equal but at equal-t ties, counted; rays
            through a shared edge, a barycentric below 1e-5 in either
            test, may slip between its two faces in one of the two
            triangle tests: counted, at most 1 in 10,000 rays); its time
            (CUDA events, profiler), counters (pops, box and face tests,
            the most pops of a ray), its bound over the wide tables and
            over the binary walk's, and the plain walks' times; the
            binary walk on the ball with max_depth two below its levels
            (a capped tree)
            against the lock-step walk on the primary rays (every output
            and the counters equal); RenderConfig() with mesh_algo="bvh"
            through `render` (a warm-up, best of 3, 840 launches a frame
            counted, beside the same frame on mesh_closest_hit, one
            frame; one wave profiled) and 160x120 frames (1 spp, one
            shadow ray a light) against the same frames on the plain
            walks (exact): the wide walk against its twin, and on the
            capped tree the binary walk against the lock-step walk (its
            launches counted from 0 over that frame);
            mesh_algo="dense" on the primary rays against
            mesh_closest_hit (hit masks equal, t within rtol 1e-4) and a
            160x120 dense frame (finite, lit, timed); tex_filter on the
            textured box at 800x600 on the wavefront (finite, lit, pixels
            changed, timed beside the unfiltered frame); render_sharded on
            a 1x1 NCCL mesh (world size 1) against render_device_host on
            the main path's config, bit for bit, and on a 1x2 gloo mesh of
            two processes that share the card (`--gloo-rank`), each half
            the samples: hits, z and sample counts equal, radiance within
            rtol 1e-5 (atol 5e-5; the ranks' sums add in another order);
            then the same two processes on a 2x1 mesh, two tiles of 1536
            lanes (not a multiple of the wave kernel's 1024-lane blocks)
            of box_scene(64, 48) against one process (TILE_CFGS): the
            wavefront's adaptive frame and the fused `rr` frame at bounce
            0 per pixel (hits, z and sample counts equal, radiance within
            atol 5e-5), and the fused frame at 2 bounces with Russian
            roulette, whose streams move with the tile's first block
            (blk0), on its mean radiance (within 1%) with hits, z and
            sample counts equal;
13. large   a large user scene from files to a frame: write_large_scene
            writes into build/large_scene an XML with the box's planes and
            its sized point light, a 327,680-face icosphere (subdivision
            7) as an OBJ and a 2048x2048 RGB PNG on the back wall's kd,
            its rows cycling through the five filters; each part timed
            alone: the host library's build, load_scene (the XML, the
            OBJ, the PNG inside it), the PNG decoded with the host library
            and with unfilter_plain (equal), build_scene, ensure_bvh with
            the C++ and the NumPy builder (every array equal), the walk
            (its levels, the walk the depth rule takes, its stack need);
            RenderConfig() at 800x600 with mesh_algo="bvh" on the
            wavefront: a first frame with its set-up, best of 3 (840
            bvh_closest_hit launches a frame, counted), and on one wave's
            primary and shadow rays the wide walk against its twin
            bvh_wide_closest_hit_plain (every output and the counters
            equal); a fresh process's start-up split (import torch, the
            port's modules, the card's context, the ctypes libraries, the
            scene load) and one `python -m rtf_tpu_torch.cli render` of
            the scene (the CLI's default profile), its wall time and
            "Render time" line.  It adds no entry to the kernels line.

Tolerances: phase 2 at bounce 0 the hit masks are equal, radiance within
atol 2e-4 and z within rtol 1e-4 on hits; past bounce 0 a rounding
difference may flip a Russian-roulette choice, so at most 1% of lanes may
lie outside atol 2e-4 and the mean radiance agrees within 1%.  Phases 3-12
hold every kernel to its plain version bit for bit (max abs error 0.0),
the GI rows included.  Dead lanes give exactly zero radiance and no hit.

The GI rows follow the same rule: rows of bounce 0 (the surface rows,
the bounce-0 query) within atol 2e-4 + rtol 1e-4 on every lane, query rows
past bounce 0 with at most 1% of lanes outside and the mean within 1%;
every row is finite and the query weight is zero on dead lanes.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  The frames are written to
build/chip_smoke_{main,textured,gi,hybrid,wavefront,mxu,hybrid_mxu,
photons,bvh,tex_filter,large}.png, phase 11's files to build/cli/.
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
# outside the tensor cores, dense TF32 FLOP/s on them
HBM_BPS, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# FP32 operations per unit of kernel work, counted by hand from
# rtf_tpu_torch/csrc/wave_kernel.cu (add, mul, div, sqrt, floor, min/max
# and compare count 1 each; expf/powf/sinf/cosf/asinf count 1): a lower
# bound.  A texture sample includes its map's transform, the tiling and
# the product with the colour it scales; env is the angular-map uv.  A
# Plücker pair (csrc/plucker.cuh): its three six-term sums and the two
# winding tests, which every pair needs (the plane terms and the division
# of the few pairs inside a winding are not counted); cross is o x d, once
# per instance and ray on the MXU tables; filter is the dense closest
# hit's sign filter a pair (csrc/mesh_hit_mxu.cu: 3 adds, 3 logic
# operations).  The BVH walk (csrc/bvh_hit.cu): inv is a ray's 1/d with
# its guards, once a ray; box a slab test with its entry distance; bvh_tri
# intersect_triangle with its normalisation, one projected area per call
# (the binary walk); wide_tri the wide walk's test on a face row (the plane
# distance, one division, the projected point, two projected areas, the
# validity tests).
OPS = dict(sphere=73, plane=46, inst=42, slab=26, tri=40, shade=250,
           shadow=12, tex_file=62, tex_checker=22, env=19, pair=39, cross=9,
           filter=6, inv=12, box=40, bvh_tri=105, wide_tri=52)
# the wave kernel's counters (csrc/wave_kernel.cu, STAT_*): work, then on
# the MXU variants the walk's slab tests, cycles by part (summed over
# lanes) and warp-iterations with their active lanes
STATS = ["rays", "hits", "shadow", "tiles", "tri_closest", "tri_shadow",
         "prim_shadow", "inst", "tex_file", "tex_checker", "env", "root",
         "groups", "leaves", "cyc_root", "cyc_walk", "cyc_pair",
         "cyc_bounces", "walk_iters", "walk_lanes", "pair_iters",
         "pair_lanes", "root_in", "cyc_prim", "cyc_shadow", "cyc_later"]
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


def dense_inputs(X_, scene, dev, seed=8):
    """mesh_closest_hit_mxu's inputs in phase 8: the Plücker matrix of the
    scene's first mesh slot (the 20,480-face ball: 40 tiles of 512 faces)
    and two sets of width x height rays in the ball's local space, each
    packed by pack_rays16 (800 x 600: 480,256 rows16): "primary" the
    frame's primary rays, "scattered" a seeded set with origins uniform in
    twice the ball's box about its centre and uniform directions.  Also
    the primary rays' local o, d and t_init."""
    import numpy as np
    import torch
    from rtf_tpu_torch.ops.trace import _to_local
    from rtf_tpu_torch.render.camera import pixel_order, primary_rays
    mesh = scene.mesh
    f0, f1 = mesh.slot_faces[0]
    abc = [getattr(mesh, k)[f0:f1].cpu().numpy() for k in
           ("tri_a", "tri_b", "tri_c")]
    trim = torch.as_tensor(X_.pack_tri_matrix(*abc), device=dev)
    w, n = scene.width, scene.width * scene.height
    order = torch.as_tensor(pixel_order(w, scene.height),
                            device=dev).to(torch.int64)
    o, d = primary_rays(scene, order % w, order // w, torch.tensor(0))
    lo, ld = _to_local(scene.mesh_inst.itm[0], scene.mesh_inst.pos[0], o, d)
    t_init = torch.full((n,), 1e30, device=dev)
    v = np.concatenate(abc)
    rng = np.random.RandomState(seed)
    so = (v.min(0) + v.max(0)) / 2 + (v.max(0) - v.min(0)) * rng.uniform(
        -1.0, 1.0, (n, 3))
    sd = rng.normal(size=(n, 3))
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    sets = {"primary": X_.pack_rays16(lo, ld, t_init)[0],
            "scattered": X_.pack_rays16(
                torch.as_tensor(so.astype(np.float32), device=dev),
                torch.as_tensor(sd.astype(np.float32), device=dev),
                t_init)[0]}
    return trim, sets, (lo, ld, t_init)


def sass(lib):
    """cuobjdump -sass of a built library (the CUDA toolkit's, beside
    nvcc)."""
    from rtf_tpu_torch import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    return out.stdout


def sass_fast_path(text, kernel):
    """Instructions per iteration of the hot loop of `kernel` (a substring
    of its mangled name) in cuobjdump output, on the path that most pairs
    take: the innermost loop (a branch back to a lower address) around the
    first HMMA, else the first FMNMX; minus the code that conditional
    forward branches skip: the one after each VOTE.ANY (the filter's rare
    path), or, without a vote, the one with the farthest target (the pair
    test's plane terms and division).  Returns (instructions, votes,
    HMMA) per iteration."""
    import re
    body = text.split("Function : ")
    body = next(b for b in body if b.split()[0].find(kernel) >= 0
                and "ILb1E" not in b.split()[0])
    ins = []    # (address, text)
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    first = next((a for a, t in ins if "HMMA" in t), None)
    if first is None:
        first = next(a for a, t in ins if "FMNMX" in t)

    def target(t):
        m = re.search(r"BRA\s+(?:!?P\d,\s*)?0x([0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None
    loops = [(target(t), a) for a, t in ins
             if target(t) is not None and target(t) <= first <= a]
    head, back = min(loops, key=lambda r: r[1] - r[0])
    span = [(a, t) for a, t in ins if head <= a <= back]
    skips = []
    for k, (a, t) in enumerate(span):
        if k and "VOTE.ANY" in span[k - 1][1] and target(t) is not None:
            skips.append((a, target(t)))
    if not skips:
        fwd = [(a, target(t)) for a, t in span if t.startswith("@")
               and target(t) is not None and a < target(t) <= back]
        skips = [max(fwd, key=lambda r: r[1])]
    fast = [t for a, t in span if not any(x < a < y for x, y in skips)]
    return (len(fast), sum(t.startswith("VOTE.ANY P") for t in fast),
            sum("HMMA" in t for t in fast))


def bvh_sets(B_, scene, one_wave, per_wave, dev):
    """Phase 12's three ray sets for bvh_closest_hit on the scene's one
    mesh slot, as the wavefront hands them to it: one wave's primary rays
    and its first shadow batch (one_wave() run once, its walks captured),
    and W*H seeded scattered rays about the mesh: {name: (o, d, t_init)}."""
    import numpy as np
    import torch
    captured, calls = {}, [0]
    kernel_fn = B_.bvh_closest_hit

    def capture(mesh_, root_, lo, ld, t_init, stats=None):
        if calls[0] in (0, 1):
            captured[calls[0]] = (lo, ld, t_init)
        calls[0] += 1
        return kernel_fn(mesh_, root_, lo, ld, t_init, stats)
    B_.bvh_closest_hit = capture
    try:
        one_wave()
    finally:
        B_.bvh_closest_hit = kernel_fn
    check(calls[0] == per_wave, f"bvh: one wave made {calls[0]} walks, "
          f"expected {per_wave}")
    mesh = scene.mesh
    v = torch.cat([mesh.tri_a, mesh.tri_b, mesh.tri_c]).cpu().numpy()
    rng = np.random.RandomState(12)
    so = (v.min(0) + v.max(0)) / 2 + (v.max(0) - v.min(0)) * \
        rng.uniform(-1.0, 1.0, (W * H, 3))
    sd = rng.normal(size=(W * H, 3))
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    return {"primary": captured[0], "shadow": captured[1],
            "scattered": (torch.as_tensor(so.astype(np.float32), device=dev),
                          torch.as_tensor(sd.astype(np.float32), device=dev),
                          torch.full((W * H,), 1e30, device=dev))}


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


def textured_desc(box_scene, w, h, seed=0, mesh_subdiv=2):
    """The textured box (tests/test_torch_common.py::textured_desc builds
    the same): file texture A (512x512) on the walls' kd through
    Transform().scale(0.25), B (256x256) on the ball's kd (spherical
    vertex uv), the scaled checker on the mirror's ks and C (512x512) as
    the environment map with colour (1, 1, 1); texels float32 in [0, 1)
    from np.random.RandomState(seed), drawn A, B, C.  mesh_subdiv sizes the
    ball (2: 320 faces, the immediates; 5: 20,480, the MXU tables)."""
    import numpy as np
    from rtf_tpu_torch.core.transform import Transform
    from rtf_tpu_torch.scene.model import (
        TexMapDesc, TextureDesc, TexturedColorDesc)
    desc = box_scene(w, h, with_mesh=True, mesh_subdiv=mesh_subdiv)
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


def compare_rows(name, plain, kern, alive, bounces, gi_from):
    """The rows of a wave with surf_out/gi_from, kernel against plain;
    returns the max abs error over every row."""
    import torch
    (pr, ph, pz, ps, pq), (kr, kh, kz, ks, kq) = plain, kern
    err, _ = compare(name, (pr, ph, pz), (kr, kh, kz), alive, bounces)
    check(len(pq) == len(kq) and (ps is None) == (ks is None),
          f"{name}: row sets differ")
    rows = [(0, ps, ks)] if ps is not None else []
    rows += [(gi_from + k, p, k_) for k, (p, k_) in enumerate(
        zip((torch.cat(q) for q in pq), (torch.cat(q) for q in kq)))]
    for b, p, k in rows:
        check(bool(torch.isfinite(k).all()), f"{name}: rows not finite")
        e = (k - p).abs()
        err = max(err, float(e.max()))
        off = (e > ATOL + ZTOL * p.abs()).any(dim=0)
        if b == 0:
            check(not bool(off.any()),
                  f"{name}: bounce-0 rows differ on {int(off.sum())} lanes")
        else:
            share = float(off.float().mean())
            check(share <= FLIP_SHARE,
                  f"{name}: rows of bounce {b}: {share:.4f} of lanes off")
            mp, mk = float(p.mean()), float(k.mean())
            check(abs(mk - mp) <= MEAN_TOL * abs(mp) + 1e-6,
                  f"{name}: rows of bounce {b}: mean {mk} vs {mp}")
    for q in kq:
        check(not bool((q[2][:, ~alive] != 0).any()),
              f"{name}: a dead lane has a query weight")
    print(f"[kernel] {name}: rows {ks.shape[0] if ks is not None else 0} "
          f"surface + {len(kq)} x 9 query, max_abs_err over all rows "
          f"{err:.3e}", flush=True)
    return err


def bound(tables, st, n, rows_in, rows_out):
    """The least time of one launch on this card: the larger of its FP32
    operations (from the work counters) over the FP32 peak and its bytes
    (each input once: rows_in floats in and rows_out out per ray, the
    tables and the atlas's texels at 12 bytes) over the HBM rate.  Also
    the bound with four 16-byte texel reads per file-texture sample
    instead of the atlas once.  The walk's slab tests are this run's
    (root, group, tile and leaf boxes); on the MXU tables a face test is a
    Plücker pair, and each root-box test adds o x d."""
    ns, np_ = tables.spheres.shape[0], tables.planes.shape[0]
    face_ops = OPS["pair"] if tables.mxu else OPS["tri"]
    slabs = st["tiles"] + st["groups"] + st["leaves"]
    flops = (st["rays"] * (ns * OPS["sphere"] + np_ * OPS["plane"])
             + st["inst"] * OPS["inst"] + slabs * OPS["slab"]
             + st["root"] * (OPS["slab"]
                             + (OPS["cross"] if tables.mxu else 0))
             + (st["tri_closest"] + st["tri_shadow"]) * face_ops
             + st["prim_shadow"] * OPS["plane"]
             + st["hits"] * OPS["shade"] + st["shadow"] * OPS["shadow"]
             + st["tex_file"] * OPS["tex_file"]
             + st["tex_checker"] * OPS["tex_checker"]
             + st["env"] * OPS["env"])
    table_bytes = sum(getattr(tables, k).numel() * 4 for k in (
        "spheres", "planes", "mesh_insts", "roots", "faces", "shade",
        "materials", "lights", "texmaps", "textures", "groups", "tnodes",
        "leaves"))
    texels = tables.atlas.shape[0] if tables.has_file_tex else 0
    nbytes = n * rows_in * 4 + n * rows_out * 4 + table_bytes + texels * 12
    nbytes_reads = nbytes - texels * 12 + st["tex_file"] * 4 * 16
    bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return dict(flops=flops, bytes=nbytes, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_ms_texel_reads=max(nbytes_reads / HBM_BPS * 1e3,
                                         ops_ms))


def walk_figures(st, blocks):
    """What the wave kernel's counters say about one launch: per walk (a
    root-box test that passed) the slab tests of each level below the root
    and the face tests (pairs), the SIMT efficiency of the walk and of the
    face loops (active lanes over 32 per warp-iteration), the bounce loop's
    cycles by part (lane cycles: a lane waiting on its warp's other lanes
    counts where it waits): sphere and plane tests, instance transform and
    root box, walk, face tests and the rest (shading and shadow-ray set-up),
    which add up to 1, and beside them the share inside shadow rays and
    the share from bounce 1 on; and the blocks' cycles (each block's
    longest lane): max, sum, mean."""
    cyc = max(st["cyc_bounces"], 1)
    walks = max(st["root_in"], 1)
    out = {
        "walks": st["root_in"],
        "per_walk": {k: st[k] / walks for k in ("groups", "tiles",
                                                 "leaves")},
        "pairs": st["tri_closest"] + st["tri_shadow"],
        "simt_walk": st["walk_lanes"] / max(32 * st["walk_iters"], 1),
        "simt_pairs": st["pair_lanes"] / max(32 * st["pair_iters"], 1),
        "cycles_share": {k: st["cyc_" + k] / cyc
                         for k in ("prim", "root", "walk", "pair")},
        "block_cycles_max": max(blocks) if blocks else 0,
        "block_cycles_sum": sum(blocks),
        "block_cycles_mean": sum(blocks) / max(len(blocks), 1),
    }
    out["per_walk"]["pairs"] = out["pairs"] / walks
    out["cycles_share"]["rest"] = 1.0 - sum(out["cycles_share"].values())
    out["cycles_share"].update(shadow=st["cyc_shadow"] / cyc,
                               later_bounces=st["cyc_later"] / cyc)
    return out


def box_volume(scene, seed, dev):
    """An irradiance volume at the committed scene_b volume's size (60 x 60
    x 45 cells, 171,166 corners) spanning the scene's world bounds: E in
    [0, 0.5) and mean directions in [-1, 1) from numpy seed `seed`."""
    import numpy as np
    from rtf_tpu_torch.gi.volume import volume_from_arrays
    dims = (60, 60, 45)
    nc = 61 * 61 * 46
    rng = np.random.RandomState(seed)
    table = np.concatenate([rng.uniform(0.0, 0.5, (3, nc)),
                            rng.uniform(-1.0, 1.0, (3, nc))]).astype(
                                np.float32)
    lo = np.asarray(scene.world_min, np.float32)
    cell = float(np.max((np.asarray(scene.world_max, np.float32) - lo)
                        / np.asarray(dims, np.float32)))
    return volume_from_arrays(table, lo, dims, cell, device=dev)


def write_photon_scene(directory, w, h, seed=0):
    """Write the Final era's scene-file set for the textured box into
    `directory` and return the XML's path: the box's 5 planes (the walls'
    kd a 512x512 PNG through a 0.25 scale), a mirror and a glass sphere,
    the 320-face icosphere as an OBJ with uv and normals whose MTL gives
    two sub-materials (one's map_Kd a 256x256 PPM), and two point lights,
    as scene_b has; the camera at w x h.  Texels from numpy seed `seed`."""
    import numpy as np
    from rtf_tpu_torch.scene.procedural import icosphere_mesh
    from rtf_tpu_torch.utils.png import write_png
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    write_png(str(directory / "wall.png"),
              rng.randint(0, 256, (512, 512, 3)).astype(np.uint8))
    ball = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    (directory / "ball.ppm").write_bytes(b"P6\n256 256\n255\n"
                                         + ball.tobytes())
    m = icosphere_mesh(2)
    v = m.v.astype(np.float64)
    vt = np.stack([0.5 + np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(v[:, 2], -1, 1)) / np.pi], 1)
    half = len(m.f) // 2
    lines = ["mtllib ball.mtl"]
    lines += [f"v {x:.7f} {y:.7f} {z:.7f}" for x, y, z in m.v]
    lines += [f"vt {a:.7f} {b:.7f}" for a, b in vt]
    lines += [f"vn {x:.7f} {y:.7f} {z:.7f}" for x, y, z in m.vn]
    for i, f in enumerate(m.f + 1):
        if i in (0, half):
            lines.append("usemtl " + ("redA" if i == 0 else "redB"))
        lines.append("f " + " ".join(f"{k}/{k}/{k}" for k in f))
    (directory / "ball.obj").write_text("\n".join(lines) + "\n")
    (directory / "ball.mtl").write_text(
        "newmtl redA\nKd 1 0.3 0.3\nKs 0.7 0.7 0.7\nNs 20\nillum 2\n"
        "map_Kd ball.ppm\nnewmtl redB\nKd 0.3 0.3 1\nKs 0.7 0.7 0.7\n"
        "Ns 20\nillum 2\n")

    def plane(name, mtl, tf):
        return (f'<object type="plane" name="{name}" material="{mtl}">'
                f'<scale value="32"/>{tf}</object>')
    xml = f"""<xml><scene>
<object name="box"><translate z="12"/>
{plane("floor", "wall", '<translate z="-12"/>')}
{plane("ceiling", "wall", '<rotate x="1" angle="180"/><translate z="12"/>')}
{plane("back", "wall", '<rotate x="1" angle="90"/><translate y="20"/>')}
{plane("left", "wallRed", '<rotate y="1" angle="90"/><translate x="-15"/>')}
{plane("right", "wallBlue",
       '<rotate y="1" angle="-90"/><translate x="15"/>')}
</object>
<object type="sphere" name="mirror" material="mirror">
<scale value="4"/><translate x="8" y="-6" z="4"/></object>
<object type="sphere" name="glass" material="glass">
<scale value="4"/><translate x="-8" y="-6" z="4"/></object>
<object type="obj" name="ball.obj">
<scale value="3"/><translate x="1" y="4" z="3"/></object>
<material type="blinn" name="wall">
<diffuse value="1" texture="wall.png"><scale value="0.25"/></diffuse>
<specular value="0"/></material>
<material type="blinn" name="wallRed">
<diffuse r="1" g="0.5" b="0.5"/><specular value="0"/></material>
<material type="blinn" name="wallBlue">
<diffuse r="0.5" g="0.5" b="1"/><specular value="0"/></material>
<material type="blinn" name="mirror"><diffuse value="0"/>
<specular value="1"/><glossiness value="80"/><reflection value="1"/>
</material>
<material type="blinn" name="glass"><diffuse value="0"/>
<specular value="1"/><glossiness value="80"/>
<refraction value="1" index="1.52"/></material>
<light type="point" name="L1"><intensity value="50.25"/>
<position x="-5" y="0" z="22"/></light>
<light type="point" name="L2"><intensity value="50.25"/>
<position x="5" y="0" z="22"/></light>
</scene><camera><position x="0" y="-60" z="12"/>
<target x="0" y="0" z="12"/><up x="0" y="0" z="1"/><fov value="30"/>
<width value="{w}"/><height value="{h}"/></camera></xml>
"""
    path = directory / "box.xml"
    path.write_text(xml)
    return path


def write_png_filtered(path, img):
    """Write img [H, W, 3] uint8 as an RGB PNG whose row y carries filter
    y % 5 (None, Sub, Up, Average, Paeth), each row filtered at once in
    numpy from the image's own bytes."""
    import struct
    import zlib

    import numpy as np
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)                 # left
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)                 # up
    b[1:] = x[:-1]
    ul = np.zeros_like(x)                # up-left
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    f = np.arange(h) % 5
    pred = np.select([f[:, None] == k for k in range(5)],
                     [np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    raw = np.concatenate([f[:, None].astype(np.uint8),
                          ((x - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


def write_large_scene(directory, w, h, subdiv=7, tex=2048, seed=0):
    """Phase 13's scene-file set in `directory`: the box's 5 planes and its point light (size 1, as box_scene's
    light_size=1.0), the back wall's kd a tex x tex RGB PNG (a gradient
    with noise from numpy seed `seed`, rows cycling through the five
    filters), and icosphere_mesh(subdiv) (327,680 faces at 7) as an OBJ
    with uv and normals; the camera at w x h.  Returns the XML's path and
    the texture's pixels."""
    import numpy as np
    from rtf_tpu_torch.scene.procedural import icosphere_mesh
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    u = np.linspace(0.0, 1.0, tex, dtype=np.float32)
    img = np.stack([u[None, :] * np.ones((tex, 1), np.float32),
                    u[:, None] * np.ones((1, tex), np.float32),
                    0.5 + 0.5 * np.sin(12.0 * (u[:, None] + u[None, :]))],
                   -1) * 200.0 + rng.uniform(0.0, 55.0, (tex, tex, 3))
    img = img.astype(np.uint8)
    write_png_filtered(directory / "wall.png", img)
    m = icosphere_mesh(subdiv)
    v = m.v.astype(np.float64)
    vt = np.stack([0.5 + np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(v[:, 2], -1, 1)) / np.pi], 1)
    f = m.f + 1
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}" for x, y, z in m.v]
    lines += [f"vt {a:.7f} {b:.7f}" for a, b in vt]
    lines += [f"vn {x:.7f} {y:.7f} {z:.7f}" for x, y, z in m.vn]
    lines += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}" for a, b, c in f]
    (directory / "ball.obj").write_text("\n".join(lines) + "\n")

    def plane(name, mtl, tf):
        return (f'<object type="plane" name="{name}" material="{mtl}">'
                f'<scale value="32"/>{tf}</object>')
    xml = f"""<xml><scene>
<object name="box"><translate z="12"/>
{plane("floor", "wall", '<translate z="-12"/>')}
{plane("ceiling", "wall", '<rotate x="1" angle="180"/><translate z="12"/>')}
{plane("back", "back", '<rotate x="1" angle="90"/><translate y="20"/>')}
{plane("left", "wallRed", '<rotate y="1" angle="90"/><translate x="-15"/>')}
{plane("right", "wallBlue",
       '<rotate y="1" angle="-90"/><translate x="15"/>')}
</object>
<object type="obj" name="ball.obj" material="ball">
<scale value="6"/><translate x="0" y="4" z="6"/></object>
<material type="blinn" name="wall">
<diffuse value="0.8"/><specular value="0"/></material>
<material type="blinn" name="back">
<diffuse value="1" texture="wall.png"/><specular value="0"/></material>
<material type="blinn" name="wallRed">
<diffuse r="1" g="0.5" b="0.5"/><specular value="0"/></material>
<material type="blinn" name="wallBlue">
<diffuse r="0.5" g="0.5" b="1"/><specular value="0"/></material>
<material type="blinn" name="ball">
<diffuse r="1" g="0.3" b="0.3"/><specular value="0.7"/>
<glossiness value="20"/></material>
<light type="point" name="L1"><intensity value="100.5"/>
<position x="0" y="0" z="22"/><size value="1"/></light>
</scene><camera><position x="0" y="-60" z="12"/>
<target x="0" y="0" z="12"/><up x="0" y="0" z="1"/><fov value="30"/>
<width value="{w}"/><height value="{h}"/></camera></xml>
"""
    path = directory / "large.xml"
    path.write_text(xml)
    return path, img


# phase 13's start-up split: one fresh process, run from the root of the
# checkout with the scene file's path as its argument
STARTUP = """
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import rtf_tpu_torch.cli
from rtf_tpu_torch import _build
from rtf_tpu_torch.scene.xml_loader import load_scene
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
for name in _build.KERNELS:
    _build.load(name)
_build.load_host()
t4 = time.perf_counter()
load_scene(sys.argv[1])
t5 = time.perf_counter()
print(json.dumps(dict(import_torch_s=t1 - t0, import_port_s=t2 - t1,
                      context_s=t3 - t2, libraries_s=t4 - t3,
                      scene_load_s=t5 - t4)))
"""


# phase 12's frames of two tile shards of 1536 lanes (64x48 over two
# ranks, not a multiple of the wave kernel's 1024-lane blocks): the
# adaptive config of tests/test_torch_sharded.py on the wavefront, and the
# fused `rr` path at bounce 0 and at 2 bounces with Russian roulette
TILE_W, TILE_H = 64, 48
TILE_CFGS = {
    "adaptive": dict(min_samples=2, max_samples=4, variance_threshold=1e-4,
                     bounces=2, shadow_min=1, shadow_max=1, gi_mode="none"),
    "rr0": dict(min_samples=2, max_samples=2, bounces=0, shadow_min=1,
                shadow_max=1, gi_mode="none", split_mode="rr"),
    "rr": dict(min_samples=16, max_samples=16, bounces=2, shadow_min=1,
               shadow_max=1, gi_mode="none", split_mode="rr"),
}


def gloo_rank(rank, port, out):
    """One of phase 12's two processes that share the card under gloo:
    render_sharded on a (1, 2) mesh (the two ranks split the samples) of
    the main path's config at 800x600, then on a (2, 1) mesh (two tiles of
    1536 lanes) the TILE_CFGS frames of box_scene(64, 48, with_mesh=False);
    rank 0 saves the frames and the first one's time to `out` (an .npz)."""
    import numpy as np
    import torch
    from torch import distributed as dist
    sys.path.insert(0, str(ROOT))
    from rtf_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = make_mesh(1, 2)
        scene = build_scene(box_scene(W, H, with_mesh=True), device="cuda")
        cfg = RenderConfig(min_samples=SPP, max_samples=SPP,
                           bounces=BOUNCES, shadow_min=1, shadow_max=1,
                           gi_mode="none")
        render_sharded(scene, cfg, mesh, seed=3, device="cuda")  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        acc = render_sharded(scene, cfg, mesh, seed=7, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = {k: x.cpu().numpy() for k, x in zip(("rad", "hits", "z", "ns"),
                                                   acc)}
        tiles = make_mesh(2, 1)
        small = build_scene(box_scene(TILE_W, TILE_H, with_mesh=False),
                            device="cuda")
        for name, kw in TILE_CFGS.items():
            acc = render_sharded(small, RenderConfig(**kw), tiles, seed=0,
                                 device="cuda")
            res.update({f"{name}_{k}": x.cpu().numpy() for k, x in zip(
                ("rad", "hits", "z", "ns"), acc)})
        if rank == 0:
            np.savez(out, seconds=dt, **res)
    finally:
        dist.destroy_process_group()


def main(argv):
    # no arguments: every phase; phase numbers: the build and those only
    phases = {int(a) for a in argv} or set(range(1, 14))
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
    from rtf_tpu_torch.render.gi import (
        child_wave_args, gi_wave, primary_gi_from)
    from rtf_tpu_torch.ops import mesh_hit as M_
    from rtf_tpu_torch.ops import mesh_hit_mxu as X_
    from rtf_tpu_torch.ops.trace import _to_local
    from rtf_tpu_torch.render import renderer as R_
    from rtf_tpu_torch.utils import tracing as T_
    # launch counters of the tracing registry
    WAVE = "launches.wave_kernel"
    WAVE_TEX, WAVE_MXU = WAVE + ".textured", WAVE + ".mxu"
    WAVE_TEX_MXU = WAVE + ".textured_mxu"
    MESH = "launches.mesh_closest_hit"
    MESH_MXU = MESH + "_mxu"
    BVH = "launches.bvh_closest_hit"
    BVH_BINARY = BVH + ".binary"
    from rtf_tpu_torch.render.camera import (
        pixel_order, primary_rays, primary_rays_ch)
    from rtf_tpu_torch.render.integrator import render_wave
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.render.scene_tables import render_path, scene_tables
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    from rtf_tpu_torch.utils.png import write_png

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}"
          f" on {kind} ({card})", flush=True)

    # ---- phase 1: build (one nvcc per source, started together)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            # wave: per variant wave_kernel<TEXTURED, GI, MXU>, mangled
            # Lb0/Lb1
            if any(k in line for k in ("registers", "spill",
                                       "entry function")):
                print(f"[build] {name}: {line.strip()}", flush=True)
        _build.load(name)
    print(f"[build] built "
          f"{', '.join(_build.library_path(k).name for k in logs)} in "
          f"{build_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    _build.load_host()      # the host library (C++ BVH builder, PNG unfilter)
    print(f"[build] host library {_build.host_library_path().name} loaded "
          f"(built if missing) in {time.perf_counter() - t0:.2f} s",
          flush=True)

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
    rows_err = {"wave_gi": 0.0, "wave_textured_gi": 0.0}
    gen = torch.Generator(device=dev).manual_seed(5)
    if 2 in phases:
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
            ("textured b4", textured, base.with_(bounces=4), 2 ** 31 - 5,
             False),
            ("textured env b4", textured, env, 41, False),
            ("textured env l2 b4", textured, env.with_(env_l2=True), 43,
             False),
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

        # the GI rows and child waves, both variants, 160x120 and 800x600
        for key, mk, rcfg in (
                ("wave_gi", lambda w, h: box_scene(w, h, with_mesh=True),
                 base.with_(bounces=2)),
                ("wave_textured_gi",
                 lambda w, h: textured_desc(box_scene, w, h),
                 base.with_(bounces=4, shadow_min=4, shadow_max=16))):
            for w, h in (SMALL, (W, H)):
                scene = build_scene(mk(w, h), device=dev)
                tables = scene_tables(scene)
                o3, d3 = rays(scene, 3)
                alive = torch.ones(w * h, dtype=torch.bool, device=dev)
                for tag, kw in (("surf", dict(surf_out=True)),
                                ("gi_from=1", dict(surf_out=True, gi_from=1)),
                                ("gi_from=0", dict(surf_out=True, gi_from=0))):
                    plain = W_.wave_plain(rcfg, tables, o3, d3, alive, 17,
                                          **kw)
                    kern = W_.wave(rcfg, tables, o3, d3, alive, 17, **kw)
                    torch.cuda.synchronize()
                    e = compare_rows(f"{key} {tag} {w}x{h}", plain, kern,
                                     alive, rcfg.bounces,
                                     kw.get("gi_from", 0))
                    if (w, h) == (W, H):
                        rows_err[key] = max(rows_err[key], e)
                # a hemisphere child wave from the primary's surface rows
                _, hit0, _, surf, _ = plain
                half = alive.clone()
                half[::2] = False
                u = torch.rand((2, w * h), generator=gen, device=dev)
                args, ckw = child_wave_args(rcfg.with_(hemisphere_samples=4),
                                            surf, hit0, half, 17, 1, u[0],
                                            u[1])
                check(float(ckw["tput3"].max()) < 1.0 and bool(args[2].any()),
                      f"{key}: child wave without live lanes")
                for tag, gkw in (("child", {}),
                                 ("child rows", dict(gi_from=0))):
                    plain = W_.wave_plain(rcfg, tables, *args, **ckw, **gkw)
                    kern = W_.wave(rcfg, tables, *args, **ckw, **gkw)
                    torch.cuda.synchronize()
                    name = f"{key} {tag} {w}x{h}"
                    if gkw:
                        e = compare_rows(name, plain, kern, args[2],
                                         ckw["bounces"], 0)
                    else:
                        e, _ = compare(name, plain, kern, args[2],
                                       ckw["bounces"])
                    if (w, h) == (W, H):
                        rows_err[key] = max(rows_err[key], e)
        print("[kernel] phase passed", flush=True)

    cfg = RenderConfig(min_samples=SPP, max_samples=SPP, bounces=BOUNCES,
                       shadow_min=1, shadow_max=1, gi_mode="none")
    check(cfg.resolved_split_mode() == "rr", "main path must run split rr")
    counters = (WAVE, WAVE_TEX, WAVE_MXU, WAVE_TEX_MXU)

    def profile_frame(tag, frame_s, fn, kernel="wave_kernel"):
        """Where one frame's device time goes (torch.profiler over fn):
        (device busy us, `kernel`'s ms per launch, launches).  Only the
        device's own events count (kernels, copies): an aten op's device
        time is that of the kernels it launched, which are listed too."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        dev_us, kern = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0 and ev.device_type == DeviceType.CUDA:
                dev_us[ev.key] = us
                if kernel in ev.key:
                    name = ev.key[ev.key.index(kernel):]
                    kern[name.split(">")[0].split("(")[0]] = (us, ev.count)
        total_us = sum(dev_us.values())
        kern_us = sum(v[0] for v in kern.values())
        kern_n = sum(v[1] for v in kern.values())
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
        prof_ms = kern_us / max(kern_n, 1) / 1e3
        print(f"[{tag}] profiled frame: device busy {total_us / 1e3:.3f} ms "
              f"= {total_us / 1e4 / frame_s:.2f}% of the best frame; "
              f"{kernel} {kern_n} launches, {prof_ms:.4f} ms each ("
              + "; ".join(f"{k} x{c} {u / 1e3 / c:.4f} ms"
                          for k, (u, c) in kern.items())
              + "); top: "
              + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top),
              flush=True)
        return total_us, prof_ms, kern_n

    def events_ms(fn, reps=20):
        """Device time per call of fn (CUDA events).  The device first
        sleeps while the host queues every call, so the host's work leaves
        no gaps in the timed run (what is timed is the kernel and the
        wrapper's small ray-packing ops)."""
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

    def host_ms(fn, reps):
        """Host time per call of fn after one untimed call (the plain
        version: a stream of small PyTorch kernels)."""
        fn()
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0_) / reps * 1e3

    def profiled_ms(fn, reps=5, key="wave_kernel"):
        """The kernel's own device time per launch (torch.profiler over reps
        calls of fn, one launch of the kernel whose name holds `key` each),
        over the kernel records the profiler delivered: late in this
        process it can deliver fewer than reps, so their count is printed
        when it falls short, and none at all (then None, printed; the CUDA
        events' figure stands beside it)."""
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
        if not count:
            print(f"[profiler] no {key} launch recorded", flush=True)
            return None
        if count < reps:
            print(f"[profiler] {count} of {reps} {key} launches recorded",
                  flush=True)
        return sum(ev.self_device_time_total for ev in evs) / count / 1e3

    def work(fn, n):
        """The kernel's counters over one call of fn (n lanes), and each
        block's cycles."""
        stats = torch.zeros(W_.stats_size(n), dtype=torch.int64, device=dev)
        fn(stats=stats)
        st = stats.tolist()
        return dict(zip(STATS, st)), st[W_.NSTAT:]

    def report_walk(tag, tables, fn, n, rows_in, rows_out):
        """Run fn (one launch of n lanes) with the counters on: print the
        walk's counters and figures, the launch's time with the counters on
        (CUDA events), and the bound on this run's counts.  Returns (work
        counts, figures)."""
        st, blocks = work(fn, n)
        fig = walk_figures(st, blocks)
        buf = torch.zeros(W_.stats_size(n), dtype=torch.int64, device=dev)
        fig["ms_counters_on"] = events_ms(lambda: fn(stats=buf), reps=5)
        bd = bound(tables, st, n, rows_in, rows_out)
        fig["bound_ms"] = bd["bound_ms"]
        cs = fig["cycles_share"]
        pw = fig["per_walk"]
        print(f"[{tag}] walk: root {st['root']} slab tests "
              f"({st['root_in']} pass), groups {st['groups']}, tiles "
              f"{st['tiles']}, leaves {st['leaves']}, pairs {fig['pairs']}"
              f" (per walk {pw['groups']:.2f}, {pw['tiles']:.2f}, "
              f"{pw['leaves']:.2f}, {pw['pairs']:.2f}); SIMT efficiency walk "
              f"{fig['simt_walk']:.4f}, pairs {fig['simt_pairs']:.4f}; "
              f"bounce-loop cycles {st['cyc_bounces']}: spheres and planes "
              f"{cs['prim']:.4f}, root {cs['root']:.4f}, walk "
              f"{cs['walk']:.4f}, face tests {cs['pair']:.4f}, rest "
              f"{cs['rest']:.4f} (shadow rays {cs['shadow']:.4f}, bounces "
              f">= 1 {cs['later_bounces']:.4f}); block cycles max "
              f"{fig['block_cycles_max']}, sum {fig['block_cycles_sum']}, "
              f"mean {fig['block_cycles_mean']:.1f} over {len(blocks)} "
              f"blocks (a launch with the counters on: "
              f"{fig['ms_counters_on']:.4f} ms, CUDA events); bound "
              f"{bd['bound_ms']:.5f} ms on these counts", flush=True)
        return st, fig

    def drive(tag, desc, small_desc, counter):
        """Render one path at W x H through `render`, counting the
        kernel's launches in `counter`; then the kernel against the plain
        version at this shape, its time per launch, its work counts and
        bound, and the plain version's time per wave."""
        scene = build_scene(desc, device=dev)
        tables = scene_tables(scene)
        check(W_.launch_counter(tables) == counter,
              f"{tag}: wrong kernel variant")
        o3, d3 = rays(scene, 0)
        n = W * H
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        err0, _ = compare(f"{tag} b0 {W}x{H}",
                          *both(cfg.with_(bounces=0), tables, o3, d3, 11), 0)
        err4, share4 = compare(f"{tag} b{BOUNCES} {W}x{H}",
                               *both(cfg, tables, o3, d3, 11), BOUNCES)
        check(err0 == err4 == 0.0,
              f"{tag}: the kernel is not exact ({err0}, {err4})")

        render(scene, cfg, device=dev, tables=tables)     # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            T_.reset_counters(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, cfg, seed=1 + rep, device=dev, tables=tables)
            dt = time.perf_counter() - t0
            counts = {c: T_.counter(c) for c in counters}
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

        _, prof_ms, _ = profile_frame(
            tag, frame_s,
            lambda: render(scene, cfg, seed=9, device=dev, tables=tables))

        # kernel time per launch (CUDA events) and its work counts
        def launch(**kw):
            return W_.wave(cfg, tables, o3, d3, alive, 11, **kw)
        kern_ms = events_ms(launch)
        st, walk = report_walk(tag, tables, launch, n, 7, 5)
        # 7 floats in and 5 out per ray (the atlas's float4 padding is the
        # kernel's choice, not the function's)
        bd = bound(tables, st, n, 7, 5)
        launch_prof_ms = profiled_ms(launch)
        # on the MXU tables each launch first runs block_order
        order_prof_ms = (profiled_ms(launch, key="block_order")
                         if tables.mxu else None)
        print(f"[{tag}] kernel {kern_ms:.4f} ms/launch at {W}x{H} (mean of "
              f"20, CUDA events; {launch_prof_ms} ms by the profiler, "
              f"kernel only; block_order {order_prof_ms} ms); work "
              f"{json.dumps(st)}; "
              f"{bd['flops']:.4e} FP32 ops, {bd['bytes']} bytes; bound "
              f"{bd['bound_ms']:.4f} ms (ops {bd['ops_ms']:.4f}, bytes "
              f"{bd['bytes_ms']:.4f}); with four texel reads per sample, "
              f"bound {bd['bound_ms_texel_reads']:.4f} ms", flush=True)

        # the plain version's time per wave, at this shape and at 160x120
        def plain_ms(tables_, o3_, d3_, reps_):
            al = torch.ones(o3_.shape[1], dtype=torch.bool, device=dev)
            return host_ms(
                lambda: W_.wave_plain(cfg, tables_, o3_, d3_, al, 11), reps_)
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
            "plain_ms_160x120": plain_small, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"],
            "bound_ms_texel_reads": bd["bound_ms_texel_reads"],
            "library_ms": None, "frame_s": frame_s, "mrays_per_s": mrays,
            "work": st, "walk": walk, "ms_profiler_launch": launch_prof_ms,
            "block_order_ms_profiler": order_prof_ms}

    def gi_launch_kinds(tag, gcfg, scene, tables, gi_vol, caustic_vol, gen):
        """Per launch kind of a GI sample wave at the scene's full shape
        (the primary launch with its rows, one child launch from it): the
        kernel against its plain version, its time (CUDA events,
        profiler), the plain version's time, work counts and bound.
        Returns (figures per kind, errors, (o3, d3, alive))."""
        w, h = scene.width, scene.height
        n = w * h
        o3, d3 = rays(scene, 0)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        gf = primary_gi_from(gi_vol, caustic_vol)

        def primary(fn=W_.wave, **kw):
            return fn(gcfg, tables, o3, d3, alive, 11, surf_out=True,
                      gi_from=gf, **kw)
        _, hit0, _, surf, _ = primary()
        u = torch.rand((2, n), generator=gen, device=dev)
        args, ckw = child_wave_args(gcfg, surf, hit0, alive, 11, 0, u[0],
                                    u[1])
        ckw["gi_from"] = 0 if gi_vol is not None else None

        def child(fn=W_.wave, **kw):
            return fn(gcfg, tables, *args, **ckw, **kw)
        kinds, errs = {}, []
        for kname, fn, live, nb, gfk, rows_in, rows_out in (
                ("primary", primary, alive, gcfg.bounces, gf, 7,
                 W_.out_rows(gcfg.bounces + 1, True, gf)),
                ("child", child, args[2], ckw["bounces"], ckw["gi_from"], 14,
                 W_.out_rows(ckw["bounces"] + 1, False, ckw["gi_from"]))):
            # the kernel against its plain version at this path's shape;
            # the plain call is also the untimed first call of its timing
            kern, plain = fn(), fn(W_.wave_plain)
            torch.cuda.synchronize()
            name = f"{tag} {kname} {w}x{h}"
            if len(kern) == 3:           # a hemisphere child: no rows
                errs.append(compare(name, plain, kern, live, nb)[0])
            else:
                errs.append(compare_rows(name, plain, kern, live, nb,
                                         0 if gfk is None else gfk))
            del kern, plain
            t0 = time.perf_counter()
            fn(W_.wave_plain)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            ms = events_ms(fn)
            ms_prof = profiled_ms(fn)
            order_prof = (profiled_ms(fn, key="block_order") if tables.mxu
                          else None)
            st, walk = report_walk(f"{tag} {kname}", tables, fn, n,
                                   rows_in, rows_out)
            bd = bound(tables, st, n, rows_in, rows_out)
            kinds[kname] = dict(ms=ms, ms_profiler=ms_prof,
                                block_order_ms_profiler=order_prof,
                                plain_ms=pms,
                                max_abs_err=errs[-1], work=st,
                                rows_in=rows_in, rows_out=rows_out, **bd,
                                walk=walk)
            print(f"[{tag}] {kname} launch: {ms:.4f} ms (mean of 20, CUDA "
                  f"events), {ms_prof} ms (profiler, kernel only; "
                  f"block_order {order_prof} ms), "
                  f"plain {pms:.2f} ms; rows {rows_in} in, "
                  f"{rows_out} out; work {json.dumps(st)}; "
                  f"{bd['flops']:.4e} FP32 ops, {bd['bytes']} bytes; bound "
                  f"{bd['bound_ms']:.4f} ms (ops {bd['ops_ms']:.4f}, bytes "
                  f"{bd['bytes_ms']:.4f}), by {bd['bound_by']}", flush=True)
        return kinds, errs, (o3, d3, alive)

    def drive_gi(tag, desc, gcfg, counter, volumes=False):
        """Render one GI path through `render`, every frame counted in
        `counter` (spp x (1 + hemisphere samples) launches); then at this
        shape, per launch kind (the primary launch with its rows, one
        child launch), the kernel against the plain version, its time,
        work counts and bound (the output rows' bytes included) and the
        plain version's time; then the whole GI sample wave on the kernel
        against the same on the plain version."""
        scene = build_scene(desc, device=dev)
        tables = scene_tables(scene)
        check(W_.launch_counter(tables) == counter,
              f"{tag}: wrong kernel variant")
        # the phase's own uniforms (seed 5), whichever phases ran before:
        # phase 9's child launch is chip_ab.py's
        gen = torch.Generator(device=dev).manual_seed(5)
        w, h = scene.width, scene.height
        n = w * h
        s_hemi, spp = gcfg.hemisphere_samples, gcfg.max_samples
        check(gcfg.min_samples == spp, f"{tag}: one adaptive rung")
        expected = spp * (1 + s_hemi)
        gi_vol = box_volume(scene, 0, dev) if volumes else None
        caustic_vol = box_volume(scene, 1, dev) if volumes else None
        if volumes:
            print(f"[{tag}] volumes: dims {gi_vol.dims}, cell "
                  f"{gi_vol.cell:.4f}, {gi_vol.table.shape[1]} corners, "
                  f"{gi_vol.table.numel() * 4} bytes each", flush=True)
        rkw = dict(device=dev, tables=tables, gi_vol=gi_vol,
                   caustic_vol=caustic_vol)
        direct = render(scene, gcfg.with_(gi_mode="none"), seed=1,
                        device=dev, tables=tables)
        render(scene, gcfg, **rkw)                         # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            T_.reset_counters(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, gcfg, seed=1 + rep, **rkw)
            dt = time.perf_counter() - t0
            counts = {c: T_.counter(c) for c in counters}
            launches = counts[counter]
            check(launches == expected and sum(counts.values()) == expected,
                  f"{tag} frame {rep}: launches {counts}, expected "
                  f"{expected} of {counter}")
            check(np.isfinite(out.radiance).all(), "non-finite radiance")
            check(out.image.shape == (h, w, 3),
                  f"image shape {out.image.shape}")
            check((out.sample_count == spp).all(), "sample counts != spp")
            check(out.image.mean() > 5.0, "frame is black")
            if dt < frame_s:
                frame_s, res = dt, out
        gain = res.radiance.mean() / direct.radiance.mean()
        check(gain > 1.0, f"{tag}: GI adds no light ({gain:.4f})")
        (ROOT / "build").mkdir(exist_ok=True)
        png = ROOT / "build" / f"chip_smoke_{tag}.png"
        write_png(str(png), res.image)
        print(f"[{tag}] frame {w}x{h} {spp}spp {gcfg.bounces} bounces "
              f"gi_mode={gcfg.gi_mode} {s_hemi} hemisphere samples: best of "
              f"3 {frame_s:.4f} s, {launches} launches/frame, mean radiance "
              f"{gain:.4f}x the frame without GI, mean byte "
              f"{res.image.mean():.2f}, png {png.relative_to(ROOT)}",
              flush=True)
        busy_us, prof_ms, _ = profile_frame(
            tag, frame_s, lambda: render(scene, gcfg, seed=9, **rkw))

        # the two launch kinds of a GI sample wave
        kinds, errs, (o3, d3, alive) = gi_launch_kinds(
            tag, gcfg, scene, tables, gi_vol, caustic_vol, gen)

        def per_launch(k):
            return (kinds["primary"][k] + s_hemi * kinds["child"][k]) \
                / (1 + s_hemi)
        # the whole GI sample wave (child arguments, volume terms) on the
        # kernel against the same on the plain version
        uni = torch.rand((s_hemi, 2, n), generator=gen, device=dev)
        kern = gi_wave(gcfg, tables, o3, d3, alive, 11, uni, gi_vol,
                       caustic_vol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = gi_wave(gcfg, tables, o3, d3, alive, 11, uni, gi_vol,
                        caustic_vol, wave_fn=W_.wave_plain)
        torch.cuda.synchronize()
        plain_gi = (time.perf_counter() - t0) * 1e3
        err_gi, share_gi = compare(f"{tag} gi_wave {w}x{h}", plain, kern,
                                   alive, gcfg.bounces)
        errs.append(err_gi)
        check(max(errs) == 0.0, f"{tag}: the kernel is not exact ({errs})")
        print(f"[{tag}] plain GI sample wave ({1 + s_hemi} plain waves and "
              f"their host work) {plain_gi:.2f} ms", flush=True)
        print(f"[{tag}] phase passed", flush=True)
        return {
            "launches": launches, "max_abs_err": max(errs),
            "max_abs_err_gi_wave": err_gi, "share_outside_atol": share_gi,
            "max_abs_err_phase2_800x600": None if tables.mxu else rows_err[
                "wave_textured_gi" if tables.textured else "wave_gi"],
            "ms": per_launch("ms"), "ms_profiler": prof_ms,
            "plain_ms": per_launch("plain_ms"), "plain_gi_wave_ms": plain_gi,
            "bound_ms": per_launch("bound_ms"),
            "bound_by": kinds["child"]["bound_by"], "library_ms": None,
            "frame_s": frame_s, "device_busy_share": busy_us / 1e6 / frame_s,
            "per_launch_kind": kinds}

    def mesh_counts():
        return {"mesh_closest_hit": T_.counter(MESH),
                **{c: T_.counter(c) for c in counters}}

    def plain_fn(lo, ld, t_init, tris, aabb, face0=0, stats=None, **k):
        """mesh_closest_hit's plain version on a trace's rays (packed for
        it), in the place of mesh_hit.py::mesh_closest_hit_rays."""
        rays8, _ = M_.pack_rays(lo, ld, t_init)
        return tuple(x[:lo.shape[0]] for x in M_.mesh_closest_hit_plain(
            rays8, tris, aabb, face0))

    def mesh_launch_figures(tag, label, scene, args, kw):
        """One captured mesh_closest_hit_rays call (args, kw): the kernel's
        time per launch (CUDA events with the queue filled first), the
        plain version's, the work counts (slab tests per level of the box
        hierarchy, pairs) and the bound on them."""
        tree = scene.mesh.hit_tree
        tree_bytes = sum(getattr(tree, k).numel() * 4 for k in (
            "faces", "roots", "groups", "tnodes", "leaves"))
        lo = args[0]

        def launch(stats=None):
            return M_.mesh_closest_hit_rays(*args, stats=stats, **kw)
        ms = events_ms(launch)
        pms = host_ms(lambda: plain_fn(*args), 2)
        stats = torch.zeros(M_.NSTAT, dtype=torch.int64, device=dev)
        launch(stats)
        (slabs, pairs, roots, walks, groups, tiles, leaves) = stats.tolist()
        n = lo.shape[0]
        flops = slabs * OPS["slab"] + pairs * OPS["tri"]
        # each input once: 28 B per ray (o, d, t_init), the slot's face
        # rows and hierarchy; each output once: 20 B per ray
        nbytes = n * 28 + tree_bytes + n * 20
        bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
        per_walk = {k: v / max(walks, 1) for k, v in (
            ("groups", groups), ("tiles", tiles), ("leaves", leaves),
            ("pairs", pairs))}
        print(f"[{tag}] mesh_closest_hit {label}: {ms:.4f} ms (mean of 20, "
              f"CUDA events), plain {pms:.2f} ms; {slabs} slab tests "
              f"({roots} root, {walks} walks; groups, tiles, leaves, pairs "
              f"per walk " + ", ".join(f"{v:.2f}" for v in per_walk.values())
              + f"), {pairs} ray-face pairs ({pairs / n:.2f} per ray); "
              f"{flops:.4e} FP32 ops, {nbytes} bytes; bound "
              f"{max(bytes_ms, ops_ms):.5f} ms (ops {ops_ms:.5f}, bytes "
              f"{bytes_ms:.5f})", flush=True)
        return dict(ms=ms, plain_ms=pms, slab_tests=slabs, pairs=pairs,
                    root_tests=roots, walks=walks, group_tests=groups,
                    tile_tests=tiles, leaf_tests=leaves, per_walk=per_walk,
                    flops=flops, bytes=nbytes,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="operations" if ops_ms >= bytes_ms
                    else "bytes")

    def drive_wavefront():
        """Phase 7: render the default config on the XLA wavefront's port
        at 800x600 with a sized light (soft shadows 4 -> 16), each frame's
        mesh_closest_hit launches counted against the code; the kernel
        against its plain version on the frame's own inputs (primary rays,
        a batch of shadow rays, a compacted bounce queue with dead lanes);
        its time, work counts and bound; a 160x120 frame with the kernel
        against the same frame with the plain version; a hemisphere-GI
        frame on the wavefront."""
        t_phase = time.perf_counter()

        def stamp(what):
            print(f"[wavefront] {time.perf_counter() - t_phase:.1f} s: "
                  f"{what}", flush=True)
        wcfg = RenderConfig()
        check(wcfg.resolved_split_mode() == "both",
              "the default config must take the 'both' split")
        scene = build_scene(box_scene(W, H, with_mesh=True, light_size=1.0),
                            device=dev)
        tables = scene_tables(scene)
        check(render_path(scene, wcfg)[0] == "wavefront",
              "the default config must take the wavefront")
        check(scene.num_mesh_inst == 1 and scene.any_soft_light,
              "one mesh instance and a sized light")
        # the count the code gives: per shade_lanes 1 closest-hit trace and
        # shadow_min + shadow_max shadow traces (the escalation traces
        # every lane), one mesh_closest_hit per trace and mesh instance;
        # per wave 1 + bounces shade_lanes; every wave of both rungs runs
        per_shade = (1 + wcfg.shadow_min + wcfg.shadow_max) \
            * scene.num_mesh_inst
        per_wave = per_shade * (1 + wcfg.bounces)
        expected = per_wave * wcfg.max_samples

        # the kernel's inputs from one wave of the frame: the primary
        # closest-hit trace (480,000 rays), its first shadow trace, and the
        # first bounce's closest-hit trace (the compacted queue)
        captured, calls = {}, [0]
        kernel_fn = M_.mesh_closest_hit_rays
        order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
        o, d = primary_rays(scene, order % W, order // W, torch.tensor(0))
        ids = torch.arange(W * H, device=dev)

        def one_wave():
            """One sample wave of the frame (render_wave, all lanes)."""
            return render_wave(
                scene, wcfg, tables, o, d, ids,
                torch.ones(W * H, dtype=torch.bool, device=dev),
                torch.Generator(device=dev).manual_seed(3), W * H,
                inv_pixel=ids)

        def capture(lo, ld, t_init, tris, aabb, face0=0, stats=None, **k):
            if calls[0] in (0, 1, per_shade):
                captured[calls[0]] = ((lo, ld, t_init, tris, aabb, face0), k)
            calls[0] += 1
            return kernel_fn(lo, ld, t_init, tris, aabb, face0, stats, **k)

        M_.mesh_closest_hit_rays = capture
        try:
            one_wave()
        finally:
            M_.mesh_closest_hit_rays = kernel_fn
        stamp("captured one wave's kernel inputs")
        kinds, err = {}, 0.0
        for key, label in ((0, "primary"), (1, "shadow"),
                           (per_shade, "bounce 1")):
            args, kw = captured[key]
            lo = args[0]
            kern = M_.mesh_closest_hit_rays(*args, **kw)
            plain = plain_fn(*args)
            torch.cuda.synchronize()
            live = lo[:, 0] < 1e6              # not a dead-lane sentinel
            hit = kern[1] >= 0
            check(torch.equal(kern[1], plain[1]),
                  f"mesh {label}: faces differ on "
                  f"{int((kern[1] != plain[1]).sum())} rays")
            e = max(float((k - p).abs().max())
                    for k, p in zip(kern[0:1] + kern[2:],
                                    plain[0:1] + plain[2:]))
            check(e == 0.0, f"mesh {label}: max abs err {e} against the "
                  "plain version")
            err = max(err, e)
            print(f"[wavefront] mesh_closest_hit vs plain, {label}: "
                  f"{lo.shape[0]} rays ({int(live.sum())} live, "
                  f"{int(hit.sum())} hit the ball), faces and hit masks "
                  f"equal, max_abs_err={e:.3e}", flush=True)
            kinds[label] = dict(rays=lo.shape[0], live=int(live.sum()),
                                hits=int(hit.sum()), max_abs_err=e)
            del kern, plain
        stamp("kernel against plain")

        # the frame, through `render`
        render(scene, wcfg, device=dev, tables=tables)    # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            T_.reset_counters(MESH, *counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, wcfg, seed=1 + rep, device=dev, tables=tables)
            dt = time.perf_counter() - t0
            counts = mesh_counts()
            check(counts["mesh_closest_hit"] == expected
                  and sum(counts.values()) == expected,
                  f"wavefront frame {rep}: launches {counts}, expected "
                  f"{expected} of mesh_closest_hit")
            check(np.isfinite(out.radiance).all(), "non-finite radiance")
            check(out.image.shape == (H, W, 3),
                  f"image shape {out.image.shape}")
            check(set(np.unique(out.sample_count)) <= {wcfg.min_samples,
                                                       wcfg.max_samples},
                  "sample counts outside the ladder")
            check(out.image.mean() > 5.0, "frame is black")
            if dt < frame_s:
                frame_s, res = dt, out
        refined = float((res.sample_count == wcfg.max_samples).mean())
        mrays = 2.0 * W * H * wcfg.max_samples / frame_s / 1e6
        (ROOT / "build").mkdir(exist_ok=True)
        png = ROOT / "build" / "chip_smoke_wavefront.png"
        write_png(str(png), res.image)
        print(f"[wavefront] frame {W}x{H} RenderConfig() (split both, "
              f"{wcfg.min_samples}->{wcfg.max_samples} spp, {wcfg.bounces} "
              f"bounces, shadows {wcfg.shadow_min}->{wcfg.shadow_max}): best "
              f"of 3 {frame_s:.4f} s, {mrays:.2f} Mrays/s (2*W*H*max_spp/t),"
              f" {expected} mesh_closest_hit launches/frame ({per_wave} per "
              f"wave), {refined:.4f} of pixels refined, mean byte "
              f"{res.image.mean():.2f}, png {png.relative_to(ROOT)}",
              flush=True)
        stamp("frames")
        # where one wave's device time goes (a frame is max_samples such
        # waves; the profiler over a whole frame's ~10^5 small ops costs
        # more than the frame)
        wave_s = min(host_ms(one_wave, 1), host_ms(one_wave, 1)) / 1e3
        busy_us, prof_ms, prof_n = profile_frame(
            "wavefront wave", wave_s, one_wave, kernel="mesh_hit_kernel")
        stamp("profiled one wave")

        # time per launch of each input kind: CUDA events with the queue
        # filled first, the plain version; work counts and the bound (the
        # profiler's kernel time is the wave's average above)
        for key, label in ((0, "primary"), (1, "shadow"),
                           (per_shade, "bounce 1")):
            args, kw = captured[key]
            kinds[label].update(mesh_launch_figures(
                "wavefront", label, scene, args, kw))
        stamp("timed the kernel and the plain version")

        # a 160x120 frame (2 spp) with the kernel and with the plain
        # version, one seed: the same draws, so the phase-2 tolerances apply
        small = build_scene(box_scene(*SMALL, with_mesh=True,
                                      light_size=1.0), device=dev)
        stab = scene_tables(small)
        scfg = wcfg.with_(min_samples=2, max_samples=2)
        T_.reset_counters(MESH)
        fk = render(small, scfg, seed=5, device=dev, tables=stab)
        check(T_.counter(MESH) == 2 * per_wave,
              "the small frame ran the kernel")
        T_.reset_counters(MESH)
        M_.mesh_closest_hit_rays = plain_fn
        try:
            fp = render(small, scfg, seed=5, device=dev, tables=stab)
        finally:
            M_.mesh_closest_hit_rays = kernel_fn
        check(T_.counter(MESH) == 0, "the plain frame launched the kernel")
        check(np.array_equal(fk.sample_count, fp.sample_count)
              and np.array_equal(fk.z >= 1e29, fp.z >= 1e29),
              "small frame: hit masks or sample counts differ")
        hitpx = fk.z < 1e29
        zrel = np.abs(fk.z - fp.z)[hitpx] / np.abs(fp.z[hitpx])
        ferr = np.abs(fk.radiance - fp.radiance).max(-1)
        share = float((ferr > ATOL).mean())
        check(float(zrel.max()) <= ZTOL, "small frame: z beyond rtol")
        check(share <= FLIP_SHARE and abs(fk.radiance.mean()
                                          / fp.radiance.mean() - 1.0)
              <= MEAN_TOL, f"small frame: {share:.4f} of pixels off, "
              f"means {fk.radiance.mean()} vs {fp.radiance.mean()}")
        print(f"[wavefront] {SMALL[0]}x{SMALL[1]} frame, kernel vs plain: "
              f"max_abs_err={float(ferr.max()):.3e}, share outside {ATOL:g} "
              f"{share:.5f}, means {fk.radiance.mean():.6f} vs "
              f"{fp.radiance.mean():.6f}", flush=True)
        # the splat sums each pixel's lanes in lane order, so the two
        # frames agree exactly where the kernel equals its plain version
        check(float(ferr.max()) == 0.0, "wavefront: the 160x120 frame "
              f"differs from the plain version's by {float(ferr.max())}")
        stamp("small frames")

        # hemisphere GI on the wavefront adds light
        gscene = build_scene(box_scene(400, 300, with_mesh=True), device=dev)
        gtab = scene_tables(gscene)
        gcfg = RenderConfig(min_samples=4, max_samples=4, bounces=2,
                            gi_mode="hemisphere", hemisphere_samples=4)
        check(render_path(gscene, gcfg)[0] == "wavefront",
              "the GI frame must take the wavefront")
        g_expected = gcfg.max_samples * 2 * (
            1 + gcfg.hemisphere_samples * max(gcfg.bounces - 1, 0)
            + gcfg.bounces)
        T_.reset_counters(MESH)
        t0 = time.perf_counter()
        gi_res = render(gscene, gcfg, device=dev, tables=gtab)
        gi_s = time.perf_counter() - t0
        check(T_.counter(MESH) == g_expected,
              f"GI frame: {T_.counter(MESH)} launches, expected {g_expected}")
        direct = render(gscene, gcfg.with_(gi_mode="none"), device=dev,
                        tables=gtab)
        gain = gi_res.radiance.mean() / direct.radiance.mean()
        check(np.isfinite(gi_res.radiance).all() and gain > 1.0,
              f"wavefront GI adds no light ({gain:.4f})")
        print(f"[wavefront] GI frame 400x300 4 spp 2 bounces hemisphere 4: "
              f"{gi_s:.3f} s (first frame), {g_expected} launches, mean "
              f"radiance {gain:.4f}x the frame without GI", flush=True)
        stamp("phase passed")
        prim = kinds["primary"]
        return {
            "launches": expected, "max_abs_err": err,
            "ms": prim["ms"], "ms_profiler": prof_ms,
            "plain_ms": prim["plain_ms"],
            "wave_s": wave_s,
            "bound_ms": prim["bound_ms"], "bound_by": prim["bound_by"],
            "library_ms": None, "frame_s": frame_s, "mrays_per_s": mrays,
            "device_busy_share": busy_us / 1e6 / wave_s,
            "profiled_launches": prof_n, "refined_share": refined,
            "small_frame_max_abs_err": float(ferr.max()),
            "gi_gain": float(gain), "per_input": kinds}

    def small_frame_vs_plain(tag, desc, fcfg, counter, launches=None,
                             **rkw):
        """A 160x120 frame with the wave kernel against the same frame with
        the plain wave put in the kernel's place (one seed, so the same
        draws; rkw: more arguments of `render`): the kernel launched
        `launches` times (default one a sample), hit masks and sample
        counts equal, z within rtol, at most 1% of pixels outside ATOL,
        means within 1%.  Returns the max abs error."""
        scene = build_scene(desc, device=dev)
        stab = scene_tables(scene)
        check(W_.launch_counter(stab) == counter,
              f"{tag}: wrong kernel variant")
        T_.reset_counters(counter)
        fk = render(scene, fcfg, seed=5, device=dev, tables=stab, **rkw)
        check(T_.counter(counter) == (launches or fcfg.max_samples),
              f"{tag}: the small frame ran the kernel")
        T_.reset_counters(counter)
        kernel_fns = R_.wave, R_.gi_wave
        R_.wave = (lambda cfg_, tables_, *a, stats=None, **k:
                   W_.wave_plain(cfg_, tables_, *a, **k))
        R_.gi_wave = (lambda *a, **k:
                      kernel_fns[1](*a, wave_fn=W_.wave_plain, **k))
        try:
            fp = render(scene, fcfg, seed=5, device=dev, tables=stab, **rkw)
        finally:
            R_.wave, R_.gi_wave = kernel_fns
        check(T_.counter(counter) == 0, f"{tag}: the plain frame launched "
              "the kernel")
        check(np.array_equal(fk.sample_count, fp.sample_count)
              and np.array_equal(fk.z >= 1e29, fp.z >= 1e29),
              f"{tag}: hit masks or sample counts differ")
        hitpx = fk.z < 1e29
        zrel = np.abs(fk.z - fp.z)[hitpx] / np.abs(fp.z[hitpx])
        ferr = np.abs(fk.radiance - fp.radiance).max(-1)
        share = float((ferr > ATOL).mean())
        check(float(zrel.max()) <= ZTOL, f"{tag}: z beyond rtol")
        check(share <= FLIP_SHARE and abs(fk.radiance.mean()
                                          / fp.radiance.mean() - 1.0)
              <= MEAN_TOL, f"{tag}: {share:.4f} of pixels off, means "
              f"{fk.radiance.mean()} vs {fp.radiance.mean()}")
        print(f"[{tag}] {scene.width}x{scene.height} frame "
              f"({scene.mesh.tri_a.shape[0]} faces), kernel vs plain: "
              f"max_abs_err={float(ferr.max()):.3e}, share outside {ATOL:g} "
              f"{share:.5f}, means {fk.radiance.mean():.6f} vs "
              f"{fp.radiance.mean():.6f}", flush=True)
        return float(ferr.max())

    def drive_mxu():
        """Phase 8: the main path's config on the 20,480-face ball (the
        untextured MXU variant), as phase 3; a 160x120 frame at
        mesh_subdiv=6 against the plain wave; then mesh_closest_hit_mxu on
        the frame's primary rays in the ball's local space."""
        t_phase = time.perf_counter()
        wave_res = drive("mxu", box_scene(W, H, with_mesh=True, mesh_subdiv=5),
                         box_scene(*SMALL, with_mesh=True, mesh_subdiv=5),
                         WAVE_MXU)
        wave_res["small_frame_subdiv6_max_abs_err"] = small_frame_vs_plain(
            "mxu", box_scene(*SMALL, with_mesh=True, mesh_subdiv=6),
            cfg.with_(min_samples=4, max_samples=4, split_mode="rr"),
            WAVE_MXU)
        check(wave_res["small_frame_subdiv6_max_abs_err"] == 0.0,
              "mxu: the subdiv-6 frame is not exact")
        print(f"[mxu] {time.perf_counter() - t_phase:.1f} s: wave kernel "
              "checks and figures", flush=True)

        # the dense closest hit on two ray sets in the ball's local space
        scene = build_scene(box_scene(W, H, with_mesh=True, mesh_subdiv=5),
                            device=dev)
        mesh = scene.mesh
        trim, sets, (lo, ld, t_init) = dense_inputs(X_, scene, dev)
        t0 = time.perf_counter()
        pack = X_.pack_faces(trim)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
        T_.reset_counters(MESH_MXU)
        kern = {k: X_.mesh_closest_hit_mxu(r, trim) for k, r in sets.items()}
        torch.cuda.synchronize()
        launches = T_.counter(MESH_MXU)
        check(launches == len(sets), f"mesh_closest_hit_mxu: {launches} "
              f"launches for {len(sets)} ray sets")
        err, res = 0.0, {}
        for name, rays16 in sets.items():
            # every 7th ray (68,608), spread over the set, exactly
            sub = rays16[::7].contiguous()
            plain = X_.mesh_closest_hit_mxu_plain(sub, trim)
            torch.cuda.synchronize()
            for k, p in zip(kern[name], plain):
                check(torch.equal(k[::7], p), f"mesh_closest_hit_mxu "
                      f"({name}): outputs differ from the plain version on "
                      f"{int((k[::7] != p).sum())} rays")
            err = max(err, max(float((k[::7].float() - p.float()).abs().max())
                               for k, p in zip(kern[name], plain)))
            stats = torch.zeros(X_.NSTAT, dtype=torch.int64, device=dev)
            X_.mesh_closest_hit_mxu(rays16, trim, stats=stats)
            filtered, rechecked, valid, tiles = stats.tolist()
            res[name] = {
                "rays": rays16.shape[0], "hits": int((kern[name][1] >= 0)
                                                     .sum()),
                "subset_rays": sub.shape[0],
                "subset_hits": int((plain[1] >= 0).sum()),
                "pairs_filtered": filtered, "pairs_rechecked": rechecked,
                "pairs_valid": valid, "survivor_share": rechecked / filtered,
                "tiles_with_survivor": tiles,
                "ms": events_ms(lambda: X_.mesh_closest_hit_mxu(rays16, trim),
                                reps=5),
                "ms_profiler": profiled_ms(
                    lambda: X_.mesh_closest_hit_mxu(rays16, trim),
                    key="mesh_hit_mxu_kernel"),
                "ms_subset": events_ms(
                    lambda: X_.mesh_closest_hit_mxu(sub, trim), reps=5),
                "plain_ms_subset": host_ms(
                    lambda: X_.mesh_closest_hit_mxu_plain(sub, trim), 1)}
            check(res[name]["subset_hits"] > 0,
                  f"no ray of the {name} subset hits the ball")
        # the primary rays through mesh_closest_hit (the packed 128-face
        # tables): the same hit mask; faces (mapped to arena ids) equal but
        # on rays that meet an edge shared by two faces
        col0, fpad, ar0, nt, _ = mesh.slot_pack[0]
        rays8, _ = M_.pack_rays(lo, ld, t_init)
        mh = M_.mesh_closest_hit(rays8, mesh.tri_packed[:, col0:col0 + fpad],
                                 mesh.tile_aabb[ar0:ar0 + nt], col0,
                                 tree=mesh.hit_tree, slot=0)
        torch.cuda.synchronize()
        kp = kern["primary"]
        mh_hit = mh[1][:W * H] >= 0
        check(torch.equal(mh_hit, kp[1][:W * H] >= 0),
              f"mesh_closest_hit_mxu and mesh_closest_hit: hit masks differ "
              f"on {int((mh_hit != (kp[1][:W * H] >= 0)).sum())} rays")
        arena = mesh.tri_perm.to(torch.int64)[
            mh[1][:W * H].clamp(min=0).to(torch.int64)]
        hits = res["primary"]["hits"]
        differ = int((mh_hit & (arena != kp[1][:W * H])).sum())
        face_share = differ / max(hits, 1)
        check(face_share <= 0.01, f"faces differ from mesh_closest_hit on "
              f"{face_share:.4f} of the hits")
        t_rel = float(((mh[0][:W * H] - kp[0][:W * H]).abs()
                       / kp[0][:W * H].abs())[mh_hit].max())
        t0 = time.perf_counter()         # warm from the subset's runs
        X_.mesh_closest_hit_mxu_plain(sets["primary"], trim)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3

        # the bound: the larger of the TF32 products (3 x 6 multiply-adds a
        # pair) over the tensor cores' rate, the filter's operations (3
        # adds and 3 logic operations a pair) and the exact test of the
        # pairs this run re-checked (39 each) over the FP32 rate, and the
        # bytes (64 B a ray and the matrix in, 20 B a ray out) over HBM's
        # rate; beside it the FP32-only bound of every pair and the issue
        # floor of the hot loop in cuobjdump's SASS
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()[0]) * 1e6
        code = sass(_build.library_path("mesh_hit_mxu"))
        loop, votes, hmma = sass_fast_path(code, "mesh_hit_mxu_kernel")
        loop /= max(votes, 1)      # a vote covers 2 x 8 faces x 64 rays
        for name, r in res.items():
            npad = r["rays"]
            f, rc = r["pairs_filtered"], r["pairs_rechecked"]
            tc_ms = f * 36 / TF32_FLOPS * 1e3
            fp_ms = (f * OPS["filter"] + rc * OPS["pair"]) / FP32_FLOPS * 1e3
            bytes_ms = (npad * 84 + trim.numel() * 4) / HBM_BPS * 1e3
            pairs = npad * trim.shape[0] * (trim.shape[2] // 5)
            r.update({
                "bound_ms": max(tc_ms, fp_ms, bytes_ms),
                "bound_by": "operations" if max(tc_ms, fp_ms) >= bytes_ms
                            else "bytes",
                "bound_tf32_ms": tc_ms, "bound_fp32_ms": fp_ms,
                "bound_bytes_ms": bytes_ms,
                "bound_cuda_cores_ms": pairs * OPS["pair"] / FP32_FLOPS * 1e3,
                "hot_loop_instructions": loop,
                "issue_floor_ms": loop * (pairs / 1024) / (132 * 4 * clock)
                                  * 1e3})
            print(f"[mxu] mesh_closest_hit_mxu {name}: {npad} rays "
                  f"({r['hits']} hit the ball), plain on every 7th "
                  f"({r['subset_rays']} rays, {r['subset_hits']} hits): "
                  f"outputs equal; {r['ms']:.4f} ms by events, "
                  f"{r['ms_profiler'] or float('nan'):.4f} by the profiler "
                  f"({r['ms_subset']:.4f} on the subset; its plain version "
                  f"{r['plain_ms_subset']:.1f}); pairs {r['pairs_filtered']} "
                  f"filtered, {r['pairs_rechecked']} re-checked (survivor "
                  f"share {r['survivor_share']:.6f}), {r['pairs_valid']} "
                  f"valid, {r['tiles_with_survivor']} 16x8 tiles with a "
                  f"survivor; bound {r['bound_ms']:.4f} ms (TF32 products "
                  f"{tc_ms:.4f}, FP32 filter and re-checks {fp_ms:.4f}, bytes"
                  f" {bytes_ms:.5f}; FP32 only "
                  f"{r['bound_cuda_cores_ms']:.4f}); hot loop {loop:.0f} "
                  f"instructions a vote of 1,024 pairs ({hmma} HMMA, "
                  f"{votes} votes an iteration), issue floor "
                  f"{r['issue_floor_ms']:.4f} ms at {clock / 1e6:.0f} MHz",
                  flush=True)
        print(f"[mxu] mesh_closest_hit_mxu: face tables packed in "
              f"{pack_ms:.2f} ms ({pack.rows.shape[0]} faces kept); the "
              f"primary rays' plain version {pms:.1f} ms; against "
              f"mesh_closest_hit: hit masks equal, faces differ on {differ} "
              f"of {hits} hits ({face_share:.5f}), t within rtol "
              f"{t_rel:.3e}", flush=True)
        print(f"[mxu] {time.perf_counter() - t_phase:.1f} s: phase passed",
              flush=True)
        p = res["primary"]
        dense = {"launches": launches, "max_abs_err": err, "ms": p["ms"],
                 "plain_ms": pms, "bound_ms": p["bound_ms"],
                 "bound_by": p["bound_by"], "library_ms": None,
                 "ray_sets": res, "pack_ms": pack_ms,
                 "faces_differ_from_mesh_closest_hit": differ,
                 "main_path": "phase 8: the frame's primary rays and a "
                              "scattered set, not a caller of the port"}
        return [wave_res, dense]

    def drive_photons():
        """Phase 10: the scene-file set written into build/photon_scene,
        loaded with the port's load_scene and built at W x H; the Final
        structure as rtf_tpu's CLI runs it: the caustic pass
        (prepare_caustic_grid) handed to `render` as caustic_grid, `render`
        given no global map (it shoots, grids and bakes both volumes
        itself), every launch counted; then each step timed on its own,
        the frame with both grids handed in, the photon map and volume of
        one chunk with mesh_closest_hit against its plain version (exact),
        a 160x120 hybrid frame against the plain wave (exact), and the
        exact-gather wavefront frame at 160x120."""
        from rtf_tpu_torch.gi import grid as GR_
        from rtf_tpu_torch.gi.photon import shoot_photons
        from rtf_tpu_torch.gi.volume import build_irradiance_volume
        from rtf_tpu_torch.render import integrator as I_
        from rtf_tpu_torch.render.config import PROFILES
        from rtf_tpu_torch.scene.xml_loader import load_scene
        t_phase = time.perf_counter()

        def stamp(what):
            print(f"[photons] {time.perf_counter() - t_phase:.1f} s: "
                  f"{what}", flush=True)

        def timed(fn):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0_

        def zero_counts():
            T_.reset_counters(MESH, MESH_MXU, *counters)
            torch.cuda.synchronize()

        xml = write_photon_scene(ROOT / "build" / "photon_scene", W, H)
        desc = load_scene(str(xml))
        scene = build_scene(desc, device=dev)
        tables = scene_tables(scene)
        pcfg = PROFILES["final"].with_(split_mode="rr", min_samples=8,
                                       max_samples=8)
        lights = [k for k in scene.light_kinds if k != "ambient"]
        check(len(lights) == 2 and scene.num_mesh_inst == 1
              and scene.mesh.tri_a.shape[0] == 320 and tables.textured
              and not tables.mxu, "the scene file's box: two lights, the "
              "320-face ball, file textures (the textured variant)")
        chunk = 131072
        passes = [(pcfg.photon_count, pcfg.photon_bounces),
                  (pcfg.caustic_count, pcfg.caustic_bounces)]
        mesh_expected = sum(-(-n // chunk) * (b + 1) for n, b in passes) \
            * scene.num_mesh_inst
        wave_expected = pcfg.max_samples * (1 + pcfg.hemisphere_samples)
        stamp(f"wrote and loaded {xml.relative_to(ROOT)} ({W}x{H}, "
              f"{scene.mesh.tri_a.shape[0]} faces, lights {lights})")

        # the main path as a user drives it, every launch counted
        zero_counts()
        t0 = time.perf_counter()
        caustic = R_.prepare_caustic_grid(scene, pcfg, 2, tables=tables)
        check(render_path(scene, pcfg, caustic) == ("fused", None),
              "the photon frame must take the fused path")
        first = render(scene, pcfg, seed=1, device=dev, tables=tables,
                       caustic_grid=caustic)
        first_s = time.perf_counter() - t0
        counts = mesh_counts()
        check(counts["mesh_closest_hit"] == mesh_expected
              and counts[WAVE_TEX] == wave_expected
              and sum(counts.values()) == mesh_expected + wave_expected
              and T_.counter(MESH_MXU) == 0,
              f"photons: launches {counts}, expected {mesh_expected} of "
              f"mesh_closest_hit and {wave_expected} of {WAVE_TEX}")
        check(np.isfinite(first.radiance).all()
              and first.image.shape == (H, W, 3)
              and (first.sample_count == pcfg.max_samples).all()
              and first.image.mean() > 5.0, "photons: the first frame")
        stamp(f"caustic pass + render with no global map (shoots, grids, "
              f"bakes, renders): {first_s:.3f} s; launches {counts}")

        # each step on its own (the same seeds as render's own passes)
        pm, photon_s = timed(lambda: shoot_photons(
            scene, pcfg, pcfg.photon_count, pcfg.photon_count,
            R_._pass_generator(scene, 1, 999), tables=tables))
        grid, grid_s = timed(lambda: GR_.build_photon_grid(
            pm, pcfg.knn_radius, scene.world_min, scene.world_max))
        cpm, caustic_s = timed(lambda: shoot_photons(
            scene, pcfg, pcfg.caustic_count, pcfg.caustic_count,
            R_._pass_generator(scene, 2, 998), caustic_only=True,
            tables=tables))
        cgrid, cgrid_s = timed(lambda: GR_.build_photon_grid(
            cpm, pcfg.caustic_radius, scene.world_min, scene.world_max))
        check(int(cgrid.n_valid) == int(caustic.n_valid),
              "the caustic pass is not deterministic")
        vol, bake_s = timed(lambda: R_._cached_volume(
            grid, pcfg.knn_radius, pcfg.knn_k, scene.world_min,
            scene.world_max))
        cvol, cbake_s = timed(lambda: R_._cached_volume(
            cgrid, pcfg.caustic_radius, pcfg.knn_k, scene.world_min,
            scene.world_max))
        occ_cap = max(2048, 2 * pcfg.knn_k)
        maps = {}
        for name, m, g, v, shot_s, g_s, b_s in (
                ("global", pm, grid, vol, photon_s, grid_s, bake_s),
                ("caustic", cpm, cgrid, cvol, caustic_s, cgrid_s, cbake_s)):
            capped = GR_.cap_occupancy(g, occ_cap).max_occupancy
            check(bool(torch.isfinite(v.table).all()),
                  f"{name} volume not finite")
            maps[name] = dict(
                stored=int(m.count), pass_s=shot_s, grid_s=g_s, bake_s=b_s,
                max_occupancy=g.max_occupancy, max_occupancy_capped=capped,
                grid_dims=g.dims, volume_dims=v.dims,
                corners=v.table.shape[1],
                corners_lit=int((v.table[:3].amax(0) > 0).sum()))
            print(f"[photons] {name} map: {m.count} stored, pass "
                  f"{shot_s:.3f} s, grid {g.dims} in {g_s:.3f} s, "
                  f"max_occupancy {g.max_occupancy} (capped at {occ_cap}: "
                  f"{capped}), volume {v.dims} cells, {v.table.shape[1]} "
                  f"corners ({maps[name]['corners_lit']} lit) baked in "
                  f"{b_s:.3f} s", flush=True)
        check(maps["global"]["stored"] > 100000
              and maps["caustic"]["stored"] > 1000, "too few photons")

        def shoot_chunk():
            return shoot_photons(   # room for a store at every bounce
                scene, pcfg, chunk, chunk * pcfg.photon_bounces,
                torch.Generator(device=dev).manual_seed(11), tables=tables)
        chunk_s = min(timed(shoot_chunk)[1] for _ in range(2))
        chunk_busy_us, chunk_prof_ms, _ = profile_frame(
            "photon chunk", chunk_s, shoot_chunk, kernel="mesh_hit_kernel")
        stamp(f"timed the passes, grids and bakes; one chunk of {chunk} "
              f"global photons {chunk_s:.4f} s")

        # the frame with both grids handed in (their volumes cached)
        rkw = dict(device=dev, tables=tables, gi_grid=grid,
                   caustic_grid=cgrid)
        render(scene, pcfg, seed=3, **rkw)              # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            zero_counts()
            t0 = time.perf_counter()
            out = render(scene, pcfg, seed=1 + rep, **rkw)
            dt = time.perf_counter() - t0
            counts = mesh_counts()
            check(counts[WAVE_TEX] == wave_expected
                  and sum(counts.values()) == wave_expected,
                  f"photon frame {rep}: launches {counts}")
            check(np.isfinite(out.radiance).all()
                  and out.image.mean() > 5.0, "photons: a frame")
            if dt < frame_s:
                frame_s, res = dt, out
        direct = render(scene, pcfg.with_(gi_mode="none"), seed=1,
                        device=dev, tables=tables)
        gain = res.radiance.mean() / direct.radiance.mean()
        check(gain > 1.0, f"photons: GI adds no light ({gain:.4f})")
        png = ROOT / "build" / "chip_smoke_photons.png"
        write_png(str(png), res.image)
        busy_us, prof_ms, _ = profile_frame(
            "photons", frame_s, lambda: render(scene, pcfg, seed=9, **rkw))
        print(f"[photons] frame {W}x{H} {pcfg.max_samples}spp "
              f"{pcfg.bounces} bounces photon GI, {pcfg.hemisphere_samples}"
              f" hemisphere samples, both grids handed in: best of 3 "
              f"{frame_s:.4f} s, {wave_expected} launches/frame, mean "
              f"radiance {gain:.4f}x the frame without GI, png "
              f"{png.relative_to(ROOT)}", flush=True)
        kinds, errs, _ = gi_launch_kinds(
            "photons", pcfg, scene, tables, vol, cvol,
            torch.Generator(device=dev).manual_seed(5))
        stamp("frames and launch figures")

        # one chunk with mesh_closest_hit and with its plain version in the
        # kernel's place, from one generator seed: maps and volumes equal
        captured, calls = {}, [0]
        kernel_fn = M_.mesh_closest_hit_rays

        def capture(*a, **k):
            if calls[0] == 1:                  # the first bounce's trace
                captured["bounce 1"] = (a, k)
            calls[0] += 1
            return kernel_fn(*a, **k)

        def one_chunk(fn):
            M_.mesh_closest_hit_rays = fn
            try:
                cpm_ = shoot_chunk()
                g_ = GR_.build_photon_grid(cpm_, pcfg.knn_radius,
                                           scene.world_min, scene.world_max)
                return cpm_, build_irradiance_volume(
                    g_, pcfg.knn_radius, pcfg.knn_k, scene.world_min,
                    scene.world_max)
            finally:
                M_.mesh_closest_hit_rays = kernel_fn
        zero_counts()
        (kmap, kvol) = one_chunk(capture)
        check(T_.counter(MESH) == pcfg.photon_bounces + 1,
              f"the chunk launched the kernel {T_.counter(MESH)} times")
        (pmap, pvol) = one_chunk(plain_fn)
        check(T_.counter(MESH) == pcfg.photon_bounces + 1,
              "the plain chunk launched the kernel")
        chunk_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(tuple(kmap) + (kvol.table,),
                                        tuple(pmap) + (pvol.table,)))
        check(chunk_err == 0.0 and int(kmap.count) == int(pmap.count)
              < chunk * pcfg.photon_bounces,
              f"photons: the chunk's map or volume differs from the plain "
              f"version's by {chunk_err}")
        print(f"[photons] one chunk of {chunk} photons, mesh_closest_hit "
              f"against its plain version: {int(kmap.count)} stored, map "
              f"and volume equal (max_abs_err={chunk_err:.3e})", flush=True)
        mesh_fig = mesh_launch_figures("photons", "bounce 1", scene,
                                       *captured["bounce 1"])

        # a 160x120 hybrid frame from those volumes, kernel against plain
        small_desc = load_scene(str(xml))
        small_desc.camera.width, small_desc.camera.height = SMALL
        scfg = pcfg.with_(min_samples=2, max_samples=2,
                          hemisphere_samples=4)
        small_err = small_frame_vs_plain(
            "photons", small_desc, scfg, WAVE_TEX,
            launches=2 * 5, gi_grid=kvol, caustic_grid=cvol)
        check(small_err == 0.0, f"photons: the 160x120 hybrid frame "
              f"differs from the plain wave's by {small_err}")
        stamp("kernel against plain")

        # the exact-gather wavefront frame at 160x120
        small = build_scene(small_desc, device=dev)
        stab = scene_tables(small)
        ecfg = scfg.with_(photon_volume=False)
        check(render_path(small, ecfg, cgrid)[0] == "wavefront",
              "photon_volume=False must take the wavefront")
        gathers = []
        est_fn = I_.estimate_irradiance

        def timed_est(g, qp, qn, radius, k):
            out, dt = timed(lambda: est_fn(g, qp, qn, radius, k))
            gathers.append((qp.shape[0], dt, g is cgrid, (g, qp, qn)))
            return out
        I_.estimate_irradiance = timed_est
        try:
            ex, ex_s = timed(lambda: render(
                small, ecfg, device=dev, tables=stab, gi_grid=grid,
                caustic_grid=cgrid))
        finally:
            I_.estimate_irradiance = est_fn
        none = render(small, ecfg.with_(gi_mode="none"), device=dev,
                      tables=stab)
        ex_gain = ex.radiance.mean() / none.radiance.mean()
        check(np.isfinite(ex.radiance).all() and ex_gain > 1.0,
              f"the exact-gather frame adds no light ({ex_gain:.4f})")
        per_call = {}
        for name, is_c in (("global", False), ("caustic", True)):
            sel = [x for x in gathers if x[2] == is_c]
            check(len(sel) > 0, f"no {name} gather in the exact frame")
            per_call[name] = dict(
                calls=len(sel), queries=sel[0][0],
                ms_per_call=sum(x[1] for x in sel) / len(sel) * 1e3)
        # the gather pass alone on one global call's candidates
        g_, qp_, qn_ = next(x[3] for x in gathers if not x[2])
        start, cnt = GR_._cell_ranges(g_, qp_, g_.max_occupancy)
        total = int(cnt.sum())
        cand = GR_._Candidates(g_, qp_, start, cnt, total)
        front = (g_.dir[cand.idx] * qn_[cand.q]).sum(-1) < 0.0
        r2 = torch.full((qp_.shape[0],), pcfg.knn_radius ** 2, device=dev)
        gather_ms = events_ms(lambda: GR_._gather_pass(g_, cand, front, r2,
                                                       0), reps=10)
        print(f"[photons] exact-gather wavefront frame {SMALL[0]}x"
              f"{SMALL[1]} ({ecfg.max_samples} spp, {ecfg.bounces} bounces,"
              f" {ecfg.hemisphere_samples} hemisphere samples): "
              f"{ex_s:.3f} s, mean radiance {ex_gain:.4f}x without GI; "
              f"estimate_irradiance "
              + "; ".join(f"{k} {v['calls']} calls of {v['queries']} "
                          f"queries, {v['ms_per_call']:.3f} ms a call"
                          for k, v in per_call.items())
              + f"; _gather_pass alone on {total} candidates "
              f"{gather_ms:.4f} ms (CUDA events)", flush=True)
        stamp("phase passed")
        p, c = kinds["primary"], kinds["child"]
        s_hemi = pcfg.hemisphere_samples

        def per_launch(k):
            return (p[k] + s_hemi * c[k]) / (1 + s_hemi)
        common = {"frame_s": frame_s, "first_frame_s": first_s,
                  "device_busy_share": busy_us / 1e6 / frame_s,
                  "maps": maps, "library_ms": None}
        return [
            {"launches": mesh_expected, "max_abs_err": chunk_err,
             "ms": mesh_fig["ms"], "ms_profiler": chunk_prof_ms,
             "plain_ms": mesh_fig["plain_ms"], "chunk_s": chunk_s,
             "chunk_device_busy_share": chunk_busy_us / 1e6 / chunk_s,
             "bound_ms": mesh_fig["bound_ms"],
             "bound_by": mesh_fig["bound_by"], "bounce_1": mesh_fig,
             **common},
            {"launches": wave_expected,
             "max_abs_err": max(errs + [small_err]),
             "ms": per_launch("ms"), "ms_profiler": prof_ms,
             "plain_ms": per_launch("plain_ms"),
             "bound_ms": per_launch("bound_ms"),
             "bound_by": c["bound_by"], "per_launch_kind": kinds,
             "exact_gather": {"frame_s": ex_s, "gain": float(ex_gain),
                              "per_call": per_call,
                              "gather_pass_ms": gather_ms,
                              "gather_pass_candidates": total},
             "gain": float(gain), **common}]

    def drive_cli():
        """Phase 11: the port's command line as a user runs it, each call a
        fresh `python -m rtf_tpu_torch.cli` process at 800x600 on phase
        10's scene-file set; then the irradiance cache in-process: the
        counted main run of render_with_cache (proj11), its build and the
        cached frame timed, the evaluator's launches per level (events,
        plain, bound), one profiled build, and the kernels against their
        plain versions: the evaluator at every level, the first hits on
        mesh_closest_hit, a 160x120 cached frame (exact)."""
        import re

        from rtf_tpu_torch.gi import irradiance_cache as IC_
        from rtf_tpu_torch.gi.io import load_photon_dat
        from rtf_tpu_torch.render.config import PROFILES
        from rtf_tpu_torch.render.scene_tables import fused_reason
        from rtf_tpu_torch.scene.xml_loader import load_scene
        from rtf_tpu_torch.utils.png import read_png
        t_phase = time.perf_counter()

        def stamp(what):
            print(f"[cli] {time.perf_counter() - t_phase:.1f} s: {what}",
                  flush=True)

        xml = ROOT / "build" / "photon_scene" / "box.xml"
        if not xml.exists():
            write_photon_scene(xml.parent, W, H)
        out = ROOT / "build" / "cli"
        out.mkdir(parents=True, exist_ok=True)
        for f in out.iterdir():         # watch --resume starts fresh
            f.unlink()
        calls = {}

        def text_of(x):
            return x.decode() if isinstance(x, bytes) else (x or "")

        def cli(*jobs, timeout=600):
            """CLI calls, each (tag, argv) in its own process, all started
            at once; fails the phase on a nonzero exit (printing the call's
            output) or past the timeout.  Returns their standard outputs."""
            procs = []
            for tag, argv in jobs:
                argv = [str(x) for x in argv]
                procs.append((tag, argv, time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-m", "rtf_tpu_torch.cli", *argv],
                    cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
            texts = []
            try:
                for tag, argv, t0, proc in procs:
                    left = max(timeout - (time.perf_counter() - t0), 1.0)
                    try:
                        so, se = proc.communicate(timeout=left)
                    except subprocess.TimeoutExpired:
                        fail(f"cli {tag}: no exit within {timeout} s")
                    dt = time.perf_counter() - t0
                    if proc.returncode != 0:
                        print(so + se, flush=True)
                        fail(f"cli {tag}: exit code {proc.returncode}")
                    times = re.findall(r"Render time is \d+:\d\d:\d\d",
                                       so)
                    calls[tag] = dict(argv=argv, wall_s=dt,
                                      together_with=len(jobs) - 1,
                                      render_time=times[-1] if times
                                      else None)
                    print(f"[cli] {tag}: exit 0, {dt:.1f} s wall"
                          + (f" (with {len(jobs) - 1} other calls at once)"
                             if len(jobs) > 1 else "")
                          + (f"; {times[-1]}" if times else ""), flush=True)
                    texts.append(so)
            finally:
                for _, _, _, proc in procs:       # stop what still runs
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            return texts

        def png(name, constant=False):
            img = read_png(str(out / name))
            check(img.shape[:2] == (H, W), f"cli: {name} is {img.shape}")
            check((float(img.std()) == 0.0) == constant,
                  f"cli: {name} is {'not ' if constant else ''}constant")

        # ---- the seven subcommands, each in its own process: the three
        # renders one at a time (their wall times are theirs alone), then
        # the short calls at once
        (text,) = cli(("render --profile proj11 --gi-cache", [
            "render", xml, "--profile", "proj11", "--gi-cache", "--zbuffer",
            out / "cache_z.png", "--samplecount", out / "cache_sc.png",
            "--out", out / "cache.png"]))
        check("of pixels traced, rest interpolated" in text,
              "cli: no irradiance-cache line")
        for name in ("cache.png", "cache_z.png", "cache_sc.png"):
            png(name)
        (text,) = cli(("render --profile final --caustics", [
            "render", xml, "--profile", "final", "--caustics",
            "--photon-dump", out / "final.dat", "--spp", "8", "--out",
            out / "final.png"]))
        dumped = int(re.search(r"photon pass: (\d+) photons",
                               text).group(1))
        check(len(load_photon_dat(str(out / "final.dat"))[0]) == dumped > 0,
              "cli: the photon dump does not reload with its count")
        png("final.png")
        state = out / "watch.npz"
        (text,) = cli(("watch --spp 4", [
            "watch", xml, "--spp", "4", "--resume", "--state", state,
            "--out", out / "watch.png"]))
        st = np.load(state)
        check(int(st["done"]) == 4 and int(st["pass_ix"]) == 3
              and re.findall(r"\[(\d)/4 spp\]", text) == ["1", "3", "4"],
              "cli: watch did not make passes of 1, 2 and 1 spp")
        png("watch.png")
        texts = cli(
            ("photons --count 1000000", ["photons", xml, "--count",
                                         "1000000", "--out",
                                         out / "pm.dat"]),
            ("preview", ["preview", xml, "--out", out / "preview.png"]),
            ("probe --pixel 400,300", ["probe", xml, "--pixel", "400,300"]),
            *((f"view --mode {m}", ["view", xml, state, "--mode", m,
                                    "--out", out / f"view_{m}.png"])
              for m in ("image", "z", "samplecount")))
        stored = int(re.search(r"stored (\d+) photons", texts[0]).group(1))
        check(len(load_photon_dat(str(out / "pm.dat"))[0]) == stored > 0,
              "cli: pm.dat does not reload with its stored count")
        png("preview.png")
        check("pixel (400, 300):" in texts[2] and "samples: 1" in texts[2],
              "cli: probe printed no pixel")
        for m in ("image", "z", "samplecount"):
            # every pixel of a watch pass takes the pass's samples, so the
            # sample-count view of a watch state is constant
            png(f"view_{m}.png", constant=m == "samplecount")
        cli(("viz", ["viz", out / "pm.dat", "--out", out / "viz.png"]))
        png("viz.png")
        stamp(f"{len(calls)} CLI calls")

        # ---- the cache in-process: the counted main run
        scene = build_scene(load_scene(str(xml)), device=dev)
        tables = scene_tables(scene)
        ccfg = PROFILES["proj11"]
        hemi = ccfg.hemisphere_samples
        check(render_path(scene, ccfg.with_(gi_mode="none"))[0]
              == "wavefront" and tables.textured and fused_reason(
                  scene, ccfg.with_(gi_mode="none", split_mode="rr")) is None,
              "cli: proj11's direct pass takes the wavefront, the "
              "evaluator the textured GI variant")
        lights = sum(1 for k in scene.light_kinds if k != "ambient")
        mesh_expected = scene.num_mesh_inst * (
            1 + R_._phase_bounds(ccfg)[-1] * (1 + ccfg.bounces)
            * (1 + lights))
        levels, first_hits = [], {}
        fused_fn, mesh_fn = IC_._eval_irradiance_fused, \
            M_.mesh_closest_hit_rays

        def zero_counts():
            T_.reset_counters(MESH, MESH_MXU, *counters)
            torch.cuda.synchronize()

        def spy(scene_, cfg_, tables_, p, n, mask, draws, level,
                wave_fn=None):
            levels.append(dict(level=level, lanes=p.shape[0],
                               traced=int(mask.sum()), inputs=(p, n, mask),
                               grid=len(IC_._grid_points(
                                   W, H, 16 >> level)[0])))
            return fused_fn(scene_, cfg_, tables_, p, n, mask, draws, level,
                            wave_fn)

        mesh_calls = [0]

        def capture(*a, **k):
            # the first-hit trace's launch, and the direct pass's first
            # shadow trace (after its primary trace)
            if mesh_calls[0] == 0:
                first_hits["call"] = (a, k)
            elif mesh_calls[0] == 2 * scene.num_mesh_inst:
                first_hits["direct"] = (a, k)
            mesh_calls[0] += 1
            return mesh_fn(*a, **k)
        zero_counts()
        IC_._eval_irradiance_fused, M_.mesh_closest_hit_rays = spy, capture
        try:
            t0 = time.perf_counter()
            res, cache = IC_.render_with_cache(scene, ccfg, 1, device=dev,
                                               tables=tables)
            first_s = time.perf_counter() - t0
        finally:
            IC_._eval_irradiance_fused, M_.mesh_closest_hit_rays = \
                fused_fn, mesh_fn
        counts = mesh_counts()
        wave_expected = hemi * len(levels)
        check(counts[WAVE_TEX] == wave_expected > 0
              and counts["mesh_closest_hit"] == mesh_expected
              and sum(counts.values()) == wave_expected + mesh_expected,
              f"cli: launches {counts}, expected {wave_expected} of "
              f"{WAVE_TEX} and {mesh_expected} of mesh_closest_hit")
        share = float(cache.computed.float().mean())
        check(np.isfinite(res.radiance).all() and res.image.mean() > 5.0
              and 0.0 < share < 0.6, "cli: the cached frame")
        print(f"[cli] render_with_cache {W}x{H} proj11 (first run): "
              f"{first_s:.3f} s; launches {counts}; points traced per level "
              + ", ".join(f"{x['level']}: {x['traced']} of {x['grid']}"
                          for x in levels)
              + f"; {share:.4f} of pixels traced", flush=True)

        def synced(fn):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0_

        def build(seed):
            return IC_.build_irradiance_cache(scene, ccfg, seed, device=dev,
                                              tables=tables)

        def cached(seed):
            return IC_.render_with_cache(scene, ccfg, seed, device=dev,
                                         tables=tables)
        synced(lambda: build(2))                         # warm-up
        build_s = min(synced(lambda: build(3 + r)) for r in range(3))
        synced(lambda: cached(2))
        cached_s = min(synced(lambda: cached(3 + r)) for r in range(3))
        busy_us, build_prof_ms, _ = profile_frame(
            "cli cache build", build_s, lambda: build(9))
        # the profiler over a cached frame's ~10^5 small wavefront ops
        # costs more than the frame: the mesh kernel's own time from five
        # first-hit traces instead
        mesh_prof_ms = profiled_ms(lambda: IC_._first_hits(scene, tables),
                                   key="mesh_hit_kernel")
        stamp(f"build_irradiance_cache best of 3 {build_s:.4f} s, "
              f"render_with_cache {cached_s:.4f} s (synchronised host "
              f"clock); device busy {busy_us / 1e6 / build_s:.4f} of a "
              f"build; mesh_closest_hit on the first hits {mesh_prof_ms} ms "
              "(profiler)")

        # ---- the evaluator's child launch at each level's shape
        cfg_s = ccfg.with_(hemisphere_samples=hemi)
        gen11 = torch.Generator(device=dev).manual_seed(11)
        per_level = []
        for x in levels:
            p, n, mask = x["inputs"]
            one = torch.ones(p.shape[0], device=dev)
            surf = torch.stack([p[:, 0], p[:, 1], p[:, 2], n[:, 0], n[:, 1],
                                n[:, 2], one, one, one, one, one, one])
            u = torch.rand((2, p.shape[0]), generator=gen11, device=dev)
            args, ckw = child_wave_args(cfg_s, surf, mask, mask, 11, 0,
                                        u[0], u[1])

            def child(fn=W_.wave, _a=args, _k=ckw, **kw):
                return fn(cfg_s, tables, *_a, **_k, **kw)
            nl = p.shape[0]
            rows_out = W_.out_rows(ckw["bounces"] + 1, False, None)
            ms = events_ms(child)
            pms = host_ms(lambda: child(W_.wave_plain), 1)
            st_, _ = work(child, nl)
            bd = bound(tables, st_, nl, 14, rows_out)
            per_level.append(dict(level=x["level"], lanes=nl,
                                  traced=x["traced"], ms=ms, plain_ms=pms,
                                  work=st_, **bd))
            print(f"[cli] evaluator child launch, level {x['level']} "
                  f"({nl} lanes): {ms:.4f} ms (mean of 20, CUDA events), "
                  f"plain {pms:.2f} ms; {bd['flops']:.4e} FP32 ops, "
                  f"{bd['bytes']} bytes; bound {bd['bound_ms']:.5f} ms "
                  f"({bd['bound_by']})", flush=True)

        # ---- the kernels against their plain versions, bit for bit
        errs = []
        for x in levels:
            p, n, mask = x["inputs"]
            e = [IC_._eval_irradiance_fused(
                scene, ccfg, tables, p, n, mask,
                IC_.CacheDraws(torch.Generator(device=dev).manual_seed(5)),
                x["level"], wave_fn=fn) for fn in (None, W_.wave_plain)]
            errs.append(float((e[0] - e[1]).abs().max()))
            print(f"[cli] evaluator, level {x['level']} ({p.shape[0]} "
                  f"lanes, {hemi} hemisphere samples), kernel vs plain: "
                  f"max_abs_err={errs[-1]:.3e}", flush=True)
        a, k = first_hits["call"]
        kern = IC_._first_hits(scene, tables)
        M_.mesh_closest_hit_rays = plain_fn
        try:
            plain = IC_._first_hits(scene, tables)
        finally:
            M_.mesh_closest_hit_rays = mesh_fn
        mesh_err = max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(kern, plain))
        print(f"[cli] _first_hits ({W * H} rays), mesh_closest_hit vs its "
              f"plain version: max_abs_err={mesh_err:.3e}", flush=True)
        da, dk = first_hits["direct"]
        dkern = M_.mesh_closest_hit_rays(*da, **dk)
        dplain = plain_fn(*da)
        check(torch.equal(dkern[1], dplain[1]), "cli: the direct pass's "
              "shadow launch: faces differ from the plain version")
        direct_err = max(float((x - y).abs().max()) for x, y in zip(
            dkern[0:1] + dkern[2:], dplain[0:1] + dplain[2:]))
        print(f"[cli] the direct pass's first shadow trace ({da[0].shape[0]}"
              f" rays, {int((dkern[1] >= 0).sum())} hit the ball), "
              f"mesh_closest_hit vs its plain version: faces equal, "
              f"max_abs_err={direct_err:.3e}", flush=True)
        del dkern, dplain
        mesh_fig = mesh_launch_figures("cli", "first hits", scene, a, k)
        small_desc = load_scene(str(xml))
        small_desc.camera.width, small_desc.camera.height = SMALL
        small = build_scene(small_desc, device=dev)
        stab = scene_tables(small)
        T_.reset_counters(WAVE_TEX)
        fk, ck = IC_.render_with_cache(small, ccfg, 5, device=dev,
                                       tables=stab)
        check(T_.counter(WAVE_TEX) > 0, "cli: the small cached frame ran "
              "no wave kernel")
        T_.reset_counters(WAVE_TEX)
        kernel_wave = IC_.wave
        IC_.wave = (lambda cfg_, tables_, *a_, stats=None, **k_:
                    W_.wave_plain(cfg_, tables_, *a_, **k_))
        try:
            fp, cp = IC_.render_with_cache(small, ccfg, 5, device=dev,
                                           tables=stab)
        finally:
            IC_.wave = kernel_wave
        check(T_.counter(WAVE_TEX) == 0, "cli: the plain cached frame "
              "launched the kernel")
        small_err = max(float(np.abs(fk.radiance - fp.radiance).max()),
                        float((ck.E - cp.E).abs().max()))
        check(np.array_equal(fk.z, fp.z)
              and torch.equal(ck.computed, cp.computed), "cli: the small "
              "cached frames differ in z or in the traced points")
        print(f"[cli] {SMALL[0]}x{SMALL[1]} render_with_cache, kernel vs "
              f"plain wave: max_abs_err={small_err:.3e}", flush=True)
        check(max(errs + [mesh_err, direct_err, small_err]) == 0.0,
              f"cli: a kernel differs from its plain version "
              f"({errs}, {mesh_err}, {direct_err}, {small_err})")
        stamp("phase passed")

        def mean(k):
            return sum(x[k] for x in per_level) / len(per_level)
        common = {"library_ms": None, "cache_build_s": build_s,
                  "render_with_cache_s": cached_s,
                  "first_render_with_cache_s": first_s,
                  "traced_share": share, "cli_calls": calls}
        return [
            {"launches": wave_expected,
             "max_abs_err": max(errs + [small_err]),
             "ms": mean("ms"), "ms_profiler": build_prof_ms,
             "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
             "bound_by": per_level[-1]["bound_by"],
             "device_busy_share_build": busy_us / 1e6 / build_s,
             "per_level": [{k_: v for k_, v in x.items()
                            if k_ != "work"} for x in per_level], **common},
            {"launches": mesh_expected,
             "launches_first_hits": scene.num_mesh_inst,
             "launches_direct_pass": mesh_expected - scene.num_mesh_inst,
             "figures_of": "the first-hit launch alone (ms, plain_ms, "
                           "bound_ms); max_abs_err over it and the direct "
                           "pass's first shadow launch; the direct pass's "
                           "wavefront launches are counted, not timed here",
             "max_abs_err": max(mesh_err, direct_err),
             "max_abs_err_direct_pass": direct_err,
             "ms": mesh_fig["ms"], "ms_profiler": mesh_prof_ms,
             "plain_ms": mesh_fig["plain_ms"],
             "bound_ms": mesh_fig["bound_ms"],
             "bound_by": mesh_fig["bound_by"], "first_hits": mesh_fig,
             **common}]

    def drive_bvh():
        """Phase 12: the BVH walk (csrc/bvh_hit.cu) on the wavefront's
        mesh_algo="bvh", the dense mesh test, footprint filtering and the
        sharded render, on box_scene(800, 600, mesh_subdiv=5,
        light_size=1.0) (the 20,480-face ball): the kernel against its plain
        version on one wave's primary and shadow rays and on a seeded
        scattered set (exact), and against mesh_closest_hit; its time,
        counters and bound; RenderConfig() with mesh_algo="bvh" (best of 3,
        840 launches a frame) and a 160x120 frame against the plain walk
        (exact); mesh_algo="dense" on the primary rays and a 160x120 frame;
        tex_filter on the textured box at 800x600; render_sharded on a 1x1
        NCCL mesh against render_device_host on the main config (exact)."""
        import dataclasses
        import socket

        from torch import distributed as dist

        from rtf_tpu_torch.ops import bvh_hit as B_
        from rtf_tpu_torch.ops.trace import _dense_mesh
        from rtf_tpu_torch.parallel.distributed import init_multihost
        from rtf_tpu_torch.parallel.mesh import make_mesh, render_sharded
        from rtf_tpu_torch.scene.build import ensure_bvh
        t_phase = time.perf_counter()

        def stamp(what):
            print(f"[bvh] {time.perf_counter() - t_phase:.1f} s: {what}",
                  flush=True)
        wcfg = RenderConfig()
        base = build_scene(box_scene(W, H, with_mesh=True, mesh_subdiv=5,
                                     light_size=1.0), device=dev)
        check(base.mesh.tri_a.shape[0] == 20480 and base.num_mesh_inst == 1,
              "bvh: the scene has one 20,480-face ball")
        scene = dataclasses.replace(base, mesh_algo="bvh")
        tables = scene_tables(scene)
        check(render_path(scene, wcfg)[0] == "wavefront",
              "bvh: RenderConfig() takes the wavefront")
        mesh = scene.mesh
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ensure_bvh(mesh)
        walk = B_.bvh_walk(mesh)
        torch.cuda.synchronize()
        bvh_build_s = time.perf_counter() - t0
        check(walk.walk == "wide", f"bvh: the depth rule took the "
              f"{walk.walk} walk on the ball")
        depth = walk.levels
        binary = B_.build_walk(mesh, "binary")
        print(f"[bvh] BVH of {mesh.tri_a.shape[0]} faces: "
              f"{mesh.bvh_min.shape[0]} binary nodes in {depth} levels, "
              f"{walk.wnodes.shape[0]} {B_.WIDTH}-wide nodes, a stack of "
              f"{walk.stack} entries; built in {bvh_build_s:.3f} s (the "
              f"C++ builder, the collapse and the face rows, once per "
              f"arena)", flush=True)
        root = walk.roots[0]
        per_shade = (1 + wcfg.shadow_min + wcfg.shadow_max) \
            * scene.num_mesh_inst
        per_wave = per_shade * (1 + wcfg.bounces)
        expected = per_wave * wcfg.max_samples
        kernel_fn = B_.bvh_closest_hit
        order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
        o, d = primary_rays(scene, order % W, order // W, torch.tensor(0))
        ids = torch.arange(W * H, device=dev)

        def one_wave(sc=scene, tb=tables):
            return render_wave(
                sc, wcfg, tb, o, d, ids,
                torch.ones(W * H, dtype=torch.bool, device=dev),
                torch.Generator(device=dev).manual_seed(3), W * H,
                inv_pixel=ids)
        sets = bvh_sets(B_, scene, one_wave, per_wave, dev)
        col0, fpad, ar0, nt, _ = mesh.slot_pack[0]
        perm = mesh.tri_perm.to(torch.int64)
        tbytes = {"wide": walk.wnodes.numel() * 4 + walk.face_rows.numel() * 4,
                  "binary": binary.nodes.numel() * 4
                  + binary.leaf_tris.numel() * 4}
        kinds, err, ties_all = {}, 0.0, 0
        for label, (lo, ld, t_init) in sets.items():
            sk, sw, sp = (torch.zeros(B_.NSTAT, dtype=torch.int64,
                                      device=dev) for _ in range(3))
            kern = B_.bvh_closest_hit(mesh, root, lo, ld, t_init, stats=sk)
            twin = B_.bvh_wide_closest_hit_plain(walk, root, lo, ld, t_init,
                                                 stats=sw)
            plain = B_.bvh_closest_hit_plain(mesh, root, lo, ld, t_init,
                                             stats=sp)
            torch.cuda.synchronize()
            e = max(float((k.float() - p.float()).abs().max())
                    for k, p in zip(kern, twin))
            check(e == 0.0 and torch.equal(kern[1], twin[1]),
                  f"bvh {label}: max abs err {e} against the wide twin")
            check(torch.equal(sk, sw), f"bvh {label}: counters "
                  f"{sk.tolist()} against the wide twin's {sw.tolist()}")
            n = lo.shape[0]
            hit = kern[1] >= 0
            check(torch.equal(hit, plain[1] >= 0)
                  and torch.equal(kern[0], plain[0]),
                  f"bvh {label}: hit masks or t differ from the lock-step "
                  f"walk's on {int((kern[0] != plain[0]).sum())} rays")
            idx, tie = B_.near_ties(mesh, lo, ld, kern, plain)
            for i, ok_ in zip(idx.tolist()[:16], tie.tolist()[:16]):
                kind_ = "near tie" if ok_ else "NOT A TIE"
                print(f"[bvh] {label} ray {i}: {kind_}: wide walk t "
                      f"{float(kern[0][i]):.9g} face {int(kern[1][i])}, "
                      f"lock-step t "
                      f"{float(plain[0][i]):.9g} face {int(plain[1][i])}",
                      flush=True)
            check(bool(tie.all()) and idx.numel() <= n // 100000,
                  f"bvh {label}: {idx.numel()} rays differ from the "
                  f"lock-step walk, {int((~tie).sum())} of them no near tie")
            ties_all += idx.numel()
            err = max(err, e)
            fig = dict(rays=n, hits=int(hit.sum()), max_abs_err=e,
                       near_ties=idx.numel())
            if label != "shadow":
                mt, mf, _, mba, mbb = M_.mesh_closest_hit_rays(
                    lo, ld, t_init, mesh.tri_packed[:, col0:col0 + fpad],
                    mesh.tile_aabb[ar0:ar0 + nt], face0=col0,
                    tree=mesh.hit_tree, slot=0)
                mhit = mf >= 0

                def near_edge(h, ba_, bb_):
                    return h & (torch.minimum(torch.minimum(ba_, bb_),
                                              1.0 - ba_ - bb_) < 1e-5)
                # a ray through a shared edge (a barycentric below 1e-5 in
                # either test) may slip between the two faces in one of the
                # two triangle tests, which round apart there: counted
                edge = near_edge(hit, kern[3], kern[4]) \
                    | near_edge(mhit, mba, mbb)
                # t within rtol 1e-4, and 1e-6 for the hits just past the
                # 1e-3 bias, where the two tests' plane distances round
                # apart by about 1e-7 (origins on the ball's surface)
                off = (kern[0] - mt).abs() - 1e-4 * mt.abs()
                bad = ~edge & ((hit != mhit) | (hit & (off > 1e-6)))
                if bool(bad.any()):
                    idx = torch.nonzero(bad)[:8, 0]
                    mp = plain_fn(lo[idx], ld[idx], t_init[idx],
                                  mesh.tri_packed[:, col0:col0 + fpad],
                                  mesh.tile_aabb[ar0:ar0 + nt], col0)
                    for j, i in enumerate(idx.tolist()):
                        print(f"[bvh] {label} ray {i}: |o| "
                              f"{float(lo[i].norm()):.6f}, walk t "
                              f"{float(kern[0][i]):.9g} face "
                              f"{int(kern[1][i])}; mesh_closest_hit t "
                              f"{float(mt[i]):.9g} face "
                              f"{int(perm[mf[i].clamp(min=0)])}, its plain "
                              f"t {float(mp[0][j]):.9g} face "
                              f"{int(perm[mp[1][j].clamp(min=0)])}",
                              flush=True)
                slips = int((edge & ((hit != mhit) | (hit & (off > 1e-6))))
                            .sum())
                check(not bool(bad.any()) and slips <= n // 10000,
                      f"bvh {label}: {int(bad.sum())} rays beyond rtol 1e-4 "
                      f"(atol 1e-6) of mesh_closest_hit or with another hit "
                      f"mask, {slips} edge slips")
                keep = hit & ~edge
                rel = ((kern[0] - mt).abs() / mt.abs())[keep]
                ma = perm[mf.clamp(min=0).to(torch.int64)].to(torch.int32)
                ties = int((keep & (ma != kern[1])).sum())
                fig.update(faces_differing_at_ties=ties, edge_slips=slips,
                           edge_rays=int(edge.sum()),
                           t_max_rel_vs_mesh_closest_hit=float(rel.max()))
                del mt, mf
            pops, inner, leaves, faces, most, boxes = sk.tolist()
            lpops, _, _, lfaces, lmost, lboxes = sp.tolist()
            ms = events_ms(lambda: B_.bvh_closest_hit(mesh, root, lo, ld,
                                                      t_init))
            pms = host_ms(lambda: B_.bvh_wide_closest_hit_plain(
                walk, root, lo, ld, t_init), 1)
            lms = host_ms(lambda: B_.bvh_closest_hit_plain(
                mesh, root, lo, ld, t_init), 1)
            flops = n * OPS["inv"] + boxes * OPS["box"] \
                + faces * OPS["wide_tri"]
            # each input once (28 B a ray in, the tables), each output once
            # (20 B a ray); the bound over the wide tables and over the
            # binary walk's
            bound = {}
            for lay, nb in tbytes.items():
                bms = (n * 48 + nb) / HBM_BPS * 1e3
                ops_ms = flops / FP32_FLOPS * 1e3
                bound[lay] = dict(bytes=n * 48 + nb, bytes_ms=bms,
                                  ops_ms=ops_ms, bound_ms=max(bms, ops_ms),
                                  bound_by="operations" if ops_ms >= bms
                                  else "bytes")
            fig.update(ms=ms, plain_ms=pms, lockstep_ms=lms,
                       nodes_popped=pops, pops_a_ray=pops / n,
                       most_pops=most, inner_entered=inner,
                       leaves_entered=leaves, face_tests=faces,
                       box_tests=boxes, lockstep_pops=lpops,
                       lockstep_most_pops=lmost, lockstep_box_tests=lboxes,
                       lockstep_face_tests=lfaces, flops=flops,
                       bound_ms=bound["wide"]["bound_ms"],
                       bound_by=bound["wide"]["bound_by"], bound=bound)
            kinds[label] = fig
            print(f"[bvh] bvh_closest_hit (wide walk) vs its twin, {label}: "
                  f"{n} rays ({fig['hits']} hit), every output and the "
                  f"counters equal, max_abs_err={e:.3e}; against the "
                  f"lock-step walk: masks and t equal, {idx.numel()} near "
                  f"ties; "
                  + (f"against mesh_closest_hit: masks equal, t max rel "
                     f"{fig['t_max_rel_vs_mesh_closest_hit']:.3e}, "
                     f"{fig['faces_differing_at_ties']} faces differ at "
                     f"equal-t ties, {fig['edge_slips']} of "
                     f"{fig['edge_rays']} rays through a shared edge slip "
                     f"through in one test; " if label != "shadow" else "")
                  + f"{ms:.4f} ms (mean of 20, CUDA events), twin "
                  f"{pms:.1f} ms ({most} lock steps), lock-step walk "
                  f"{lms:.1f} ms ({lmost}); {pops} pops ({pops / n:.3f} a "
                  f"ray, most {most}; lock-step {lpops / n:.3f}, most "
                  f"{lmost}), {boxes} box tests ({boxes / n:.3f} a ray; "
                  f"lock-step {lboxes / n:.3f}), {faces} face tests "
                  f"({faces / n:.3f} a ray; lock-step {lfaces / n:.3f}); "
                  f"{flops:.4e} FP32 ops; bound "
                  f"{bound['wide']['bound_ms']:.5f} ms over the wide tables "
                  f"({bound['wide']['bytes']} bytes, ops "
                  f"{bound['wide']['ops_ms']:.5f}), "
                  f"{bound['binary']['bound_ms']:.5f} ms over the binary "
                  f"walk's ({bound['binary']['bytes']} bytes)", flush=True)
            del kern, twin, plain

        # the binary walk on a capped tree (max_depth two levels below the
        # ball's, where bvh_traverse's clamp drops nodes): the primary rays
        capped = dataclasses.replace(mesh, max_depth=depth - 2,
                                     bvh_walk=None)
        check(B_.bvh_walk(capped).walk == "binary",
              "bvh: the capped tree did not take the binary walk")
        lo, ld, t_init = sets["primary"]
        sk, sp = (torch.zeros(B_.NSTAT, dtype=torch.int64, device=dev)
                  for _ in range(2))
        kern = B_.bvh_closest_hit(capped, root, lo, ld, t_init, stats=sk)
        plain = B_.bvh_closest_hit_plain(capped, root, lo, ld, t_init,
                                         stats=sp)
        torch.cuda.synchronize()
        cap_err = max(float((k.float() - p.float()).abs().max())
                      for k, p in zip(kern, plain))
        check(cap_err == 0.0 and torch.equal(kern[1], plain[1])
              and torch.equal(sk, sp), f"bvh capped: the binary walk differs "
              f"from the lock-step walk by {cap_err}, counters "
              f"{sk.tolist()} against {sp.tolist()}")
        n = lo.shape[0]
        cap_ms = events_ms(lambda: B_.bvh_closest_hit(capped, root, lo, ld,
                                                      t_init))
        cap_pms = host_ms(lambda: B_.bvh_closest_hit_plain(
            capped, root, lo, ld, t_init), 1)
        cpops, cinner, _, cfaces, cmost, cboxes = sk.tolist()
        cflops = n * OPS["inv"] + cboxes * OPS["box"] \
            + cfaces * OPS["bvh_tri"]
        cbytes = n * 48 + tbytes["binary"]
        cap = dict(rays=n, hits=int((kern[1] >= 0).sum()),
                   max_abs_err=cap_err, ms=cap_ms, plain_ms=cap_pms,
                   nodes_popped=cpops, most_pops=cmost, box_tests=cboxes,
                   face_tests=cfaces, bytes=cbytes, flops=cflops,
                   bound_ms=max(cbytes / HBM_BPS, cflops / FP32_FLOPS) * 1e3,
                   bound_by="bytes" if cbytes / HBM_BPS
                   >= cflops / FP32_FLOPS else "operations")
        print(f"[bvh] the binary walk on the capped tree (max_depth "
              f"{depth - 2}, {depth} levels), the primary rays: every "
              f"output and the counters equal to the lock-step walk's; "
              f"{cap_ms:.4f} ms (events), plain {cap_pms:.1f} ms; {cpops} "
              f"pops (most {cmost}), {cfaces} face tests; bound "
              f"{cap['bound_ms']:.5f} ms ({cap['bound_by']})", flush=True)
        del kern, plain
        prim = sets["primary"]
        prof_ms = profiled_ms(lambda: B_.bvh_closest_hit(mesh, root, *prim),
                              key="bvh_wide_kernel")
        cap_prof_ms = profiled_ms(lambda: B_.bvh_closest_hit(
            capped, root, *prim), key="bvh_hit_kernel")
        stamp("kernel against plain and mesh_closest_hit, timed")

        # RenderConfig() with the walk, through `render`
        def bvh_counts():
            return {"bvh_closest_hit": T_.counter(BVH),
                    "bvh_closest_hit_binary": T_.counter(BVH_BINARY),
                    **mesh_counts()}
        render(scene, wcfg, device=dev, tables=tables)    # warm-up frame
        frame_s, res = float("inf"), None
        for rep in range(3):
            T_.reset_counters(BVH, BVH_BINARY, MESH, *counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, wcfg, seed=1 + rep, device=dev, tables=tables)
            dt = time.perf_counter() - t0
            counts = bvh_counts()
            check(counts["bvh_closest_hit"] == expected
                  and sum(counts.values()) == expected,
                  f"bvh frame {rep}: launches {counts}, expected {expected}"
                  f" of bvh_closest_hit")
            check(np.isfinite(out.radiance).all() and out.image.mean() > 5.0,
                  "bvh frame: non-finite or black")
            if dt < frame_s:
                frame_s, res = dt, out
        png = ROOT / "build" / "chip_smoke_bvh.png"
        (ROOT / "build").mkdir(exist_ok=True)
        write_png(str(png), res.image)
        # the same frame on mesh_closest_hit, once (the tables are warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(base, wcfg, seed=1, device=dev, tables=tables)
        auto_s = time.perf_counter() - t0
        wave_s = min(host_ms(one_wave, 1), host_ms(one_wave, 1)) / 1e3
        busy_us, wave_prof_ms, _ = profile_frame(
            "bvh wave", wave_s, one_wave, kernel="bvh_wide_kernel")
        print(f"[bvh] frame {W}x{H} RenderConfig() mesh_algo='bvh': best of "
              f"3 {frame_s:.4f} s ({expected} bvh_closest_hit launches, "
              f"{per_wave} a wave; mean byte {res.image.mean():.2f}, png "
              f"{png.relative_to(ROOT)}); the same frame on "
              f"mesh_closest_hit ('auto') {auto_s:.4f} s (one frame)",
              flush=True)
        stamp("frames")

        # 160x120 frames, one sample wave, one shadow ray a light: the wide
        # walk's kernel against its twin, and on a capped tree (the path
        # of trees deeper than max_depth - 2) the binary walk against the
        # lock-step walk, its launches counted from 0 over the frame
        small = dataclasses.replace(build_scene(box_scene(
            *SMALL, with_mesh=True, mesh_subdiv=5, light_size=1.0),
            device=dev), mesh_algo="bvh")
        stab = scene_tables(small)
        scfg = wcfg.with_(min_samples=1, max_samples=1, shadow_min=1,
                          shadow_max=1)
        small_capped = dataclasses.replace(
            small, mesh=dataclasses.replace(ensure_bvh(small.mesh),
                                            max_depth=depth - 2,
                                            bvh_walk=None))
        small_err = {}
        for tag, sc, plain_of in (
                ("wide", small, lambda m: lambda mesh_, root_, *a, **k:
                 B_.bvh_wide_closest_hit_plain(B_.bvh_walk(mesh_), root_,
                                               *a, **k)),
                ("binary", small_capped, lambda m: B_.bvh_closest_hit_plain)):
            T_.reset_counters(BVH, BVH_BINARY)
            fk = render(sc, scfg, seed=5, device=dev, tables=stab)
            small_launches = (T_.counter(BVH), T_.counter(BVH_BINARY))
            T_.reset_counters(BVH, BVH_BINARY)
            plain_calls = [0]
            plain_walk_fn = plain_of(sc.mesh)

            def plain_walk(*a, **k):
                plain_calls[0] += 1
                return plain_walk_fn(*a, **k)
            B_.bvh_closest_hit = plain_walk
            try:
                fp = render(sc, scfg, seed=5, device=dev, tables=stab)
            finally:
                B_.bvh_closest_hit = kernel_fn
            check(T_.counter(BVH) == T_.counter(BVH_BINARY) == 0,
                  "bvh: the plain frame launched a kernel")
            want = (plain_calls[0], 0) if tag == "wide" \
                else (0, plain_calls[0])
            check(small_launches == want and plain_calls[0] > 0,
                  f"bvh {tag}: the small frame made {small_launches} "
                  f"launches against {plain_calls[0]} plain walks")
            if tag == "binary":
                binary_frame_launches = small_launches[1]
            e = float(np.abs(fk.radiance - fp.radiance).max())
            check(e == 0.0 and np.array_equal(fk.z, fp.z)
                  and np.array_equal(fk.sample_count, fp.sample_count),
                  f"bvh {tag}: the 160x120 frame differs from its plain "
                  f"walk's by {e}")
            small_err[tag] = e
            print(f"[bvh] {SMALL[0]}x{SMALL[1]} frame, the {tag} walk "
                  f"({plain_calls[0]} launches) vs its plain walk: "
                  f"max_abs_err={e:.3e}", flush=True)
        stamp("small frames")

        # mesh_algo="dense": the primary rays, and a 160x120 frame
        lo, ld, t_init = prim
        n = lo.shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt_, df, _, _, _ = _dense_mesh(
            mesh, lo, ld, t_init, torch.full((n,), -1, dtype=torch.int32,
                                             device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, device=dev), torch.zeros(n, device=dev),
            mesh.slot_faces[0])
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        mt, mf, _, _, _ = M_.mesh_closest_hit_rays(
            lo, ld, t_init, mesh.tri_packed[:, col0:col0 + fpad],
            mesh.tile_aabb[ar0:ar0 + nt], face0=col0, tree=mesh.hit_tree,
            slot=0)
        dhit = df >= 0
        check(torch.equal(dhit, mf >= 0), "dense: hit masks differ from "
              "mesh_closest_hit")
        drel = float(((dt_ - mt).abs() / mt.abs())[dhit].max())
        check(drel <= 1e-4, f"dense: t beyond rtol 1e-4 ({drel})")
        dense_scene = dataclasses.replace(build_scene(box_scene(
            *SMALL, with_mesh=True, mesh_subdiv=5), device=dev),
            mesh_algo="dense")
        dcfg = RenderConfig(min_samples=2, max_samples=2, bounces=2,
                            shadow_min=1, shadow_max=1, split_mode="both")
        dtab = scene_tables(dense_scene)
        T_.reset_counters(MESH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dres = render(dense_scene, dcfg, device=dev, tables=dtab)
        dense_frame_s = time.perf_counter() - t0
        check(T_.counter(MESH) == 0 and np.isfinite(dres.radiance).all()
              and dres.image.mean() > 5.0, "dense frame: a mesh kernel ran,"
              " or non-finite or black")
        print(f"[bvh] dense, the primary rays ({n}, {int(dhit.sum())} hit "
              f"the ball): {dense_s:.3f} s, masks equal to "
              f"mesh_closest_hit's, t max rel {drel:.3e}; a {SMALL[0]}x"
              f"{SMALL[1]} dense frame (2 spp, 2 bounces, 'both') "
              f"{dense_frame_s:.3f} s, finite and lit", flush=True)
        stamp("dense")

        # tex_filter on the textured box at full width
        tscene = build_scene(textured_desc(box_scene, W, H), device=dev)
        ttab = scene_tables(tscene)
        fcfg = wcfg.with_(tex_filter=True)
        check(render_path(tscene, fcfg)[0] == "wavefront",
              "tex_filter takes the wavefront")
        frames = {}
        render(tscene, wcfg, seed=2, device=dev, tables=ttab)   # warm-up
        for name, c in (("unfiltered", wcfg), ("filtered", fcfg)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames[name] = (render(tscene, c, seed=1, device=dev,
                                   tables=ttab), time.perf_counter() - t0)
        (fu, fu_s), (ff, ff_s) = frames["unfiltered"], frames["filtered"]
        changed = float((np.abs(ff.radiance - fu.radiance).max(-1)
                         > 1e-3).mean())
        check(np.isfinite(ff.radiance).all() and ff.image.mean() > 5.0
              and changed > 0.05, f"tex_filter frame: non-finite, black or "
              f"unchanged ({changed:.4f} of pixels changed)")
        write_png(str(ROOT / "build" / "chip_smoke_tex_filter.png"),
                  ff.image)
        print(f"[bvh] tex_filter {W}x{H} RenderConfig() on the textured "
              f"box: {ff_s:.4f} s against {fu_s:.4f} s unfiltered; "
              f"{changed:.4f} of pixels changed, mean byte "
              f"{ff.image.mean():.2f} against {fu.image.mean():.2f}",
              flush=True)
        stamp("tex_filter")

        # render_sharded on a 1x1 NCCL mesh against render_device_host
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        init_multihost(f"localhost:{port}", 1, 0, device=dev)
        try:
            mesh11 = make_mesh(1, 1)
            main = build_scene(box_scene(W, H, with_mesh=True), device=dev)
            mtab = scene_tables(main)
            T_.reset_counters(WAVE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = render_sharded(main, cfg, mesh11, seed=7, device=dev)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t0
            check(T_.counter(WAVE) == SPP,
                  f"sharded: {T_.counter(WAVE)} wave "
                  f"launches, expected {SPP}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = R_.render_device_host(main, cfg, seed=7, device=dev,
                                        tables=mtab)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            check(same, "sharded: the 1x1 mesh differs from "
                  "render_device_host")
        finally:
            dist.destroy_process_group()
        print(f"[bvh] render_sharded on a 1x1 NCCL mesh, {W}x{H} {SPP} spp "
              f"{BOUNCES} bounces: equal bit for bit to render_device_host "
              f"({sharded_s:.4f} s, first call, against {host_s:.4f} s)",
              flush=True)
        # two processes on the one card under gloo, each half the samples
        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        out = ROOT / "build" / "chip_smoke_gloo.npz"
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-rank",
             str(r), str(port), str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p_.communicate(timeout=300)[0] for p_ in procs]
        finally:
            for p_ in procs:
                p_.kill()
        check(all(p_.returncode == 0 for p_ in procs), "gloo ranks failed:"
              "\n" + "\n".join(x[-3000:] for x in logs))
        g = np.load(out)
        ref = [x.cpu().numpy() for x in R_.render_device_host(
            main, cfg, seed=7, device=dev, tables=mtab)]
        gerr = float(np.abs(g["rad"] - ref[0]).max())
        check(np.array_equal(g["hits"], ref[1])
              and np.array_equal(g["ns"], ref[3])
              and np.array_equal(g["z"], ref[2])
              and np.allclose(g["rad"], ref[0], rtol=1e-5, atol=5e-5),
              f"gloo 1x2 on one card: differs from render_device_host "
              f"(radiance {gerr})")
        gloo_s = float(g["seconds"])
        print(f"[bvh] render_sharded on a 1x2 gloo mesh, two processes on "
              f"the one card, each {SPP // 2} of the {SPP} samples: "
              f"{gloo_s:.4f} s a frame (after a warm-up; {host_s:.4f} s on one "
              f"process); hits, z and sample counts equal to "
              f"render_device_host, radiance sums within {gerr:.3e} (the "
              f"two ranks' sums add in another order)", flush=True)
        # two tiles of 1536 lanes against one process: the wavefront's
        # adaptive frame and the fused frame at bounce 0 per pixel
        # (tests/test_torch_sharded.py's tolerances: hits and sample counts
        # equal, radiance within atol 5e-5, z within 1e-5); past bounce 0
        # a tile that does not start on a 1024-lane block draws other
        # Russian-roulette streams (blk0), so the rr frame is held on its
        # mean radiance (within MEAN_TOL relative) with hits, z and sample
        # counts equal
        small = build_scene(box_scene(TILE_W, TILE_H, with_mesh=False),
                            device=dev)
        tiles = {}
        for name, kw in TILE_CFGS.items():
            ref = [x.cpu().numpy() for x in R_.render_device_host(
                small, RenderConfig(**kw), seed=0, device=dev)]
            got = [g[f"{name}_{k}"] for k in ("rad", "hits", "z", "ns")]
            same = (np.array_equal(got[1], ref[1])
                    and np.array_equal(got[3], ref[3])
                    and np.allclose(got[2], ref[2], rtol=0, atol=1e-5))
            rad_err = float(np.abs(got[0] - ref[0]).max())
            mean_rel = float(abs(got[0].mean() - ref[0].mean())
                             / ref[0].mean())
            ok_ = same and (mean_rel <= MEAN_TOL if name == "rr"
                            else rad_err <= 5e-5)
            tiles[name] = dict(rad_max_abs_err=rad_err, mean_rel=mean_rel,
                               hits_z_counts_equal=bool(same))
            check(ok_, f"gloo 2x1 tiles {name}: against one process, hits, "
                  f"z and counts equal {same}, radiance {rad_err:.3e}, "
                  f"mean {mean_rel:.3e} relative")
            print(f"[bvh] render_sharded on two tiles of 1536 lanes (gloo, "
                  f"two processes on the card), {name} ({TILE_W}x{TILE_H}, "
                  f"{kw}): hits, z and sample counts equal to one process, "
                  f"radiance max abs err {rad_err:.3e}, mean "
                  f"{mean_rel:.3e} relative", flush=True)
        stamp("phase passed")
        p = kinds["primary"]
        return [{
            "launches": expected, "max_abs_err": err, "ms": p["ms"],
            "ms_profiler": prof_ms, "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None, "frame_s": frame_s,
            "frame_s_mesh_closest_hit": auto_s, "wave_s": wave_s,
            "wave_ms_profiler": wave_prof_ms,
            "device_busy_share": busy_us / 1e6 / wave_s,
            "bvh_build_s": bvh_build_s,
            "bvh_nodes": mesh.bvh_min.shape[0],
            "wide_nodes": walk.wnodes.shape[0], "stack": walk.stack,
            "bvh_levels": depth, "near_ties": ties_all,
            "small_frame_max_abs_err": small_err["wide"],
            "dense_primary_s": dense_s, "dense_frame_s": dense_frame_s,
            "tex_filter_frame_s": ff_s, "unfiltered_frame_s": fu_s,
            "sharded_1x1_exact": True,
            "sharded_gloo_1x2_s": gloo_s,
            "sharded_gloo_1x2_rad_max_abs_err": gerr,
            "sharded_gloo_2x1_tiles": tiles, "per_input": kinds}, {
            "launches": binary_frame_launches, "max_abs_err": cap_err,
            "ms": cap_ms, "ms_profiler": cap_prof_ms,
            "plain_ms": cap_pms, "bound_ms": cap["bound_ms"],
            "bound_by": cap["bound_by"], "library_ms": None,
            "small_frame_max_abs_err": small_err["binary"],
            "capped_max_depth": depth - 2, "primary": cap}]

    def drive_large():
        """Phase 13: a large user scene from files to a frame, on the card
        host: the scene-file set of write_large_scene (the 327,680-face
        ball, the 2048x2048 texture) loaded with load_scene and each part
        of the load timed alone, the PNG decoded with the host library and
        with unfilter_plain (equal), build_scene, ensure_bvh with the C++
        and the NumPy builder (equal), the walk; RenderConfig() at 800x600
        with mesh_algo="bvh": a first frame with its set-up, best of 3
        (840 bvh_closest_hit launches a frame, counted), the wide walk
        against its twin on one wave's primary and shadow rays (exact);
        the host library's build; a fresh process's start-up split and one
        CLI render of the scene.  Adds no kernels-line entry."""
        import dataclasses
        import re

        from rtf_tpu_torch.ops import bvh_hit as B_
        from rtf_tpu_torch.scene import xml_loader as XL_
        from rtf_tpu_torch.scene.build import ensure_bvh
        from rtf_tpu_torch.utils.png import read_png
        t_phase = time.perf_counter()
        fig = {}

        def stamp(what):
            print(f"[large] {time.perf_counter() - t_phase:.1f} s: {what}",
                  flush=True)

        def timed(key, fn, *a, **k):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out_ = fn(*a, **k)
            torch.cuda.synchronize()
            fig[key] = time.perf_counter() - t0_
            return out_

        directory = ROOT / "build" / "large_scene"
        xml, pixels = timed("write_s", write_large_scene, directory, W, H)
        stamp(f"wrote {sorted(p.name for p in directory.iterdir())}")
        timed("library_build_s", _build.build_host)

        # ---- load, each part alone: the OBJ and the PNG inside load_scene
        # timed by wrapping the loader's two readers
        parts = {"obj_s": 0.0, "png_s": 0.0}

        def timing(key, fn):
            def wrapped(*a, **k):
                t0_ = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    parts[key] += time.perf_counter() - t0_
            return wrapped
        load_obj, read_png_ = XL_.load_obj, XL_.read_png
        XL_.load_obj = timing("obj_s", load_obj)
        XL_.read_png = timing("png_s", read_png_)
        try:
            desc = timed("load_scene_s", XL_.load_scene, str(xml))
        finally:
            XL_.load_obj, XL_.read_png = load_obj, read_png_
        fig.update(parts)
        fig["xml_s"] = fig["load_scene_s"] - parts["obj_s"] - parts["png_s"]
        tex = desc.materials["back"].diffuse.texmap.texture.data
        check(tex.shape == (2048, 2048, 3), f"large: the texture is "
              f"{tex.shape}")
        png = str(directory / "wall.png")
        img = timed("png_native_s", read_png, png)
        img_plain = timed("png_plain_s", read_png, png, use_native=False)
        check(np.array_equal(img, img_plain) and img.dtype == np.uint8
              and np.array_equal(img, pixels), "large: the host library's "
              "PNG decode, unfilter_plain's and the pixels written differ")
        print(f"[large] load_scene {fig['load_scene_s']:.3f} s: the XML "
              f"{fig['xml_s']:.3f} s, the OBJ {parts['obj_s']:.3f} s, the "
              f"PNG {parts['png_s']:.3f} s; the 2048x2048 PNG alone "
              f"{fig['png_native_s']:.3f} s with the host library, "
              f"{fig['png_plain_s']:.3f} s with unfilter_plain (both equal "
              f"to the pixels written)", flush=True)

        # ---- build: the scene, the BVH with each builder, the walk
        scene = timed("build_scene_s", build_scene, desc, device=dev)
        nf = scene.mesh.tri_a.shape[0]
        check(nf == 327680 and scene.num_mesh_inst == 1,
              f"large: {nf} faces, {scene.num_mesh_inst} instances")
        mesh_plain = dataclasses.replace(scene.mesh)
        timed("ensure_bvh_native_s", ensure_bvh, scene.mesh)
        timed("ensure_bvh_plain_s", ensure_bvh, mesh_plain, use_native=False)
        for k in ("bvh_min", "bvh_max", "bvh_child", "bvh_eoff", "bvh_ecnt",
                  "bvh_elems", "slot_root"):
            a, b = getattr(scene.mesh, k), getattr(mesh_plain, k)
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"large: {k} of the C++ builder differs from the NumPy "
                  f"builder's")
        walk = timed("build_walk_s", B_.bvh_walk, scene.mesh)
        fig.update(levels=walk.levels, walk=walk.walk, stack=walk.stack,
                   bvh_nodes=scene.mesh.bvh_min.shape[0],
                   wide_nodes=walk.wnodes.shape[0])
        check(walk.walk == "wide", f"large: the depth rule took the "
              f"{walk.walk} walk")
        print(f"[large] build_scene {fig['build_scene_s']:.3f} s; "
              f"ensure_bvh on {nf} faces {fig['ensure_bvh_native_s']:.3f} s "
              f"with the C++ builder, {fig['ensure_bvh_plain_s']:.3f} s with "
              f"the NumPy builder (all arrays equal); build_walk "
              f"{fig['build_walk_s']:.3f} s: {fig['bvh_nodes']} binary nodes "
              f"in {walk.levels} levels, the {walk.walk} walk, "
              f"{fig['wide_nodes']} {B_.WIDTH}-wide nodes, a stack need of "
              f"{walk.stack}", flush=True)
        stamp("loaded and built")

        # ---- RenderConfig() with mesh_algo="bvh": a first frame with its
        # set-up (a new build_scene, the tables, the BVH and the walk at
        # the first trace), then best of 3, each frame's launches counted
        wcfg = RenderConfig()
        per_wave = (1 + wcfg.shadow_min + wcfg.shadow_max) * (1 + wcfg.bounces)
        expected = per_wave * wcfg.max_samples

        def first():
            sc = dataclasses.replace(build_scene(desc, device=dev),
                                     mesh_algo="bvh")
            return sc, render(sc, wcfg, device=dev)
        scene, _ = timed("first_frame_s", first)
        tables = scene_tables(scene)
        check(render_path(scene, wcfg)[0] == "wavefront",
              "large: RenderConfig() takes the wavefront")
        frame_s, res = float("inf"), None
        for rep in range(3):
            T_.reset_counters(BVH, BVH_BINARY, MESH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, wcfg, seed=1 + rep, device=dev, tables=tables)
            dt = time.perf_counter() - t0
            counts = tuple(map(T_.counter, (BVH, BVH_BINARY, MESH)))
            check(counts == (expected, 0, 0), f"large frame {rep}: launches "
                  f"(wide, binary, mesh_closest_hit) {counts}, expected "
                  f"{expected} of the wide walk")
            check(np.isfinite(out.radiance).all() and out.image.mean() > 5.0,
                  "large frame: non-finite or black")
            if dt < frame_s:
                frame_s, res = dt, out
        fig.update(frame_s=frame_s, launches=expected)
        frame_png = ROOT / "build" / "chip_smoke_large.png"
        write_png(str(frame_png), res.image)
        print(f"[large] frame {W}x{H} RenderConfig() mesh_algo='bvh': first "
              f"frame with its set-up {fig['first_frame_s']:.3f} s, best of "
              f"3 {frame_s:.4f} s ({expected} bvh_closest_hit launches a "
              f"frame; mean byte {res.image.mean():.2f}, png "
              f"{frame_png.relative_to(ROOT)})", flush=True)

        # ---- the wide walk against its twin on one wave's rays
        order = torch.as_tensor(pixel_order(W, H), device=dev).to(torch.int64)
        o, d = primary_rays(scene, order % W, order // W, torch.tensor(0))
        ids = torch.arange(W * H, device=dev)

        def one_wave():
            return render_wave(
                scene, wcfg, tables, o, d, ids,
                torch.ones(W * H, dtype=torch.bool, device=dev),
                torch.Generator(device=dev).manual_seed(3), W * H,
                inv_pixel=ids)
        sets = bvh_sets(B_, scene, one_wave, per_wave, dev)
        walk = B_.bvh_walk(scene.mesh)
        root = walk.roots[0]
        for label in ("primary", "shadow"):
            lo, ld, t_init = sets[label]
            sk, sw = (torch.zeros(B_.NSTAT, dtype=torch.int64, device=dev)
                      for _ in range(2))
            kern = B_.bvh_closest_hit(scene.mesh, root, lo, ld, t_init,
                                      stats=sk)
            twin = B_.bvh_wide_closest_hit_plain(walk, root, lo, ld, t_init,
                                                 stats=sw)
            torch.cuda.synchronize()
            e = max(float((k.float() - p.float()).abs().max())
                    for k, p in zip(kern, twin))
            check(e == 0.0 and torch.equal(kern[1], twin[1])
                  and torch.equal(sk, sw), f"large {label}: max abs err {e}, "
                  f"counters {sk.tolist()} against the twin's {sw.tolist()}")
            fig[f"{label}_rays"] = lo.shape[0]
            fig[f"{label}_hits"] = int((kern[1] >= 0).sum())
            print(f"[large] bvh_closest_hit on the frame's {label} rays "
                  f"({lo.shape[0]}, {fig[f'{label}_hits']} hit the ball) "
                  f"against bvh_wide_closest_hit_plain: every output and the "
                  f"counters equal, max_abs_err={e:.3e}", flush=True)
        stamp("frames and the walk against its twin")

        # ---- a fresh process's start-up split, then one CLI render
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", STARTUP, str(xml)],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"large: the start-up process failed:\n"
              f"{proc.stdout}{proc.stderr}")
        split = json.loads(proc.stdout.strip().splitlines()[-1])
        # the interpreter's start and exit: the wall time outside the parts
        split["interpreter_s"] = wall - sum(split.values())
        split["process_wall_s"] = wall
        fig["startup"] = split
        print(f"[large] start-up of a fresh process: {wall:.3f} s wall: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()
                          if k != "process_wall_s"), flush=True)
        out_png = ROOT / "build" / "large_scene" / "cli.png"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rtf_tpu_torch.cli", "render", str(xml),
             "--out", str(out_png)], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, flush=True)
        check(proc.returncode == 0, f"large: cli render exit code "
              f"{proc.returncode}")
        times = re.findall(r"Render time is \d+:\d\d:\d\d", proc.stdout)
        for line in proc.stdout.splitlines()[-40:]:     # its own lines
            print(f"[large]   cli: {line}", flush=True)
        cli_img = read_png(str(out_png))
        check(cli_img.shape[:2] == (H, W) and float(cli_img.std()) > 0.0,
              f"large: cli.png is {cli_img.shape}, or constant")
        fig.update(cli_wall_s=wall, cli_render_time=times[-1] if times
                   else None)
        print(f"[large] cli render {xml.relative_to(ROOT)} (its default "
              f"profile, final): exit 0, {wall:.1f} s wall; "
              f"{times[-1] if times else 'no Render time line'}", flush=True)
        print(f"[large] host library built in {fig['library_build_s']:.2f} s "
              f"({_build.host_library_path().name}); figures "
              + json.dumps(fig), flush=True)
        stamp("phase passed")
        return []

    gi_cfg = RenderConfig(min_samples=8, max_samples=8, bounces=2,
                          shadow_min=1, shadow_max=1, gi_mode="hemisphere",
                          hemisphere_samples=4, queue_factor=1.0)
    hyb_cfg = RenderConfig(min_samples=8, max_samples=8, bounces=4,
                           shadow_min=4, shadow_max=16, gi_mode="photon",
                           hemisphere_samples=30)
    # (phase, kernels-line entries, the function that runs the phase and
    # returns one result per entry)
    runs = [
        # ---- phase 3: the main path (untextured variant)
        (3, {"name": "wave",
             "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
             "replaces": "rtf_tpu/render/fused.py:1741"},
         lambda: drive("main", box_scene(W, H, with_mesh=True),
                       box_scene(*SMALL, with_mesh=True), WAVE)),
        # ---- phase 4: the textured box at full width (textured variant)
        (4, {"name": "wave_textured",
             "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
             "replaces": "rtf_tpu/render/fused_seg.py:482 and :516"},
         lambda: drive("textured", textured_desc(box_scene, W, H),
                       textured_desc(box_scene, *SMALL),
                       WAVE_TEX)),
        # ---- phase 5: bench.py's GI cell (untextured variant, rows)
        (5, {"name": "wave_gi",
             "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
             "replaces":
                 "rtf_tpu/render/fused.py:1741 (surf_out/gi_from rows)"},
         lambda: drive_gi("gi", box_scene(400, 300, with_mesh=True), gi_cfg,
                          WAVE)),
        # ---- phase 6: the hybrid frame on the textured box at full width
        (6, {"name": "wave_textured_gi",
             "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
             "replaces": "rtf_tpu/render/fused_seg.py:516 (gi_out rows)"},
         lambda: drive_gi("hybrid", textured_desc(box_scene, W, H), hyb_cfg,
                          WAVE_TEX, volumes=True)),
        # ---- phase 7: the XLA wavefront's port, mesh_closest_hit
        (7, {"name": "mesh_closest_hit",
             "source": "rtf_tpu_torch/csrc/mesh_hit.cu",
             "replaces": "rtf_tpu/ops/pallas_mesh.py:330"},
         drive_wavefront),
        # ---- phase 8: the main path's config on a 20,480-face mesh (the
        # MXU variant), and the dense Plücker closest hit
        (8, [{"name": "wave_mxu",
              "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
              "replaces": "rtf_tpu/render/fused.py:1741 (MXU tables: "
                          "_mesh_closest_mxu :774, _mesh_anyhit_mxu :920)"},
             {"name": "mesh_closest_hit_mxu",
              "source": "rtf_tpu_torch/csrc/mesh_hit_mxu.cu",
              "replaces": "rtf_tpu/ops/pallas_mesh_mxu.py:179"}],
         drive_mxu),
        # ---- phase 9: the hybrid frame on the 20,480-face mesh (the
        # textured MXU variant with GI rows, gi_mesh_perm)
        (9, {"name": "wave_textured_mxu",
             "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
             "replaces": "rtf_tpu/render/fused_seg.py:482 and :516 (MXU "
                         "tables, has_mesh_tables)"},
         lambda: drive_gi("hybrid_mxu",
                          textured_desc(box_scene, W, H, mesh_subdiv=5),
                          hyb_cfg, WAVE_TEX_MXU, volumes=True)),
        # ---- phase 10: a scene file and the photon pipeline: the caustic
        # pass, `render` shooting its own photons and baking its volumes
        (10, [{"name": "mesh_closest_hit_photons",
               "source": "rtf_tpu_torch/csrc/mesh_hit.cu",
               "replaces": "rtf_tpu/ops/pallas_mesh.py:330 (photon "
                           "traces: gi/photon.py)"},
              {"name": "wave_textured_gi_photons",
               "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
               "replaces": "rtf_tpu/render/fused_seg.py:482 and :516 "
                           "(gi_out rows; volumes baked from photon maps)"}],
         drive_photons),
        # ---- phase 11: the command line, each subcommand in its own
        # process, and the irradiance cache in-process
        (11, [{"name": "wave_textured_gi_cache",
               "source": "rtf_tpu_torch/csrc/wave_kernel.cu",
               "replaces": "rtf_tpu/render/fused_seg.py:482 and :516 "
                           "(the irradiance cache's fused evaluator)"},
              {"name": "mesh_closest_hit_cache",
               "source": "rtf_tpu_torch/csrc/mesh_hit.cu",
               "replaces": "rtf_tpu/ops/pallas_mesh.py:330 (the cache's "
                           "first hits and its direct pass)"}],
         drive_cli),
        # ---- phase 12: the BVH walk, the dense test, footprint filtering
        # and the sharded render
        (12, [{"name": "bvh_closest_hit",
               "source": "rtf_tpu_torch/csrc/bvh_hit.cu",
               "replaces": "rtf_tpu/ops/trace.py:161 (bvh_traverse, no "
                           "pallas_call; the wide walk)"},
              {"name": "bvh_closest_hit_binary",
               "source": "rtf_tpu_torch/csrc/bvh_hit.cu",
               "replaces": "rtf_tpu/ops/trace.py:161 (bvh_traverse, no "
                           "pallas_call; the binary walk, trees deeper than "
                           "max_depth - 2)"}],
         drive_bvh),
        # ---- phase 13: a large user scene from files to a frame (the host
        # library: the C++ BVH builder and PNG unfilter; no kernel entry)
        (13, [], drive_large),
    ]
    kernels = []
    for ph, entries, fn in runs:
        if ph not in phases:
            continue
        results = fn()
        if isinstance(entries, dict):
            entries, results = [entries], [results]
        kernels += [{**e, "route": "cuda", **r, "build_s": build_s}
                    for e, r in zip(entries, results)]

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main(sys.argv[1:])
