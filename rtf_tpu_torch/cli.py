"""Command-line renderer (rtf_tpu/cli.py), on the card.

Supersedes the reference's hardcoded scene path + GLUT keybindings
(main(), Final/main.cpp:1015-1024; SPACE-to-render, viewport.cpp:414-480)
with a real CLI:

    python -m rtf_tpu_torch.cli render scene.xml --profile final --out out.png
    python -m rtf_tpu_torch.cli photons scene.xml --count 1000000 --out pm.dat
    python -m rtf_tpu_torch.cli viz pm.dat --out cloud.png

`render` writes the beauty image plus the reference's diagnostic AOVs
(z-buffer and sample-count images, RenderImage::ComputeZBufferImage /
ComputeSampleCountImage, scene.h:591-637) and prints the wall-clock
"Render time" like the viewport did (viewport.cpp:398-404).

Every subcommand that touches a tensor runs on the card (`--device
cuda`, the default) and fails where there is none; `--device cpu` asks
for the CPU.  The kernels build into build/ at first use.  The
subcommands, flags, printed lines and files are rtf_tpu's; `watch`'s
checkpoint has rtf_tpu's keys, so `view` reads either package's.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _load(scene_path: str, width, height, device):
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.xml_loader import load_scene
    desc = load_scene(scene_path)
    if width:
        desc.camera.width = width
    if height:
        desc.camera.height = height
    return build_scene(desc, device=device)


def _elapsed(t0) -> str:
    dt = int(time.time() - t0)
    return "Render time is %d:%02d:%02d" % (dt // 3600, dt // 60 % 60,
                                            dt % 60)


def cmd_render(args):
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import (
        prepare_caustic_grid, prepare_photon_grid, render,
    )
    from rtf_tpu_torch.utils.image import sample_count_image, zbuffer_image
    from rtf_tpu_torch.utils.png import write_png

    cfg = PROFILES[args.profile]
    if args.spp:
        cfg = cfg.with_(min_samples=args.spp, max_samples=args.spp)
    if args.bounces is not None:
        cfg = cfg.with_(bounces=args.bounces)

    t0 = time.time()
    scene = _load(args.scene, args.width, args.height, args.device)
    print(f"scene loaded in {time.time() - t0:.1f}s: "
          f"{scene.num_spheres} spheres, {scene.num_planes} planes, "
          f"{scene.num_mesh_inst} mesh instances, {scene.num_lights} lights")

    grid = None
    caustic = None
    if args.caustics:
        t0 = time.time()
        caustic = prepare_caustic_grid(scene, cfg, args.seed + 1)
        print(f"caustic pass: {int(caustic.n_valid)} photons "
              f"in {time.time() - t0:.1f}s")
    if cfg.gi_mode == "photon":
        t0 = time.time()
        grid = prepare_photon_grid(scene, cfg, args.seed)
        print(f"photon pass: {int(grid.n_valid)} photons "
              f"in {time.time() - t0:.1f}s")
        if args.photon_dump:
            from rtf_tpu_torch.gi.io import save_photon_dat
            save_photon_dat(args.photon_dump, grid.pos, grid.dir,
                            grid.power, int(grid.n_valid))
            print(f"photon map dumped to {args.photon_dump}")

    t0 = time.time()
    if args.gi_cache:
        # as rtf_tpu's CLI: a photon profile's map, shot above, is not
        # handed to the cached render
        from rtf_tpu_torch.gi.irradiance_cache import render_with_cache
        res, cache = render_with_cache(scene, cfg, args.seed,
                                       device=args.device)
        frac = float(cache.computed.float().mean())
        print(f"irradiance cache: {frac:.0%} of pixels traced, "
              f"rest interpolated")
    else:
        res = render(scene, cfg, seed=args.seed, device=args.device,
                     gi_grid=grid, caustic_grid=caustic)
    print(_elapsed(t0))

    write_png(args.out, res.image)
    print(f"wrote {args.out}")
    if args.zbuffer:
        write_png(args.zbuffer, zbuffer_image(res.z))
        print(f"wrote {args.zbuffer}")
    if args.samplecount:
        write_png(args.samplecount, sample_count_image(res.sample_count))
        print(f"wrote {args.samplecount}")
    return 0


def cmd_photons(args):
    import torch

    from rtf_tpu_torch.gi.io import save_photon_dat
    from rtf_tpu_torch.gi.photon import shoot_photons
    from rtf_tpu_torch.render.config import PROFILES

    cfg = PROFILES[args.profile].with_(photon_count=args.count)
    scene = _load(args.scene, None, None, args.device)
    t0 = time.time()
    pm = shoot_photons(scene, cfg, n_emit=args.count, capacity=args.count,
                       draws=torch.Generator(device=scene.device)
                       .manual_seed(args.seed),
                       caustic_only=args.caustic)
    n = int(pm.count)
    print(f"stored {n} photons in {time.time() - t0:.1f}s")
    save_photon_dat(args.out, pm.pos, pm.dir, pm.power, n)
    print(f"wrote {args.out}")
    return 0


def cmd_viz(args):
    """Photon point-cloud viewer (PhotonMapViz parity,
    PhotonMap/PhotonMap/PhotonMapViz.cpp:157-227): renders the .dat dump
    as a splatted point cloud instead of a GLUT window, in numpy."""
    import numpy as np

    from rtf_tpu_torch.gi.io import load_photon_dat
    from rtf_tpu_torch.utils.png import write_png

    pos, dirs, power = load_photon_dat(args.dat)
    print(f"{len(pos)} photons loaded from {args.dat}")
    w, h = args.width, args.height
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    center = (lo + hi) / 2
    ext = float(np.max(hi - lo)) or 1.0

    # simple turntable camera looking at the cloud center
    ang = np.deg2rad(args.angle)
    cam = center + ext * np.array([np.sin(ang), -np.cos(ang), 0.3])
    fwd = center - cam
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)

    rel = pos - cam
    z = rel @ fwd
    x = rel @ right
    y = rel @ up
    keep = z > 1e-3
    px = (x[keep] / z[keep] * w * 0.9 + w / 2).astype(int)
    py = (-y[keep] / z[keep] * w * 0.9 + h / 2).astype(int)
    c = np.clip(power[keep] / np.percentile(power[keep].max(1), 90), 0, 1)
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    img = np.zeros((h, w, 3), np.float32)
    order = np.argsort(-z[keep][inside])   # far first (near overwrites)
    xi, yi, ci = px[inside][order], py[inside][order], c[inside][order]
    img[yi, xi] = ci
    write_png(args.out, (img * 255).astype(np.uint8))
    print(f"wrote {args.out}")
    return 0


def cmd_watch(args):
    """Progressive preview, the analog of the GLUT viewport (ShowViewport,
    viewport.cpp:93-139): samples accumulate pass by pass (1, 2, 4, ...
    spp), the output PNG (plus optional z / sample-count view modes,
    GlutKeyboard '3'/'4', viewport.cpp:414-480) refreshes after every
    pass, a progress line replaces the progress bar
    (viewport.cpp:308-336), and Ctrl-C is StopRender."""
    import numpy as np
    import torch

    from rtf_tpu_torch.core.math import BIGFLOAT
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import (
        finalize, preview, render_device_host,
    )
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.utils.image import sample_count_image, zbuffer_image
    from rtf_tpu_torch.utils.png import write_png

    cfg = PROFILES[args.profile]
    target = args.spp or cfg.max_samples
    scene = _load(args.scene, args.width, args.height, args.device)
    dev = scene.device
    tables = scene_tables(scene)
    num_px = scene.width * scene.height

    rad = torch.zeros((3, num_px), dtype=torch.float32, device=dev)
    hits = torch.zeros(num_px, dtype=torch.int32, device=dev)
    z = torch.full((num_px,), BIGFLOAT, dtype=torch.float32, device=dev)
    ns = torch.zeros(num_px, dtype=torch.int32, device=dev)

    done, pass_ix = 0, 0
    state_path = args.state or (args.out + ".state.npz")
    if args.resume:
        try:
            st = np.load(state_path)
            if int(st["num_px"]) == num_px:
                rad = torch.as_tensor(st["rad"], device=dev)
                hits = torch.as_tensor(st["hits"], device=dev)
                z = torch.as_tensor(st["z"], device=dev)
                ns = torch.as_tensor(st["ns"], device=dev)
                done = int(st["done"])
                pass_ix = int(st["pass_ix"])
                print(f"resumed at {done} spp from {state_path}")
        except Exception:
            # a truncated or foreign file: any unusable state means the
            # same thing, start fresh
            print(f"no usable state at {state_path}; starting fresh")

    t0 = time.time()
    if done == 0 and not args.no_preview:
        # the flat-shaded scene preview, written at once: the analog of
        # the GL pre-render view (viewport.cpp:93-268)
        write_png(args.out, preview(scene, device=dev, tables=tables).image)
        print(f"[preview] {args.out} (flat-shaded scene view)",
              flush=True)

    def _progress(done_w, total_w):
        print(f"\r  pass wave {done_w}/{total_w}", end="", flush=True)

    pass_spp = 1
    try:
        while done < target:
            pass_spp = min(pass_spp, target - done)
            cfg_p = cfg.with_(min_samples=pass_spp, max_samples=pass_spp)
            # sample_base=done: subpixel positions are pure
            # halton(sample_idx), so each pass continues the index stream
            # ([done, done + pass_spp)); from index 0 every pass would
            # re-accumulate the same offsets and never converge
            r, hcount, zp, nsp = render_device_host(
                scene, cfg_p, args.seed + pass_ix, device=dev,
                tables=tables, sample_base=done,
                progress_cb=None if args.no_progress else _progress)
            if not args.no_progress:
                print("", flush=True)
            rad = rad + r
            hits = hits + hcount
            z = torch.minimum(z, zp)
            ns = ns + nsp
            done += pass_spp
            res = finalize(scene, cfg, tables, rad, hits, z, ns)
            write_png(args.out, res.image)
            if args.zbuffer:
                write_png(args.zbuffer, zbuffer_image(res.z))
            if args.samplecount:
                write_png(args.samplecount,
                          sample_count_image(res.sample_count))
            if args.resume or args.state:
                # atomic checkpoint: `view` reads this file from another
                # terminal while watch runs, and a killed watch must never
                # leave a truncated npz: write a temporary file in the
                # same directory and os.replace() it into place
                tmp_path = state_path + ".tmp.npz"
                np.savez(tmp_path, rad=rad.cpu().numpy(),
                         hits=hits.cpu().numpy(), z=z.cpu().numpy(),
                         ns=ns.cpu().numpy(), done=done,
                         pass_ix=pass_ix + 1, num_px=num_px,
                         width=scene.width, height=scene.height,
                         profile=args.profile)
                os.replace(tmp_path, state_path)
            print(f"[{done}/{target} spp] {args.out} updated   "
                  + _elapsed(t0), flush=True)
            pass_ix += 1
            pass_spp *= 2
    except KeyboardInterrupt:
        print("\nstopped (StopRender)")
    return 0


def cmd_preview(args):
    """Standalone flat-shaded scene preview, the GL pre-render scene-graph
    view (ShowViewport, viewport.cpp:93-268) as a PNG.  When the camera
    has a lens, --dof-frames jittered frames are averaged (the viewport's
    32-frame DOF GL preview, viewport.cpp:76-80, 344-361)."""
    from rtf_tpu_torch.render.renderer import preview
    from rtf_tpu_torch.utils.png import write_png

    scene = _load(args.scene, args.width, args.height, args.device)
    res = preview(scene, dof_frames=args.dof_frames, device=args.device)
    write_png(args.out, res.image)
    dof = f", dof x{args.dof_frames or 32}" if float(scene.dof) > 0 else ""
    print(f"wrote {args.out} ({scene.width}x{scene.height}{dof})")
    return 0


def cmd_view(args):
    """Mid-render view-mode switching, the viewport's 1-5 keys while a
    render is in flight (GlutKeyboard, viewport.cpp:414-480): reads the
    accumulator checkpoint that `watch --resume` rewrites after every
    pass and writes one view mode from it: beauty image, z-buffer or
    sample-count (scene.h:591-637)."""
    import numpy as np
    import torch

    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import finalize
    from rtf_tpu_torch.render.scene_tables import scene_tables
    from rtf_tpu_torch.utils.image import sample_count_image, zbuffer_image
    from rtf_tpu_torch.utils.png import write_png

    try:
        st = np.load(args.state)
        num_px_st = int(st["num_px"])
    except Exception as e:
        # the writer replaces the file atomically, but an older checkpoint
        # can be truncated; no traceback
        print(f"checkpoint {args.state} busy/corrupt ({type(e).__name__});"
              " retry after the next watch pass", file=sys.stderr)
        return 1
    scene = _load(args.scene, int(st["width"]) if "width" in st else None,
                  int(st["height"]) if "height" in st else None,
                  args.device)
    if num_px_st != scene.width * scene.height:
        print(f"state {args.state} has {num_px_st} pixels; scene "
              f"is {scene.width}x{scene.height}", file=sys.stderr)
        return 1
    # the profile the in-flight watch render used (saved in the
    # checkpoint), so the gamma matches its output; --profile overrides
    profile = args.profile
    if profile is None:
        profile = str(st["profile"]) if "profile" in st else "final"
    dev = scene.device
    res = finalize(scene, PROFILES[profile], scene_tables(scene),
                   *(torch.as_tensor(st[k], device=dev)
                     for k in ("rad", "hits", "z", "ns")))
    mode = args.mode
    if mode == "image":
        write_png(args.out, res.image)
    elif mode == "z":
        write_png(args.out, zbuffer_image(res.z))
    elif mode == "samplecount":
        write_png(args.out, sample_count_image(res.sample_count))
    print(f"wrote {args.out} ({mode} view at {int(st['done'])} spp)")
    return 0


def cmd_probe(args):
    """Per-pixel debug readout, the viewport's left-click pixel inspector
    (PrintPixelData, viewport.cpp:484-515): prints the rendered colour, z
    and sample count at one pixel."""
    from rtf_tpu_torch.render.config import PROFILES
    from rtf_tpu_torch.render.renderer import render

    x, y = (int(v) for v in args.pixel.split(","))
    cfg = PROFILES[args.profile]
    if args.spp:
        cfg = cfg.with_(min_samples=args.spp, max_samples=args.spp)
    scene = _load(args.scene, args.width, args.height, args.device)
    res = render(scene, cfg, seed=args.seed, device=args.device)
    c = res.radiance[y, x]
    print(f"pixel ({x}, {y}):")
    print(f"  color (linear): {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
    print(f"  color (8-bit):  {tuple(int(v) for v in res.image[y, x])}")
    zv = float(res.z[y, x])
    print(f"  z: {'miss' if zv >= 1e29 else f'{zv:.6f}'}")
    print(f"  samples: {int(res.sample_count[y, x])}")
    return 0


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                        "'cpu' asks for the CPU)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rtf_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene XML")
    r.add_argument("scene")
    r.add_argument("--profile", default="final",
                   help="proj3|proj5|proj8|proj10|proj11|proj12|final|photon")
    r.add_argument("--out", default="out.png")
    r.add_argument("--zbuffer", help="write z-buffer AOV PNG")
    r.add_argument("--samplecount", help="write sample-count AOV PNG")
    r.add_argument("--photon-dump", help="write the photon map .dat")
    r.add_argument("--gi-cache", action="store_true",
                   help="progressive screen-space irradiance cache "
                        "instead of per-pixel GI (cyIrradianceMap "
                        "analog)")
    r.add_argument("--caustics", action="store_true",
                   help="add the caustic-map estimate (opt-in; the "
                        "reference ships this commented out)")
    r.add_argument("--spp", type=int, help="force fixed samples/pixel")
    r.add_argument("--bounces", type=int)
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--seed", type=int, default=0)
    _device_flag(r)
    r.set_defaults(fn=cmd_render)

    p = sub.add_parser("photons", help="shoot a photon map to .dat")
    p.add_argument("scene")
    p.add_argument("--count", type=int, default=1_000_000)
    p.add_argument("--out", default="photonmap.dat")
    p.add_argument("--caustic", action="store_true")
    p.add_argument("--profile", default="photon")
    p.add_argument("--seed", type=int, default=0)
    _device_flag(p)
    p.set_defaults(fn=cmd_photons)

    w = sub.add_parser("watch", help="progressive preview (viewport analog)")
    w.add_argument("scene")
    w.add_argument("--profile", default="final")
    w.add_argument("--out", default="out.png")
    w.add_argument("--zbuffer", help="also refresh a z-buffer view PNG")
    w.add_argument("--samplecount",
                   help="also refresh a sample-count view PNG")
    w.add_argument("--spp", type=int, help="total samples target")
    w.add_argument("--width", type=int)
    w.add_argument("--height", type=int)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--resume", action="store_true",
                   help="checkpoint accumulators per pass and resume "
                        "from them (render-resume; the reference only "
                        "checkpoints the photon pass)")
    w.add_argument("--state", help="explicit state .npz path")
    w.add_argument("--no-preview", action="store_true",
                   help="skip the instant flat-shaded scene preview "
                        "written before pass 1")
    w.add_argument("--no-progress", action="store_true",
                   help="disable the intra-pass wave progress line "
                        "(progress waits for each wave, trading a little "
                        "pipelining)")
    _device_flag(w)
    w.set_defaults(fn=cmd_watch)

    pv = sub.add_parser("preview", help="flat-shaded scene preview "
                        "(GL pre-render view analog)")
    pv.add_argument("scene")
    pv.add_argument("--out", default="preview.png")
    pv.add_argument("--width", type=int)
    pv.add_argument("--height", type=int)
    pv.add_argument("--dof-frames", type=int, default=0,
                    help="lens-jittered preview frames when the camera "
                         "has DOF (0 = auto: 32, matching the GL "
                         "accumulation count)")
    _device_flag(pv)
    pv.set_defaults(fn=cmd_preview)

    vw = sub.add_parser("view", help="render a view mode from a watch "
                        "checkpoint (mid-render view switching)")
    vw.add_argument("scene")
    vw.add_argument("state", help="the .state.npz that watch --resume "
                    "rewrites after every pass")
    vw.add_argument("--mode", default="image",
                    choices=["image", "z", "samplecount"])
    vw.add_argument("--profile", default=None,
                    help="finalize profile (gamma); default: the "
                         "profile saved in the checkpoint")
    vw.add_argument("--out", default="view.png")
    _device_flag(vw)
    vw.set_defaults(fn=cmd_view)

    pb = sub.add_parser("probe", help="print color/z/samples at a pixel")
    pb.add_argument("scene")
    pb.add_argument("--pixel", required=True, help="x,y")
    pb.add_argument("--profile", default="proj3")
    pb.add_argument("--spp", type=int)
    pb.add_argument("--width", type=int)
    pb.add_argument("--height", type=int)
    pb.add_argument("--seed", type=int, default=0)
    _device_flag(pb)
    pb.set_defaults(fn=cmd_probe)

    v = sub.add_parser("viz", help="render a photon .dat as a point cloud")
    v.add_argument("dat")
    v.add_argument("--out", default="photons.png")
    v.add_argument("--width", type=int, default=800)
    v.add_argument("--height", type=int, default=600)
    v.add_argument("--angle", type=float, default=0.0)
    v.set_defaults(fn=cmd_viz)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
