"""Readings that the limits of `correct` are set from, for one cell, in
one process on the card:

  python3 rtbench/calibrate.py --workload box.fused_64spp --seed0 <n> \
      [--seeds 12] [--control 3]

For each of `--seeds` run seeds from seed0 it renders the frame a run of
that seed renders first (the timed path's `render`, on the set-up's
scene and tables) and compares it with the reference's frame (the sound reading); for
the first `--control` seeds it also puts the reference computed with
bfloat16 scene and rays in the program's place (the control's reading).
Prints one JSON line a seed.  The benchmark's runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from rtbench import check, harness, manifest
    from rtbench.reference import frames
    from rtf_tpu_torch.render.renderer import render
    cell = manifest.Cell(manifest.load(), args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[calibrate] no card", file=sys.stderr)
        return 2
    cfg = harness.render_config(cell.traffic)
    w, h = args.width, args.height
    with torch.no_grad():
        scene, tables = harness.build(cell.config, dev, w, h)
        for k in range(args.seeds):
            seed = args.seed0 + k
            fs = harness.frame_seed(seed, 0)
            t = time.perf_counter()
            res = render(scene, cfg, seed=fs, device=dev, tables=tables)
            prog_s = time.perf_counter() - t
            program = {a: getattr(res, a) for a in
                       ("image", "radiance", "z", "sample_count")}
            del res
            line = {"workload": args.workload, "seed": seed,
                    "frame_s": prog_s}
            for side, lower in (("sound", False), ("control", True)):
                if lower and k >= args.control:
                    continue
                t = time.perf_counter()
                ref = frames.reference(
                    cell.config, cell.traffic, fs, dev,
                    harness.derived_seed(seed, 4), w, h)
                if lower:
                    # the control in the program's place
                    low = frames.reference(
                        cell.config, cell.traffic, fs, dev,
                        harness.derived_seed(seed, 4), w, h, lower=True)
                    program_side = {a: _full(low, a, ref) for a in program}
                else:
                    program_side = program
                line[side] = check.numbers(program_side, ref)
                line[side + "_s"] = time.perf_counter() - t
            print(json.dumps(line), flush=True)
    return 0


def _full(ans, key, ref):
    """A reference answer over its pixels, laid out as a whole frame's
    array (pixels it did not render are left zero)."""
    import numpy as np
    pix = np.asarray(ans["pixels"])
    n = int(max(pix.max(), np.asarray(ref["pixels"]).max())) + 1
    v = np.asarray(ans[key])
    out = np.zeros((n,) + v.shape[1:], v.dtype)
    out[pix] = v
    return out


if __name__ == "__main__":
    sys.exit(main())
