"""Rehearse one cell end to end on the CPU at a tiny size:

  python3 rtbench/rehearse.py --workload box.fused_64spp --width 64 \
      --height 48 [--seconds 1] [--seed 7] [--trace 0]

The same set-up, window, launch wrappers, trace reduction, reference and
check as a run on the card, with the program's and the reference's plain
versions on the CPU.  A cell on several cards (a traffic that names a
"mesh", rtbench/sharded.py) runs as many gloo ranks, one process each,
through `render_sharded`: this process is rank 0 and starts the others
(`--workload box.sharded4 --width 32 --height 24` on a manifest that holds
such a cell, as rtbench/tests/test_rtbench_sharded.py writes one).  It
prints the check and the counts, and no device metric: a CPU run measures
nothing the benchmark reports.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from rtbench import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T0, device="cpu", width=args.width,
                      height=args.height)
    out.pop("metrics")
    out.pop("breakdown", None)
    print(json.dumps(out))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
