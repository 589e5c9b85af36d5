"""The benchmark of rtf_tpu_torch on NVIDIA H100s (BENCHMARK.json):

  python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout.  Prints the run's result as the last line of
standard output (one JSON object) and the numbers compared, each with its
limit, as the last lines of standard error.  Exits non-zero, printing no
result, without the cell's cards, when a run fails, or when JAX or rtf_tpu
was loaded.  A cell on several cards starts this script once more for each
card but the first (`--rank k --port p --parent <pid>`, rtbench/
sharded.py); such a rank prints no result.
"""
import time

T0 = time.perf_counter()   # process start: before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, as rank 0 starts it
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--width", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--height", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # caches of the program's builds stay inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    from rtbench import harness
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T0, device=args.device,
                          width=args.width, height=args.height,
                          rank=args.rank, port=args.port, parent=args.parent)
    except harness.NoCard as e:
        print(f"[rtbench] no card: {e}", file=sys.stderr)
        return 2
    if out is None:          # a rank > 0
        return 0
    for name, c in out["check"].items():
        print(f"[rtbench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
