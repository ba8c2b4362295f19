"""The readings behind a cell's correctness limits, one JSON line a seed:

    python3 benchmarks/readings.py --workload <cell> --seeds 1 2 3 [--no-control] [--witness]

Each line holds the program's numbers and the control's (the reference in
TF32) for the seed, with ``--witness`` the float32 reference's, and the
quantiles of the differences behind them (``harness/readings.py``). Not
part of a benchmark run.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--witness", action="store_true",
                   help="also the reference computed in float32")
    args = p.parse_args(argv)
    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, os.path.dirname(BENCH_DIR))
    from harness.manifest import Manifest
    from harness.readings import collect

    for row in collect(Manifest(), args.workload, args.seeds,
                       control=not args.no_control, witness=args.witness):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
