"""One run of one cell of the benchmark of ``worldrenderer_tpu_torch``.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the card(s) the cell asks
for. Set-up (imports, the card, the kernels' build or load, the scene and
inputs from the seed, the program's configuration, one warm request) is
timed from the process's start; then the cell's traffic runs for
``--seconds`` (with ``--trace 1`` under the profiler, at most the mix's
``trace_requests`` requests), then the plain reference recomputes a sample
of the window's requests. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (``--trace 1``) and, last, ``checks``: each number compared
with its limit, also printed as the last lines of standard error.
"""

import time

_T_FIRST_LINE = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _process_age() -> float:
    """Seconds from the process's start to now, from /proc (the
    interpreter's own start-up before this file's first line included);
    0 where /proc does not tell."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    age = _process_age()
    started = min(_T_FIRST_LINE, time.perf_counter() - age) if age else _T_FIRST_LINE
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, ROOT)
    from harness.manifest import Manifest

    manifest = Manifest()
    cell = manifest.workload(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from harness.cell import forbidden_modules, power_limit, run_cell

    card = power_limit()
    result = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", started)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"card: {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
