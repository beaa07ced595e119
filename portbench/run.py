"""Run one cell of the port's benchmark and print its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (evostencils_torch/) and
BENCHMARK.json.  Needs as many CUDA devices as the cell asks for; without
them, or without the port, it exits non-zero and prints no result.  With
`--trace 1` the line carries the cell's per-layer metrics, the device's busy
and traced seconds and a breakdown, and a bounded copy of the traced device
events goes to portbench_out/ in the checkout.  The numbers compared with
the reference, each beside its limit, are the last lines on stderr and the
last key of the result.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One torch and numpy thread: the host's share of each request (the loops'
# reads, the verdicts, the translation) runs on one thread as the optimizer's
# serial dispatcher runs it.  Set before torch loads.
for variable in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[variable] = "1"
# Every build and kernel cache of the run stays at a fixed place inside the
# checkout: the port builds its kernel library under build/evostencils_torch/.
for variable, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[variable] = os.path.join(ROOT, "build", sub)
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    sys.setrecursionlimit(100000)
    try:
        from portbench import harness

        result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             STARTED)
    except Exception as error:  # noqa: BLE001 - any failure ends the run without a result
        traceback.print_exc()
        print(f"portbench: {type(error).__name__}: {error}", file=sys.stderr)
        return 1
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
