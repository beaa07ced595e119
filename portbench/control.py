"""The control readings that set a cell's limits, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--cpu]

prints one JSON line per item: the program's result and the reference's,
and the reference computed one precision below the configuration's (the
cell's kind of work says which) put in the program's place, each with its gaps
as the cell's check measures them.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="1,2,3")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    sys.setrecursionlimit(100000)
    import importlib

    import torch

    from portbench import harness

    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a card, or pass --cpu")
    _, _, config, traffic = harness.load_cell(ROOT, args.workload)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cpu" if args.cpu else "cuda")
    for row in kind.control(config, traffic, seeds, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
