"""One worker rank of the benchmark's `dispatch` kind of work
(portbench/kinds/dispatch.py), which rank 0 starts as

    python3 portbench/dispatch_worker.py

with one line of JSON on stdin: its rank, the group's size, the store's
port, the collective timeout, the device type, the configuration, the
traffic mix and the seed.  It then joins the gloo group and obeys rank 0's
commands.  When stdin ends (rank 0 closed it or is gone) the worker ends at
once, whatever it is doing.
"""

import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _end_with_rank_0() -> None:
    sys.stdin.read()
    os._exit(3)


def main() -> None:
    import json

    spec = json.loads(sys.stdin.readline())
    threading.Thread(target=_end_with_rank_0, daemon=True).start()
    sys.setrecursionlimit(100000)
    from portbench.kinds import dispatch

    dispatch.serve(spec)


if __name__ == "__main__":
    main()
