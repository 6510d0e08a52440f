"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 3] [--control 3]

For each seed, in one process, a run of the cell as ``run.py`` makes it
(``harness.run_cell``: set-up, a window of ``--seconds``, the check), whose
compared numbers are the program's readings: their largest over a dozen
seeds or more is a limit's lower reading. For the first ``--control``
seeds the run also judges the control (the reference in TF32 put in the
program's place) and, for a training cell, the half-batch fault (the
reference with half of each batch left out), by the same expression that
decides ``correct``: their smallest readings are the upper ones. One JSON
line a seed. The benchmark's own runs never take the control.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", type=int, default=3)
    args = parser.parse_args()
    spec = harness.load_spec(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(spec, seed, args.seconds, False, control=i < args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
