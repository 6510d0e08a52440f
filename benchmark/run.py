"""One run of one benchmark cell of the PyTorch/CUDA port on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON object as the last line
of standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last) and
the compared numbers beside their limits as the last lines of standard
error. Exits with another code than 0, and prints no result, without CUDA
or with fewer cards than the cell asks for, or if the run holds JAX or
the JAX package once its window has closed.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402

START = harness.process_start()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = harness.load_spec(args.workload)

    import torch

    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", START)
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
