"""Run one cell of the benchmark once and print its result line.

    python3 benchmark_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the card's busy and window seconds and
a breakdown. It exits non-zero, with no result, without the CUDA cards the
cell needs. ``--control bf16`` runs the program's bf16 path in place of the
configuration's fp32 (its numbers must fail a limit) and ``--fault`` plants
a fault under the timed path (``harness/faults.py``); neither is used in a
measured run.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark_torch.harness import cell as cells  # noqa: E402
from benchmark_torch.harness import device as cards  # noqa: E402
from benchmark_torch.harness.faults import FAULTS  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    p.add_argument("--fault", choices=FAULTS, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cell = cells.load(args.workload)
    cards.set_cache_dirs()
    cards.require_cards(cell.chips)
    from benchmark_torch.harness import runner

    result, lines = runner.run_cell(args.workload, args.seed, args.seconds, args.trace, T0,
                                    control=args.control, fault=args.fault)
    runner.emit(result, lines)


if __name__ == "__main__":
    main()
