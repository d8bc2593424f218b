"""The benchmark's command:

    python3 -m perfbench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU.  It
prints one JSON result line last on standard output; without a card it
exits with 2 and prints none.  See ``harness.py``.
"""

from __future__ import annotations

import argparse
import sys

from .harness import process_start, run_cell


def main(argv=None) -> int:
    t_proc = process_start()
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                    t_proc=t_proc)


if __name__ == "__main__":
    sys.exit(main())
