"""Time the two methods of the split-axis sort on the card.

Runs ``chip_smoke.py``'s ``sort_method_paths`` alone: the odd-even
network and columnsort of ``heat_tpu_torch/parallel/sort.py`` over
``MeshComm(8)`` at 8 × 98 rows (the least block where columnsort applies),
1e5 and 1e7 rows, each bitwise against ``torch.sort(stable=True)``, then
timed by CUDA events.  Run from the repository's root on a machine with a
card:

    PYTHONPATH=. python3 scripts/probe_sort_methods.py [--seed N]
"""

import argparse
import sys

import torch

import chip_smoke as cs


def main() -> int:
    import heat_tpu_torch as ht

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_sort_methods: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(f"[probe] {card}")
    cs.sort_method_paths(ht, args.seed, torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
