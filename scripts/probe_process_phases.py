"""Run ``chip_smoke.py``'s example and process phases alone on the card.

Builds K1, K3 and K5, then runs ``example_paths`` (the eight scripts of
``examples/torch`` for a few steps each) and ``process_paths`` (NCCL at
world size 1 in this process; NCCL's refusal of two ranks on one card; two
gloo processes on the one card against one-process runs), with the gates
of ``chip_smoke.py``.  Run from the repository's root on a machine with a
card:

    PYTHONPATH=. python3 scripts/probe_process_phases.py [examples] [process]
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs


def main() -> int:
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import attention as k3
    from heat_tpu_torch.ops import cdist as k1
    from heat_tpu_torch.ops import lasso_sweep as k5

    if not torch.cuda.is_available():
        print("probe_process_phases: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda mod: mod._kernel(), (k1, k3, k5)))
    print(f"[probe] K1, K3, K5 built in {time.perf_counter() - t0:.1f} s", flush=True)
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(f"[probe] {card}")
    ht.wire.set_mode("off")
    which = sys.argv[1:] or ["examples", "process"]
    if "examples" in which:
        t0 = time.perf_counter()
        exm = cs.example_paths(ht, k1, k3, k5, card)
        print(f"[probe] examples: launches K1 {exm['k1']}, K3 {exm['k3']}, K5 {exm['k5']}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if "process" in which:
        t0 = time.perf_counter()
        prc = cs.process_paths(ht, k1, k3, 0, torch.device("cuda", 0), card)
        print(f"[probe] process: launches K1 {prc['k1']}, K3 {prc['k3']}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
