"""chip_smoke.py's serving and fault phases alone, in a fresh process.

    PYTHONPATH=. python3 scripts/probe_serving_fault_phases.py [serve] [fault]

Builds K1, K3 and K7, then runs ``chip_smoke.serving_paths`` (the engine's
three endpoints taking the benchmark's 256 requests, shed and drain, the
4-replica fleet) and ``chip_smoke.fault_paths`` (the OOM back-off, the
TransformerLM under ``run_elastic``, the monitor and ``chain_slope``) with
every gate of the full script, on one card, beside its name and power
limit.  ``knn_paths``' direct served median is not measured here (NaN in
the comparison line).  About a minute on the card.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs


def main() -> None:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import attention as k3
    from heat_tpu_torch.ops import cdist as k1
    from heat_tpu_torch.ops import repack as k7

    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(card, torch.__version__, torch.version.cuda)
    ht.wire.set_mode("off")
    with ThreadPoolExecutor(3) as pool:
        for fut in [pool.submit(m._kernel) for m in (k1, k3, k7)]:
            fut.result()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    which = sys.argv[1:] or ["serve", "fault"]
    if "serve" in which:
        cs.serving_paths(ht, k1, 0, dev, card, dict(served_median_ms=float("nan"), served_p99_ms=float("nan")))
    if "fault" in which:
        cs.fault_paths(ht, k1, k3, k7, 0, dev, card)
    print(f"probe done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
