"""How often a torch.profiler session on the card records no kernel.

    PYTHONPATH=. python3 scripts/probe_profiler_sessions.py [--rounds 3]

Profiles one launch of K1 (``ops.cdist.cdist`` at (4096, 64) x (8, 64)) in
sessions of their own, each started, the launch synchronized and stopped as
``utils.monitor.profile_trace`` does, and counts the CUDA-typed events of
``key_averages()``: first in the fresh process, then after each of
``--rounds`` ``KMeans(k=8, init="random").fit_stream`` runs over the
streaming phase's 4194304 x 64 f32 ``.npy`` file (``chip_smoke.py``'s
``stream_paths`` shape), then after ``torch.cdist`` of the same rows in
float64.  Prints, for each point, the kernels seen in 6 sessions, with the
card's name and power limit.
"""

import argparse
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import heat_tpu_torch as ht
from heat_tpu_torch.ops import cdist as k1

ROWS, F, K = 4_194_304, 64, 8


def session(x, y) -> int:
    """CUDA events of one profiled K1 launch."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    k1.cdist(x, y, sqrt=False)
    torch.cuda.synchronize()
    prof.stop()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    ht.wire.set_mode("off")
    k1._kernel()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, F, generator=gen, device=dev)
    y = torch.randn(K, F, generator=gen, device=dev)

    def report(label):
        print(f"[sessions] after {label}: kernels seen in 6 sessions {[session(x, y) for _ in range(6)]} on {card}",
              flush=True)

    report("a fresh start")
    data = torch.randn(ROWS, F, generator=gen, device=dev)
    tmp = tempfile.mkdtemp(prefix="heat_sessions_")
    try:
        path = os.path.join(tmp, "x.npy")
        np.save(path, data.cpu().numpy())
        report("writing the file")
        for i in range(args.rounds):
            ht.cluster.KMeans(n_clusters=K, init="random", random_state=i, max_iter=5, tol=-1.0).fit_stream(
                path, budget=ROWS * F)
            report(f"fit_stream {i}")
        torch.cdist(data.double(), torch.randn(K, F, generator=gen, device=dev, dtype=torch.float64)).argmin(1)
        report("a float64 cdist")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
