"""What the fusion engine and the guard cost on the paths chip_smoke.py drives.

    PYTHONPATH=<tree> python3 scripts/probe_fusion_cost.py --label <name> [--out FILE]

Imports ``heat_tpu_torch`` from ``<tree>`` (a checkout of this repo, or of
an earlier commit, which has no fusion engine: there every setting runs the
eager path) and times on the card, one process, one card:

* the served KNN predict: ``KNeighborsClassifier(5)`` on a 65536 x 64 f32
  corpus split over ``MeshComm(4)``, 128 requests of 1-8 replicated rows,
  synchronized around each (chip_smoke.py's served cell).  Median and p99
  ms, the host syncs of one request (torch.cuda's sync debug mode), and the
  cyclic collector's runs and seconds during the 128 requests.  It is timed
  fresh, then again after the process has aged as chip_smoke.py's has by
  then: 3000 distinct programs in the engine's caches and 2e6 long-lived
  Python objects;
* the batch KNN predict of 65536 split-0 queries;
* the census chain ``exp((x - y) / 2 * x + 0.5).sum()`` at 8e6;
* the KMeans assignment step (labels and inertia) at 2e6 x 64, k = 8;
* ``(exp(a * 0.1) - 1).resplit(1)`` of a 4096^2 f32 chain over
  ``MeshComm(4)``: the fused split tail, and materialize-then-resplit.

Each path runs with the engine on and the guard at ``warn`` (its flag read
when it has landed), ``raise`` (read at once) and ``off``, and with the
engine off (``fusion.fuse(False)``).  Prints one line a measurement with
the card's name and power limit, and writes ``cProfile`` reports of the
census chains and of the served requests (aged), each setting, to
``--out`` when given.
"""

import argparse
import contextlib
import cProfile
import gc
import io
import pstats
import subprocess
import time
import warnings

import numpy as np
import torch

import heat_tpu_torch as ht
from heat_tpu_torch.ops import cdist as k1

HAS_FUSION = hasattr(ht, "fusion")


def settings():
    """(engine, guard) pairs this tree has."""
    if not HAS_FUSION:
        return [("none", "none")]
    return [("on", "warn"), ("on", "raise"), ("on", "off"), ("off", "off")]


@contextlib.contextmanager
def setting(fuse: str, guard: str):
    if not HAS_FUSION:
        yield
        return
    with ht.fusion.fuse(fuse == "on"), ht.guard.guarded(guard):
        yield


def sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def host_syncs(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


class GcMeter:
    """Runs and seconds of the cyclic collector between start and stop."""

    def __init__(self):
        self.runs, self.seconds, self._t0 = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.runs += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def age(dev) -> list:
    """Fill the engine's caches with 3000 distinct programs (eager ops on a
    tree without the engine) and keep 2e6 Python objects alive."""
    for i in range(3000):
        v = ht.array(torch.ones(i % 300 + 1, 3 + i // 300, device=dev))
        ((v * (i / 3000.0) + 1.0).exp() - v).sum().larray
    return [[j] for j in range(2_000_000)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    lab = f"[{args.label}]"
    k1._kernel()
    dev = torch.device("cuda", 0)
    mesh = ht.MeshComm(4)
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(65536, 64, generator=gen, device=dev)
    Y = (X[:, 0] > 0).to(torch.int32)
    model = ht.classification.KNeighborsClassifier(5).fit(ht.array(X, split=0, comm=mesh, copy=False),
                                                          ht.array(Y, split=0, comm=mesh, copy=False))
    rng = np.random.default_rng(15)
    reqs = [torch.randn(int(r), 64, generator=gen, device=dev) for r in rng.integers(1, 9, 128)]

    def served(tag):
        for f, g in settings():
            with setting(f, g):
                model.predict(ht.array(reqs[0], comm=mesh, copy=False))
                with GcMeter() as gm:
                    ms = [sync_ms(lambda: model.predict(ht.array(r, comm=mesh, copy=False))) for r in reqs]
                syncs = host_syncs(lambda: model.predict(ht.array(reqs[1], comm=mesh, copy=False)))
            print(f"{lab} served KNN {tag} engine={f} guard={g}: median {np.median(ms):.4f} ms, p99 "
                  f"{np.percentile(ms, 99):.4f} ms, host syncs a request {syncs}, collector runs {gm.runs} "
                  f"({gm.seconds * 1e3:.3f} ms) in 128 requests on {card}", flush=True)

    served("fresh")
    Q = ht.array(torch.randn(65536, 64, generator=gen, device=dev), split=0, comm=mesh, copy=False)
    for f, g in settings():
        with setting(f, g):
            model.predict(Q)
            ms = sorted(sync_ms(lambda: model.predict(Q)) for _ in range(3))
        print(f"{lab} batch KNN predict (65536, 64) engine={f} guard={g}: {ms[1]:.4f} ms (median of 3) on {card}",
              flush=True)
    del Q

    xs, ys = (torch.randn(8_000_000, generator=gen, device=dev) for _ in range(2))
    x, y = ht.array(xs, split=0), ht.array(ys, split=0)
    profiles = []
    for f, g in settings():
        with setting(f, g):
            ms = [sync_ms(lambda: ht.exp((x - y) / 2.0 * x + 0.5).sum().larray) for _ in range(22)][2:]
            if args.out:
                profiles.append((f"200 census chains, engine={f} guard={g}",
                                 profiled(lambda: [ht.exp((x - y) / 2.0 * x + 0.5).sum().larray for _ in range(200)])))
        print(f"{lab} census chain at 8e6 engine={f} guard={g}: median {np.median(ms):.4f} ms a call "
              f"(host clock around a synchronize) on {card}", flush=True)
    del x, y, xs, ys

    data = torch.randn(2_000_000, 64, generator=gen, device=dev)
    xa = ht.array(data, split=0)
    km = ht.cluster.KMeans(n_clusters=8, init="random", max_iter=1)
    km._cluster_centers = ht.array(data[:8].clone())
    for f, g in settings():
        with setting(f, g):
            ms = [sync_ms(lambda: km._assign_to_cluster(xa, return_inertia=True)) for _ in range(12)][2:]
        print(f"{lab} KMeans assignment step (2000000, 64) k=8 engine={f} guard={g}: median {np.median(ms):.4f} ms "
              f"a call on {card}", flush=True)
    del xa, data, km

    a = ht.array(torch.randn(4096, 4096, generator=gen, device=dev), split=0, comm=mesh)
    for f, g in settings():
        with setting(f, g):
            tail = [sync_ms(lambda: (ht.exp(a * 0.1) - 1.0).resplit(1)) for _ in range(7)][2:]
            mat = [sync_ms(lambda: (ht.materialize(ht.exp(a * 0.1) - 1.0) if HAS_FUSION
                                    else ht.exp(a * 0.1) - 1.0).resplit(1)) for _ in range(7)][2:]
        print(f"{lab} (exp(a * 0.1) - 1).resplit(1) of (4096, 4096) over MeshComm(4) engine={f} guard={g}: "
              f"{np.median(tail):.4f} ms as written, {np.median(mat):.4f} ms materialized first (median of 5) "
              f"on {card}", flush=True)
    del a

    keep = age(dev)
    served("aged")
    if args.out:
        for f, g in settings():
            with setting(f, g):
                profiles.append((f"128 served requests, aged, engine={f} guard={g}", profiled(
                    lambda: [model.predict(ht.array(r, comm=mesh, copy=False)).larray for r in reqs])))
        with open(args.out, "w") as fh:
            for what, text in profiles:
                fh.write(f"{args.label}: {what}, on {card}\n{text}\n")
    del keep


def profiled(fn) -> str:
    """``fn()`` under cProfile, synchronized: the 25 functions of most own
    time."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(25)
    return s.getvalue()


if __name__ == "__main__":
    main()
