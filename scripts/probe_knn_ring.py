"""Where the time of the KNN batch predict goes, on one card.

    PYTHONPATH=<tree> python3 scripts/probe_knn_ring.py --label <name>

Imports ``heat_tpu_torch`` from ``<tree>`` (a checkout of this repo, or of
an earlier commit whose both-row-split ``cdist`` gathers its corpus
instead of ringing it) and runs, in one process, chip_smoke.py's KNN batch
cell: ``KNeighborsClassifier(5)`` fitted on a 65536 x 64 f32 corpus split
0 over ``MeshComm(4)``, the wire plane off, a warm-up predict of 4096
queries, then predicts of 65536 split-0 queries.  It prints, with the
card's name and power limit:

* the first full-size predict (chip_smoke.py's timed call: host clock
  around a synchronize) and five more, each with the caching allocator's
  new device allocations during the call;
* the distances alone, ``spatial.cdist(q, x)`` read at once, by host clock
  and by CUDA events, and the gathered layout (the corpus replicated);
* one warm predict under ``torch.profiler``: device busy time against the
  profiled wall;
* one warm predict under ``cProfile``: the host functions with the most
  own time.
"""

import argparse
import cProfile
import io
import pstats
import subprocess
import time

import torch
from torch.autograd import DeviceType

import heat_tpu_torch as ht
from heat_tpu_torch.ops import cdist as k1

N, F, K, POSITIONS = 65_536, 64, 5, 4


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()[0].strip()


def allocs() -> int:
    return int(torch.cuda.memory_stats().get("num_device_alloc", -1))


def host_ms(fn):
    torch.cuda.synchronize()
    a0 = allocs()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), allocs() - a0


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    name, tag = card(), args.label
    dev = torch.device("cuda", 0)
    ht.wire.set_mode("off")
    k1._kernel()
    mesh = ht.MeshComm(POSITIONS)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 15)
    X = torch.randn(N, F, generator=gen, device=dev)
    labels = (X[:, 0] > 0).to(torch.int32)
    Q = torch.randn(N, F, generator=gen, device=dev)
    torch.cuda.empty_cache()
    x_ht = ht.array(X, split=0, comm=mesh, copy=False)
    model = ht.classification.KNeighborsClassifier(n_neighbors=K).fit(x_ht, ht.array(labels, split=0, comm=mesh,
                                                                                    copy=False))
    q_ht = ht.array(Q, split=0, comm=mesh, copy=False)
    model.predict(ht.array(Q[:4096], split=0, comm=mesh, copy=False))
    k1.launches = 0
    first, ms, n_alloc = host_ms(lambda: model.predict(q_ht))
    print(f"[{tag}] knn batch predict, first full-size call: {ms:.4f} ms host clock, {n_alloc} new device "
          f"allocations, K1 launches {k1.launches} on {name}")
    for i in range(5):
        again, ms, n_alloc = host_ms(lambda: model.predict(q_ht))
        print(f"[{tag}] knn batch predict, call {i + 2}: {ms:.4f} ms host clock, {n_alloc} new device allocations, "
              f"labels equal the first call's {torch.equal(again.larray, first.larray)} on {name}")
        del again
    ev = event_ms(lambda: model.predict(q_ht).larray)
    print(f"[{tag}] knn batch predict: {ev:.4f} ms a call by CUDA events over 5 on {name}")

    def dist():
        return ht.materialize(ht.spatial.cdist(q_ht, x_ht)).larray

    x_whole = ht.array(X, comm=mesh, copy=False)

    def gathered():
        with ht.fusion.fuse(False):
            return ht.spatial.cdist(q_ht, x_whole).larray

    for what, fn in (("split-0 corpus", dist), ("replicated corpus (gathered layout)", gathered)):
        fn()
        _, ms, n_alloc = host_ms(fn)
        print(f"[{tag}] cdist of the queries to the {what}: {ms:.4f} ms host clock ({n_alloc} new device "
              f"allocations), {event_ms(fn):.4f} ms by CUDA events on {name}")
    torch.cuda.synchronize()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(q_ht).larray
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # the device's own rows (kernels, copies): an operator's row repeats
    # the time of the kernels it launched
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[{tag}] knn batch predict under torch.profiler: device busy {busy:.4f} ms of {wall:.4f} ms wall "
          f"on {name}")
    for e in rows[:8]:
        print(f"[{tag}]     {e.self_device_time_total / 1e3:.4f} ms x{e.count} {e.key[:100]}")

    pr = cProfile.Profile()
    torch.cuda.synchronize()
    pr.enable()
    model.predict(q_ht).larray
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(12)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[{tag}] cprofile {line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
