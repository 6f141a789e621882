"""The fleet router (``heat_tpu_torch.serving.router``) against heat_tpu's
on the CPU: the consistent-hash ring, and the failover matrix (an error
burst that opens the circuit, a stall mid-flight, a dispatch fault at the
replica site) with the same seeded injections in both packages, giving the
same sequence of health states and the same counts; then ``rolling_swap``
with its canary and its rollback, the tuning-cache merge, and one case on
the card.  The mirror is ``tests/test_router.py``.

Each replica gets its own stall detector: the stall scenario arms a short
timeout on the replica it wedges only, so a sibling serving the failover
can never be taken for stalled.  Every fleet is closed in a ``finally``;
waits are on futures, or on a state with a deadline.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch import serving as TS
from heat_tpu_torch.core import telemetry as TT
from heat_tpu_torch.serving import router as TR
from heat_tpu_torch.utils import fault as TF

F, O = 8, 4
COUNTS = ("dispatched", "spills", "retries", "failovers", "backoffs", "rejected", "late_results", "lost_futures",
          "degradations", "ejections", "half_opens", "probes", "probe_failures", "recoveries")


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(autouse=True)
def on_the_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


def _pkgs(ht):
    """(package, serving, telemetry, fault) of both packages."""
    from heat_tpu import serving as JS
    from heat_tpu.core import telemetry as JT
    from heat_tpu.utils import fault as JF

    return {"torch": (htt, TS, TT, TF), "jax": (ht, JS, JT, JF)}


class _Linear:
    """A swappable model: one resident operand."""

    def __init__(self, pkg, w):
        self.w = pkg.array(w)

    def predict(self, x):
        return x @ self.w


W = np.random.default_rng(1818).normal(size=(F, O)).astype(np.float32)
W2 = np.random.default_rng(1819).normal(size=(F, O)).astype(np.float32)


def _fleet(pkg, serving, fault, timeouts, **kw):
    """A fleet of ``len(timeouts)`` replicas, replica i watched by a stall
    detector of ``timeouts[i]`` seconds, serving ``_Linear(W)`` as ``lin``."""
    engines = []
    for i, t in enumerate(timeouts):
        det = fault.StallDetector(timeout=t).start()
        engines.append(serving.ServingEngine(name=f"r{i}", stall_detector=det))
    kw.setdefault("cooldown_s", 0.05)
    kw.setdefault("error_threshold", 2)
    kw.setdefault("probe_timeout_s", 15.0)
    fleet = serving.ServingFleet(engines, **kw)
    fleet.register("lin", models=[_Linear(pkg, W) for _ in engines], feature_dim=F, min_bucket=8, max_batch=16,
                   warm=True)
    return fleet


def _key_for(fleet, name):
    for key in range(4096):
        if fleet._ring_order(key)[0].name == name:
            return key
    raise AssertionError(f"no key hashes home to {name}")


def _wait_healthy(fleet, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(r.state == TR.HEALTHY for r in fleet.replicas):
            return True
        time.sleep(0.01)
    return False


def _scenario(which, pkg, serving, telemetry, fault):
    """One failover drill; the health-state sequence per replica, the
    router's counts, and whether every answer was right."""
    telemetry.reset_group("serving")
    telemetry.reset_group("router")
    x = np.ones((2, F), np.float32)
    with telemetry.telemetry_level("events"):
        telemetry.clear_events()
        if which == "stall":
            # the cooldown outlasts the stall: the first probe finds r0 free
            fleet = _fleet(pkg, serving, fault, (0.1, 60.0), cooldown_s=1.0)
            arm = fault.FaultInjector(seed=0).stall_in("serving.step.r0", 0.4)
        else:
            fleet = _fleet(pkg, serving, fault, (60.0, 60.0))
            arm = (fault.FaultInjector(seed=0).error_in("serving.step.r1", times=4) if which == "error burst"
                   else fault.FaultInjector(seed=0).error_in("serving.replica.r0"))
        try:
            home = "r1" if which == "error burst" else "r0"
            key = _key_for(fleet, home)
            with fault.injected(arm):
                # the error burst sends two requests home to r1; after a
                # dispatch fault a second request finds r0 serving again
                outs = [fleet.predict("lin", x, key=key) for _ in range(1 if which == "stall" else 2)]
                if which == "stall":
                    # r0 is ejected and its request served by r1; its
                    # watchdog has done its part (an idle replica's short
                    # clock must not race the probe's few milliseconds)
                    fleet.replicas[0].detector.pause()
                # the circuit closes again through half-open probes
                assert _wait_healthy(fleet)
            ok = all(np.allclose(np.asarray(o), x @ W, rtol=1e-5) for o in outs)
            stats = fleet.stats()
            states = [(e["replica"], e["state"]) for e in telemetry.events("router_health")]
        finally:
            fleet.close()
    return states, {k: stats[k] for k in COUNTS}, ok, arm.fired


EXPECTED = {
    # r1 fails twice (degraded, then the breaker opens at 2), each request
    # failing over to r0; two of the four armed faults remain, so two
    # probes fail before the third closes the circuit
    "error burst": ([("r1", "degraded"), ("r1", "ejected"), ("r1", "half_open"), ("r1", "ejected"),
                     ("r1", "half_open"), ("r1", "ejected"), ("r1", "half_open"), ("r1", "healthy")],
                    dict(dispatched=4, failovers=2, retries=2, degradations=1, ejections=3, half_opens=3, probes=3,
                         probe_failures=2, recoveries=1)),
    # r0 wedges with the request in flight: its detector ejects it and the
    # request fails over (uncharged); the wedged batch lands late; a probe
    # brings r0 back
    "stall": ([("r0", "ejected"), ("r0", "half_open"), ("r0", "healthy")],
              dict(dispatched=2, failovers=1, retries=1, late_results=1, ejections=1, half_opens=1, probes=1,
                   recoveries=1)),
    # the dispatch itself fails at r0: degraded, failover to r1; the next
    # request home to r0 is served there, which clears the degradation
    "dispatch fault": ([("r0", "degraded"), ("r0", "healthy")],
                       dict(dispatched=3, failovers=1, retries=1, degradations=1)),
}


@pytest.mark.parametrize("which", list(EXPECTED))
def test_failover_matrix_matches_heat_tpu(ht, which):
    got = {name: _scenario(which, *mods) for name, mods in _pkgs(ht).items()}
    assert got["torch"] == got["jax"]
    states, counts, ok, fired = got["torch"]
    want_states, want_counts = EXPECTED[which]
    assert ok and states == want_states
    assert counts == {k: want_counts.get(k, 0) for k in COUNTS}


def test_ring_placement_matches_heat_tpu(ht):
    fleets = {}
    for name, (pkg, serving, telemetry, fault) in _pkgs(ht).items():
        fleets[name] = serving.ServingFleet(replicas=4, stall_timeout_s=60.0)
    try:
        orders = {n: [[r.name for r in f._ring_order(k)] for k in range(64)] for n, f in fleets.items()}
        assert orders["torch"] == orders["jax"]
        assert len({o[0] for o in orders["torch"]}) == 4  # keys spread over the fleet
        assert fleets["torch"]._ring_keys == fleets["jax"]._ring_keys
    finally:
        for f in fleets.values():
            f.close()
    for f in fleets.values():
        assert not f._housekeeper.is_alive() and all(not r.detector._thread.is_alive() for r in f.replicas)


def test_rolling_swap_and_its_rollback_match_heat_tpu(ht):
    x = np.random.default_rng(3).normal(size=(2, F)).astype(np.float32)
    reports = {}
    for name, (pkg, serving, telemetry, fault) in _pkgs(ht).items():
        telemetry.reset_group("serving")
        telemetry.reset_group("router")
        fleet = _fleet(pkg, serving, fault, (60.0, 60.0))
        try:
            for i in range(4):
                fleet.predict("lin", x, key=f"w{i}")
            compiles = telemetry.serving_report()["step_compiles"]
            futs = [fleet.submit("lin", x, key=f"t{i}") for i in range(6)]
            good = fleet.rolling_swap("lin", {"w": pkg.array(W2)}, canary=1, regression_ratio=100.0)
            for f in futs:
                assert np.asarray(f.result(30)).shape == (2, O)
            after = [np.asarray(fleet.predict("lin", x, key=f"p{i}")) for i in range(4)]
            assert telemetry.serving_report()["step_compiles"] == compiles
            # a swap whose canary probes fail (r0's steps error) is rolled
            # back: the fleet keeps serving W2
            with fault.injected(fault.FaultInjector(seed=0).error_in("serving.step.r0", times=64)):
                bad = fleet.rolling_swap("lin", {"w": pkg.array(W)}, canary=1)
            kept = [np.asarray(fleet.predict("lin", x, key=f"q{i}")) for i in range(4)]
            stats = fleet.stats()
        finally:
            fleet.close()
        for v in after + kept:
            np.testing.assert_allclose(v, x @ W2, rtol=1e-5, atol=1e-6)
        reports[name] = (good, bad, stats["swaps"], stats["rollbacks"])
    assert reports["torch"] == reports["jax"]
    good, bad, swaps, rollbacks = reports["torch"]
    assert good == {"endpoint": "lin", "canary": 1, "swapped": ["r0", "r1"], "rolled_back": False, "reason": None}
    assert bad["rolled_back"] and bad["swapped"] == [] and "r0" in bad["reason"]
    assert (swaps, rollbacks) == (3, 1)


def test_shared_model_refuses_a_canary_and_tuning_caches_merge(tmp_path):
    fleet = TS.ServingFleet(replicas=2, stall_timeout_s=60.0,
                            autotune_caches=[str(tmp_path / "a.json"), str(tmp_path / "b.json")],
                            autotune_merge_out=str(tmp_path / "m.json"))
    try:
        shared = _Linear(htt, W)
        fleet.register("sh", shared, feature_dim=F, min_bucket=8, max_batch=16)
        with pytest.raises(ValueError, match="models="):
            fleet.rolling_swap("sh", {"w": shared.w})
        with pytest.raises(ValueError, match="one model per replica"):
            fleet.register("bad", models=[shared], feature_dim=F)
        with pytest.raises(KeyError):
            fleet.submit("nope", np.ones((1, F), np.float32))
        for cache in ("a", "b"):
            htt.autotune.save(str(tmp_path / f"{cache}.json"))
        before = fleet.stats()["cache_merges"]
        fleet._merge_caches()
        assert fleet.stats()["cache_merges"] == before + 1 and (tmp_path / "m.json").exists()
    finally:
        fleet.close()
    with pytest.raises(TS.RequestRejected, match="closed"):
        fleet.submit("sh", np.ones((1, F), np.float32))


# ------------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_fleet_serves_kmeans_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    htt.use_device("gpu")
    g = torch.Generator(device="cuda").manual_seed(1)
    centres = torch.randn(8, 64, generator=g, device="cuda")
    models = [htt.cluster.kmeans_from_state(centres.cpu().numpy(), 1, 0.0) for _ in range(4)]
    fleet = TS.ServingFleet(replicas=4, stall_timeout_s=30.0)
    try:
        fleet.register("km", models=models, feature_dim=64, min_bucket=8, max_batch=32, warm=True)
        reqs = [torch.randn(r, 64, generator=g, device="cuda").cpu().numpy() for r in (1, 4, 3, 2) * 8]
        futs = [fleet.submit("km", r, key=i) for i, r in enumerate(reqs)]
        for r, f in zip(reqs, futs):
            d = torch.cdist(torch.from_numpy(r).double(), centres.double().cpu())
            np.testing.assert_array_equal(np.ravel(f.result(60)), d.argmin(1).numpy())
        assert fleet.stats()["lost_futures"] == 0
    finally:
        fleet.close()


# ------------------------------------------- the fusion engine under threads
def test_fusion_eager_scope_is_per_thread():
    """Replicas run steps on threads of their own.  A program's op-by-op
    run evaluates eagerly on its thread only: two runs that overlap as
    A-enter, B-enter, A-exit, B-exit leave the engine on (a module-global
    switch saved and restored by each run was left off), and no other
    thread sees the engine off meanwhile."""
    from heat_tpu_torch.core import fusion

    entered = {k: threading.Event() for k in "AB"}
    leave = {k: threading.Event() for k in "AB"}
    seen = {}

    def body(k):
        def custom(vals):
            seen[k] = fusion.enabled()
            entered[k].set()
            assert leave[k].wait(10)
            return None
        fusion._Program((), (), (), custom).run([])

    assert fusion.enabled()
    threads = {k: threading.Thread(target=body, args=(k,)) for k in "AB"}
    threads["A"].start()
    assert entered["A"].wait(10)
    threads["B"].start()
    assert entered["B"].wait(10)
    assert fusion.enabled()  # this thread is not inside a run
    leave["A"].set()
    threads["A"].join(10)
    leave["B"].set()
    threads["B"].join(10)
    assert not any(t.is_alive() for t in threads.values())
    assert seen == {"A": False, "B": False} and fusion.enabled()
    with fusion.sealed():
        other = []
        t = threading.Thread(target=lambda: other.append(getattr(fusion._LOCAL, "sealed", 0)))
        t.start()
        t.join(10)
        assert other == [0] and fusion._LOCAL.sealed == 1


def test_fused_chains_on_many_threads_stay_right():
    """More threads than cores, each materializing fused chains with a
    short switch interval: every value is right and the engine stays on."""
    from heat_tpu_torch.core import fusion

    x = htt.array(np.arange(64, dtype=np.float32).reshape(16, 4), split=0, comm=htt.MeshComm(4), device="cpu")
    want = np.arange(64, dtype=np.float32).reshape(16, 4) * 3.0 + 1.0
    errors = []

    def work():
        try:
            for _ in range(20):
                got = ((x * 2.0 + 1.0) + x).numpy()
                if not np.array_equal(got, want):
                    errors.append("wrong value")
        except Exception as exc:  # noqa: BLE001 — reported by the assertion below
            errors.append(repr(exc))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and fusion.enabled()
