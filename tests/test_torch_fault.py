"""``heat_tpu_torch.utils.fault`` and the transport engine's OOM back-off
against heat_tpu's on the CPU: the injector's schedules fired alike in both
packages, the stall detector driven by events (no test races a sleep),
``run_elastic`` on the MLP (``mlp_from_flax``) with the same faults and the
same checkpoints, the back-off under ``oom_in``/``low_hbm`` with
``TILE_BYTES`` monkeypatched in both packages (values bitwise, the same
counters), and both ``_is_oom``\\ s accepting an injected OOM.  The mirrors
are ``tests/test_fault.py`` and heat_tpu's transport back-off tests.
"""

import threading

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import guard as PG
from heat_tpu_torch.core import memtrack as PM
from heat_tpu_torch.core import stream as PS
from heat_tpu_torch.parallel import transport as PT
from heat_tpu_torch.utils import fault as PF

PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(autouse=True)
def on_the_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


# ------------------------------------------------------------- the injector
def _drive_sites(F):
    """Fire a fixed site schedule through injector module ``F``; returns
    what each consultation did and the injector's record."""
    inj = (F.FaultInjector(seed=3).oom_in("transport.resplit", times=2).error_in("fusion.exec")
           .nan_in("transport.reshape").stall_in("serving.step.*", 0.0, times=2))
    log = []
    for site in ("transport.resplit", "transport.take", "fusion.exec", "transport.resplit", "transport.resplit",
                 "serving.step.r3", "serving.step", "serving.step.r0", "serving.step.r1"):
        try:
            inj.fire_site(site)
            log.append((site, "ok"))
        except F.InjectedOOM as e:
            log.append((site, "oom", str(e)))
        except F.FaultInjector.InjectedFault as e:
            log.append((site, "error", str(e)))
    hit = inj.corrupt_site("transport.reshape", [np.ones(3, np.float32), np.arange(3)])
    miss = inj.corrupt_site("transport.reshape", [np.ones(3, np.float32)])
    log.append(("corrupt", [np.isnan(np.asarray(h, np.float64)).tolist() for h in hit],
                np.isnan(miss[0]).any()))
    return log, inj.fired, inj.seed


def test_site_schedules_match(ht):
    from heat_tpu.utils import fault as JF

    assert _drive_sites(PF) == _drive_sites(JF)


def test_step_schedules_match(ht):
    from heat_tpu.utils import fault as JF

    def drive(F):
        inj = F.FaultInjector().raise_at(2).nan_at(4).raise_at(5, sticky=True)
        out = []
        for step in (0, 2, 2, 4, 4, 5, 5):
            try:
                got = inj.fire(step, np.float32(1.5))
                out.append((step, bool(np.isnan(np.asarray(got, np.float64)))))
            except F.FaultInjector.InjectedFault as e:
                out.append((step, str(e)))
        return out

    assert drive(PF) == drive(JF)
    # a tensor loss stays a tensor, corrupted in place of the value
    got = PF.FaultInjector().nan_at(1).fire(1, torch.tensor(2.0))
    assert isinstance(got, torch.Tensor) and torch.isnan(got)


def test_corrupt_site_keeps_structure_and_integers():
    inj = PF.FaultInjector().nan_in("transport.resplit")
    shards = [torch.ones(2), None, torch.arange(3)]
    got = inj.corrupt_site("transport.resplit", shards)
    assert torch.isnan(got[0]).all() and got[1] is None and torch.equal(got[2], torch.arange(3))
    assert inj.fired == [("nan", "transport.resplit")]


def test_install_and_scoped_injection_arm_guard_and_memtrack():
    inj = PF.FaultInjector().oom_in("x").low_hbm(1 << 20)
    assert PG._INJECTOR is None
    with PF.injected(inj):
        assert PG._INJECTOR is inj and PM.min_free_bytes() == 1 << 20
        with pytest.raises(PF.InjectedOOM):
            PG.fire("x")
    assert PG._INJECTOR is None and PM.min_free_bytes() is None
    PF.install_injector(inj)
    try:
        assert PG._INJECTOR is inj and PM.min_free_bytes() == 1 << 20
    finally:
        PF.clear_injector()
    assert PG._INJECTOR is None and PM.min_free_bytes() is None


def test_injected_oom_is_an_oom_for_stream_and_transport(ht):
    from heat_tpu.core import stream as JS

    err = PF.InjectedOOM("stream.slab")
    assert isinstance(err, torch.OutOfMemoryError) and "RESOURCE_EXHAUSTED" in str(err)
    assert PS._is_oom(err) and PT._is_oom(err)
    assert not PS._is_oom(RuntimeError("boom")) and not PT._is_oom(RuntimeError("boom"))
    from heat_tpu.utils.fault import InjectedOOM

    assert JS._is_oom(InjectedOOM("stream.slab")) and str(InjectedOOM("s")) == str(PF.InjectedOOM("s"))


# --------------------------------------------------------- the stall detector
def _events(det):
    got = {k: threading.Event() for k in ("stall", "recover", "pause", "resume")}
    det.subscribe(lambda kind, info: got[kind].set())
    return got


def test_stall_then_recover_by_events():
    det = PF.StallDetector(timeout=0.05)
    ev = _events(det)
    quiet = []
    det.on_stall = quiet.append
    det.start()
    try:
        assert ev["stall"].wait(10), "no stall fired"
        assert quiet and quiet[0] > 0.05
        assert not ev["recover"].is_set()
        det.beat()  # the recover notification is sent on the beating thread
        assert ev["recover"].is_set()
    finally:
        det.stop()
    assert not det._thread.is_alive()


def test_pause_nests_and_subscribers_hear_it():
    det = PF.StallDetector(timeout=0.05)
    ev = _events(det)
    det.start()
    try:
        with det.pause():
            det.pause()
            assert ev["pause"].is_set() and det._paused == 2
            det.resume()
            # still paused: a watcher poll sees the pause and fires nothing
            assert not ev["stall"].wait(0.3)
        assert ev["resume"].is_set() and det._paused == 0
        assert ev["stall"].wait(10)
    finally:
        det.stop()
    assert not det._thread.is_alive()


def test_subscriber_may_unsubscribe_itself_and_errors_are_contained():
    det = PF.StallDetector(timeout=1.0)
    seen = []

    def once(kind, info):
        seen.append(kind)
        det.unsubscribe(once)

    def broken(kind, info):
        raise ValueError("subscriber bug")

    det.subscribe(once)
    det.subscribe(broken)
    det._notify("pause", depth=1)
    det._notify("pause", depth=1)
    det.unsubscribe(broken)
    det.unsubscribe(broken)  # an unknown callback is a no-op
    assert seen == ["pause"] and det._subs == []


# ---------------------------------------------------------------- run_elastic
@pytest.fixture(scope="module")
def mlp(ht):
    import jax

    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 8, 6)).astype(np.float32)
    y = rng.integers(0, 4, (10, 8))
    module = ht.models.MLP(features=(16, 4))
    variables = module.init(jax.random.PRNGKey(0), x[0])
    return module, jax.tree_util.tree_map(np.asarray, variables), x, y


LR = 0.1


def _port_run(mlp, faults, directory):
    _, variables, xs, ys = mlp
    model = htt.models.mlp_from_flax(variables, device="cpu")
    names = [n for n, _ in model.named_parameters()]

    def step_fn(state, batch):
        i, x, y = batch
        params = {k: v.clone().requires_grad_(True) for k, v in state.items()}
        logits = torch.func.functional_call(model, params, (x,))
        loss = torch.nn.functional.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        new = {k: (p - LR * g).detach() for (k, p), g in zip(params.items(), grads)}
        return new, {"loss": faults.fire(i, loss.detach())}

    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, report = PF.run_elastic(
        step_fn, init, lambda i: (i, torch.from_numpy(xs[i]), torch.from_numpy(ys[i])), len(xs),
        checkpointer=htt.utils.Checkpointer(directory), checkpoint_every=2, max_restarts=4)
    # the port's MLP layer i holds flax's Dense_i: kernel (in, out), bias
    return {n: state[n].numpy() for n in names}, report


def _jax_run(ht, mlp, faults, directory):
    import jax
    import optax
    from heat_tpu.utils.fault import run_elastic

    module, variables, xs, ys = mlp

    @jax.jit
    def grad_step(params, x, y):
        def loss_fn(p):
            logits = module.apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda p, d: p - LR * d, params, g), loss

    def step_fn(state, batch):
        i, x, y = batch
        new, loss = grad_step(state, x, y)
        return new, {"loss": faults.fire(i, loss)}

    state, report = run_elastic(step_fn, variables["params"], lambda i: (i, xs[i], ys[i]), len(xs),
                                checkpointer=ht.utils.Checkpointer(directory), checkpoint_every=2, max_restarts=4)
    return state, report


def test_run_elastic_matches_heat_tpu_on_the_mlp(ht, mlp, tmp_path):
    from heat_tpu.utils.fault import FaultInjector as JFI

    def arm(F):
        return F().nan_at(3).raise_at(6).raise_at(8, sticky=True)

    got, rep_t = _port_run(mlp, arm(PF.FaultInjector), str(tmp_path / "torch"))
    want, rep_j = _jax_run(ht, mlp, arm(JFI), str(tmp_path / "jax"))
    kinds = [(e["kind"], e["step"]) for e in rep_t.events]
    assert kinds == [(e["kind"], e["step"]) for e in rep_j.events]
    assert kinds == [("failure", 3), ("restore", 2), ("failure", 6), ("restore", 6), ("failure", 8),
                     ("restore", 8), ("skip", 8)]
    assert (rep_t.restarts, rep_t.skipped_steps, rep_t.steps_run) == (rep_j.restarts, rep_j.skipped_steps,
                                                                       rep_j.steps_run) == (3, [8], 10)
    for i in range(2):
        dense = want[f"Dense_{i}"]
        np.testing.assert_allclose(got[f"layers.{i}.kernel"], np.asarray(dense["kernel"]), rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(got[f"layers.{i}.bias"], np.asarray(dense["bias"]), rtol=0, atol=PARAM_ATOL)


def test_run_elastic_rewinds_without_checkpointer_and_exhausts_its_budget():
    def counting(faults):
        def step(state, batch):
            return state + batch, faults.fire(batch, np.float32(state))
        return step

    state, report = PF.run_elastic(counting(PF.FaultInjector().raise_at(6)), 0.0, lambda s: s, 10)
    assert state == sum(range(10)) and [e["kind"] for e in report.events] == ["failure", "rewind"]
    faults = PF.FaultInjector().raise_at(1, sticky=True).raise_at(2, sticky=True).raise_at(3, sticky=True)
    with pytest.raises(PF.ElasticFailure):
        PF.run_elastic(counting(faults), 0.0, lambda s: s, 8, max_restarts=2)
    assert not PF.default_health_check({"a": [torch.tensor([1.0, float("inf")])]})
    assert not PF.default_health_check(np.array([1j, np.nan]))
    assert PF.default_health_check({"n": torch.arange(3), "s": "text", "f": 1.0})


# ------------------------------------------------------- the transport back-off
CASES = {
    "reshape": ("transport.reshape", (999, 20), 0, lambda m, x: m.reshape(x, (1998, 10))),
    "resplit": ("transport.resplit", (64, 400), 0, lambda m, x: m.resplit(x, 1)),
    "fused tail": ("transport.resplit", (64, 400), 0, lambda m, x: m.resplit(x * 2.0 + 1.0, 1)),
}


def _backoff(ht, monkeypatch, case, arm, tile):
    """The case's value and transport counters in both packages, each with
    ``TILE_BYTES`` at ``tile`` and the injector ``arm(FaultInjector)``."""
    from heat_tpu.parallel import transport as JT
    from heat_tpu.utils import fault as JF

    site, shape, split, op = CASES[case]
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(PT, "TILE_BYTES", tile)
    monkeypatch.setattr(JT, "TILE_BYTES", tile)
    out = {}
    for name, mod, F, T, arr in (
        ("torch", htt, PF, PT, htt.array(x, split=split, comm=htt.MeshComm(4), device="cpu")),
        ("jax", ht, JF, JT, ht.array(x, split=split, comm=ht.parallel.mesh.local_mesh(4))),
    ):
        T.reset_stats()
        inj = arm(F.FaultInjector)
        with F.injected(inj):
            try:
                val = op(mod, arr).numpy()
            except F.InjectedOOM as e:
                val = e
        st = T.stats()
        out[name] = (val, inj.fired, {k: st[k] for k in ("oom_retries", "oom_exhausted", "last_tile_bytes",
                                                         "retries_by_kind", "informed_retries",
                                                         "last_retry_informed")})
    return site, x, op, out


@pytest.mark.parametrize("case", list(CASES))
def test_oom_backoff_halves_as_heat_tpu_does(ht, monkeypatch, case):
    site = CASES[case][0]
    _, x, op, out = _backoff(ht, monkeypatch, case, lambda F: F().oom_in(site, times=2), 1 << 20)
    (vt, ft, st), (vj, fj, sj) = out["torch"], out["jax"]
    assert ft == fj == [("oom", site)] * 2
    assert st == sj
    assert st["oom_retries"] == 2 and st["last_tile_bytes"] == (1 << 20) // 4 and st["informed_retries"] == 0
    assert st["retries_by_kind"] == {site.split(".")[1]: 2}
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(vt, op(np, x) if case == "reshape" else vj)


def test_oom_backoff_first_retry_sized_from_free_memory(ht, monkeypatch):
    # low_hbm: 1 MiB free; the first retry claims a quarter of it, under
    # the halving (512 KiB)
    _, _, _, out = _backoff(ht, monkeypatch, "reshape",
                            lambda F: F().oom_in("transport.reshape", times=1).low_hbm(1 << 20), 1 << 20)
    (vt, _, st), (vj, _, sj) = out["torch"], out["jax"]
    assert st == sj and st["informed_retries"] == 1 and st["last_retry_informed"] is True
    assert st["last_tile_bytes"] == (1 << 20) // 4
    np.testing.assert_array_equal(vt, vj)


def test_oom_backoff_reraises_at_the_floor(ht, monkeypatch):
    floor = PT.TILE_FLOOR_BYTES
    _, _, _, out = _backoff(ht, monkeypatch, "resplit",
                            lambda F: F().oom_in("transport.resplit", times=3), 2 * floor)
    (vt, ft, st), (vj, fj, sj) = out["torch"], out["jax"]
    assert isinstance(vt, PF.InjectedOOM) and type(vj).__name__ == "InjectedOOM"
    assert st == sj and st["oom_exhausted"] == 1 and st["oom_retries"] == 1 and len(ft) == len(fj) == 2


def test_other_errors_pass_the_backoff_untouched():
    PT.reset_stats()
    a = htt.array(np.ones((8, 4), np.float32), split=0, comm=htt.MeshComm(4), device="cpu")
    with PF.injected(PF.FaultInjector().error_in("transport.resplit")):
        with pytest.raises(PF.FaultInjector.InjectedFault):
            htt.resplit(a, 1)
    assert PT.stats()["oom_retries"] == 0
