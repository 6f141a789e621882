"""``heat_tpu_torch.core.guard`` (``ht.guard``) against heat_tpu's on the
CPU: the modes and their environment parsing, the scoped forms, the
caller attribution, the error and warning types, and the fault-injection
hooks as the transport engine calls them (the same sites, in the same
order, for the same resplit at meshes 1, 4 and 8), and the fusion
engine's consumer of the mode: the NaN/Inf check of a materialized chain
and the op-by-op replay that names the first op, its user line and its
subtree, the same as heat_tpu's for the same chains.  The mirror is
``tests/test_guard.py``.
"""

import inspect
import warnings

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch.core import guard as PG

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def JG(ht):
    from heat_tpu.core import guard

    return guard


@pytest.mark.parametrize("raw", ["off", "0", "false", "no", "", "warn", "on", "default", "1", "true", "raise",
                                 "strict", "ERROR"])
def test_env_modes_parse_alike(JG, monkeypatch, raw):
    monkeypatch.setenv("HEAT_TPU_GUARD", raw)
    assert PG._env_mode() == JG._env_mode()


def test_modes_and_scopes_match(JG):
    assert PG.mode() == "warn" and PG.__all__ == JG.__all__
    for G in (PG, JG):
        rows = []
        for m in ("off", "warn", "raise", True, False):
            with G.guarded(m):
                rows.append((G.mode(), G.enabled(), G.strict()))
        assert rows == [("off", False, False), ("warn", True, False), ("raise", True, True), ("raise", True, True),
                        ("off", False, False)]
        assert G.mode() == "warn"
        prev = G.set_enabled(True)
        assert (prev, G.set_mode("warn")) == ("warn", "raise")
        with pytest.raises(ValueError):
            G.set_mode("loud")


def test_capture_site_names_the_caller(JG):
    line = inspect.currentframe().f_lineno + 1
    got, want = PG.capture_site(1), JG.capture_site(1)
    assert got == want == (__file__, line, "test_capture_site_names_the_caller")
    assert PG.format_site(got) == JG.format_site(want) == f"{__file__}:{line} in test_capture_site_names_the_caller"
    assert PG.format_site(None) == "<heat_tpu_torch internal>"


def test_error_and_warning_types():
    assert issubclass(PG.NonFiniteWarning, RuntimeWarning) and PG.NonFiniteWarning.event_id is None
    err = PG.NonFiniteError("boom", op="div", site=("f.py", 3, "g"), subtree="x / y")
    assert isinstance(err, FloatingPointError) and (err.op, err.site, err.subtree, err.event_id) == (
        "div", ("f.py", 3, "g"), "x / y", None)
    with pytest.warns(PG.NonFiniteWarning):
        warnings.warn("nan", PG.NonFiniteWarning)


class _Recorder:
    """An injector that records the sites it is offered and corrupts
    nothing."""

    def __init__(self):
        self.sites = []

    def fire_site(self, site):
        self.sites.append(("fire", site))

    def corrupt_site(self, site, value):
        self.sites.append(("corrupt", site))
        return value


class _Failing(_Recorder):
    def fire_site(self, site):
        raise MemoryError(f"injected at {site}")


@pytest.mark.parametrize("n", MESHES)
def test_transport_calls_the_hooks_as_heat_tpu_does(ht, JG, n):
    x = np.arange(96, dtype=np.float32).reshape(12, 8)
    seen = []
    for G, make in ((PG, lambda: htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu")),
                    (JG, lambda: ht.array(x, split=0, comm=ht.parallel.mesh.local_mesh(n)))):
        a = make()
        rec = _Recorder()
        G._INJECTOR = rec
        try:
            a.resplit_(1)
        finally:
            G._INJECTOR = None
        np.testing.assert_array_equal(a.numpy(), x)
        seen.append(rec.sites)
    assert seen[0] == seen[1]
    assert seen[0] == ([] if n == 1 else [("fire", "transport.resplit"), ("corrupt", "transport.resplit")])


def test_an_injected_fault_reaches_the_caller():
    a = htt.array(np.ones((8, 4), np.float32), split=0, comm=htt.MeshComm(4), device="cpu")
    PG._INJECTOR = _Failing()
    try:
        with pytest.raises(MemoryError, match="transport.resplit"):
            a.resplit_(1)
    finally:
        PG._INJECTOR = None
    assert a.split == 0
    PG.fire("anything")  # no injector: a no-op
    assert PG.corrupt("anything", 5) == 5
    assert htt.guard is PG


# ------------------------------------------------ the fusion engine's check
def _both(ht):
    from heat_tpu.core import fusion as JF

    return ((ht, JF, {}), (htt, htt.fusion, {"device": "cpu"}))


# one line builds every package's chain: the sites must name this line
_BAD = lambda H, x: (x - x) / (x - x)  # noqa: E731


@pytest.mark.parametrize("n", MESHES)
def test_introduced_nan_names_the_same_op_line_and_subtree(ht, n):
    got = []
    for H, F, dev in _both(ht):
        comm = ht.parallel.mesh.local_mesh(n) if H is ht else htt.MeshComm(n)
        F.reset_cache()
        with H.guard.guarded(True):
            x = H.arange(8 * n, dtype=H.float32, split=0, comm=comm, **dev)
            bad = _BAD(H, x)
            with pytest.raises(H.guard.NonFiniteError) as ctx:
                bad.numpy()
        err = ctx.value
        got.append((err.op, err.site, "first non-finite" in err.subtree, err.subtree.count("div("),
                    F.cache_stats()["fallback_reasons"]["guard_replay"]))
    assert got[0] == got[1]
    assert got[1][0] == "div" and got[1][1][0] == __file__ and got[1][4] == 1


def test_inf_warn_mode_propagation_and_guard_off_match(ht):
    rows = []
    for H, F, dev in _both(ht):
        row = []
        x = H.arange(8, dtype=H.float32, split=0, **dev)
        with H.guard.guarded(True), pytest.raises(H.guard.NonFiniteError) as ctx:
            ((x + 1.0) / (x - x)).numpy()
        row.append(ctx.value.op)
        with H.guard.guarded("warn"), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = np.asarray(_BAD(H, x).numpy())
        msgs = [str(w.message) for w in caught if issubclass(w.category, H.guard.NonFiniteWarning)]
        row += [bool(np.isnan(out).all()), len(msgs), "'div'" in msgs[0]]
        src = np.array([1.0, np.nan, np.inf, 3.0], dtype=np.float32)
        with H.guard.guarded(True):
            row.append(np.asarray((H.array(src, split=0, **dev) * 2.0 + 1.0).numpy()).tolist()[1:3])
        F.reset_cache()
        with H.guard.guarded(False):
            row.append(bool(np.isnan(np.asarray(_BAD(H, x).numpy())).all()))
        row.append(F.cache_stats()["fallback_reasons"]["guard_replay"])
        rows.append(row)
    assert str(rows[0]) == str(rows[1])


def test_shared_node_blamed_once_with_both_consumers(ht):
    rows = []
    for H, F, dev in _both(ht):
        F.reset_cache()
        x = H.arange(24, dtype=H.float32, split=0, **dev)
        bad = _BAD(H, x)
        with H.guard.guarded(True), pytest.raises(H.guard.NonFiniteError) as ctx:
            H.materialize(bad + 1.0, bad * 2.0)
        err = ctx.value
        rows.append((err.op, err.subtree.count("div("), "2-output program" in str(err), "root index 0, 1" in str(err),
                     F.cache_stats()["fallback_reasons"]["guard_replay"]))
    assert rows[0] == rows[1] == ("div", 1, True, True, 1)


class _NaNAt(_Recorder):
    """Corrupts the first value offered at ``fusion.exec`` with NaN."""

    def __init__(self, make_nan):
        super().__init__()
        self._nan = make_nan
        self.fired = []

    def corrupt_site(self, site, value):
        self.sites.append(("corrupt", site))
        if site == "fusion.exec" and not self.fired:
            self.fired.append(site)
            return (self._nan(value[0]),) + tuple(value[1:])
        return value


def test_injected_corruption_raises_unattributed_and_guard_adds_no_misses(ht):
    import jax.numpy as jnp

    rows = []
    for (H, F, dev), nan in zip(_both(ht), (lambda v: jnp.full_like(v, jnp.nan),
                                            lambda v: v * float("nan"))):
        G = H.guard
        x = H.arange(8, dtype=H.float32, split=0, **dev)
        inj = _NaNAt(nan)
        G._INJECTOR = inj
        try:
            with G.guarded(True), pytest.raises(G.NonFiniteError) as ctx:
                (x + 1.0).numpy()
        finally:
            G._INJECTOR = None
        F.reset_cache()
        with G.guarded(True):
            ((x + 1.0) * 2.0).numpy()
            mid = F.cache_stats()
            ((H.arange(8, dtype=H.float32, split=0, **dev) + 1.0) * 2.0).numpy()  # another line, one program
            end = F.cache_stats()
        rows.append((ctx.value.op, inj.fired, end["misses"] - mid["misses"], end["hits"] - mid["hits"]))
    assert rows[0] == rows[1] == (None, ["fusion.exec"], 0, 1)


def test_warn_mode_on_the_card_reads_its_flag_later(monkeypatch):
    """In ``warn`` mode on the card the check's flag goes to the host
    without waiting: it is read at the next materialization or host read,
    and the warning names the op and the user line all the same.  Emulated
    here by deferring on the CPU as on the card."""
    from heat_tpu_torch.core import fusion as PF

    monkeypatch.setattr(PF, "_DEFER_ON", ("cpu",))
    x = htt.array(np.array([0.0, 1.0, 2.0], np.float32), split=0, comm=htt.MeshComm(2), device="cpu")
    with PG.guarded("warn"), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (x / x).larray
        assert caught == [] and len(PF._DEFERRED) == 1
        (x + 1.0).larray  # the next materialization reads the flag
        got = [w for w in caught if issubclass(w.category, PG.NonFiniteWarning)]
        assert len(got) == 1 and "'div'" in str(got[0].message) and got[0].filename == __file__
        assert len(PF._DEFERRED) == 1  # the second chain's own check
        x.numpy()
        assert not PF._DEFERRED
        (x / x).larray
        x.numpy()  # a host read reads it too
        assert len([w for w in caught if issubclass(w.category, PG.NonFiniteWarning)]) == 2
        assert not PF._DEFERRED
        (x * 2.0).larray  # a finite chain leaves nothing behind
        x.numpy()
        assert len(caught) == 2 and not PF._DEFERRED
    with PG.guarded("raise"):
        with pytest.raises(PG.NonFiniteError):
            (x / x).larray  # raise mode reads at once
    assert not PF._DEFERRED


def test_finite_extremes_pass_and_a_complex_nan_is_named():
    """Values at the edge of f64's range are finite and pass the check;
    a NaN made in a complex output is caught and named."""
    big = htt.array(np.array([1e308, 1e308, 1.0]), split=0, comm=htt.MeshComm(2), device="cpu")
    z = htt.array(np.array([1 + 1j, 0j, 2 - 1j], np.complex64), split=0, comm=htt.MeshComm(2), device="cpu")
    with PG.guarded("raise"):
        np.testing.assert_array_equal((big * 1.0).numpy(), np.array([1e308, 1e308, 1.0]))
        with pytest.raises(PG.NonFiniteError) as err:
            (z / z).larray  # 0/0 at the middle element
    assert err.value.op == "div"
