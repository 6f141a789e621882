"""``heat_tpu_torch.core.guard`` (``ht.guard``) against heat_tpu's on the
CPU: the modes and their environment parsing, the scoped forms, the
caller attribution, the error and warning types, and the fault-injection
hooks as the transport engine calls them (the same sites, in the same
order, for the same resplit at meshes 1, 4 and 8).  The mirror is
``tests/test_guard.py``; heat_tpu's consumer of the mode, the fusion
engine's NaN check and replay, waits for the port of ``core/fusion.py``.
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
