"""``heat_tpu_torch.utils.monitor`` and ``utils.bench`` against heat_tpu's
on the CPU: the ``@monitor()`` rows (success and failure), ``record``,
``annotate_last``, ``report`` and ``chain_slope`` under one scripted clock
in both packages (``time.perf_counter`` monkeypatched), and the port's
``profile_trace`` writing a Chrome trace of the block.  The mirror is
``tests/test_monitor.py``.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from heat_tpu_torch.utils import bench as TB
from heat_tpu_torch.utils import monitor as TM


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


class _Clock:
    """A scripted ``time.perf_counter``: each call reads ``now``, which the
    timed work advances."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _drive_monitor(M, clock):
    M.reset()

    @M.monitor(name="work", emit=False)
    def work(s):
        clock.now += s
        return np.float32(s)

    @M.monitor(emit=False)
    def broken():
        clock.now += 0.25
        raise KeyError("gone")

    work(0.5)
    work(1.25)
    with pytest.raises(KeyError):
        broken()
    M.record("slope", 0.0123456789, emit=False, method="chain-delta", k1=1, k2=9)
    M.annotate_last(iters=7)
    buf = io.StringIO()
    M.report(buf)
    rows = M.measurements()
    M.reset()
    assert M.measurements() == []
    return rows, buf.getvalue()


def test_monitor_rows_match(ht, monkeypatch):
    import time

    from heat_tpu.utils import monitor as JM

    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    got = _drive_monitor(TM, clock)
    assert got == _drive_monitor(JM, clock)
    rows, text = got
    assert rows[:3] == [{"name": "work", "wall_s": 0.5}, {"name": "work", "wall_s": 1.25},
                        {"name": "broken", "wall_s": 0.25, "status": "error", "error": "KeyError"}]
    assert rows[3] == {"name": "slope", "wall_s": 0.012346, "method": "chain-delta", "k1": 1, "k2": 9, "iters": 7}
    assert [json.loads(line) for line in text.splitlines()] == rows
    with pytest.raises(RuntimeError, match="no measurement"):
        TM.annotate_last(x=1)


@pytest.mark.parametrize("unit, fixed, max_k", [(0.01, 0.3, 1025), (0.2, 0.05, 1025), (1e-6, 0.0, 64)])
def test_chain_slope_matches(ht, monkeypatch, unit, fixed, max_k):
    import time

    from heat_tpu.utils import bench as JB

    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)

    def run_k(k):
        clock.now += fixed + k * unit

    got = TB.chain_slope(run_k, max_k=max_k)
    want = JB.chain_slope(run_k, max_k=max_k)
    assert tuple(got) == tuple(want) and got.fields() == want.fields()
    assert got.per_unit_s == pytest.approx(unit, rel=1e-9)
    assert got.capped == (max_k == 64)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with TM.profile_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(out)
    assert name.startswith("heat_tpu_torch.") and name.endswith(".trace.json")
    events = json.loads((out / name).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
