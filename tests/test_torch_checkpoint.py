"""``heat_tpu_torch.utils.checkpointing`` on the CPU: round trips of trees
of DNDarrays (every split, bf16 and integer types), tensors, numpy arrays
and python scalars; the JSON sidecar against heat_tpu's for the same tree;
``Checkpointer``'s retention and ``latest_step``; and a training run
resumed from a checkpoint, which must take the same steps as one that
never stopped (bitwise on the CPU)."""

import json
import os

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _tree(comm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(13, 4)).astype(np.float32)
    return {
        "x0": htt.array(x, split=0, comm=comm, device="cpu"),
        "x1": htt.array(x, split=1, comm=comm, device="cpu"),
        "xr": htt.array(x, comm=comm, device="cpu"),
        "b16": htt.array(x, dtype=htt.bfloat16, split=0, comm=comm, device="cpu"),
        "i": htt.array(np.arange(7, dtype=np.int64), split=0, comm=comm, device="cpu"),
        "t": torch.arange(6, dtype=torch.float64).reshape(2, 3),
        "t16": torch.ones(3, dtype=torch.bfloat16) / 3,
        "np": np.arange(5, dtype=np.int16),
        "nested": [1, 2.5, "s", None, True, (torch.zeros(2), {3: torch.ones(1)})],
    }


@pytest.mark.parametrize("n", [1, 4, 8])
def test_round_trip(tmp_path, n):
    comm = htt.MeshComm(n)
    tree = _tree(comm)
    htt.utils.save_checkpoint(str(tmp_path / "ck"), tree)
    back = htt.utils.load_checkpoint(str(tmp_path / "ck"), comm=comm, device="cpu")
    assert set(back) == set(tree)
    for k in ("x0", "x1", "xr", "b16", "i"):
        a, b = tree[k], back[k]
        assert isinstance(b, htt.DNDarray) and b.split == a.split and b.dtype is a.dtype and b.shape == a.shape
        assert b.comm.size == n and [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]
        assert torch.equal(b.larray, a.larray)
    assert torch.equal(back["t"], tree["t"]) and back["t"].dtype == torch.float64
    assert torch.equal(back["t16"], tree["t16"]) and back["t16"].dtype == torch.bfloat16
    assert isinstance(back["np"], np.ndarray) and np.array_equal(back["np"], tree["np"])
    assert back["nested"][:5] == [1, 2.5, "s", None, True]
    assert isinstance(back["nested"][5], tuple) and torch.equal(back["nested"][5][1][3], torch.ones(1))
    # saving again replaces the directory
    htt.utils.save_checkpoint(str(tmp_path / "ck"), {"only": 1})
    assert htt.utils.load_checkpoint(str(tmp_path / "ck"), device="cpu") == {"only": 1}
    with pytest.raises(TypeError):
        htt.utils.save_checkpoint(str(tmp_path / "bad"), {"f": object()})


def test_sidecar_matches_heat_tpus(ht, tmp_path):
    from heat_tpu.utils import checkpointing as jck

    rng = np.random.default_rng(1)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    jc = ht.parallel.mesh.local_mesh(4)
    jtree = {"a": ht.array(x, split=0, comm=jc), "b": [ht.array(x, split=1, comm=jc), 3],
             "c": {"d": ht.array(x[:, 0].astype(np.int32), comm=jc)}}
    _, want = jck._split_tree(jtree)
    comm = htt.MeshComm(4)
    ttree = {"a": htt.array(x, split=0, comm=comm, device="cpu"), "b": [htt.array(x, split=1, comm=comm, device="cpu"), 3],
             "c": {"d": htt.array(x[:, 0].astype(np.int32), comm=comm, device="cpu")}}
    htt.utils.save_checkpoint(str(tmp_path / "ck"), ttree)
    with open(tmp_path / "ck" / "heat_meta.json") as f:
        assert json.load(f) == want


def test_checkpointer_retention_and_target(tmp_path):
    ck = htt.utils.Checkpointer(str(tmp_path / "run"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore_latest(device="cpu") is None
    for step in (1, 5, 12):
        path = ck.save(step, {"step": step, "w": torch.full((2,), float(step))})
        assert os.path.isdir(path)
    assert ck.all_steps() == [5, 12] and ck.latest_step() == 12
    got = ck.restore_latest(device="cpu")
    assert got["step"] == 12 and torch.equal(got["w"], torch.full((2,), 12.0))
    assert ck.restore(5, device="cpu")["step"] == 5
    os.makedirs(tmp_path / "run" / "step_junk")
    assert ck.all_steps() == [5, 12]
    # a target tree's DNDarrays give their comm
    comm = htt.MeshComm(4)
    ck.save(13, {"a": htt.array(np.arange(8.0), split=0, comm=comm, device="cpu")})
    back = ck.restore(13, target={"a": htt.zeros(8, split=0, comm=comm, device="cpu")}, device="cpu")
    assert back["a"].comm is comm and back["a"].split == 0


def test_resumed_training_takes_the_same_steps(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.integers(0, 3, 16)

    def fresh():
        model = htt.models.MLP((8, 3), in_features=6, device="cpu", generator=torch.Generator().manual_seed(0))
        return htt.nn.DataParallel(model, optimizer=htt.optim.DataParallelOptimizer(htt.optim.adam(0.05))).init(0, x)

    straight = fresh()
    losses = [float(straight.train_step(x, y)) for _ in range(4)]
    first = fresh()
    for _ in range(2):
        first.train_step(x, y)
    ck = htt.utils.Checkpointer(str(tmp_path / "run"))
    ck.save(2, {"model": first.module.state_dict(), "opt": first.optimizer.torch_optimizer.state_dict()})
    state = ck.restore_latest(device="cpu")
    resumed = fresh()
    resumed.module.load_state_dict(state["model"])
    resumed.optimizer.torch_optimizer.load_state_dict(state["opt"])
    assert resumed.optimizer.torch_optimizer.count == 2
    assert [float(resumed.train_step(x, y)) for _ in range(2)] == losses[2:]
    for a, b in zip(resumed.module.parameters(), straight.module.parameters()):
        assert torch.equal(a, b)
