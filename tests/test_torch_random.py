"""heat_tpu_torch's random numbers on the CPU: properties.

The values against heat_tpu's Threefry streams are
tests/test_torch_threefry.py's.  What is checked here: permutations are
permutations, the same at every mesh size of one route for one seed (a
split-0 permutation over several positions takes the Feistel route, one
position the sort rounds, as in heat_tpu); ``shuffle_rows`` keeps rows
paired; integers stay in their bounds for every dtype (uint8's
``high=256`` too); normal draws have the moments asked for, with DNDarray
means and deviations; the state round-trips through
``get_state``/``set_state`` in heat_tpu's tuple layout, heat_tpu's own
state included.  Names and signatures are heat_tpu's.
"""

import inspect

import numpy as np
import pytest

import heat_tpu_torch as htt

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _comm(n):
    return htt.MeshComm(n)


def test_names_and_signatures(ht):
    names = set(ht.random.__all__)
    assert names <= set(htt.random.__all__)
    for name in names:
        want = list(inspect.signature(getattr(ht.random, name)).parameters)
        assert list(inspect.signature(getattr(htt.random, name)).parameters) == want, name
    for alias in ("random", "random_sample", "ranf", "sample"):
        assert getattr(htt.random, alias) is htt.random.rand
    assert htt.random.standard_normal is htt.random.randn
    assert htt.random.random_integer is htt.random.randint


@pytest.mark.parametrize("split", [None, 0])
def test_randperm_is_a_permutation_at_every_mesh(split):
    got = []
    for n in MESHES:
        htt.random.seed(11)
        p = htt.random.randperm(1001, split=split, comm=_comm(n), device="cpu")
        assert p.dtype is htt.int32 and p.split == split and p.shape == (1001,)
        assert [s.shape[0] for s in p.lshards()] == ([1001] if split is None else [int(m[0]) for m in p.lshape_map])
        v = p.numpy()
        assert np.array_equal(np.sort(v), np.arange(1001))
        got.append(v)
    # one position draws by sort rounds, several along split 0 by Feistel keys
    assert all(np.array_equal(got[0 if split is None else 1], g) for g in got[1:])
    assert not np.array_equal(got[0], np.arange(1001))
    htt.random.seed(11)
    assert htt.random.randperm(5, dtype=htt.int64, device="cpu").dtype is htt.int64
    assert htt.random.randperm(0, device="cpu").shape == (0,)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_permutation_of_rows_at_every_mesh(split):
    x = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
    got = []
    for n in MESHES:
        htt.random.seed(5)
        p = htt.random.permutation(htt.array(x, split=split, comm=_comm(n), device="cpu"))
        assert p.split == split and p.shape == x.shape and p.dtype is htt.float32
        v = p.numpy()
        order = np.argsort(v[:, 0])
        np.testing.assert_array_equal(v[order], x)
        got.append(v)
    assert all(np.array_equal(got[0 if split != 0 else 1], g) for g in got[1:])
    htt.random.seed(5)
    q = htt.random.permutation(12, split=0, comm=_comm(4), device="cpu")
    assert sorted(q.numpy().tolist()) == list(range(12))
    htt.random.seed(5)
    r = htt.random.permutation([4, 5, 6, 7], device="cpu")
    assert sorted(r.numpy().tolist()) == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        htt.random.permutation(htt.array(np.float32(1.0), device="cpu"))


def test_shuffle_rows_keeps_rows_paired():
    x = np.arange(50 * 4, dtype=np.float32).reshape(50, 4)
    labels = np.arange(50) % 7
    got = []
    for n in MESHES:
        htt.random.seed(3)
        comm = _comm(n)
        xs, ls = htt.random.shuffle_rows([htt.array(x, split=0, comm=comm, device="cpu"),
                                          htt.array(labels, split=0, comm=comm, device="cpu")])
        assert xs.split == ls.split == 0 and xs.shape == x.shape and ls.shape == (50,)
        v, lab = xs.numpy(), ls.numpy()
        rows = (v[:, 0] // 4).astype(np.int64)
        np.testing.assert_array_equal(v, x[rows])
        np.testing.assert_array_equal(lab, labels[rows])
        assert np.array_equal(np.sort(rows), np.arange(50))
        got.append(v)
    assert all(np.array_equal(got[1], g) for g in got[2:])
    assert htt.random.shuffle_rows([]) == []
    comm = _comm(4)
    with pytest.raises(ValueError):
        htt.random.shuffle_rows([htt.array(x, split=1, comm=comm, device="cpu")])
    with pytest.raises(ValueError):
        htt.random.shuffle_rows([htt.array(x, split=0, comm=comm, device="cpu"),
                                 htt.array(labels[:49], split=0, comm=comm, device="cpu")])


@pytest.mark.parametrize("dtype, low, high", [("uint8", 0, 256), ("uint8", 250, 256), ("int8", -128, 128),
                                              ("int16", -5, 6), ("int32", -(2**31), 2**31 - 1),
                                              ("int64", -(2**40), 2**40), ("int32", 0, 1)])
def test_randint_in_bounds(dtype, low, high):
    got = []
    for n in MESHES:
        htt.random.seed(9)
        a = htt.random.randint(low, high, (400, 3), dtype=getattr(htt, dtype), split=0, comm=_comm(n), device="cpu")
        assert a.dtype.__name__ == dtype and a.shape == (400, 3) and a.split == 0
        v = a.numpy().astype(np.int64)
        assert v.min() >= low and v.max() < high
        got.append(v)
    assert all(np.array_equal(got[0], g) for g in got[1:])
    if high - low > 2:
        assert len(np.unique(got[0])) > 2


def test_randint_defaults():
    htt.random.seed(1)
    a = htt.random.randint(7, size=1000, device="cpu")
    assert a.dtype is htt.int32 and a.shape == (1000,)
    assert set(np.unique(a.numpy()).tolist()) == set(range(7))
    s = htt.random.random_integer(3, 4, device="cpu")
    assert s.shape == () and int(s) == 3


def test_normal_moments_with_dndarray_mean_and_std():
    comm = _comm(4)
    htt.random.seed(2)
    a = htt.random.normal(3.0, 0.5, (200_000,), split=0, comm=comm, device="cpu")
    v = a.numpy()
    assert a.dtype is htt.float32 and a.split == 0
    assert abs(v.mean() - 3.0) < 0.01 and abs(v.std() - 0.5) < 0.01
    mean = htt.array(np.array([-100.0, 0.0, 100.0, 5.0], np.float32), comm=comm, device="cpu")
    std = htt.array(np.array([1.0, 2.0, 0.0, 10.0], np.float32), comm=comm, device="cpu")
    b = htt.random.normal(mean, std, (50_000, 4), split=0, comm=comm, device="cpu").numpy()
    np.testing.assert_allclose(b.mean(0), [-100, 0, 100, 5], atol=0.2)
    np.testing.assert_allclose(b.std(0), [1, 2, 0, 10], rtol=0.02, atol=1e-6)
    # a split mean of the result's shape is used shard by shard
    m2 = htt.array(np.repeat(np.arange(8, dtype=np.float32)[:, None] * 10, 1000, 1).T.copy(), split=0, comm=comm,
                   device="cpu")
    c = htt.random.normal(m2, 0.1, (1000, 8), split=0, comm=comm, device="cpu").numpy()
    np.testing.assert_allclose(c.mean(0), np.arange(8) * 10, atol=0.02)
    d = htt.random.normal(0.0, 1.0, (10, 3), dtype=htt.float64, split=1, comm=comm, device="cpu")
    assert d.dtype is htt.float64 and d.split == 1
    htt.random.seed(8)
    z = htt.random.standard_normal(100_000, device="cpu").numpy()
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1) < 0.02
    u = htt.random.random((100_000,), device="cpu").numpy()
    assert u.min() >= 0 and u.max() < 1 and abs(u.mean() - 0.5) < 0.01


def test_state_round_trip_and_rejections(ht):
    htt.random.seed(1234)
    htt.random.rand(3, device="cpu")
    state = htt.random.get_state()
    assert state == ("Threefry", 1234, 1, 0, 0.0)
    assert len(state) == len(ht.random.get_state())
    first = htt.random.randn(5, device="cpu").numpy()
    htt.random.rand(7, device="cpu")
    htt.random.set_state(state)
    np.testing.assert_array_equal(htt.random.randn(5, device="cpu").numpy(), first)
    htt.random.set_state(state[:3])
    np.testing.assert_array_equal(htt.random.randn(5, device="cpu").numpy(), first)
    # heat_tpu's own state is read: the next draw is heat_tpu's next draw
    ht.random.seed(77)
    ht.random.rand(2)
    htt.random.set_state(ht.random.get_state())
    assert htt.random.get_state() == ht.random.get_state()
    np.testing.assert_array_equal(htt.random.rand(6, device="cpu").numpy(), np.asarray(ht.random.rand(6).numpy()))
    with pytest.raises(ValueError, match="Philox"):
        htt.random.set_state(("Philox", 1, 0, 0, 0.0))
    with pytest.raises(ValueError):
        htt.random.set_state(["Threefry", 1, 0])
    with pytest.raises(ValueError):
        htt.random.set_state(("Threefry", 1))
    htt.random.set_state(state[:3])
    assert htt.random.get_state() == state
