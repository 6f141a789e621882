"""KNeighborsClassifier: heat_tpu_torch against heat_tpu on the CPU at meshes
1, 4 and 8 in every layout of queries and training set, and ``predict``
through K1 against its plain version on the card.

Labels must be equal exactly.  The random data is checked first to give
every query a clear gap between its k-th and (k+1)-th nearest distance, so
rounding cannot reorder the neighbours; the tie cases are built from
duplicate training rows and equal votes, where both packages keep the lower
training index and the lower class.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.classification import kneighborsclassifier as knn_mod
from heat_tpu_torch.ops import cdist as k1
from heat_tpu_torch.parallel import sort as sort_mod


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


MESHES = (1, 4, 8)
LAYOUTS = [(0, 0), (None, 0), (None, None), (0, None)]
K = 3
# topk_select sorts a small block whole and selects from a large one (the
# batch predict's 4096-row blocks); "select" takes that route at any size
ROUTES = ("sort", "select")


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "select":
        monkeypatch.setattr(sort_mod, "_SORT_ELEMENTS", 0)
    return request.param


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = (rng.integers(0, 3, size=40) * 2 + 1).astype(np.int32)
    q = rng.normal(size=(13, 3)).astype(np.float32)
    d = np.sort(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1), axis=1)
    assert (d[:, K] - d[:, K - 1] > 1e-4).all()
    return x, y, q


@pytest.fixture(scope="module")
def data():
    return _data()


def _fit_both(ht, n, x, y, split, k=K):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    jm = ht.classification.KNeighborsClassifier(k).fit(ht.array(x, split=split, comm=jc), ht.array(y, split=split, comm=jc))
    tm = htt.classification.KNeighborsClassifier(k).fit(htt.array(x, split=split, comm=tc, device="cpu"),
                                                        htt.array(y, split=split, comm=tc, device="cpu"))
    return jm, tm, jc, tc


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("sq, sx", LAYOUTS)
def test_predict_in_every_layout(ht, data, n, sq, sx, route):
    x, y, q = data
    jm, tm, jc, tc = _fit_both(ht, n, x, y, sx)
    np.testing.assert_array_equal(tm.classes_.numpy(), jm.classes_.numpy())
    a = jm.predict(ht.array(q, split=sq, comm=jc))
    b = tm.predict(htt.array(q, split=sq, comm=tc, device="cpu"))
    assert b.shape == a.shape and b.split == a.split and b.dtype.__name__ == a.dtype.__name__
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()] or a.split is None
    assert tm.score(htt.array(q, split=sq, comm=tc, device="cpu"), b) == 1.0


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("n", MESHES)
def test_ties_keep_the_lower_index_and_class(ht, n, route):
    # rows 1 and 5 are one point with other labels (classes 1 and 2); a
    # query near it ties them exactly at the cut between the 1st and 2nd
    # neighbour, and takes the lower index first.  [2.5, 2.5] ties rows 0,
    # 1 and 5 after row 7: at the cut between the 2nd and 3rd neighbour
    # for k = 2, inside the selection for k = 4
    x = np.array([[0, 0], [5, 5], [9, 0], [0, 9], [-7, 3], [5, 5], [2, -8], [3, 3]], np.float32)
    y = np.array([0, 1, 2, 1, 0, 2, 1, 0], np.int32)
    q = np.array([[5, 5], [5.2, 5.1], [0, 0.2], [1.5, 1.5], [2.5, 2.5]], np.float32)
    for sq, sx in LAYOUTS[:3]:
        for k in (1, 2, 4):
            jm, tm, jc, tc = _fit_both(ht, n, x, y, sx, k=k)
            a = jm.predict(ht.array(q, split=sq, comm=jc)).numpy()
            b = tm.predict(htt.array(q, split=sq, comm=tc, device="cpu")).numpy()
            np.testing.assert_array_equal(b, a)
    # k = 1 at the duplicate point: the lower index, class 1; k = 2 next
    # to it: one vote each for classes 1 and 2, the lower class
    for k in (1, 2):
        jm, tm, jc, tc = _fit_both(ht, n, x, y, 0, k=k)
        assert int(tm.predict(htt.array(q[k - 1 : k], comm=tc, device="cpu")).numpy()[0]) == 1


@pytest.mark.parametrize("n", MESHES)
def test_one_hot_labels_and_encoding(ht, data, n):
    x, y, q = data
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    labels = (y // 2).astype(np.int32)
    ja = ht.classification.KNeighborsClassifier.one_hot_encoding(ht.array(labels, split=0, comm=jc))
    ta = htt.classification.KNeighborsClassifier.one_hot_encoding(htt.array(labels, split=0, comm=tc, device="cpu"))
    assert ta.split == ja.split and ta.dtype is htt.float32
    np.testing.assert_array_equal(ta.numpy(), ja.numpy())
    onehot = ja.numpy()
    jm = ht.classification.KNeighborsClassifier(K).fit(ht.array(x, split=0, comm=jc), ht.array(onehot, split=0, comm=jc))
    tm = htt.classification.KNeighborsClassifier(K).fit(htt.array(x, split=0, comm=tc, device="cpu"),
                                                        htt.array(onehot, split=0, comm=tc, device="cpu"))
    assert tm.classes_ is None
    for sq in (0, None):
        a = jm.predict(ht.array(q, split=sq, comm=jc))
        b = tm.predict(htt.array(q, split=sq, comm=tc, device="cpu"))
        assert b.dtype.__name__ == a.dtype.__name__
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_metric_calls_and_unported_parts(data, monkeypatch):
    """The default metric is ``spatial.cdist``: a split-0 batch calls K1's
    wrapper once per position with rows, a replicated request once per
    position of the split training set.  A custom metric is used as given."""
    x, y, q = data
    calls = []
    real = k1.cdist
    monkeypatch.setattr(k1, "cdist", lambda a, b, sqrt=True: calls.append(a.shape) or real(a, b, sqrt=sqrt))
    mesh = htt.MeshComm(4)
    m = htt.classification.KNeighborsClassifier(K).fit(htt.array(x, split=0, comm=mesh, device="cpu"),
                                                       htt.array(y, split=0, comm=mesh, device="cpu"))
    m.predict(htt.array(q, split=0, comm=mesh, device="cpu"))
    assert calls == [(4, 3), (4, 3), (4, 3), (1, 3)]
    calls.clear()
    m.predict(htt.array(q[:2], comm=mesh, device="cpu"))
    assert calls == [(2, 3)] * 4
    l1 = htt.classification.KNeighborsClassifier(K, effective_metric_=htt.spatial.manhattan)
    l1.fit(htt.array(x, split=0, comm=mesh, device="cpu"), htt.array(y, split=0, comm=mesh, device="cpu"))
    d = np.abs(q[:, None, :] - x[None]).sum(-1)
    votes = np.zeros((13, 3))
    for i, nb in enumerate(np.argsort(d, axis=1, kind="stable")[:, :K]):
        for j in nb:
            votes[i, y[j] // 2] += 1
    np.testing.assert_array_equal(l1.predict(htt.array(q, split=0, comm=mesh, device="cpu")).numpy(),
                                  np.argmax(votes, axis=1) * 2 + 1)
    # fit_stream is ported (tests/test_torch_stream.py): no source raises as in
    # heat_tpu, and close_stream without a stream does nothing
    with pytest.raises(TypeError, match="cannot stream"):
        m.fit_stream(None, None)
    m.close_stream()
    # quantize_ is ported (tests/test_torch_quantize.py); unfitted it raises
    with pytest.raises(RuntimeError, match="fit the model first"):
        htt.classification.KNeighborsClassifier().quantize_()
    with pytest.raises(RuntimeError):
        htt.classification.KNeighborsClassifier().predict(htt.array(q, device="cpu"))
    with pytest.raises(ValueError):
        m.fit(htt.array(x, device="cpu"), htt.array(y[:5], device="cpu"))


def test_topk_select_matches_the_full_order(monkeypatch):
    """The selection of ``_nearest`` (torch.topk, then a re-rank of the rows
    whose k-th value ties across the cut) equals ``topk_order``'s on rows
    full of ties."""
    from heat_tpu_torch.parallel import sort as sort_mod
    from heat_tpu_torch.parallel.sort import topk_order, topk_select

    monkeypatch.setattr(sort_mod, "_SORT_ELEMENTS", 0)  # select, as rows too long to sort
    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, 4, (300, 50), generator=g).to(torch.float32)
    t[::7] = torch.randn(43, 50, generator=g)
    for k in (1, 3, 10):
        for largest in (True, False):
            assert torch.equal(topk_select(t, k, largest), topk_order(t, k, largest))
    got = knn_mod.KNeighborsClassifier(5)._nearest(t)
    assert torch.equal(got, topk_order(t, 5, False))


# ---------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("sq", [0, None])
def test_predict_through_k1_on_card(cuda, sq, monkeypatch):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(20000, 64, generator=g, device=cuda)
    y = (x[:, 0] > 0).to(torch.int32)
    q = torch.randn(3000, 64, generator=g, device=cuda)
    mesh = htt.MeshComm(4)
    model = htt.classification.KNeighborsClassifier(5).fit(htt.array(x, split=0, comm=mesh), htt.array(y, split=0, comm=mesh))
    before = k1.launches
    got = model.predict(htt.array(q, split=sq, comm=mesh)).larray
    torch.cuda.synchronize()
    assert k1.launches == before + 4
    monkeypatch.setattr(k1, "cdist", k1.reference_cdist)
    want = model.predict(htt.array(q, split=sq, comm=mesh)).larray
    d = torch.cdist(q.double(), x.double()) ** 2
    top = torch.topk(d, 6, largest=False).values
    bound = 1e-5 * ((q.double() ** 2).sum(1) + (x.double() ** 2).sum(1).max())
    clear = (top[:, 5] - top[:, 4]) > bound
    assert bool(clear.float().mean() > 0.95)
    assert torch.equal(got[clear], want[clear])
    cpu = htt.classification.KNeighborsClassifier(5).fit(htt.array(x.cpu(), split=0, comm=mesh, device="cpu"),
                                                         htt.array(y.cpu(), split=0, comm=mesh, device="cpu"))
    assert torch.equal(cpu.predict(htt.array(q.cpu(), split=sq, comm=mesh, device="cpu")).larray[clear.cpu()],
                       got.cpu()[clear.cpu()])
