"""The rest of linear algebra: ``outer``, ``projection``, ``trace``, ``vdot``,
``vecdot``, ``cross``, ``det``, ``inv`` and ``svd``, heat_tpu_torch against
heat_tpu on the CPU at meshes 1, 4 and 8, and on the card against the CPU.

The same numpy inputs go to both packages.  Shapes, dtypes, splits and
per-position shards must agree; float32 values to rtol 1e-5 (sums and
products are taken in other orders), integer and float64 values to 1e-12.
``det`` and ``inv`` take the same route in both packages (the elimination
over the rows for a matrix split over several positions, LU otherwise), so
they agree to 1e-5 relative.  SVD factors are unique up to one sign per
singular vector: S agrees to 1e-5 and U, V up to those signs.  13 rows over
8 positions leave shards of 2, 2, 2, 2, 2, 2, 1 and 0 rows.
"""

import importlib

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt

basics = importlib.import_module("heat_tpu_torch.core.linalg.basics")


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


MESHES = (1, 4, 8)
SPLITS = (None, 0, 1)
F32 = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=1e-12, atol=0.0)


def _rand(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _well_conditioned(n, seed, dtype=np.float32):
    """I + 0.1·G/√n: pivots near 1, so every partial product of the
    elimination stays well inside the type's range."""
    return (np.eye(n) + 0.1 * np.random.default_rng(seed).normal(size=(n, n)) / np.sqrt(n)).astype(dtype)


def _arrays(ht, n, x, split):
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    return ht.array(x, split=split, comm=jc), htt.array(x, split=split, comm=tc, device="cpu")


def _same(a, b, **tol):
    tol = tol or EXACT
    assert tuple(a.shape) == tuple(b.shape)
    assert a.dtype.__name__ == b.dtype.__name__
    assert a.split == b.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), **tol)
    sa, sb = a.lshards(), b.lshards()
    if a.split is not None:
        assert [s.shape for s in sa] == [s.shape for s in sb]
        for x, y in zip(sa, sb):
            np.testing.assert_allclose(y, x, **tol)


# ------------------------------------------------------------ the basics
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("sa", (None, 0))
@pytest.mark.parametrize("sb", (None, 0))
def test_outer(ht, n, sa, sb):
    ja, ta = _arrays(ht, n, _rand(13, seed=1), sa)
    jb, tb = _arrays(ht, n, _rand(7, seed=2), sb)
    _same(ht.outer(ja, jb), htt.outer(ta, tb))
    for split in (0, 1, None):
        _same(ht.outer(ja, jb, split=split), htt.outer(ta, tb, split=split))
    if sa != sb:
        return
    ji, ti = _arrays(ht, n, np.arange(6, dtype=np.int32).reshape(2, 3), sa)
    _same(ht.outer(ji, jb), htt.outer(ti, tb))
    jo, to = _arrays(ht, n, np.zeros((13, 7), np.float32), 0)
    ht.outer(ja, jb, out=jo)
    assert htt.outer(ta, tb, out=to) is to
    _same(jo, to)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (None, 0))
def test_projection_vdot_vecdot(ht, n, split):
    a, b = _rand(13, seed=3), _rand(13, seed=4)
    ja, ta = _arrays(ht, n, a, split)
    jb, tb = _arrays(ht, n, b, split)
    _same(ht.projection(ja, jb), htt.projection(ta, tb), **F32)
    _same(ht.vdot(ja, jb), htt.vdot(ta, tb), **F32)
    c = (_rand(13, seed=5) + 1j * _rand(13, seed=6)).astype(np.complex64)
    jc, tc = _arrays(ht, n, c, split)
    _same(ht.vdot(jc, jb), htt.vdot(tc, tb), **F32)
    _same(ht.vdot(jc, jc), htt.vdot(tc, tc), **F32)
    x, y = _rand(13, 4, seed=7), _rand(13, 4, seed=8)
    jx, tx = _arrays(ht, n, x, split)
    jy, ty = _arrays(ht, n, y, split)
    for axis in (0, 1, -1):
        for keepdims in (False, True):
            _same(ht.vecdot(jx, jy, axis=axis, keepdims=keepdims), htt.vecdot(tx, ty, axis=axis, keepdims=keepdims),
                  **F32)
    ji, ti = _arrays(ht, n, np.arange(13, dtype=np.int32), split)
    _same(ht.vdot(ji, ji), htt.vdot(ti, ti))
    with pytest.raises(RuntimeError):
        htt.projection(tx, ty)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_trace(ht, n, split):
    x = _rand(13, 9, seed=9)
    jx, tx = _arrays(ht, n, x, split)
    for offset in (-12, -3, 0, 8):
        _same(ht.trace(jx, offset=offset), htt.trace(tx, offset=offset), **F32)
        _same(ht.trace(jx, offset=offset, axis1=1, axis2=0), htt.trace(tx, offset=offset, axis1=1, axis2=0), **F32)
    ji, ti = _arrays(ht, n, np.arange(117, dtype=np.int32).reshape(13, 9), split)
    _same(ht.trace(ji, offset=1), htt.trace(ti, offset=1))
    _same(ht.trace(ji, dtype=ht.float32), htt.trace(ti, dtype=htt.float32))
    jo, to = _arrays(ht, n, np.zeros((), np.float64), None)
    ht.trace(jx, out=jo)
    assert htt.trace(tx, out=to) is to
    _same(jo, to, **F32)
    j3, t3 = _arrays(ht, n, _rand(4, 13, 5, seed=10), split)
    _same(ht.trace(j3, axis1=1, axis2=2), htt.trace(t3, axis1=1, axis2=2), **F32)


@pytest.mark.parametrize("n, split", [(1, None), (1, 0), (4, 0), (8, 0)])
def test_cross(ht, n, split):
    a, b = _rand(13, 3, seed=11), _rand(13, 3, seed=12)
    ja, ta = _arrays(ht, n, a, split)
    jb, tb = _arrays(ht, n, b, split)
    _same(ht.cross(ja, jb), htt.cross(ta, tb), **F32)
    # 2-vectors: with a 3-vector they are promoted, alone they give z
    a2, b2 = _rand(13, 2, seed=13), _rand(13, 2, seed=14)
    ja2, ta2 = _arrays(ht, n, a2, split)
    jb2, tb2 = _arrays(ht, n, b2, split)
    _same(ht.cross(ja2, jb), htt.cross(ta2, tb), **F32)
    _same(ht.cross(ja, jb2), htt.cross(ta, tb2), **F32)
    _same(ht.cross(ja2, jb2), htt.cross(ta2, tb2), **F32)
    # the vector axis first, the result's vector axis last; axis overrides
    at, bt = _rand(3, 13, seed=15), _rand(3, 13, seed=16)
    jat, tat = _arrays(ht, n, at, None if split is None else 1)
    jbt, tbt = _arrays(ht, n, bt, None if split is None else 1)
    _same(ht.cross(jat, jbt, axisa=0, axisb=0, axisc=-1), htt.cross(tat, tbt, axisa=0, axisb=0, axisc=-1), **F32)
    _same(ht.cross(jat, jbt, axis=0), htt.cross(tat, tbt, axis=0), **F32)
    # the split moves past the vector axis of a 3-D array
    a3, b3 = _rand(13, 3, 4, seed=17), _rand(13, 3, 4, seed=18)
    ja3, ta3 = _arrays(ht, n, a3, split)
    jb3, tb3 = _arrays(ht, n, b3, split)
    _same(ht.cross(ja3, jb3, axisa=1, axisb=1, axisc=0), htt.cross(ta3, tb3, axisa=1, axisb=1, axisc=0), **F32)
    ji, ti = _arrays(ht, n, np.arange(39, dtype=np.int64).reshape(13, 3), split)
    _same(ht.cross(ji, ji[::-1]), htt.cross(ti, ti[::-1]))
    t4 = _arrays(ht, n, _rand(13, 4, seed=19), split)[1]
    with pytest.raises(ValueError):
        htt.cross(t4, t4)


# ----------------------------------------------------------- det and inv
def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
def test_det_inv_on_both_routes(ht, n, split):
    a = _well_conditioned(13, seed=20)
    ja, ta = _arrays(ht, n, a, split)
    jd, td = ht.linalg.det(ja), htt.linalg.det(ta)
    assert td.shape == () and td.split is None and td.dtype is htt.float32
    assert abs(float(td.item()) - float(jd.item())) <= 1e-5 * abs(float(jd.item()))
    ji, ti = ht.linalg.inv(ja), htt.linalg.inv(ta)
    assert ti.split == ji.split == split and ti.dtype is htt.float32
    assert _rel(ti.numpy(), ji.numpy()) <= 1e-5
    assert [s.shape for s in ti.lshards()] == [s.shape for s in ji.lshards()]
    np.testing.assert_allclose(a.astype(np.float64) @ ti.numpy(), np.eye(13), atol=1e-5)
    # a matrix whose first column needs pivoting on another position
    p = np.roll(a, 7, axis=0)
    jp, tp = _arrays(ht, n, p, split)
    assert abs(float(htt.linalg.det(tp).item()) - float(ht.linalg.det(jp).item())) <= 1e-5 * abs(float(
        ht.linalg.det(jp).item()))
    assert _rel(htt.linalg.inv(tp).numpy(), ht.linalg.inv(jp).numpy()) <= 1e-5


@pytest.mark.parametrize("n", (1, 4))
def test_det_inv_int_float64_and_stacks(ht, n):
    ai = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 4]], np.int32)
    for split in SPLITS:
        ja, ta = _arrays(ht, n, ai, split)
        _same(ht.linalg.det(ja), htt.linalg.det(ta), **F32)
        _same(ht.linalg.inv(ja), htt.linalg.inv(ta), **F32)
        a64 = _well_conditioned(13, seed=21, dtype=np.float64)
        ja, ta = _arrays(ht, n, a64, split)
        _same(ht.linalg.det(ja), htt.linalg.det(ta), rtol=1e-12, atol=1e-14)
        _same(ht.linalg.inv(ja), htt.linalg.inv(ta), rtol=1e-12, atol=1e-14)
    stack = np.stack([_well_conditioned(5, seed=s) for s in range(3)])
    for split in (None, 0, 1):
        ja, ta = _arrays(ht, n, stack, split)
        _same(ht.linalg.det(ja), htt.linalg.det(ta), **F32)
        _same(ht.linalg.inv(ja), htt.linalg.inv(ta), **F32)
    with pytest.raises(RuntimeError):
        htt.linalg.det(htt.array(_rand(3, 4), device="cpu"))


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("split", SPLITS)
def test_singular_inv_is_inf_or_nan(ht, n, split):
    s = _rand(13, 13, seed=22)
    s[:, 5] = s[:, 2]
    s[4] = 0
    ja, ta = _arrays(ht, n, s, split)
    want, got = ht.linalg.inv(ja).numpy(), htt.linalg.inv(ta).numpy()
    assert not np.isfinite(want).all() and not np.isfinite(got).all()
    assert float(htt.linalg.det(ta).item()) == 0.0 == float(ht.linalg.det(ja).item())


def test_elimination_reads_one_pivot_a_column(monkeypatch):
    """The pivot of each column stays on the device: the elimination reads
    no tensor value on the host (on the card such a read would wait for
    every launch before it), and its values are those of a run that may."""
    a = _well_conditioned(13, seed=23)
    a[[0, 9]] = a[[9, 0]] * 3  # the first pivot lies on another position
    arrays = [htt.array(a, split=split, comm=htt.MeshComm(4), device="cpu") for split in (0, 1)]
    want = [torch.linalg.det(torch.from_numpy(a).double()), torch.linalg.inv(torch.from_numpy(a).double())]

    def host_read(*args, **kwargs):
        raise AssertionError("the elimination read a tensor value on the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "__int__", "__float__", "__bool__", "__index__"):
            m.setattr(torch.Tensor, name, host_read)
        dets = [basics.det(t).larray for t in arrays]
        invs = [torch.cat(basics.inv(t).shards, dim=t.split) for t in arrays]
    for d, i in zip(dets, invs):
        assert abs(float(d) - float(want[0])) <= 1e-5 * abs(float(want[0]))
        assert _rel(i.double().numpy(), want[1].numpy()) <= 1e-5


def test_sixteen_bit_factorizations(ht):
    """LAPACK factors no 16-bit floats: ``qr``, ``svd`` and the local ``det``
    and ``inv`` raise NotImplementedError in both packages.  The
    elimination route is plain arithmetic, so a split bf16 matrix gives a
    determinant and an inverse in both, which agree to bf16's rounding."""
    a = _well_conditioned(13, seed=24)
    for n, split in ((1, None), (1, 0), (4, None), (4, 0), (4, 1)):
        ja, ta = _arrays(ht, n, a, split)
        jb, tb = ja.astype(ht.bfloat16), ta.astype(htt.bfloat16)
        for name in ("qr", "svd"):
            with pytest.raises(NotImplementedError):
                getattr(ht.linalg, name)(jb)
            with pytest.raises(NotImplementedError, match="Unsupported dtype bfloat16"):
                getattr(htt.linalg, name)(tb)
        if n == 4 and split is not None:
            jd, td = ht.linalg.det(jb), htt.linalg.det(tb)
            assert td.dtype is htt.bfloat16 and jd.dtype is ht.bfloat16
            assert abs(float(td.item()) - float(jd.item())) <= 3e-2 * abs(float(jd.item()))
            ji, ti = ht.linalg.inv(jb), htt.linalg.inv(tb)
            assert ti.dtype is htt.bfloat16
            assert _rel(ti.numpy().astype(np.float32), ji.numpy().astype(np.float32)) <= 3e-2
            continue
        for name in ("det", "inv"):
            with pytest.raises(NotImplementedError):
                getattr(ht.linalg, name)(jb)
            with pytest.raises(NotImplementedError, match="Unsupported dtype bfloat16"):
                getattr(htt.linalg, name)(tb)
    with pytest.raises(NotImplementedError, match="Unsupported dtype float16"):
        htt.linalg.qr(htt.array(a, device="cpu").astype(htt.float16))


# ------------------------------------------------------------------- svd
def _same_up_to_sign(u_want, u_got, atol):
    signs = np.sign(np.sum(u_want * u_got, axis=0))
    np.testing.assert_allclose(u_got * signs[None, :], u_want, rtol=0, atol=atol)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(64, 5), (13, 13)])
def test_svd(ht, n, split, shape):
    x = _rand(*shape, seed=25)
    jx, tx = _arrays(ht, n, x, split)
    ju, js, jv = ht.linalg.svd(jx)
    tu, ts, tv = htt.linalg.svd(tx)
    assert tu.split == ju.split and ts.split is None and tv.split is None
    assert tu.shape == ju.shape and ts.shape == js.shape and tv.shape == jv.shape
    assert [s.shape for s in tu.lshards()] == [s.shape for s in ju.lshards()]
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5, atol=1e-5 * float(js.numpy()[0]))
    _same_up_to_sign(ju.numpy(), tu.numpy(), 1e-4)
    _same_up_to_sign(jv.numpy(), tv.numpy(), 1e-4)
    u, s, v = (t.numpy().astype(np.float64) for t in (tu, ts, tv))
    np.testing.assert_allclose(u * s @ v.T, x, atol=1e-5 * np.abs(x).max() * 10)
    _same(ht.linalg.svd(jx, compute_uv=False), htt.linalg.svd(tx, compute_uv=False), rtol=1e-5, atol=1e-5)


def test_svd_routes_and_errors(ht):
    # the TSQR route: split 0, several positions, m >= n * positions
    x = _rand(64, 8, seed=26)
    tx = htt.array(x, split=0, comm=htt.MeshComm(8), device="cpu")
    u, s, v = htt.svd(tx)
    assert u.split == 0 and [t.shape[0] for t in u.shards] == [8] * 8
    ju, js, jv = ht.svd(ht.array(x, split=0, comm=ht.parallel.mesh.local_mesh(8)))
    np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        htt.linalg.svd(tx, full_matrices=True)
    with pytest.raises(ValueError):
        htt.linalg.svd(htt.array(_rand(2, 3, 4), device="cpu"))
    si = htt.linalg.svd(htt.array(np.arange(12, dtype=np.int32).reshape(4, 3), device="cpu"), compute_uv=False)
    assert si.dtype is htt.float32


# ---------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("split", SPLITS)
def test_det_inv_svd_on_card(cuda, split):
    a = torch.from_numpy(_well_conditioned(96, seed=27))
    mesh = htt.MeshComm(4)
    card = htt.array(a.to(cuda), split=split, comm=mesh)
    cpu = htt.array(a, split=split, comm=mesh, device="cpu")
    d_card, d_cpu = float(htt.linalg.det(card).item()), float(htt.linalg.det(cpu).item())
    assert abs(d_card - d_cpu) <= 1e-5 * abs(d_cpu)
    i_card, i_cpu = htt.linalg.inv(card), htt.linalg.inv(cpu)
    assert i_card.split == split
    assert _rel(i_card.numpy(), i_cpu.numpy()) <= 1e-4
    x = torch.randn(4096, 32, generator=torch.Generator().manual_seed(1))
    u, s, v = htt.linalg.svd(htt.array(x.to(cuda), split=split, comm=mesh))
    _, s_cpu, _ = htt.linalg.svd(htt.array(x, split=split, comm=mesh, device="cpu"))
    np.testing.assert_allclose(s.numpy(), s_cpu.numpy(), rtol=1e-5)
    rec = (u.larray.double() * s.larray.double()) @ v.larray.double().T
    assert float((rec.cpu() - x.double()).norm() / x.double().norm()) <= 1e-5
    # a wide matrix (cuSOLVER's gesvd takes tall ones: torch transposes)
    s_w = htt.linalg.svd(htt.array(x.T.contiguous().to(cuda), comm=mesh), compute_uv=False).larray.cpu()
    s_t = htt.linalg.svd(htt.array(x.to(cuda), comm=mesh), compute_uv=False).larray.cpu()
    np.testing.assert_allclose(s_w.numpy(), s_t.numpy(), rtol=1e-5)
