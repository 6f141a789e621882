"""The members of ``DCSR_matrix`` that the port gained last (trim, the
position's and the global CSR triples, ``larray``, ``global_indptr``,
``balanced``, ``lshape``): heat_tpu_torch against heat_tpu on the CPU at
meshes 1, 4 and 8, bitwise in values, dtype and shape.

``larray`` is a ``torch.sparse_csr_tensor`` in the port and a
``jax.experimental.sparse.BCSR`` in heat_tpu: their triples and dense forms
are compared.  13 rows over 8 positions leave positions of 2, 1 and 0
rows; rows 3 and 11 are empty.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import heat_tpu_torch as htt

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _csr(seed=0):
    sp = scipy.sparse.random(13, 11, density=0.3, random_state=np.random.default_rng(seed), format="lil", dtype=np.float64)
    for r in (3, 11):
        sp.rows[r], sp.data[r] = [], []
    return sp.tocsr().astype(np.float32)


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("split", (0, None))
def test_dcsr_members(ht, n, split):
    sp = _csr(n)
    a = ht.sparse.sparse_csr_matrix(sp, split=split, comm=ht.parallel.mesh.local_mesh(n))
    b = htt.sparse.sparse_csr_matrix(sp, split=split, comm=htt.MeshComm(n), device="cpu")
    for name in ("ldata", "lindices", "lindptr", "data", "gdata", "indices", "gindices", "indptr", "gindptr"):
        _same(getattr(b, name), getattr(a, name))
    assert b.lindices.dtype == b.lindptr.dtype == b.indptr.dtype == torch.int32
    assert b.lshape == a.lshape and b.balanced is a.balanced is True
    gp_a, gp_b = a.global_indptr, b.global_indptr
    assert gp_b.split == gp_a.split and gp_b.shape == gp_a.shape and gp_b.dtype.__name__ == gp_a.dtype.__name__
    _same(torch.from_numpy(gp_b.numpy()), gp_a.numpy())
    larray = b.larray
    assert larray.layout == torch.sparse_csr and tuple(larray.shape) == sp.shape
    bcsr = a.larray
    _same(larray.crow_indices(), bcsr.indptr)
    _same(larray.col_indices(), bcsr.indices)
    _same(larray.values(), bcsr.data)
    _same(larray.to_dense(), bcsr.todense())
    assert b.trim() is b and a.trim() is a
    _same(b.data, a.data)  # unchanged by trim


def test_dcsr_members_of_an_empty_position_and_a_sum(ht):
    """A matrix whose last rows are empty (at 8 positions the last three
    hold no entries) and the sum of two matrices (heat_tpu's slabs carry
    slack capacity there, which its ``trim`` drops; the port has none)."""
    n = 8
    sp = _csr(7)
    sp[9:] = 0
    sp.eliminate_zeros()
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.sparse.sparse_csr_matrix(sp, split=0, comm=jc)
    b = htt.sparse.sparse_csr_matrix(sp, split=0, comm=tc, device="cpu")
    sa, sb = (a + a).trim(), (b + b).trim()
    for x, y in ((a, b), (sa, sb)):
        for name in ("ldata", "lindices", "lindptr", "data", "indices", "indptr"):
            _same(getattr(y, name), getattr(x, name))
        _same(y.larray.to_dense(), x.larray.todense())
