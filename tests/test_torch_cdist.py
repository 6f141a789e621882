"""K1, the fused squared-distance kernel, and ``spatial.cdist``: heat_tpu_torch
against heat_tpu on the CPU, and the CUDA kernel against its plain version
on the card.

Tolerance: the kernels sum the cross term and the norms in different orders,
and the expansion cancels, so squared distances agree to
|Δd2| ≤ 1e-5·(‖x‖²+‖y‖²) elementwise; distances are compared through their
squares.  The same holds for bf16/f16 input: every version widens it to f32
first, and a product of two 16-bit values is exact in f32, so again only
the order of the sums differs.  Exact agreement is required of shapes,
splits and shard layouts, and of the noise floor's zeros.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import cdist as k1


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests (the tests that
    need only the card run without it)."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


MESHES = (1, 4, 8)


def _check_d2(got, want, x, y, sqrt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if sqrt:
        got, want = got**2, want**2
    scale = (x.astype(np.float64) ** 2).sum(1)[:, None] + (y.astype(np.float64) ** 2).sum(1)[None, :]
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-30), np.max(np.abs(got - want) / (scale + 1e-30))


def _data(m, n, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, d)).astype(dtype), rng.normal(size=(n, d)).astype(dtype)


def _data16(m, n, d, x_type, y_type, seed=0):
    """Blob-like rows as torch tensors of the given types: made in f32 by
    numpy, rounded by torch (the card tests run without ml_dtypes)."""
    x, y = _data(m, n, d, seed=seed)
    return torch.from_numpy(3 * x).to(getattr(torch, x_type)), torch.from_numpy(3 * y).to(getattr(torch, y_type))


def _np16(t):
    """A 16-bit CPU tensor as numpy (bf16 as ml_dtypes', for the JAX package)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(pytest.importorskip("ml_dtypes").bfloat16)
    return t.numpy()


def _f32(t):
    return t.float().cpu().numpy()


PAIRS16 = [("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("float16", "float16"), ("float16", "float32")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(37, 8, 5), (1, 1, 3), (64, 1, 64), (200, 100, 17)])
@pytest.mark.parametrize("sqrt", [False, True])
def test_reference_against_jax_xla_regime(ht, shape, sqrt):
    # n < 128: heat_tpu's dispatch takes its jnp expansion, not the kernel
    x, y = _data(*shape)
    want = ht.ops.cdist.cdist(x, y, sqrt=sqrt)
    got = k1.reference_cdist(torch.from_numpy(x), torch.from_numpy(y), sqrt=sqrt)
    assert got.dtype == torch.float32
    _check_d2(got.numpy(), want, x, y, sqrt)


@pytest.mark.parametrize("shape", [(300, 128, 64), (37, 129, 67), (9, 257, 3)])
@pytest.mark.parametrize("sqrt", [False, True])
def test_reference_against_pallas_interpret(ht, shape, sqrt):
    x, y = _data(*shape, seed=1)
    want = ht.ops.cdist._cdist_pallas(x, y, sqrt=sqrt, interpret=True)
    got = k1.reference_cdist(torch.from_numpy(x), torch.from_numpy(y), sqrt=sqrt)
    _check_d2(got.numpy(), want, x, y, sqrt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("x_type", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(300, 128, 64), (37, 129, 20), (9, 257, 3)])
@pytest.mark.parametrize("sqrt", [False, True])
def test_reference_against_pallas_interpret_16bit(ht, x_type, shape, sqrt):
    # the TPU kernel widens each 16-bit tile to f32 (heat_tpu/ops/cdist.py:41-42)
    x, y = _data16(*shape, x_type, x_type, seed=3)
    want = ht.ops.cdist._cdist_pallas(_np16(x), _np16(y), sqrt=sqrt, interpret=True)
    got = k1.reference_cdist(x, y, sqrt=sqrt)
    assert got.dtype == torch.float32
    _check_d2(got.numpy(), want, _f32(x), _f32(y), sqrt)


@pytest.mark.parametrize("pair", PAIRS16)
def test_wrapper_on_cpu_takes_16bit_as_the_plain_version(pair):
    x, y = _data16(20, 7, 4, *pair)
    before = k1.launches
    got = k1.cdist(x, y, sqrt=False)
    want = k1.reference_cdist(x.float(), y.float(), sqrt=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert k1.launches == before


def test_wrapper_on_cpu_is_the_plain_version():
    x, y = _data(20, 7, 4)
    before = k1.launches
    got = k1.cdist(torch.from_numpy(x), torch.from_numpy(y), sqrt=False)
    want = k1.reference_cdist(torch.from_numpy(x), torch.from_numpy(y), sqrt=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert k1.launches == before


def test_zero_row_input():
    x, y = _data(0, 8, 5)
    out = k1.cdist(torch.from_numpy(x), torch.from_numpy(y), sqrt=True)
    assert tuple(out.shape) == (0, 8) and out.dtype == torch.float32


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        k1.cdist(torch.zeros(3), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        k1.cdist(torch.zeros(3, 4), torch.zeros(2, 3))


LAYOUTS = [(0, None), (None, None), (None, 0), (0, 0), (1, None), (0, 1)]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("splits", LAYOUTS)
def test_spatial_cdist_layouts(ht, n, splits):
    x, y = _data(13, 6, 5, seed=2)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.cdist(ht.array(x, split=splits[0], comm=jc), ht.array(y, split=splits[1], comm=jc))
    b = htt.spatial.cdist(
        htt.array(x, split=splits[0], comm=tc, device="cpu"),
        htt.array(y, split=splits[1], comm=tc, device="cpu"),
    )
    assert b.shape == a.shape and b.split == a.split and b.dtype is htt.float32
    _check_d2(b.numpy(), a.numpy(), x, y, sqrt=True)
    sa, sb = a.lshards(), b.lshards()
    assert [s.shape for s in sb] == [s.shape for s in sa]


@pytest.mark.parametrize("n", MESHES)
def test_spatial_cdist_float64_takes_the_expansion(ht, n):
    x, y = _data(13, 6, 5, seed=4, dtype=np.float64)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.cdist(ht.array(x, split=0, comm=jc), ht.array(y, comm=jc))
    b = htt.spatial.cdist(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(y, comm=tc, device="cpu"))
    assert b.dtype is htt.float64 and a.dtype is ht.float64
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("splits", [(0, None), (None, None), (None, 0), (0, 0)])
@pytest.mark.parametrize("x_type", ["bfloat16", "float16"])
def test_spatial_cdist_16bit_through_k1_with_the_noise_floor(ht, n, splits, x_type):
    # y holds copies of x's rows: the JAX package's floor sets their
    # distances to exactly 0, and so must the port's
    x, y = _data16(13, 6, 5, x_type, x_type, seed=8)
    y[:3] = x[[0, 5, 12]]
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.cdist(ht.array(_np16(x), split=splits[0], comm=jc), ht.array(_np16(y), split=splits[1], comm=jc))
    b = htt.spatial.cdist(
        htt.array(_np16(x), split=splits[0], comm=tc, device="cpu"),
        htt.array(_np16(y), split=splits[1], comm=tc, device="cpu"),
    )
    assert b.shape == a.shape and b.split == a.split
    assert b.dtype is htt.float32 and a.dtype.__name__ == "float32"
    _check_d2(b.numpy(), a.numpy(), _f32(x), _f32(y), sqrt=True)
    zeros = a.numpy() == 0
    assert zeros[[0, 5, 12], [0, 1, 2]].all()
    np.testing.assert_array_equal(b.numpy() == 0, zeros)
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("x_type", ["bfloat16", "float16"])
def test_spatial_rbf_16bit(ht, n, x_type):
    x, _ = _data16(13, 1, 5, x_type, x_type, seed=9)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.rbf(ht.array(_np16(x), split=0, comm=jc), sigma=4.0)
    b = htt.spatial.rbf(htt.array(x, split=0, comm=tc, device="cpu"), sigma=4.0)
    assert b.dtype is htt.float32 and b.split == a.split
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.diag(b.numpy()), 1.0)


def test_spatial_cdist_16bit_makes_no_f32_copy(monkeypatch):
    # K1 gets the 16-bit blocks themselves; the floor widens 2^18 rows at most
    from heat_tpu_torch.spatial import distance

    seen = []
    real = k1.cdist
    monkeypatch.setattr(distance._k1, "cdist", lambda a, b, sqrt: seen.append((a.dtype, b.dtype)) or real(a, b, sqrt))
    x, y = _data16(40, 3, 4, "bfloat16", "float32", seed=10)
    tc = htt.MeshComm(4)
    htt.spatial.cdist(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(y, comm=tc, device="cpu"))
    htt.spatial.cdist(htt.array(x, split=0, comm=tc, device="cpu"))
    assert seen == [(torch.bfloat16, torch.float32)] * 4 + [(torch.bfloat16, torch.bfloat16)] * 4


def test_spatial_cdist_zero_row_shard():
    x, y = _data(13, 3, 4, seed=5)
    b = htt.spatial.cdist(htt.array(x, split=0, comm=htt.MeshComm(8), device="cpu"), htt.array(y, comm=htt.MeshComm(8), device="cpu"))
    assert [s.shape for s in b.shards] == [(2, 3)] * 6 + [(1, 3), (0, 3)]
    _check_d2(b.numpy(), k1.reference_cdist(torch.from_numpy(x), torch.from_numpy(y)).numpy(), x, y, True)


def test_spatial_cdist_integer_input_promotes_to_float32(ht):
    x = np.arange(12, dtype=np.int32).reshape(4, 3)
    a = ht.spatial.cdist(ht.array(x, split=0))
    b = htt.spatial.cdist(htt.array(x, split=0, comm=htt.MeshComm(4), device="cpu"))
    assert b.dtype is htt.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-3)


# ------------------------------------------------------------------ manhattan
# L1 distances are sums of |x - y| over the features, taken in other orders
# by the two packages: rtol 1e-6 for f32 (a few ulps of the sum); exact on
# integer-valued data; bf16 differences are rounded in bf16 by both, the
# f32 sums then rounded once to bf16 (one bf16 ulp)
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("splits", LAYOUTS)
@pytest.mark.parametrize("integer", [False, True])
def test_spatial_manhattan_layouts(ht, n, splits, integer):
    x, y = _data(13, 6, 5, seed=12)
    if integer:
        x, y = np.round(x * 8), np.round(y * 8)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.manhattan(ht.array(x, split=splits[0], comm=jc), ht.array(y, split=splits[1], comm=jc))
    b = htt.spatial.manhattan(
        htt.array(x, split=splits[0], comm=tc, device="cpu"),
        htt.array(y, split=splits[1], comm=tc, device="cpu"),
    )
    assert b.shape == a.shape == (13, 6) and b.split == a.split and b.dtype is htt.float32
    if integer:
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    else:
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)
    assert [s.shape for s in b.lshards()] == [s.shape for s in a.lshards()]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", ["float64", "bfloat16", "int32"])
def test_spatial_manhattan_dtypes(ht, n, dtype):
    x, y = _data(13, 4, 3, seed=13)
    x, y = np.round(x * 4), np.round(y * 4)
    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        x, y = (x + 0.25).astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)
    else:
        x, y = x.astype(dtype), y.astype(dtype)
    jc, tc = ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)
    a = ht.spatial.manhattan(ht.array(x, split=0, comm=jc), ht.array(y, comm=jc))
    b = htt.spatial.manhattan(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(y, comm=tc, device="cpu"))
    assert b.dtype.__name__ == a.dtype.__name__ == ("float32" if dtype == "int32" else dtype)
    np.testing.assert_array_equal(b.numpy().astype(np.float64), a.numpy().astype(np.float64))


def test_spatial_manhattan_self_and_blocks(monkeypatch):
    # y defaults to x; a block of two rows at a time gives the same values
    from heat_tpu_torch.spatial import distance

    x, _ = _data(13, 1, 5, seed=14)
    tc = htt.MeshComm(4)
    whole = htt.spatial.manhattan(htt.array(x, split=0, comm=tc, device="cpu"))
    want = np.abs(x[:, None, :] - x[None, :, :]).sum(-1)
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(np.diag(whole.numpy()), 0.0)
    monkeypatch.setattr(distance, "_L1_ELEMENTS", 2 * 13 * 5)
    np.testing.assert_array_equal(htt.spatial.manhattan(htt.array(x, split=0, comm=tc, device="cpu")).numpy(), whole.numpy())


# ------------------------------------------------------------------ on the card
CARD_SHAPES = [(1000, 8, 64), (1000, 1, 64), (1003, 257, 67), (5, 3, 1), (0, 8, 64), (130, 9, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("sqrt", [False, True])
def test_kernel_against_plain_on_card(cuda, shape, sqrt):
    x, y = _data(*shape, seed=6)
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    before = k1.launches
    got = k1.cdist(xt, yt, sqrt=sqrt)
    torch.cuda.synchronize()
    assert k1.launches == before + (1 if shape[0] and shape[1] else 0)
    assert got.is_cuda and got.dtype == torch.float32 and tuple(got.shape) == shape[:2]
    want = k1.reference_cdist(xt, yt, sqrt=sqrt)
    _check_d2(got.cpu().numpy(), want.cpu().numpy(), x, y, sqrt)


# the 16-bit kernel's geometry: the tall tile (n <= 8: Lloyd, kmeans++'s
# column), the general tile, ragged m, n and d, d odd or off a multiple of 8
# (4- and 2-byte loads), and bases off 16 bytes (below)
CARD_SHAPES_16 = [(1000, 8, 64), (1000, 1, 64), (1003, 257, 67), (130, 9, 16), (777, 8, 3),
                  (777, 300, 20), (1001, 8, 65), (5, 3, 1), (0, 8, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS16)
@pytest.mark.parametrize("shape", CARD_SHAPES_16)
@pytest.mark.parametrize("sqrt", [False, True])
def test_kernel16_against_plain_on_card(cuda, pair, shape, sqrt):
    x, y = _data16(*shape, *pair, seed=11)
    xt, yt = x.to(cuda), y.to(cuda)
    before = k1.launches
    got = k1.cdist(xt, yt, sqrt=sqrt)
    again = k1.cdist(xt, yt, sqrt=sqrt)
    torch.cuda.synchronize()
    assert k1.launches == before + (2 if shape[0] and shape[1] else 0)
    assert got.is_cuda and got.dtype == torch.float32 and tuple(got.shape) == shape[:2]
    assert torch.equal(got, again)
    want = k1.reference_cdist(xt, yt, sqrt=sqrt)
    _check_d2(got.cpu().numpy(), want.cpu().numpy(), _f32(x), _f32(y), sqrt)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS16)
@pytest.mark.parametrize("d", [64, 20, 3])
@pytest.mark.parametrize("offset", [1, 3, "row"])
def test_kernel16_at_misaligned_bases_on_card(cuda, pair, d, offset):
    # x starts 2 or 6 bytes past an aligned buffer, or one row in (a
    # row-offset view, 2·d bytes: off 16 unless d is a multiple of 8)
    m, n = 1031, (8 if d != 3 else 13)
    x, y = _data16(m + 1, n, d, *pair, seed=12)
    xt, yt = x.to(cuda), y.to(cuda)
    if offset == "row":
        xv = xt[1:]
    else:
        buf = torch.empty(m * d + offset, dtype=xt.dtype, device=cuda)
        xv = buf[offset:].view(m, d)
        xv.copy_(xt[1:])
    assert xv.is_contiguous()
    got = k1.cdist(xv, yt, sqrt=False)
    want = k1.reference_cdist(xv, yt, sqrt=False)
    torch.cuda.synchronize()
    _check_d2(got.cpu().numpy(), want.cpu().numpy(), _f32(x[1:]), _f32(y), False)


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        k1.cdist(x.double(), x.double())
    with pytest.raises(TypeError):
        k1.cdist(x, x.bfloat16())
    with pytest.raises(TypeError):
        k1.cdist(x.bfloat16(), x.half())
    with pytest.raises(ValueError):
        k1.cdist(torch.zeros(3, 4, device=cuda).T, x)
    with pytest.raises(ValueError):
        k1.cdist(x, x.cpu())


@pytest.mark.gpu
def test_spatial_cdist_on_card_launches_k1(cuda):
    x, y = _data(13, 6, 5, seed=7)
    before = k1.launches
    b = htt.spatial.cdist(htt.array(x, split=0, comm=htt.MeshComm(4), device="gpu"), htt.array(y, comm=htt.MeshComm(4), device="gpu"))
    assert k1.launches == before + 4
    _check_d2(b.numpy(), k1.reference_cdist(torch.from_numpy(x), torch.from_numpy(y)).numpy(), x, y, True)
