"""K7, the rechunk repack: heat_tpu_torch's plain version against
heat_tpu's Pallas kernel (interpret mode) and numpy on the CPU, and the CUDA
kernel against its plain version on the card.

Tolerance: none.  The kernel copies raw bytes, so every comparison is of
the bytes themselves, for every dtype."""

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops import repack as k7

# tests/test_kernels.py:140-146, then the other dtypes the engine moves
SHAPES = [
    ((1998, 10), np.float32),
    ((500, 13), np.float32),
    ((64, 64), np.int32),
    ((40, 17, 7), np.float32),
    ((4096, 1), np.float32),
    ((333, 11), np.bool_),
    ((333, 11), np.int8),
    ((250, 9), np.float16),
    ((250, 9), "bfloat16"),
    ((250, 9), np.float64),
]


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _flat(total, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(total) < 0.5
    if dtype == "bfloat16" or np.issubdtype(dtype, np.floating):
        return rng.standard_normal(total).astype(np.float32 if dtype == "bfloat16" else dtype)
    return rng.integers(-100, 100, total).astype(dtype)


def _torch(flat, dtype):
    t = torch.from_numpy(flat)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=lambda v: str(v))
def test_plain_repack_equals_heat_tpu_interpret_and_numpy(ht, monkeypatch, shape, dtype):
    import jax.numpy as jnp
    from heat_tpu.ops import repack as jrepack

    monkeypatch.setenv("HEAT_TPU_PALLAS", "interpret")
    total = int(np.prod(shape))
    flat = _flat(total, dtype, seed=total)
    src = _torch(flat, dtype)
    got = k7.reference_repack(src, shape)
    assert tuple(got.shape) == shape and got.is_contiguous() and got.dtype == src.dtype
    assert got.data_ptr() != src.data_ptr()
    jflat = jnp.asarray(flat).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(flat)
    want = np.asarray(jrepack.repack(jflat, shape, interpret=True))
    assert want.shape == shape
    assert torch.equal(_bytes(got), torch.from_numpy(np.array(want).view(np.uint8)).view(-1))
    assert torch.equal(_bytes(got), _bytes(src.reshape(shape)))
    # the wrapper on a CPU tensor is the plain version
    before = k7.calls, k7.launches
    assert torch.equal(_bytes(k7.repack(src, shape)), _bytes(got))
    assert (k7.calls, k7.launches) == (before[0] + 1, before[1])


def test_segments_against_torch_cat():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 255, 101).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 255, 37).astype(np.uint8))
    c = torch.from_numpy(rng.integers(0, 255, 64).astype(np.uint8))
    segs = [(a, 3, 27), (b, 1, 35), (c, 0, 0), (a, 50, 8)]
    got = k7.repack_segments(segs, (10, 7))
    want = torch.cat([a[3:30], b[1:36], a[50:58]]).reshape(10, 7)
    assert torch.equal(got, want)
    assert torch.equal(k7.reference_repack_segments(segs, (10, 7)), want)
    # one segment is exactly repack
    assert torch.equal(k7.repack_segments([(a, 0, 101)], (101,)), k7.repack(a, (101,)))


def test_zero_rows_and_bad_segments():
    src = torch.arange(12, dtype=torch.float32)
    assert tuple(k7.repack_segments([(src, 4, 0)], (0, 10)).shape) == (0, 10)
    with pytest.raises(ValueError):
        k7.repack_segments([(src, 0, 12)], (5, 2))  # 12 elements cannot fill 10
    with pytest.raises(ValueError):
        k7.repack_segments([(src, 8, 5)], (5,))  # past the source's end
    with pytest.raises(ValueError):
        k7.repack_segments([], (0,))
    with pytest.raises(TypeError):
        k7.repack_segments([(src, 0, 2), (src.double(), 0, 2)], (4,))
    with pytest.raises(ValueError):
        k7.repack_segments([(src.reshape(3, 4), 0, 12)], (12,))  # not 1-D


def test_non_contiguous_source_raises():
    src = torch.arange(24, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack_segments([(src[::2], 0, 12)], (12,))
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack(src.reshape(4, 6).t(), (24,))


def test_sources_off_the_cpu_and_not_on_one_card_raise():
    # a tensor that is neither on the CPU nor on a card: no plain version,
    # no kernel
    cpu = torch.zeros(4)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(cpu, 0, 4), (meta, 0, 4)], (8,))
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(meta, 0, 4)], (4,))


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.bool, torch.float64, torch.int64,
               torch.complex64]


def _card_data(total, dtype, gen, dev):
    if dtype == torch.bool:
        return torch.rand(total, generator=gen, device=dev) < 0.5
    if dtype.is_floating_point or dtype.is_complex:
        return torch.randn(total, generator=gen, device=dev, dtype=dtype)
    return torch.randint(-100, 100, (total,), generator=gen, device=dev, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1998, 10), (499_999, 3), (7, 1), (123_457, 33)], ids=str)
def test_kernel_bitwise_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(11)
    flat = _card_data(int(np.prod(shape)), dtype, gen, cuda)
    before = k7.launches
    got = k7.repack(flat, shape)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert got.is_cuda and got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(_bytes(got), _bytes(k7.reference_repack(flat, shape)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.float64], ids=str)
def test_kernel_segments_at_odd_offsets_on_card(cuda, dtype):
    # every pair of source and destination alignments: 1-byte offsets
    # differ modulo 16, f32 offsets modulo 4, so the kernel takes every
    # width from 1 to 16 bytes with heads and tails
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = _card_data(100_003, dtype, gen, cuda)
    b = _card_data(77_777, dtype, gen, cuda)
    c = _card_data(31, dtype, gen, cuda)
    for starts in [(1, 3, 5), (0, 0, 0), (7, 2, 30), (15, 16, 1)]:
        segs = [(a, starts[0], 50_001), (c, starts[2], 1), (b, starts[1], 60_000), (a, 60_001, 29)]
        total = sum(s[2] for s in segs)
        before = k7.launches
        got = k7.repack_segments(segs, (total,))
        torch.cuda.synchronize()
        assert k7.launches == before + 1
        assert torch.equal(_bytes(got), _bytes(k7.reference_repack_segments(segs, (total,))))


@pytest.mark.gpu
def test_kernel_zero_rows_and_reruns_on_card(cuda):
    src = torch.arange(30, dtype=torch.float32, device=cuda)
    before = k7.launches
    empty = k7.repack_segments([(src, 5, 0)], (0, 3))
    assert tuple(empty.shape) == (0, 3) and k7.launches == before
    got = k7.repack(src, (10, 3))
    again = k7.repack(src, (10, 3))
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, src.reshape(10, 3))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    src = torch.arange(64, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack_segments([(src[::2], 0, 32)], (32,))
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(src, 0, 32), (src.cpu(), 0, 32)], (64,))
    with pytest.raises(ValueError, match="at most"):
        k7.repack_segments([(src, i, 1) for i in range(k7.MAX_SEGMENTS + 1)], (k7.MAX_SEGMENTS + 1,))


@pytest.mark.gpu
def test_transport_reshape_on_card_matches_cpu(cuda):
    import heat_tpu_torch as htt

    x = np.random.default_rng(5).standard_normal((999, 20)).astype(np.float32)
    for n in (1, 4, 8):
        mesh = htt.MeshComm(n)
        before = k7.launches
        got = htt.reshape(htt.array(torch.from_numpy(x).to(cuda), split=0, comm=mesh), (1998, 10))
        want = htt.reshape(htt.array(x, split=0, comm=mesh, device="cpu"), (1998, 10))
        torch.cuda.synchronize()
        assert k7.launches - before == (n if n > 1 else 0)
        for g, w in zip(got.shards, want.shards):
            assert torch.equal(_bytes(g.cpu()), _bytes(w))
