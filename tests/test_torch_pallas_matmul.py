"""K2, the blocked GEMM behind ``ops.pallas_matmul``: heat_tpu_torch's plain
version against heat_tpu's Pallas kernel on the CPU, and the CUDA kernel
against its plain version on the card.

heat_tpu runs its kernel in interpret mode (``HEAT_TPU_PALLAS``), as
tests/test_ops.py:28-40 does.  Both accumulate in f32 and round once to
a's dtype.  Tolerances: f32 |Δ| ≤ 1e-4 on the CPU, and on the card
|Δ| ≤ 1e-5·max(|a|·|b|) (the sums run up to 2048 deep there); bf16 within one bf16 rounding of the f32 result,
|Δ| ≤ 2⁻⁷·|c| + 1e-3 (the two round f32 sums that differ in their last
bits).  The tensor-core geometries (rows that TMA cannot describe, bases
off 16-byte alignment, k = 8200) are held to the same bound, rerun
bitwise equal, run only the tensor-core kernel and count one launch a call.
The f32 kernel's geometries (rows off 16 bytes, which take its 4-byte
copies; bases one element past a 16-byte boundary; ragged tiles and a long
k) are held to the f32 bound, rerun bitwise equal and run only ``mm_kernel``.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import matmul as k2

# tests/test_ops.py:32 and the wider edges of the card's tiles
SHAPES = [(37, 53, 41), (128, 128, 128), (1, 7, 300), (129, 5, 130)]


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PALLAS", "interpret")


@pytest.mark.parametrize("shape,offset", [((6, 16), 0), ((6, 16), 1), ((3, 5, 20), 0), ((4, 777), 1), ((2, 0), 0)])
def test_tma_rows_keeps_what_qualifies_and_pads_the_rest(shape, offset):
    # TMA needs a 16-byte aligned base and 16-bit rows a multiple of 8
    n = 1
    for s in shape:
        n *= s
    t = torch.arange(n + offset, dtype=torch.float32).to(torch.bfloat16)[offset:].view(shape)
    got, ld = k2.tma_rows(t)
    cols = shape[-1]
    assert ld == -(-cols // 8) * 8
    if cols % 8 == 0 and t.data_ptr() % 16 == 0:
        assert got is t
    else:
        assert got.data_ptr() % 16 == 0 and got.shape == shape[:-1] + (ld,)
    assert torch.equal(got[..., :cols], t)


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=2.0**-7)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_f32_matches_jax_kernel(ht, interpret, m, k, n):
    import jax.numpy as jnp

    a, b = _ab(m, k, n, m + k + n)
    want = np.asarray(ht.ops.pallas_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = htt.ops.pallas_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_matches_jax_kernel(ht, interpret, m, k, n):
    import jax.numpy as jnp

    a, b = _ab(m, k, n, 2 * m + k)
    want = ht.ops.pallas_matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = htt.ops.pallas_matmul(torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_block_changes_no_values(ht, interpret):
    import jax.numpy as jnp

    a, b = _ab(37, 53, 41, 5)
    want = np.asarray(ht.ops.pallas_matmul(jnp.asarray(a), jnp.asarray(b), block=128))
    for block in (128, 512):
        got = htt.ops.pallas_matmul(torch.from_numpy(a), torch.from_numpy(b), block=block)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_two_d_only_raises_in_both(ht, interpret):
    import jax.numpy as jnp

    a = np.zeros((2, 3, 4), np.float32)
    b = np.zeros((4, 5), np.float32)
    with pytest.raises(ValueError, match="2-D only"):
        ht.ops.pallas_matmul(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError, match="2-D only"):
        htt.ops.pallas_matmul(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError, match="2-D only"):
        htt.ops.pallas_matmul(torch.zeros(4), torch.from_numpy(b))


def test_plain_version_rounds_once_to_a_dtype():
    a = torch.full((1, 3), 1.0 + 2.0**-8, dtype=torch.bfloat16)  # rounds to 1.0 in bf16
    b = torch.full((3, 1), 1.0, dtype=torch.bfloat16)
    assert k2.reference_matmul(a, b).dtype == torch.bfloat16
    x = torch.tensor([[1.0, 2.0**-9, 2.0**-9]], dtype=torch.bfloat16)
    y = torch.ones(3, 1, dtype=torch.bfloat16)
    # one rounding of the f32 sum 1 + 2^-8, not two of 1 + 2^-9
    assert float(k2.reference_matmul(x, y)) == float(torch.tensor(1.0 + 2.0**-8).to(torch.bfloat16))


def test_cpu_path_launches_nothing():
    before = k2.launches
    htt.ops.pallas_matmul(torch.ones(3, 4), torch.ones(4, 5))
    assert k2.launches == before


def test_inner_dimension_mismatch_raises():
    with pytest.raises(ValueError):
        k2.matmul(torch.ones(3, 4), torch.ones(5, 2))


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [(37, 53, 41), (1, 7, 300), (1000, 777, 1333), (1, 1, 1), (129, 0, 5), (256, 2048, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("m,k,n", CARD_SHAPES)
def test_kernel_against_plain_on_card(cuda, dtype, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    before = k2.launches
    got = htt.ops.pallas_matmul(a, b)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    want = k2.reference_matmul(a, b).float()
    if dtype == torch.float32:
        scale = float((a.abs() @ b.abs()).max()) if k else 0.0
        assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1.0)
    else:
        assert bool(((got.float() - want).abs() <= 2.0**-7 * want.abs() + 1e-3).all())


def _kernel_names(fn):
    """The names of the CUDA kernels ``fn`` runs, from torch.profiler.  A
    trace that recorded no device event at all is taken again (up to three
    times): it says nothing about which kernels ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def _operand(shape, dtype, g, device, offset):
    """A contiguous matrix, its base 2 bytes past a 16-byte boundary when
    ``offset``."""
    n = shape[0] * shape[1]
    flat = torch.randn(n + int(offset), generator=g, device=device).to(dtype)
    return flat[int(offset):].view(shape)


TC_SHAPES = [
    # (m, k, n, dtype, offset a, offset b)
    (1000, 777, 1333, torch.float16, False, False),
    (1000, 777, 1333, torch.bfloat16, True, False),
    (512, 1024, 768, torch.bfloat16, True, True),
    (8192, 8200, 8192, torch.bfloat16, False, False),
    (300, 4104, 520, torch.float16, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dtype,off_a,off_b", TC_SHAPES)
def test_tensor_core_geometries_on_card(cuda, m, k, n, dtype, off_a, off_b):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = _operand((m, k), dtype, g, cuda, off_a)
    b = _operand((k, n), dtype, g, cuda, off_b)
    assert (a.data_ptr() % 16 != 0) == off_a and (b.data_ptr() % 16 != 0) == off_b
    before = k2.launches
    got = htt.ops.pallas_matmul(a, b)
    assert k2.launches == before + 1
    again = htt.ops.pallas_matmul(a, b)
    want = k2.reference_matmul(a, b).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    assert torch.equal(got, again), "reruns are not bitwise equal"
    assert bool(((got.float() - want).abs() <= 2.0**-7 * want.abs() + 1e-3).all())
    names = _kernel_names(lambda: htt.ops.pallas_matmul(a, b))
    ours = [x for x in names if "mm_tc_kernel" in x]
    assert len(ours) == 1, names
    # besides the kernel only the wrapper's copies into aligned buffers run
    assert not any(w in x.lower() for x in names for w in ("gemm", "cutlass", "mm_kernel<")), names


F32_SHAPES = [
    # (m, k, n, offset a, offset b): rows of a and b off 16 bytes (the 4-byte
    # copies), ragged tiles and long k, bases one element past 16 bytes
    (1000, 777, 1333, False, False),
    (513, 1024, 260, False, False),
    (130, 4100, 96, False, False),
    (2048, 2048, 2048, False, False),
    (513, 1024, 260, True, True),
    (512, 1024, 768, True, False),
    (300, 4104, 520, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,off_a,off_b", F32_SHAPES)
def test_f32_geometries_on_card(cuda, m, k, n, off_a, off_b):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + off_a)
    a = _operand((m, k), torch.float32, g, cuda, off_a)
    b = _operand((k, n), torch.float32, g, cuda, off_b)
    assert (a.data_ptr() % 16 != 0) == off_a and (b.data_ptr() % 16 != 0) == off_b
    before = k2.launches
    got = htt.ops.pallas_matmul(a, b)
    assert k2.launches == before + 1
    again = htt.ops.pallas_matmul(a, b)
    want = k2.reference_matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, again), "reruns are not bitwise equal"
    assert float((got - want).abs().max()) <= 1e-5 * float((a.abs() @ b.abs()).max())
    names = _kernel_names(lambda: htt.ops.pallas_matmul(a, b))
    assert len(names) == 1 and "mm_kernel<" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tensor_core_trace_shows_only_the_new_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    a, b = (torch.randn(4096, 4096, generator=g, device=cuda).to(dtype) for _ in range(2))
    htt.ops.pallas_matmul(a, b)
    names = _kernel_names(lambda: htt.ops.pallas_matmul(a, b))
    assert len(names) == 1 and "mm_tc_kernel" in names[0], names


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    a = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        k2.matmul(a, a.T.contiguous().half())
    with pytest.raises(TypeError):
        k2.matmul(a.double(), a.T.double())
    with pytest.raises(ValueError):
        k2.matmul(a, torch.zeros(3, 2))
