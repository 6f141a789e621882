"""K3, flash attention: heat_tpu_torch's ``flash_attention`` against
heat_tpu's on the CPU, and the CUDA kernel against its plain version on the
card.

heat_tpu runs its Pallas kernel in interpret mode (``HEAT_TPU_PALLAS``),
as tests/test_ops.py does; the port on the CPU runs its plain version.
Tolerances, on unit-normal inputs: f32 |Δ| ≤ 1e-5 (the two sum in other
orders); bf16 |Δ| ≤ 2e-2, since the plain version (like heat_tpu's
``_attention_ref``) rounds the scores and p to bf16 while the kernel keeps
f32 throughout, and a bf16 ulp at |o| ~ 1 is 7.8e-3.  On the card the
kernel is held to the f32 plain version on the same inputs: f32 |Δ| ≤ 1e-5;
16-bit |Δ| ≤ 1e-3 + 2⁻⁷·|o| (one rounding of the output), and in bf16 also
+ 2⁻⁸·(softmax(s)·|v|): the tensor-core kernel rounds p to bf16 before its
product with v (the sum l stays f32), which moves o by at most half a bf16
ulp of each p·|v| term.  The same rounding in f16 (2⁻¹¹) stays inside the
1e-3.  The tensor-core geometries (head dims 64 and 256, a row of 40 bytes,
an operand off 16-byte alignment) are held to the same bounds, run only the
tensor-core kernel, and count one launch a call.  Gradients: both packages recompute through the plain
version, |Δ| ≤ 1e-5.
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops import attention as k3
from heat_tpu_torch.ops import flash_attention

F32_TOL = 1e-5
BF16_TOL = 2e-2
# the kernel in 16 bits against the f32 plain version on the card
CARD_TOL_16 = 1e-3


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PALLAS", "interpret")


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_flash(ht, q, k, v, causal, dtype=None):
    import jax.numpy as jnp

    conv = (lambda a: jnp.asarray(a, dtype=dtype)) if dtype is not None else jnp.asarray
    return np.asarray(ht.ops.flash_attention(conv(q), conv(k), conv(v), causal=causal).astype(jnp.float32))


# the shapes of tests/test_ops.py:113-160, plus causal with sq > sk
CASES = [
    ("self (3,40,16)", (3, 40, 16), (3, 40, 16), False),
    ("self (3,40,16) causal", (3, 40, 16), (3, 40, 16), True),
    ("4-D (2,4,24,8) causal", (2, 4, 24, 8), (2, 4, 24, 8), True),
    ("cross (2,13,8)x(2,29,8)", (2, 13, 8), (2, 29, 8), False),
    ("cross (2,13,8)x(2,29,8) causal", (2, 13, 8), (2, 29, 8), True),
    ("causal sq>sk (2,29,8)x(2,13,8)", (2, 29, 8), (2, 13, 8), True),
]


@pytest.mark.parametrize("name,qshape,kshape,causal", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_f32(ht, interpret, name, qshape, kshape, causal):
    q, k, v = _normal(qshape, 1), _normal(kshape, 2), _normal(kshape, 3)
    want = _jax_flash(ht, q, k, v, causal)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == qshape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_bf16(ht, interpret, causal):
    import jax.numpy as jnp

    q, k, v = _normal((2, 4, 37, 16), 4), _normal((2, 4, 37, 16), 5), _normal((2, 4, 37, 16), 6)
    want = _jax_flash(ht, q, k, v, causal, dtype=jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=0)


def test_scale_and_plain_version_match_jax_reference(ht, monkeypatch):
    """With the kernel off, heat_tpu runs ``_attention_ref``, the port's
    plain version's original; an explicit scale reaches both."""
    monkeypatch.setenv("HEAT_TPU_PALLAS", "off")
    import jax.numpy as jnp

    q, k = _normal((3, 40, 16), 7), _normal((3, 33, 16), 8)
    want = np.asarray(ht.ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), causal=True, scale=0.3))
    got = k3.reference_flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_gradient_matches_jax(ht, interpret, causal):
    import jax
    import jax.numpy as jnp

    q, k, v = _normal((2, 3, 24, 8), 9), _normal((2, 3, 24, 8), 10), _normal((2, 3, 24, 8), 11)
    w = _normal((2, 3, 24, 8), 12)

    def loss(q_, k_, v_):
        return (ht.ops.flash_attention(q_, k_, v_, causal=causal) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)


def test_incompatible_shapes_raise_in_both(ht, interpret):
    import jax.numpy as jnp

    q, k = np.zeros((2, 5, 8), np.float32), np.zeros((3, 5, 8), np.float32)
    with pytest.raises(ValueError):
        ht.ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    with pytest.raises(ValueError):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))


def test_empty_sequences():
    q = torch.zeros(2, 3, 0, 8)
    assert tuple(flash_attention(q, q, q).shape) == (2, 3, 0, 8)
    kv = torch.zeros(2, 0, 8)
    # no key at all: every row outputs 0, as the kernel's l == 0 rule gives
    assert torch.equal(flash_attention(torch.ones(2, 4, 8), kv, kv), torch.zeros(2, 4, 8))


def test_cpu_path_launches_nothing():
    before = k3.launches
    q = torch.from_numpy(_normal((2, 9, 8), 13))
    flash_attention(q, q, q, causal=True)
    assert k3.launches == before


def test_mixed_devices_raise():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        k3._forward(q, q.to("meta"), q, False, 1.0)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [
    # (bh, sq, sk, d, causal)
    (64, 300, 300, 64, True),
    (3, 40, 40, 16, False),
    (2, 13, 29, 8, False),
    (2, 1000, 1337, 24, True),
    (2, 1000, 1337, 24, False),
    (4, 129, 65, 128, True),
    (2, 70, 70, 200, False),
    (2, 65, 65, 256, True),
    (1, 1, 1, 1, True),
    (2, 65, 0, 8, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("bh,sq,sk,d,causal", CARD_CASES)
def test_kernel_against_plain_on_card(cuda, dtype, bh, sq, sk, d, causal):
    g = torch.Generator(device=cuda).manual_seed(bh * 7 + sq + d)
    q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for n in (sq, sk, sk))
    before = k3.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k3.launches == before + 2
    assert got.dtype == dtype and tuple(got.shape) == (bh, sq, d)
    assert torch.equal(got, again), "reruns are not bitwise equal"
    want = k3.reference_flash_attention(q.float(), k.float(), v.float(), causal=causal)
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= F32_TOL
    else:
        assert bool((diff <= _bound_16(q, k, v, causal, want)).all())


def _bound_16(q, k, v, causal, want):
    """|Δo| allowed to the 16-bit kernel against the f32 plain version
    ``want``: 1e-3 + 2^-7 |o| covers the one rounding of each output (half an
    ulp is 2^-8 |o|); in bf16 the rounding of p before P·V adds up to 2^-8 of
    softmax(s)·|v|, taken from the f32 plain version with |v|."""
    bound = CARD_TOL_16 + 2.0**-7 * want.abs()
    if q.dtype == torch.bfloat16:
        pv = k3.reference_flash_attention(q.float(), k.float(), v.float().abs(), causal=causal)
        bound = bound + 2.0**-8 * pv
    return bound


def _tensor_core_kernels(fn):
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


def _offset(shape, dtype, g, device):
    """A contiguous tensor whose base lies 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=g, device=device).to(dtype)
    return flat[1:].view(shape)


TC_CASES = [
    # (bh, sq, sk, d, dtype, causal, offset base)
    (8, 1024, 1024, 64, torch.bfloat16, True, False),
    (8, 1024, 1024, 64, torch.bfloat16, False, False),
    (4, 700, 900, 256, torch.bfloat16, True, False),
    (4, 700, 900, 256, torch.bfloat16, False, False),
    (4, 1000, 1337, 20, torch.bfloat16, False, False),
    (4, 1000, 1337, 20, torch.bfloat16, True, False),
    (4, 1000, 1337, 24, torch.float16, True, False),
    (2, 333, 517, 128, torch.bfloat16, True, True),
    (2, 333, 517, 72, torch.float16, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,offset", TC_CASES)
def test_tensor_core_geometries_on_card(cuda, bh, sq, sk, d, dtype, causal, offset):
    g = torch.Generator(device=cuda).manual_seed(bh + sq + d)
    if offset:
        q, k, v = (_offset((bh, n, d), dtype, g, cuda) for n in (sq, sk, sk))
        assert q.data_ptr() % 16 != 0
    else:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for n in (sq, sk, sk))
    before = k3.launches
    got = flash_attention(q, k, v, causal=causal)
    assert k3.launches == before + 1
    again = flash_attention(q, k, v, causal=causal)
    want = k3.reference_flash_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (bh, sq, d)
    assert torch.equal(got, again), "reruns are not bitwise equal"
    assert bool(((got.float() - want).abs() <= _bound_16(q, k, v, causal, want)).all())
    names = _tensor_core_kernels(lambda: flash_attention(q, k, v, causal=causal))
    ours = [n for n in names if "flash_fwd_kernel" in n]
    assert len(ours) == 1 and "flash_fwd_kernel_tc" in ours[0], names
    # besides the kernel only the wrapper's copies into aligned buffers run:
    # no library attention, no GEMM, no CUDA-core K3
    assert not any(w in n.lower() for n in names for w in ("sdpa", "fmha", "gemm", "flash_fwd_kernel<float")), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_tensor_core_trace_shows_only_the_new_kernel(cuda, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(16, 4096, 128, generator=g, device=cuda).to(dtype) for _ in range(3))
    flash_attention(q, k, v, causal=causal)
    names = _tensor_core_kernels(lambda: flash_attention(q, k, v, causal=causal))
    assert len(names) == 1 and "flash_fwd_kernel_tc" in names[0], names


@pytest.mark.gpu
def test_kernel_gradient_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 100, 32, generator=g, device=cuda).requires_grad_() for _ in range(3))
    w = torch.randn(2, 4, 100, 32, generator=g, device=cuda)
    (flash_attention(q, k, v, causal=True) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (k3.reference_flash_attention(q, k, v, causal=True) * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert float((a - t.grad).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)
    wide = torch.zeros(1, 4, 257, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)
