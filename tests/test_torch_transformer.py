"""The TransformerLM forward slice: heat_tpu_torch's model, converter,
sequence parallelism and shard-list collectives against heat_tpu on the
CPU, and the model on the card.

A flax ``TransformerLM.init`` (the recipe of tests/test_sequence.py:104-112)
is converted to numpy and loaded by ``transformer_from_flax``; the logits
must agree within 1e-4·max|logit| (f32; the two sum in other orders).
Ring and Ulysses attention are compared with heat_tpu's
``sequence_parallel_attention`` on a 1-D ``("sp",)`` CPU mesh of the same
size as the port's ``MeshComm``, within 1e-5 (unit-normal inputs).
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.ops import attention as k3
from heat_tpu_torch.parallel import collectives
from heat_tpu_torch.parallel.sequence import sequence_parallel_attention

CONFIG = dict(vocab_size=50, num_layers=2, num_heads=4, head_dim=8, max_seq_len=32)
ATTN_TOL = 1e-5


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


@pytest.fixture(scope="module")
def flax_model(ht):
    """(numpy parameter tree, tokens, JAX logits) of the test_sequence recipe."""
    import jax
    import jax.numpy as jnp

    tokens = np.random.default_rng(3).integers(0, 50, (2, 32))
    model = ht.models.TransformerLM(**CONFIG)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    logits = np.asarray(model.apply(variables, jnp.asarray(tokens)))
    params = jax.tree_util.tree_map(np.asarray, variables)
    return params, tokens, logits


def _sp_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


# ---------------------------------------------------------------- the model
def test_logits_match_flax(flax_model):
    params, tokens, want = flax_model
    model = htt.models.transformer_from_flax(params, device="cpu")
    assert (model.vocab_size, model.num_layers, model.num_heads, model.head_dim, model.mlp_ratio, model.max_seq_len) == (
        50, 2, 4, 8, 4, 32
    )
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 32, 50)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_converter_takes_the_tree_without_its_params_key(flax_model):
    params, tokens, want = flax_model
    model = htt.models.transformer_from_flax(params["params"], device="cpu", remat=True)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_converter_rejects_a_disagreeing_width(flax_model):
    with pytest.raises(ValueError, match="num_heads"):
        htt.models.transformer_from_flax(flax_model[0], device="cpu", num_heads=2)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_model_matches_flax(ht, flax_model, strategy):
    import jax.numpy as jnp

    params, tokens, _ = flax_model
    mesh = _sp_mesh(4)
    jax_sp = ht.models.TransformerLM(**CONFIG, attention=strategy, sp_mesh=mesh)
    want = np.asarray(jax_sp.apply(params, jnp.asarray(tokens)))
    model = htt.models.transformer_from_flax(params, device="cpu", attention=strategy, sp_mesh=htt.MeshComm(4))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_model_matches_dense(flax_model, n, strategy):
    params, tokens, _ = flax_model
    dense = htt.models.transformer_from_flax(params, device="cpu")
    sp = htt.models.transformer_from_flax(params, device="cpu", attention=strategy, sp_mesh=htt.MeshComm(n))
    with torch.no_grad():
        want = dense(torch.from_numpy(tokens))
        got = sp(torch.from_numpy(tokens))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_remat_gives_the_same_gradient():
    g = torch.Generator().manual_seed(0)
    model = htt.models.TransformerLM(**CONFIG, device="cpu", generator=g)
    tokens = torch.randint(0, 50, (2, 16), generator=g)
    grads = []
    for remat in (False, True):
        model.remat = remat
        model.zero_grad()
        model(tokens).logsumexp(-1).mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_init_follows_the_flax_initialisers():
    model = htt.models.TransformerLM(vocab_size=4000, num_layers=1, num_heads=4, head_dim=16, max_seq_len=64,
                                     device="cpu", generator=torch.Generator().manual_seed(1))
    model.requires_grad_(False)
    block = model.blocks[0]
    assert abs(float(model.embed.std()) - 1 / 8) < 0.005
    assert abs(float(block.mlp_in.std()) - 1 / 8) < 0.005 and float(block.mlp_in.abs().max()) <= 2 / 8 / 0.8796 + 1e-6
    assert abs(float(block.mlp_out.std()) - 1 / 16) < 0.003
    assert torch.equal(block.norm1.scale, torch.ones(64))


def test_layernorm_matches_flax(ht):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(5).standard_normal((3, 7, 24)).astype(np.float32) * 3 + 1
    ln = nn.LayerNorm(use_bias=False)
    variables = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ln.apply(variables, jnp.asarray(x)))
    got = htt.models.LayerNorm(24, device="cpu")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_moe_experts_raise_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 12"):
        htt.models.TransformerLM(**CONFIG, moe_experts=4, device="cpu")


def test_unknown_attention_raises():
    with pytest.raises(ValueError):
        htt.models.TransformerLM(**CONFIG, attention="sliding", device="cpu")


def test_sequence_parallel_needs_a_mesh():
    model = htt.models.TransformerLM(**CONFIG, attention="ring", device="cpu")
    with pytest.raises(ValueError, match="sp_mesh"):
        model(torch.zeros(1, 8, dtype=torch.int64))


# ------------------------------------------------------- sequence parallelism
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(ht, n, strategy, causal):
    import jax.numpy as jnp
    from heat_tpu.parallel.sequence import sequence_parallel_attention as jax_spa

    q, k, v = _qkv((2, 8, 32, 8), seed=n)
    want = np.asarray(jax_spa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _sp_mesh(n), "sp",
                              causal=causal, strategy=strategy))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = sequence_parallel_attention(tq, tk, tv, htt.MeshComm(n), causal=causal, strategy=strategy)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    dense = htt.ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATTN_TOL, rtol=0)


def test_ulysses_indivisible_heads_raise_in_both(ht):
    import jax.numpy as jnp
    from heat_tpu.parallel.sequence import sequence_parallel_attention as jax_spa

    q = np.zeros((1, 3, 16, 8), np.float32)  # 3 heads over 8 positions
    with pytest.raises(Exception):
        jax_spa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), _sp_mesh(8), "sp", strategy="ulysses")
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="not divisible"):
        sequence_parallel_attention(t, t, t, htt.MeshComm(8), strategy="ulysses")


def test_unknown_strategy_raises_in_both(ht):
    import jax.numpy as jnp
    from heat_tpu.parallel.sequence import sequence_parallel_attention as jax_spa

    q = np.zeros((1, 8, 16, 8), np.float32)
    with pytest.raises(ValueError, match="unknown strategy"):
        jax_spa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), _sp_mesh(4), "sp", strategy="tree")
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="unknown strategy"):
        sequence_parallel_attention(t, t, t, htt.MeshComm(4), strategy="tree")


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_uneven_sequence_raises_in_both(ht, strategy):
    import jax.numpy as jnp
    from heat_tpu.parallel.sequence import sequence_parallel_attention as jax_spa

    q = np.zeros((1, 8, 10, 8), np.float32)  # 10 rows over 4 positions
    with pytest.raises(Exception):
        jax_spa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), _sp_mesh(4), "sp", strategy=strategy)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="does not divide"):
        sequence_parallel_attention(t, t, t, htt.MeshComm(4), strategy=strategy)


def test_ulysses_launches_once_per_position_on_cpu_path_none():
    q = torch.from_numpy(_qkv((1, 8, 16, 8), 0)[0])
    before = k3.launches
    sequence_parallel_attention(q, q, q, htt.MeshComm(4), strategy="ulysses")
    assert k3.launches == before  # the CPU takes the plain version


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("split_axis,concat_axis", [(0, 1), (1, 0), (1, 2)])
def test_all_to_all_matches_numpy(n, split_axis, concat_axis):
    rng = np.random.default_rng(n)
    blocks = [rng.standard_normal((8, 16, 3)).astype(np.float32) for _ in range(n)]
    got = collectives.all_to_all([torch.from_numpy(b) for b in blocks], split_axis, concat_axis)
    for i in range(n):
        want = np.concatenate([np.split(blocks[j], n, axis=split_axis)[i] for j in range(n)], axis=concat_axis)
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_all_to_all_raises_on_an_indivisible_split():
    with pytest.raises(ValueError):
        collectives.all_to_all([torch.zeros(3, 4)] * 2, split_axis=0, concat_axis=1)


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ring_shift_matches_numpy(n, shift):
    blocks = [np.full((2, 3), i, np.float32) for i in range(n)]
    got = collectives.ring_shift([torch.from_numpy(b) for b in blocks], shift=shift)
    for i in range(n):
        np.testing.assert_array_equal(got[(i + shift) % n].numpy(), blocks[i])


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_on_card_matches_cpu_and_launches_once_per_layer(cuda):
    g = torch.Generator().manual_seed(0)
    cpu_model = htt.models.TransformerLM(**CONFIG, device="cpu", generator=g)
    card_model = htt.models.TransformerLM(**CONFIG, device="gpu")
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, 50, (2, 32), generator=g)
    before = k3.launches
    with torch.no_grad():
        got = card_model(tokens.to(cuda))
        want = cpu_model(tokens)
    torch.cuda.synchronize()
    assert k3.launches == before + CONFIG["num_layers"]
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_on_card(cuda, strategy):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 8, 256, 64, generator=g, device=cuda) for _ in range(3))
    before = k3.launches
    got = sequence_parallel_attention(q, k, v, htt.MeshComm(4), causal=True, strategy=strategy)
    torch.cuda.synchronize()
    assert k3.launches == before + (4 if strategy == "ulysses" else 0)
    want = k3.reference_flash_attention(q, k, v, causal=True)
    assert float((got - want).abs().max()) <= ATTN_TOL
