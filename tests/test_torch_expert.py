"""``heat_tpu_torch.parallel.expert`` and the mixture-of-experts
TransformerLM against heat_tpu on the CPU: the same numpy tokens and
weights through heat_tpu's ``moe_ffn`` (``shard_map`` with real
``all_to_all``s over an "ep" mesh of n CPU devices, or its ``mesh=None``
path) and the port's (shard-list collectives over ``MeshComm(n)``), at
meshes 1, 4 and 8.  The mirror is ``tests/test_expert.py``.

Tolerance: routing is held exactly (expert choices, slot positions, the
kept mask, so the same choices are dropped); ``fraction_dropped`` is equal;
outputs and the load-balancing loss agree to 1e-5 relative (f32 products
and softmax summed in other orders); gradients through router and experts
to 1e-5 relative of their largest entry; the MoE LM's logits to 1e-4 of
their largest entry, as the dense LM's test holds them.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import expert as tex

MESHES = (1, 4, 8)
D, H, E = 16, 32, 8


@pytest.fixture(scope="module")
def jex():
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    from heat_tpu.parallel import expert

    return expert


def _mesh(n):
    if n is None:
        return None, None
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("ep",)), htt.MeshComm(n)


def _params(seed, d=D, h=H, e=E):
    rng = np.random.default_rng(seed)
    gate = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    w_in = (rng.standard_normal((e, d, h)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.standard_normal((e, h, d)) / np.sqrt(h)).astype(np.float32)
    return gate, w_in, w_out


def _jitted(fn, **kw):
    """heat_tpu's function compiled whole by ``jax.jit`` (op by op it
    dispatches and compiles each op alone, ~20x slower on the CPU)."""
    import functools

    import jax

    return jax.jit(functools.partial(fn, **kw))


def _both(jex, x, params, n, **kw):
    import jax.numpy as jnp

    jm, tm = _mesh(n)
    yj, aj = _jitted(jex.moe_ffn, mesh=jm, axis="ep", **kw)(jnp.asarray(x), *map(jnp.asarray, params))
    yt, at = tex.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, params), mesh=tm, axis="ep", **kw)
    return (np.asarray(yj), {k: float(v) for k, v in aj.items()}), (yt.numpy(), {k: float(v) for k, v in at.items()})


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()), 1e-30))


# (mesh, k, capacity factor): meshes None, 1, 4 and 8, two with nothing
# dropped and two that drop (heat_tpu traces and compiles each expert-parallel
# call anew, ~5 s of CPU, so the cases are few)
CASES = [(None, 2, 16.0), (1, 2, 1.0), (4, 1, 0.5), (8, 2, 16.0)]


@pytest.mark.parametrize("n, k, cf", CASES)
def test_moe_ffn_matches_heat_tpu_and_drops_the_same_choices(jex, n, k, cf):
    x = np.random.default_rng(2).standard_normal((64, D)).astype(np.float32)
    params = _params(3)
    (yj, aj), (yt, at) = _both(jex, x, params, n, k=k, capacity_factor=cf)
    assert at["fraction_dropped"] == aj["fraction_dropped"]
    assert (at["fraction_dropped"] > 0) == (cf < 2)
    np.testing.assert_allclose(at["load_balance_loss"], aj["load_balance_loss"], rtol=1e-5)
    _close(yt, yj)
    # the drop pattern itself, shard by shard, from the same logits
    import jax.numpy as jnp

    shards = 1 if n is None else n
    cap = tex.expert_capacity(x.shape[0] // shards, E, k, cf)
    for xs in np.split(x, shards):
        logits = xs @ params[0]
        rj = jex._route(jnp.asarray(logits), k, cap)
        rt = tex._route(torch.from_numpy(logits), k, cap)
        for a, b in zip(rj[1:4], rt[1:4]):  # top_idx, pos_in_expert, kept
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_router_ties_break_as_lax_top_k(jex):
    import jax.numpy as jnp

    # every expert equally likely on some rows, pairwise ties on others
    logits = np.zeros((6, E), np.float32)
    logits[1, [3, 5]] = 2.0
    logits[2, [7, 0, 4]] = 1.0
    logits[3] = np.repeat([0.5, -0.5], E // 2)
    rj = jex._route(jnp.asarray(logits), 3, 4)
    rt = tex._route(torch.from_numpy(logits), 3, 4)
    for a, b in zip(rj[:4], rt[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    dj = jex.top_k_routing(jnp.asarray(logits), 2, 2)
    dt = tex.top_k_routing(torch.from_numpy(logits), 2, 2)
    for a, b in zip(dj[:2], dt[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n", [None])
def test_leading_dims_are_flattened(jex, n):
    x = np.random.default_rng(4).standard_normal((2, 16, D)).astype(np.float32)
    (yj, _), (yt, _) = _both(jex, x, _params(5), n, k=1, capacity_factor=8.0)
    assert yt.shape == x.shape
    _close(yt, yj)


def test_errors_match_heat_tpu(jex):
    import jax.numpy as jnp

    gate, w_in, w_out = _params(0)
    jm, tm = _mesh(8)
    for fn, mesh, conv in ((jex.moe_ffn, jm, jnp.asarray), (tex.moe_ffn, tm, torch.from_numpy)):
        with pytest.raises(ValueError, match="token count 12"):
            fn(conv(np.zeros((12, D), np.float32)), conv(gate), conv(w_in), conv(w_out), mesh=mesh)
        g6 = np.zeros((D, 6), np.float32)
        with pytest.raises(ValueError, match="num_experts 6"):
            fn(conv(np.zeros((16, D), np.float32)), conv(g6), conv(w_in[:6]), conv(w_out[:6]), mesh=mesh)

    from heat_tpu_torch.core import quantize as tq

    x = torch.zeros(16, D)
    qin = tq.quantize_tensor(torch.from_numpy(w_in), "int8", axis=(0, 2))
    with pytest.raises(ValueError, match="both"):
        tex.moe_ffn(x, torch.from_numpy(gate), qin, torch.from_numpy(w_out))
    # quantized experts are ported; scales on other axes are refused
    wrong = tq.quantize_tensor(torch.from_numpy(w_in), "int8", axis=-1)
    with pytest.raises(ValueError, match=r"axis=\(0, 2\)"):
        tex.moe_ffn(x, torch.from_numpy(gate), wrong, wrong)


@pytest.mark.parametrize("n", [None, 4])
def test_gradients_match_jax_grad(jex, n):
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(6).standard_normal((32, D)).astype(np.float32)
    params = _params(7)
    jm, tm = _mesh(n)

    def loss_j(a, g, wi, wo):
        y, aux = jex.moe_ffn(a, g, wi, wo, k=2, capacity_factor=1.0, mesh=jm, axis="ep")
        return jnp.mean(y * y) + 0.01 * aux["load_balance_loss"]

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(jnp.asarray(x), *map(jnp.asarray, params))
    ts = [torch.tensor(a, requires_grad=True) for a in (x,) + params]
    y, aux = tex.moe_ffn(*ts, k=2, capacity_factor=1.0, mesh=tm)
    assert float(aux["fraction_dropped"]) > 0  # gradients through a drop too
    (torch.mean(y * y) + 0.01 * aux["load_balance_loss"]).backward()
    for name, a, b in zip(("x", "gate", "w_in", "w_out"), gj, ts):
        assert np.abs(np.asarray(a)).max() > 0, name
        _close(b.grad.numpy(), np.asarray(a), rtol=1e-5)


def test_reruns_are_bitwise_equal():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((64, D)).astype(np.float32))
    params = [torch.from_numpy(p) for p in _params(9)]
    y1, _ = tex.moe_ffn(x, *params, capacity_factor=1.0, mesh=htt.MeshComm(4))
    y2, _ = tex.moe_ffn(x, *params, capacity_factor=1.0, mesh=htt.MeshComm(4))
    assert torch.equal(y1, y2)


LM = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8, max_seq_len=32, moe_experts=8, moe_k=2)


# the LM on the single-shard path in both packages (heat_tpu traces its
# expert-parallel model twice, init and apply, ~20 s of CPU; the ffn cases
# above hold that path)
@pytest.mark.parametrize("n", [None])
def test_moe_lm_forward_and_aux_losses_from_flax(jex, n):
    import jax
    import jax.numpy as jnp

    import heat_tpu as ht

    jm, tm = _mesh(n)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    lm = ht.models.TransformerLM(**LM, ep_mesh=jm)
    variables = jax.jit(lm.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    logits, state = _jitted(lm.apply, mutable=["intermediates"])(variables, jnp.asarray(tokens))
    want_aux = [float(v) for v in jax.tree.leaves(state["intermediates"])]
    params = jax.tree_util.tree_map(np.asarray, variables)

    model = htt.models.transformer_from_flax(params, device="cpu", moe_k=2, ep_mesh=tm)
    assert model.blocks[0].moe.num_experts == 8 and model.mlp_ratio == 4
    assert isinstance(model.blocks[0].moe, htt.models.MoEMlp)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    want = np.asarray(logits)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    got_aux = [float(a) for a in model.moe_aux_losses()]
    assert len(got_aux) == len(want_aux) == 2
    np.testing.assert_allclose(got_aux, want_aux, rtol=1e-5)


def test_moe_lm_trains_through_remat_and_the_aux_losses():
    gen = torch.Generator().manual_seed(0)
    model = htt.models.TransformerLM(**LM, ep_mesh=htt.MeshComm(4), remat=True, device="cpu", generator=gen)
    tokens = torch.randint(0, 64, (2, 16), generator=gen)
    logits = model(tokens)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), tokens.reshape(-1))
    (loss + 0.01 * sum(model.moe_aux_losses())).backward()
    gate = model.blocks[0].moe.gate.grad
    assert gate is not None and bool(torch.isfinite(gate).all()) and float(gate.abs().max()) > 0
    assert htt.models.TransformerLM(**{**LM, "moe_experts": 0}, device="cpu").moe_aux_losses() == []


# ------------------------------------------------------- quantized experts
# (mesh, k, capacity factor, dtype): the single-shard path and the
# expert-parallel one, with and without drops
QCASES = [(None, 2, 16.0, "int8"), (None, 2, 0.5, "fp8"), (4, 1, 0.5, "int8"), (8, 2, 16.0, "fp8")]


def _force_arm(mods, geometry, arm):
    """Drive each autotune module's ``moe_ffn`` entry to resolve to
    ``arm`` with the same observe sequence (no wall clock involved)."""
    for a in mods:
        key = a.quant_key("moe_ffn", *geometry)
        a.decide(key, "bf16", arms=a.QUANT_ARMS)
        for _ in range(a.explore_k()):
            a.observe(key, "bf16", 1.0 if arm == "int8" else 0.1)
            a.observe(key, "int8", 0.1 if arm == "int8" else 1.0)


@pytest.mark.parametrize("arm", ["bf16", "int8"])
@pytest.mark.parametrize("n, k, cf, dtype", QCASES)
def test_quantized_moe_ffn_matches_heat_tpu_on_both_arms(jex, n, k, cf, dtype, arm):
    import jax.numpy as jnp
    from heat_tpu.core import autotune as JA
    from heat_tpu.core import quantize as JQ

    from heat_tpu_torch.core import autotune as TA
    from heat_tpu_torch.core import quantize as TQ

    x = np.random.default_rng(12).standard_normal((64, D)).astype(np.float32)
    gate, w_in, w_out = _params(13)
    qj = [JQ.quantize_tensor(jnp.asarray(w), dtype, axis=(0, 2)) for w in (w_in, w_out)]
    qt = [TQ.quantize_tensor(torch.from_numpy(w), dtype, axis=(0, 2)) for w in (w_in, w_out)]
    for a, b in zip(qj, qt):
        # the weights' grid is heat_tpu's, bit for bit
        assert a.axes == b.axes == (0, 2) and a.orig_dtype == b.orig_dtype == "float32"
        np.testing.assert_array_equal(np.asarray(a.q).view(np.uint8), b.q.view(torch.uint8).numpy())
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    prev = (TA.set_enabled(True), JA.set_enabled(True))
    try:
        TA.reset()
        JA.reset()
        hits = (TA.stats()["cache_hits"], JA.stats()["cache_hits"], TQ.stats()["by_arm"][arm])
        _force_arm((TA, JA), (64, D, H, E, 1 if n is None else n, k, TQ.autotune.dtype_name(qt[0].q.dtype)), arm)
        jm, tm = _mesh(n)
        yj, aj = jex.moe_ffn(jnp.asarray(x), jnp.asarray(gate), *qj, k=k, capacity_factor=cf, mesh=jm, axis="ep")
        with torch.no_grad():
            yt, at = tex.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate), *qt, k=k, capacity_factor=cf, mesh=tm)
        # one served decision in each package, for the forced arm
        assert (TA.stats()["cache_hits"] - hits[0], JA.stats()["cache_hits"] - hits[1]) == (1, 1)
        assert TQ.stats()["by_arm"][arm] - hits[2] == 1
    finally:
        TA.set_enabled(prev[0])
        JA.set_enabled(prev[1])
        TA.reset()
        JA.reset()
    _close(yt.numpy(), np.asarray(yj))
    assert float(at["fraction_dropped"]) == float(aj["fraction_dropped"])
    assert (float(at["fraction_dropped"]) > 0) == (cf < 1)
    if arm == "bf16":
        # the reference arm is bitwise the unquantized flow over the
        # dequantized weights
        yd, _ = tex.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate), *map(TQ.dequantize_tensor, qt), k=k,
                            capacity_factor=cf, mesh=tm)
        np.testing.assert_array_equal(yt.numpy(), yd.numpy())


def test_quantized_moe_under_autograd_takes_bf16_untimed():
    from heat_tpu_torch.core import autotune as TA
    from heat_tpu_torch.core import quantize as TQ

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((32, D)).astype(np.float32)).requires_grad_()
    gate, w_in, w_out = (torch.from_numpy(p) for p in _params(4))
    qw = [TQ.quantize_tensor(w, "int8", axis=(0, 2)) for w in (w_in, w_out)]
    prev = TA.set_enabled(True)
    try:
        TA.reset()
        assert TQ.declines_to_reference(x) and not TQ.declines_to_reference(x.detach())
        y, _ = tex.moe_ffn(x, gate, *qw, k=2, mesh=htt.MeshComm(4))
        assert TA.table() == {}
        y.sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        with torch.no_grad():
            tex.moe_ffn(x, gate, *qw, k=2, mesh=htt.MeshComm(4))
        assert len(TA.table()) == 1
    finally:
        TA.set_enabled(prev)
        TA.reset()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_moemlp_quantize_through_transformer_from_flax(jex, dtype):
    import jax
    import jax.numpy as jnp

    import heat_tpu as ht
    from heat_tpu.core import quantize as JQ
    from heat_tpu.models.transformer import MoEMlp as JMoE

    from heat_tpu_torch.core import quantize as TQ

    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    lm = ht.models.TransformerLM(**LM)
    variables = jax.jit(lm.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params = jax.tree_util.tree_map(np.asarray, variables)
    # heat_tpu's model serves quantized experts through MoEMlp only: its
    # reference here is the LM with each expert weight quantized and
    # dequantized by heat_tpu (the bf16 arm's values)
    deq = jax.tree_util.tree_map(np.asarray, variables)
    for name, blk in deq["params"].items():
        if name.startswith("block_"):
            for w in ("w_in", "w_out"):
                blk["moe"][w] = np.asarray(JQ.dequantize_tensor(JQ.quantize_tensor(jnp.asarray(blk["moe"][w]), dtype,
                                                                                   axis=(0, 2))))
    want = np.asarray(jax.jit(lm.apply)(deq, jnp.asarray(tokens)))
    model = htt.models.transformer_from_flax(params, device="cpu", moe_quantize=dtype)
    assert all(b.moe.quantize == dtype for b in model.blocks)
    plain = htt.models.transformer_from_flax(deq, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
        # the plane is off in the suite: the bf16 arm, bitwise the
        # unquantized model over the dequantized weights
        np.testing.assert_array_equal(got, plain(torch.from_numpy(tokens)).numpy())
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    # the layer alone against heat_tpu's MoEMlp(quantize=)
    x = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(np.float32)
    layer = JMoE(num_experts=8, hidden=128, quantize=dtype)
    lv = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(layer.apply(lv, jnp.asarray(x)))
    port = htt.models.MoEMlp(8, 128, quantize=dtype, dim=32, device="cpu")
    with torch.no_grad():
        for name in ("gate", "w_in", "w_out"):
            getattr(port, name).copy_(torch.from_numpy(np.asarray(lv["params"][name])))
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    assert TQ.stats()["quantized"] > 0
