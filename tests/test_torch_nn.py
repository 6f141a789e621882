"""Data-parallel training: ``heat_tpu_torch.nn`` (DataParallel,
DataParallelMultiGPU), the MLP, the ResNets and the TransformerLM against
heat_tpu's flax models on the CPU.

Each case initialises the flax model through heat_tpu's ``DataParallel``,
carries its variables across with the converters, and runs the same
``train_step`` on both for several steps.  Losses must agree within 1e-5
relative and parameters (and BatchNorm statistics) within 1e-5 absolute
after the steps (f32; the two sum in other orders).  DASO's per-slice
parameters and sync schedule are held to heat_tpu's two-tier runs on a
(dcn=2, ici=2) mesh.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _jcomm(ht, n):
    return ht.parallel.mesh.local_mesh(n)


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _train_both(ht, flax_module, convert, opt_name, opt_kw, x, y, mesh, steps=3):
    """(losses of heat_tpu, losses of the port, heat_tpu's model, the port's
    wrapper) after ``steps`` steps from the same variables."""
    import optax

    jc, tc = _jcomm(ht, mesh), htt.MeshComm(mesh)
    jm = ht.nn.DataParallel(flax_module, comm=jc,
                            optimizer=ht.optim.DataParallelOptimizer(getattr(optax, opt_name)(**opt_kw)))
    jm.init(0, x)
    module = convert(_numpy_tree(jm.variables))
    tm = htt.nn.DataParallel(module, comm=tc, optimizer=htt.optim.DataParallelOptimizer(
        getattr(htt.optim, opt_name)(**opt_kw))).init(0, x)
    lj, lt = [], []
    for _ in range(steps):
        lj.append(float(jm.train_step(ht.array(x, split=0, comm=jc), ht.array(y, split=0, comm=jc))))
        loss = tm.train_step(htt.array(x, split=0, comm=tc, device="cpu"), htt.array(y, split=0, comm=tc, device="cpu"))
        assert loss.ndim == 0 and loss.device.type == "cpu"
        lt.append(float(loss))
    return lj, lt, jm, tm


# ------------------------------------------------------------------------ MLP
@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(16, 3, 4)).astype(np.float32), rng.integers(0, 5, 16)


@pytest.mark.parametrize("mesh, opt_name, opt_kw", [
    (1, "sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True}),
    (4, "sgd", {"learning_rate": 0.05}),
    (8, "sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    (4, "adam", {"learning_rate": 0.02}),
    (4, "adamw", {"learning_rate": 0.02}),
    (8, "rmsprop", {"learning_rate": 0.01}),
    (1, "adagrad", {"learning_rate": 0.1}),
])
def test_mlp_train_steps_match(ht, mlp_data, mesh, opt_name, opt_kw):
    x, y = mlp_data
    lj, lt, jm, tm = _train_both(ht, ht.models.MLP(features=(32, 5)),
                                 lambda v: htt.models.mlp_from_flax(v, device="cpu"), opt_name, opt_kw, x, y, mesh)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    assert lj[-1] < lj[0]
    want = _flat(_numpy_tree(jm.variables["params"]))
    for i, layer in enumerate(tm.module.layers):
        np.testing.assert_allclose(layer.kernel.detach().numpy(), want[f"Dense_{i}/kernel"], atol=PARAM_ATOL)
        np.testing.assert_allclose(layer.bias.detach().numpy(), want[f"Dense_{i}/bias"], atol=PARAM_ATOL)
    # the forward wraps a DNDarray input's result split 0
    xd = htt.array(x, split=0, comm=htt.MeshComm(mesh), device="cpu")
    out = tm(xd)
    assert isinstance(out, htt.DNDarray) and out.split == 0 and out.shape == (16, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm(ht.array(x, split=0, comm=_jcomm(ht, mesh))).larray),
                               atol=PARAM_ATOL)
    assert isinstance(tm.forward(x), torch.Tensor)


def test_mse_loss_for_float_targets(ht, mlp_data):
    x, _ = mlp_data
    y = np.random.default_rng(1).normal(size=(16, 5)).astype(np.float32)
    lj, lt, _, _ = _train_both(ht, ht.models.MLP(features=(8, 5)), lambda v: htt.models.mlp_from_flax(v, device="cpu"),
                               "sgd", {"learning_rate": 0.1}, x, y, 4, steps=2)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)


def test_init_draws_a_deferred_module_from_the_generator(mlp_data):
    x, y = mlp_data
    a = htt.nn.DataParallel(htt.models.MLP((8, 5), device="cpu"), optimizer=htt.optim.DataParallelOptimizer(
        htt.optim.sgd(0.1))).init(3, x)
    b = htt.nn.DataParallel(htt.models.MLP((8, 5), device="cpu"), optimizer=htt.optim.DataParallelOptimizer(
        htt.optim.sgd(0.1))).init(torch.Generator().manual_seed(3), x)
    assert a.module.layers[0].kernel.shape == (12, 8)
    assert torch.equal(a.module.layers[0].kernel, b.module.layers[0].kernel)
    ready = htt.models.MLP((8, 5), in_features=12, device="cpu")
    before = ready.layers[0].kernel.detach().clone()
    htt.nn.DataParallel(ready, optimizer=htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1))).init(99, x)
    assert torch.equal(ready.layers[0].kernel, before)
    with pytest.raises(RuntimeError):
        htt.nn.DataParallel(htt.models.MLP((8, 5), device="cpu")).train_step(x, y)
    with pytest.raises(TypeError, match="DataParallelMultiGPU"):
        daso = htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1)), comm=htt.MeshComm(2))
        htt.nn.DataParallel(htt.models.MLP((8, 5), device="cpu"), optimizer=daso).init(0, x)


# --------------------------------------------------------------------- ResNet
RESNET_CASES = {
    "basic": dict(block="BasicBlock", s2d=False, mesh=4),
    "bottleneck-s2d": dict(block="BottleneckBlock", s2d=True, mesh=8),
}


@pytest.mark.parametrize("name", list(RESNET_CASES))
def test_resnet_train_steps_match(ht, name):
    # one test a case: heat_tpu's compile of the DP step is most of its time
    import jax.numpy as jnp
    from heat_tpu.models import resnet as jr

    case = RESNET_CASES[name]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    if case["s2d"]:
        x2 = np.asarray(jr.space_to_depth(x))
        np.testing.assert_array_equal(htt.models.resnet.space_to_depth(torch.from_numpy(x)).numpy(), x2)
        x = x2
    y = rng.integers(0, 5, 8)
    net = jr.ResNet(stage_sizes=(1, 1), block_cls=getattr(jr, case["block"]), num_filters=8, num_classes=5,
                    s2d_stem=case["s2d"])
    convert = lambda v, **kw: htt.models.resnet_from_flax(v, stage_sizes=(1, 1), s2d_stem=case["s2d"], device="cpu", **kw)
    lj, lt, jm, tm = _train_both(ht, net, convert, "sgd", {"learning_rate": 0.1, "momentum": 0.9}, x, y, case["mesh"])
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    assert lj[-1] < lj[0]
    want = convert(_numpy_tree(jm.variables)).state_dict()
    got = tm.module.state_dict()
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=PARAM_ATOL, err_msg=key)
    # the BatchNorm statistics moved (momentum 0.9 toward the batch's)
    assert not np.allclose(got["bn_init.var"].numpy(), 1.0)
    # the eval forward normalises with the running statistics
    out = tm(x)
    assert out.dtype == torch.float32 and out.shape == (8, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm(ht.array(x)).larray), atol=PARAM_ATOL)
    # bf16: convolutions and the dense layer in bf16, statistics in f32, f32 logits
    net16 = jr.ResNet(stage_sizes=(1, 1), block_cls=getattr(jr, case["block"]), num_filters=8, num_classes=5,
                      s2d_stem=case["s2d"], dtype=jnp.bfloat16)
    want16 = np.asarray(net16.apply(jm.variables, jnp.asarray(x)))
    model16 = convert(_numpy_tree(jm.variables), dtype=torch.bfloat16)
    got16 = model16(torch.from_numpy(x)).detach()
    assert got16.dtype == torch.float32 and model16.bn_init.mean.dtype == torch.float32
    # bf16 products round at other places in the two libraries
    np.testing.assert_allclose(got16.numpy(), want16, atol=0.05 * np.abs(want16).max())


def test_same_padding_is_xla_s():
    from heat_tpu_torch.models.resnet import _same_pads

    assert _same_pads(16, 3, 2) == (0, 1) and _same_pads(15, 3, 2) == (1, 1) and _same_pads(8, 1, 2) == (0, 0)
    assert _same_pads(16, 3, 1) == (1, 1) and _same_pads(16, 7, 2) == (2, 3)


# -------------------------------------------------------------- TransformerLM
def test_transformer_train_steps_match(ht):
    config = dict(vocab_size=50, num_layers=2, num_heads=4, head_dim=8, max_seq_len=32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 50, (4, 32))
    targets = np.roll(tokens, -1, axis=1)
    convert = lambda v: htt.models.transformer_from_flax(v, device="cpu", attention="flash")
    lj, lt, jm, tm = _train_both(ht, ht.models.TransformerLM(**config), convert, "adam", {"learning_rate": 1e-2},
                                 tokens, targets, 4, steps=3)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    assert lj[-1] < lj[0]
    want = convert(_numpy_tree(jm.variables)).state_dict()
    for name, value in tm.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL, err_msg=name)


# ----------------------------------------------------------------------- DASO
def _daso_pair(ht, optax_tx, port_tx, warmup=0, cooldown=0, total=10):
    import jax
    from jax.sharding import Mesh
    from heat_tpu.parallel.mesh import MeshComm

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    jc = MeshComm(mesh, split_axis="ici")
    jd = ht.optim.DASO(ht.optim.DataParallelOptimizer(optax_tx), mesh=mesh, comm=jc, total_epochs=total,
                       warmup_epochs=warmup, cooldown_epochs=cooldown)
    jm = ht.nn.DataParallelMultiGPU(ht.models.MLP(features=(8, 2)), comm=jc, optimizer=jd)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = rng.integers(0, 2, 32)
    jm.init(0, x[:4])
    first = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], jm.variables)
    td = htt.optim.DASO(htt.optim.DataParallelOptimizer(port_tx), mesh=(2, 2), comm=htt.MeshComm(4), total_epochs=total,
                        warmup_epochs=warmup, cooldown_epochs=cooldown)
    tm = htt.nn.DataParallelMultiGPU(htt.models.mlp_from_flax(first, device="cpu"), comm=htt.MeshComm(4), optimizer=td)
    tm.init(0, x[:4])
    return jd, jm, td, tm, x, y


def _slices(jm, tm):
    wj = np.asarray(jm.variables["params"]["Dense_0"]["kernel"])
    wt = np.stack([r.layers[0].kernel.detach().numpy() for r in tm.replicas])
    return wj, wt


def test_daso_slices_and_sync_schedule_match(ht):
    import optax

    jd, jm, td, tm, x, y = _daso_pair(ht, optax.sgd(0.1, momentum=0.9), htt.optim.sgd(0.1, momentum=0.9))
    assert td.n_slices == jd.n_slices == 2 and len(tm.replicas) == 2
    for d in (jd, td):
        d.global_skip, d.batches_seen = 3, 1
    for step in range(2, 9):
        lj = float(jm.train_step(ht.array(x), ht.array(y)))
        lt = float(tm.train_step(htt.array(x, device="cpu"), htt.array(y, device="cpu")))
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
        assert td.batches_seen == jd.batches_seen == step
        wj, wt = _slices(jm, tm)
        np.testing.assert_allclose(wt, wj, atol=PARAM_ATOL)
        synced = step % 3 == 0
        assert np.allclose(wt[0], wt[1], rtol=1e-6, atol=1e-7) == synced == np.allclose(wj[0], wj[1], rtol=1e-6, atol=1e-7)
    # inference uses the slice mean
    np.testing.assert_allclose(tm(htt.array(x, device="cpu")).numpy(), np.asarray(jm(ht.array(x)).larray),
                               atol=PARAM_ATOL)


def test_daso_warmup_and_cooldown_sync_every_step(ht):
    import optax

    jd, jm, td, tm, x, y = _daso_pair(ht, optax.sgd(0.1), htt.optim.sgd(0.1), warmup=2, cooldown=2, total=6)
    assert td.phase == jd.phase == "warmup"
    for epoch in (0, 5):
        for d in (jd, td):
            d.epoch, d.global_skip = epoch, 8
        assert td.phase == jd.phase
        for _ in range(2):
            jm.train_step(ht.array(x), ht.array(y))
            tm.train_step(x, y)
            wj, wt = _slices(jm, tm)
            assert np.allclose(wt[0], wt[1]) and np.allclose(wj[0], wj[1])
            np.testing.assert_allclose(wt, wj, atol=PARAM_ATOL)


def test_daso_phase_machine_matches(ht):
    import optax

    jd, _, td, _, _, _ = _daso_pair(ht, optax.sgd(0.1), htt.optim.sgd(0.1), total=20)
    for d in (jd, td):
        d.epoch, d.global_skip, d._last_losses = 1, 2, [1.0]
    for loss in (0.999, 0.998, 1.5, 1.2, 1.19, 1.189):
        jd.epoch_loss_logic(loss)
        td.epoch_loss_logic(loss)
        assert td.global_skip == jd.global_skip and td.local_skip == jd.local_skip
    for loss in (1.0, 0.9, 0.89):
        jd.next_epoch(loss)
        td.next_epoch(loss)
        assert (td.epoch, td.phase, td.global_skip) == (jd.epoch, jd.phase, jd.global_skip)
    td.reset()
    assert (td.epoch, td.global_skip, td.batches_seen) == (0, 0, 0)
    with pytest.raises(ValueError):
        htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1)), mesh=(3, 2), comm=htt.MeshComm(4))
    assert htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1)), comm=htt.MeshComm(4)).n_slices == 1


# -------------------------------------------------------- names and functional
def test_nn_falls_through_to_torch_and_linear_matches(ht):
    assert htt.nn.Linear is torch.nn.Linear and htt.nn.functional.relu is torch.nn.functional.relu
    with pytest.raises(AttributeError):
        htt.nn.no_such_layer
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    w = rng.normal(size=(3, 6)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    for mesh in (1, 4):
        jc = _jcomm(ht, mesh)
        want = ht.nn.functional.linear(ht.array(x, split=0, comm=jc), ht.array(w, comm=jc), ht.array(b, comm=jc))
        got = htt.nn.functional.linear(htt.array(x, split=0, comm=htt.MeshComm(mesh), device="cpu"),
                                       htt.array(w, device="cpu", comm=htt.MeshComm(mesh)),
                                       htt.array(b, device="cpu", comm=htt.MeshComm(mesh)))
        assert got.split == want.split
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-5)
