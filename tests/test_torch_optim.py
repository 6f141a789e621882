"""``heat_tpu_torch.optim``: optax's optimizers and schedules, the plateau
detector and the optimizer wrappers against heat_tpu and optax on the CPU.

Each of the eight ported optimizers takes 3 steps from the same parameters
and gradients as optax's at optax's defaults; parameters must agree within
1e-6 relative (f32, the two round the moment updates in other orders).  The
schedules are compared at steps 0..20 within 1e-6 relative (optax computes
in f32, the port in f64).
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


CASES = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adam", {}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.1}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True, "momentum": 0.5}),
    ("rmsprop", {"eps_in_sqrt": False, "initial_scale": 0.5}),
    ("adagrad", {}),
    ("adadelta", {}),
    ("adadelta", {"rho": 0.5, "weight_decay": 0.1}),
    ("lamb", {}),
    ("lamb", {"weight_decay": 0.1}),
    ("lars", {}),
    ("lars", {"weight_decay": 0.1, "nesterov": True}),
    ("lars", {"trust_ratio_mask": False, "momentum": 0.5, "eps": 1e-3}),
]


@pytest.mark.parametrize("name, kw", CASES)
def test_optimizers_follow_optax(ht, name, kw):
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(len(name) + len(kw))
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    tx = getattr(optax, name)(0.05, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = getattr(htt.optim, name)(0.05, **kw)(list(tp.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=f"{name} {kw} {k}")


def test_adadelta_without_a_learning_rate_follows_optax(ht):
    # optax.adadelta's default learning_rate=None scales by nothing, so its
    # update is not negated either; the port follows it
    import jax.numpy as jnp
    import optax

    g = np.array([0.5, -1.0, 2.0], np.float32)
    tx = optax.adadelta()
    p = jnp.ones(3, jnp.float32)
    state = tx.init(p)
    t = torch.nn.Parameter(torch.ones(3))
    opt = htt.optim.adadelta()([t])
    for _ in range(4):
        u, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, u)
        t.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=1e-6)
    assert float(t.detach()[0]) > 1.0  # moved with the gradient, as optax's does


def test_optax_defaults_are_not_torchs():
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert htt.optim.adamw(1e-3)(p).defaults["weight_decay"] == 1e-4
    assert torch.optim.AdamW(p).defaults["weight_decay"] == 1e-2
    assert htt.optim.rmsprop(1e-3)(p).defaults["decay"] == 0.9
    assert htt.optim.adagrad(1e-3)(p).defaults["initial_accumulator_value"] == 0.1


def test_learning_rate_schedules_drive_the_optimizers(ht):
    import jax.numpy as jnp
    import optax

    sched = htt.optim.lr_scheduler.StepLR(0.1, 3, 0.5)
    tx = optax.sgd(ht.optim.lr_scheduler.StepLR(0.1, 3, 0.5))
    p = torch.nn.Parameter(torch.ones(3))
    opt = htt.optim.sgd(sched)([p])
    jp = jnp.ones(3)
    state = tx.init(jp)
    for _ in range(7):
        updates, state = tx.update(jnp.ones(3), state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.ones(3)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6)


@pytest.mark.parametrize("name, args", [("StepLR", (0.1, 4, 0.5)), ("ExponentialLR", (0.1, 0.9)),
                                        ("CosineAnnealingLR", (0.1, 12, 0.01)), ("CosineAnnealingLR", (0.1, 7))])
def test_schedules_match_heat_tpu(ht, name, args):
    want = getattr(ht.optim.lr_scheduler, name)(*args)
    got = getattr(htt.optim.lr_scheduler, name)(*args)
    for step in range(21):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=f"{name} step {step}")


def test_optax_schedules_match(ht):
    import optax

    for name, args, kw in (("exponential_decay", (0.2, 5, 0.7), {"transition_begin": 3, "staircase": True}),
                           ("exponential_decay", (0.2, 5, 0.7), {"end_value": 0.1}),
                           ("cosine_decay_schedule", (0.2, 9), {"alpha": 0.1, "exponent": 2.0}),
                           ("constant_schedule", (0.3,), {})):
        want = getattr(optax, name)(*args, **kw)
        got = getattr(htt.optim.lr_scheduler, name)(*args, **kw)
        for step in range(21):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=f"{name} {step}")


def test_names_fall_through_to_torch_optim_and_missing_ones_raise():
    assert htt.optim.SGD is torch.optim.SGD and htt.optim.Adam is torch.optim.Adam
    # heat_tpu maps these three to optax's (heat_tpu/optim/__init__.py:20-22);
    # none of the optax names raises any more
    assert htt.optim.Adadelta is htt.optim.adadelta
    assert htt.optim.LAMB is htt.optim.lamb and htt.optim.LARS is htt.optim.lars
    p = [torch.nn.Parameter(torch.ones(2))]
    for name in ("adadelta", "lamb", "lars"):
        assert isinstance(getattr(htt.optim, name)(0.1)(p), torch.optim.Optimizer)
    with pytest.raises(AttributeError):
        htt.optim.no_such_optimizer


def test_data_parallel_optimizer_binds_factories_and_keeps_bound_optimizers():
    p = [torch.nn.Parameter(torch.ones(2))]
    dpo = htt.optim.DataParallelOptimizer(htt.optim.sgd(0.5))
    assert dpo.state is None
    dpo.init(p)
    p[0].grad = torch.ones(2)
    dpo.step()
    np.testing.assert_array_equal(p[0].detach().numpy(), [0.5, 0.5])
    dpo.zero_grad()
    assert p[0].grad is None
    bound = torch.optim.SGD(p, lr=0.1)
    dpo = htt.optim.DataParallelOptimizer(optimizer=bound)
    dpo.init(p)
    assert dpo.torch_optimizer is bound
    q = [torch.nn.Parameter(torch.ones(3))]
    dpo.init(q)
    assert dpo.torch_optimizer is not bound and dpo.torch_optimizer.defaults["lr"] == 0.1
    with pytest.raises(TypeError):
        htt.optim.DataParallelOptimizer(3)


def test_detect_metric_plateau_matches_heat_tpu(ht):
    seq = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.51, 0.52, 0.53, 0.54, 0.55]
    for kw in ({"patience": 2}, {"mode": "max", "patience": 1, "threshold_mode": "abs", "threshold": 0.01},
               {"patience": 1, "cooldown": 2}):
        a = ht.optim.DetectMetricPlateau(**kw)
        b = htt.optim.DetectMetricPlateau(**kw)
        assert [a.test_if_improving(v) for v in seq] == [b.test_if_improving(v) for v in seq]
        assert a.get_state() == b.get_state()
        c = htt.optim.DetectMetricPlateau()
        c.set_state(b.get_state())
        assert c.get_state() == b.get_state()
    with pytest.raises(ValueError):
        htt.optim.DetectMetricPlateau(mode="sideways")
