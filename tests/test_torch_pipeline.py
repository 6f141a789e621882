"""``heat_tpu_torch.parallel.pipeline`` against heat_tpu's pipeline on the
CPU: the same numpy stage weights and batch through heat_tpu's
``pipeline_apply`` (a ``lax.scan`` with ``ppermute`` inside ``shard_map``
over a "pp" mesh of n CPU devices) and the port's over ``MeshComm(n)``, at
meshes 1, 4 and 8, and against the sequential stack.

Tolerance: the stages are a dense layer and tanh in f32, computed in the
same order by both packages and the sequential stack, so forwards agree to
1e-6 absolute and 1e-5 relative; gradients (through the reverse pipeline,
autograd's and ``jax.grad``'s) to 1e-6 absolute and 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

MESHES = (1, 4, 8)
WIDTH = 8


@pytest.fixture(scope="module")
def jpp():
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    from heat_tpu.parallel import pipeline

    return pipeline


def _params(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((WIDTH, WIDTH)) / np.sqrt(WIDTH)).astype(np.float32),
         "b": (rng.standard_normal(WIDTH) * 0.01).astype(np.float32)}
        for _ in range(n)
    ]


def _stage_torch(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_jax(p, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _torch_tree(params, grad=False):
    return [{k: torch.tensor(v, requires_grad=grad) for k, v in p.items()} for p in params]


def _sequential(params, x):
    for p in params:
        x = _stage_torch(p, x)
    return x


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("n_micro", [1, 3, 6, 12])
def test_forward_matches_heat_tpu_and_the_sequential_stack(jpp, n, n_micro):
    import jax.numpy as jnp

    params = _params(n)
    x = np.random.default_rng(1).standard_normal((12, WIDTH)).astype(np.float32)
    mesh = _jax_mesh(n)
    want = np.asarray(jpp.pipeline_apply(
        _stage_jax, jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()} for p in params], mesh),
        jnp.asarray(x), mesh=mesh, n_micro=n_micro,
    ))
    comm = htt.MeshComm(n)
    tp = _torch_tree(params)
    got = pipeline_apply(_stage_torch, stack_stage_params(tp, comm), torch.from_numpy(x), mesh=comm, n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _sequential(tp, torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", MESHES)
def test_gradients_match_jax_grad_and_the_sequential_stack(jpp, n):
    import jax
    import jax.numpy as jnp

    params = _params(n, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, WIDTH)).astype(np.float32)
    y = rng.standard_normal((8, WIDTH)).astype(np.float32)
    mesh = _jax_mesh(n)
    stacked = jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()} for p in params], mesh)
    g_jax = jax.jit(jax.grad(lambda sp: jnp.mean((jpp.pipeline_apply(_stage_jax, sp, jnp.asarray(x), mesh=mesh,
                                                                     n_micro=2) - jnp.asarray(y)) ** 2)))(stacked)

    comm = htt.MeshComm(n)
    leaves = {k: torch.tensor(np.stack([p[k] for p in params]), requires_grad=True) for k in ("w", "b")}
    out = pipeline_apply(_stage_torch, leaves, torch.from_numpy(x), mesh=comm, n_micro=2)
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()

    tp = _torch_tree(params, grad=True)
    torch.mean((_sequential(tp, torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    for k in ("w", "b"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g_jax[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        seq = np.stack([p[k].grad.numpy() for p in tp])
        np.testing.assert_allclose(leaves[k].grad.numpy(), seq, rtol=1e-4, atol=1e-6, err_msg=k)


def test_bubble_ticks_are_skipped():
    # n_micro · n_stages stage calls a forward, heat_tpu's discarded
    # bubble ticks (n_stages − 1 of them a stage) are not run
    calls = []
    comm = htt.MeshComm(4)
    params = stack_stage_params(_torch_tree(_params(4)), comm)
    x = torch.zeros(6, WIDTH)
    pipeline_apply(lambda p, a: calls.append(a.shape) or _stage_torch(p, a), params, x, mesh=comm, n_micro=3)
    assert len(calls) == 3 * 4 and set(calls) == {(2, WIDTH)}


def test_errors_match_heat_tpu(jpp):
    import jax
    import jax.numpy as jnp

    params = _params(4)
    mesh, comm = _jax_mesh(4), htt.MeshComm(4)
    with pytest.raises(ValueError):
        jpp.stack_stage_params(params + params, mesh)
    with pytest.raises(ValueError, match="4-way 'pp' axis"):
        stack_stage_params(_torch_tree(params + params), comm)
    # a hand-stacked tree of 8 stages on a 4-way mesh
    bad_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[{k: jnp.asarray(v) for k, v in p.items()} for p in params * 2])
    with pytest.raises(ValueError):
        jpp.pipeline_apply(_stage_jax, bad_j, jnp.zeros((8, WIDTH)), mesh=mesh, n_micro=2)
    bad_t = {k: torch.from_numpy(np.stack([p[k] for p in params * 2])) for k in ("w", "b")}
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(_stage_torch, bad_t, torch.zeros(8, WIDTH), mesh=comm, n_micro=2)
    good = stack_stage_params(_torch_tree(params), comm)
    with pytest.raises(ValueError, match="n_micro=5"):
        pipeline_apply(_stage_torch, good, torch.zeros(12, WIDTH), mesh=comm, n_micro=5)
    with pytest.raises(ValueError, match="structure"):
        stack_stage_params([{"w": torch.zeros(1)}, {"b": torch.zeros(1)}, {"w": torch.zeros(1)}, {"w": torch.zeros(1)}],
                           comm)


def test_transformer_blocks_as_stages():
    # the chip phase's shape of use: TransformerBlocks' parameters stacked,
    # each stage a functional call of one block, against the blocks in order
    from torch.func import functional_call

    gen = torch.Generator().manual_seed(0)
    blocks = [htt.models.TransformerBlock(2, 4, device="cpu", generator=gen) for _ in range(4)]
    comm = htt.MeshComm(4)
    stacked = stack_stage_params([dict(b.named_parameters()) for b in blocks], comm)
    x = torch.randn(4, 6, 8, generator=gen)
    got = pipeline_apply(lambda p, a: functional_call(blocks[0], p, (a,)), stacked, x, mesh=comm, n_micro=2)
    want = x
    for b in blocks:
        want = b(want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
