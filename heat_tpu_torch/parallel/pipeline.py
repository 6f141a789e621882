"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh
(counterpart of heat_tpu/parallel/pipeline.py).

Each position of a :class:`~heat_tpu_torch.parallel.mesh.MeshComm` owns one
*stage* (one slice of a stack of structurally identical layers).  The
schedule is heat_tpu's: fill, steady state and drain over
``n_micro + n_stages − 1`` ticks; at tick t stage 0 takes microbatch t,
every other stage takes what its predecessor handed it at tick t − 1, and
the activations pass stage to stage by ``ppermute``
(:func:`~heat_tpu_torch.parallel.collectives.ppermute`).  The reverse
pipeline is autograd's, as heat_tpu's is ``jax.grad``'s.

heat_tpu runs every stage at every tick and throws away the bubble ticks'
outputs (stage i before tick i or after tick i + n_micro − 1).  The port
skips those calls: a forward calls ``fn`` ``n_micro · n_stages`` times, and
a bubble stage hands on zeros.  The values are the same.

Layout: stage parameters are stacked on a leading axis of size
``n_stages`` (:func:`stack_stage_params`), slice i for position i.

Each process runs its own stages (every stage in one process): the
stacked parameters (replicated) are cut to its stages,
the carry crosses the process boundary through ``ppermute``'s process
route (the exchange), and the last stage's output is joined on every
process; the backward all-gathers each stage's parameter gradients, so
they are whole on every process (one
:func:`~heat_tpu_torch.parallel.collectives.grad_chain` a call).
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from . import collectives
from .collectives import ppermute
from .mesh import MeshComm

__all__ = ["pipeline_apply", "stack_stage_params"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the tensors of trees of one structure (nested dicts,
    lists and tuples)."""
    first = trees[0]
    if isinstance(first, dict):
        if any(set(t) != set(first) for t in trees[1:]):
            raise ValueError("the stage trees do not share one structure")
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (list, tuple)):
        if any(len(t) != len(first) for t in trees[1:]):
            raise ValueError("the stage trees do not share one structure")
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def stack_stage_params(params_list, mesh: MeshComm, axis: str = "pp"):
    """Stack the per-stage parameter trees on a leading dimension of one
    slice per position (heat_tpu/parallel/pipeline.py:30).  All stages must
    share one tree structure.  The stack is replicated: on a mesh that
    spans processes :func:`pipeline_apply` cuts each process's stages."""
    n_stages = mesh.size
    if len(params_list) != n_stages:
        raise ValueError(f"{len(params_list)} stage trees for a {n_stages}-way {axis!r} axis")
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def pipeline_apply(fn: Callable, stage_params, x: torch.Tensor, *, mesh: MeshComm, axis: str = "pp",
                   n_micro: int) -> torch.Tensor:
    """Run ``x`` through the stage pipeline; returns the last stage's
    activations (heat_tpu/parallel/pipeline.py:47).

    ``fn(stage_param_tree, activation) -> activation`` is one stage's
    compute and keeps the activation's shape.  ``stage_params`` has leaves
    with a leading ``n_stages`` dimension (:func:`stack_stage_params`).
    ``x``'s leading dimension must divide into ``n_micro`` microbatches;
    the bubble fraction is ``(n_stages − 1) / (n_micro + n_stages − 1)``."""
    n_stages = mesh.size
    leading = {int(leaf.shape[0]) for leaf in _leaves(stage_params)}
    if leading != {n_stages}:
        raise ValueError(
            f"stage_params leading dim(s) {sorted(leading)} must equal the mesh's {axis!r} axis size {n_stages}"
        )
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    micro = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    local = mesh.local_positions
    one = {i: (slice(i, i + 1),) for i in range(n_stages)}
    # stage 0 reads the whole input, the last stage holds the whole output
    first = {i: (slice(None),) if i == 0 else (slice(0, 0),) for i in range(n_stages)}
    last = {i: (slice(None),) if i == n_stages - 1 else (slice(0, 0),) for i in range(n_stages)}
    leaves = _leaves(stage_params)
    grad = torch.is_grad_enabled() and (x.requires_grad or any(leaf.requires_grad for leaf in leaves))
    with collectives.grad_chain(grad):
        cuts = {id(leaf): dict(zip(local, collectives.cut(leaf, one, mesh))) for leaf in leaves}
        stage_p = {i: _tree_map(lambda a, i=i: cuts[id(a)][i][0], stage_params) for i in local}
        xs = dict(zip(local, collectives.cut(micro, first, mesh)))
        ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        carry = {i: torch.zeros_like(micro[0]) for i in local}
        emitted = []
        for t in range(n_micro + n_stages - 1):
            outs = []
            for i in local:
                if 0 <= t - i < n_micro:  # stage i holds microbatch t − i
                    outs.append(fn(stage_p[i], xs[i][t] if i == 0 else carry[i]))
                else:  # a bubble tick: heat_tpu's output here is discarded
                    outs.append(torch.zeros_like(micro[0]))
            if t >= n_stages - 1 and n_stages - 1 in local:
                emitted.append(outs[-1])
            carry = dict(zip(local, ppermute(outs, ring, comm=mesh)))
        shape = tuple(micro.shape)
        parts = [torch.stack(emitted) if i == n_stages - 1 else micro.new_zeros((0,) + shape[1:]) for i in local]
        out = collectives.join(parts, last, shape, mesh)
    return out.reshape((out.shape[0] * out.shape[1],) + tuple(out.shape[2:]))
