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
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

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
    share one tree structure."""
    mesh.only_local("pipeline.stack_stage_params")
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
    mesh.only_local("pipeline.pipeline_apply")
    n_stages = mesh.size
    leading = {int(leaf.shape[0]) for leaf in _leaves(stage_params)}
    if leading != {n_stages}:
        raise ValueError(
            f"stage_params leading dim(s) {sorted(leading)} must equal the mesh's {axis!r} axis size {n_stages}"
        )
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    micro = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    stage_p = [_tree_map(lambda a, i=i: a[i], stage_params) for i in range(n_stages)]
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    carry = [torch.zeros_like(micro[0]) for _ in range(n_stages)]
    emitted = []
    for t in range(n_micro + n_stages - 1):
        outs = []
        for i in range(n_stages):
            if 0 <= t - i < n_micro:  # stage i holds microbatch t − i
                outs.append(fn(stage_p[i], micro[t] if i == 0 else carry[i]))
            else:  # a bubble tick: heat_tpu's output here is discarded
                outs.append(torch.zeros_like(micro[0]))
        if t >= n_stages - 1:
            # the last stage's output for microbatch t − n_stages + 1
            emitted.append(outs[-1])
        carry = ppermute(outs, ring)
    out = torch.stack(emitted)
    return out.reshape((out.shape[0] * out.shape[1],) + tuple(out.shape[2:]))
