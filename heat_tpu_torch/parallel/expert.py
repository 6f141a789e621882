"""Expert parallelism: the mixture-of-experts FFN with all-to-all dispatch
(counterpart of heat_tpu/parallel/expert.py).

The schedule is heat_tpu's (GShard/Switch): top-k routing with a static
per-expert capacity, one ``all_to_all`` that moves each position's token
slots to the positions of their experts, the expert FFN as one batched
product over each position's resident experts, and the inverse
``all_to_all`` with the weighted combine.  Under the single controller a
:class:`~heat_tpu_torch.parallel.mesh.MeshComm` of N positions cuts the
tokens and the experts one block per position, and the collectives are the
shard-list ones of :mod:`.collectives`.

Routing keeps the JAX package's arithmetic: gate logits ``x @ gate_w`` in
x's dtype, the softmax in f32, ``lax.top_k``'s order (ties to the lower
expert, :func:`~heat_tpu_torch.parallel.sort.topk_select`), slot positions
``cumsum(onehot)·onehot − onehot`` in token-major order in int32, so the
same choices are dropped.  The kept rows go to their slots by an index
copy (the kept slot indices are unique), not by an atomic add, so reruns
are bitwise equal; every dropped choice lands in a trash row that is cut
off, and the gather side reads zeros for it.

``mesh=None`` runs the same routing over all tokens at once.  Capacity is
enforced per shard, so the two paths agree only while nothing is dropped
(``fraction_dropped == 0``), as in heat_tpu.

On a mesh whose positions belong to several processes each process routes
and runs its own positions' tokens and experts; the slots cross through
the exchange and the output is joined on every process
(:func:`_moe_positions`).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives
from .collectives import all_to_all
from .mesh import MeshComm
from .sort import topk_select

__all__ = ["top_k_routing", "moe_ffn", "expert_capacity"]

# jax.nn.gelu's default is the tanh approximation
_gelu = partial(F.gelu, approximate="tanh")


def expert_capacity(tokens_per_shard: int, num_experts: int, k: int, capacity_factor: float) -> int:
    """Static per-expert, per-shard token capacity (GShard's rule,
    heat_tpu/parallel/expert.py:44): ``ceil(capacity_factor·k·tokens/E)``,
    at least 1."""
    cap = int(math.ceil(capacity_factor * k * tokens_per_shard / num_experts))
    return max(cap, 1)


def _route(gate_logits: torch.Tensor, k: int, capacity: int):
    """Top-k token→expert assignment with capacity-limited slot positions
    (heat_tpu/parallel/expert.py:58).  Returns ``(top_w, top_idx,
    pos_in_expert, kept, aux)``, the first four (t, k); ``aux`` holds the
    Switch load-balancing loss and the dropped fraction of this shard."""
    t, num_experts = gate_logits.shape
    probs = torch.softmax(gate_logits.to(torch.float32), dim=-1)
    top_idx = topk_select(probs, k)  # (t, k), lax.top_k's order
    top_w = probs.gather(-1, top_idx)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # position of each (token, choice) in its expert's queue, token-major:
    # heat_tpu's cumsum(onehot)·onehot − onehot over the (t·k, E) one-hot,
    # computed on its transpose, so the scan runs along contiguous rows
    onehot = (torch.arange(num_experts, device=top_idx.device)[:, None] == top_idx.reshape(1, -1)).to(torch.int32)
    position = torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot - onehot  # (E, t·k)
    pos_in_expert = position.sum(dim=0, dtype=torch.int32).reshape(t, k)
    kept = pos_in_expert < capacity

    f = F.one_hot(top_idx, num_experts).to(torch.float32).mean(dim=(0, 1))
    p = probs.mean(dim=0)
    aux = {
        "load_balance_loss": num_experts * torch.sum(f * p),
        "fraction_dropped": 1.0 - kept.to(torch.float32).mean(),
    }
    return top_w, top_idx, pos_in_expert, kept, aux


def top_k_routing(gate_logits: torch.Tensor, k: int, capacity: int):
    """GShard's dense routing tensors (heat_tpu/parallel/expert.py:94), kept
    for inspection: ``(dispatch, combine, aux)`` with dispatch (t, E, C)
    one-hot and combine the dispatch scaled by the normalised router
    weight."""
    num_experts = gate_logits.shape[1]
    top_w, top_idx, pos_in_expert, kept, aux = _route(gate_logits, k, capacity)
    dispatch = (
        F.one_hot(top_idx, num_experts).to(torch.float32)[..., None]
        * F.one_hot(torch.clamp_max(pos_in_expert, capacity - 1).long(), capacity).to(torch.float32)[:, :, None, :]
        * kept[..., None, None]
    )  # (t, k, E, C)
    combine = torch.sum(dispatch * top_w[..., None, None], dim=1)
    return torch.sum(dispatch, dim=1), combine, aux


def _dispatch(x: torch.Tensor, gate_w: torch.Tensor, k: int, capacity: int):
    """One shard's routing and token→slot copy (the first half of
    heat_tpu's ``_moe_shard``, :116): ``(slots (E, C, d), dest (t·k,),
    top_w (t, k), aux)``."""
    t, d = x.shape
    num_experts = gate_w.shape[1]
    top_w, top_idx, pos_in_expert, kept, aux = _route(x @ gate_w, k, capacity)
    n_slots = num_experts * capacity
    # kept choices go to slot e·C + pos (unique); dropped ones to the trash
    # row n_slots, which is cut off
    dest = torch.where(kept, top_idx * capacity + pos_in_expert, n_slots).reshape(-1)
    src = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    slots = torch.zeros(n_slots + 1, d, dtype=x.dtype, device=x.device).index_copy(0, dest, src)
    return slots[:n_slots].reshape(num_experts, capacity, d), dest, top_w, aux


def _experts(inputs: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, activation: Callable,
             s_in: Optional[torch.Tensor] = None, s_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The resident experts' FFN, one batched product each way
    (``einsum("ecd,edh->ech")``, ``einsum("ech,ehd->ecd")``).  With the
    per-(expert, out-channel) scales ``s_in`` (E, h) and ``s_out`` (E, d),
    ``w_in``/``w_out`` are int8/fp8 tensors: each product reads them widened
    to the f32 accumulator, and its scale multiplies the product
    (heat_tpu/parallel/expert.py:164-170)."""
    if s_in is None:
        return torch.bmm(activation(torch.bmm(inputs, w_in)), w_out)
    comp = torch.promote_types(inputs.dtype, torch.float32)
    pre = torch.bmm(inputs.to(comp), w_in.to(comp))
    hidden = activation(pre * s_in[:, None, :].to(comp)).to(inputs.dtype)
    pre = torch.bmm(hidden.to(comp), w_out.to(comp))
    return (pre * s_out[:, None, :].to(comp)).to(inputs.dtype)


def _combine(outputs: torch.Tensor, dest: torch.Tensor, top_w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Slot→token gather and weighted combine (heat_tpu :177-185): the
    appended zero row answers every dropped choice."""
    t, k = top_w.shape
    d = outputs.shape[-1]
    flat = torch.cat([outputs.reshape(-1, d), outputs.new_zeros(1, d)])
    gathered = flat.index_select(0, dest).reshape(t, k, d)
    y = torch.sum(gathered * top_w[..., None].to(gathered.dtype), dim=1)
    return y.to(dtype)


def _is_quantized(w) -> bool:
    """heat_tpu's ``QuantizedTensor`` form: a buffer ``q`` with its
    ``scale``, not a tensor."""
    return not isinstance(w, torch.Tensor) and hasattr(w, "q") and hasattr(w, "scale")


def moe_ffn(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    k: int = 2,
    capacity_factor: float = 2.0,
    activation: Callable = _gelu,
    mesh: Optional[MeshComm] = None,
    axis: str = "ep",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mixture-of-experts feed-forward (heat_tpu/parallel/expert.py:187).

    ``x`` (..., t, d): leading dims are flattened into the tokens, which
    must divide over ``mesh``'s positions when it is given.  ``gate_w``
    (d, E) is replicated; ``w_in`` (E, d, h) and ``w_out`` (E, h, d) are cut
    into one block of E/N experts per position.  ``mesh=None`` is the
    single-shard path.  ``axis`` is kept for parity with the JAX mesh axis
    name: a :class:`MeshComm` has one axis.

    Returns ``(y, aux)``: y shaped like x; aux holds ``load_balance_loss``
    (add ``alpha·loss`` to the objective) and ``fraction_dropped``,
    averaged over the positions.

    ``w_in``/``w_out`` may also be a pair of
    :class:`~heat_tpu_torch.core.quantize.QuantizedTensor`
    (``quantize_tensor(w, axis=(0, 2))`` or ``quantize_params``): the
    expert products then read the int8/fp8 tensors with the per-(expert,
    channel) scales applied after each product, dispatched per geometry
    over the ``("bf16", "int8")`` autotune arms, an explore call returning
    the bf16 (dequantized) arm's result."""
    q_in, q_out = _is_quantized(w_in), _is_quantized(w_out)
    if q_in != q_out:
        raise ValueError(
            "moe_ffn: quantize both w_in and w_out or neither "
            f"(got {type(w_in).__name__} / {type(w_out).__name__})"
        )
    if q_in:
        return _moe_ffn_quantized(x, gate_w, w_in, w_out, k=k, capacity_factor=capacity_factor,
                                  activation=activation, mesh=mesh, axis=axis)
    return _moe_run(x, gate_w, w_in, w_out, None, None, k=k, capacity_factor=capacity_factor,
                    activation=activation, mesh=mesh, axis=axis)


def _moe_ffn_quantized(x, gate_w, qw_in, qw_out, *, k, capacity_factor, activation, mesh, axis):
    """The arm-dispatched quantized MoE FFN (heat_tpu :304): bf16 runs the
    master-dtype path over both weights dequantized (bitwise the
    unquantized flow over the same values), int8 the expert products over
    the low-precision tensors.  Under autograd (grad mode and an input that
    requires grad) the bf16 arm runs untimed, with no table write."""
    from ..core import autotune, quantize as _quantize

    for name, qt in (("w_in", qw_in), ("w_out", qw_out)):
        if qt.axes != (0, 2):
            raise ValueError(
                f"moe_ffn: quantized {name} needs per-(expert, out-channel) scales — quantize with axis=(0, 2), "
                f"got axes {qt.axes}"
            )

    def _bf16():
        return _moe_run(x, gate_w, _quantize.dequantize_tensor(qw_in), _quantize.dequantize_tensor(qw_out), None,
                        None, k=k, capacity_factor=capacity_factor, activation=activation, mesh=mesh, axis=axis)

    def _int8():
        return _moe_run(x, gate_w, qw_in.q, qw_out.q, qw_in.scale, qw_out.scale, k=k,
                        capacity_factor=capacity_factor, activation=activation, mesh=mesh, axis=axis)

    if _quantize.declines_to_reference(x, gate_w):
        return _bf16()
    tokens = math.prod(x.shape[:-1])
    d = x.shape[-1]
    n = 1 if mesh is None else mesh.size
    geometry = (tokens, d, qw_in.shape[2], gate_w.shape[1], n, k, autotune.dtype_name(qw_in.q.dtype))
    return _quantize.tuned_arm(
        "moe_ffn", geometry, _bf16, _int8,
        desc=f"moe_ffn t={tokens} d={d} h={qw_in.shape[2]} E={gate_w.shape[1]} S={n}", comm=mesh, device=x.device,
    )


def _moe_run(x, gate_w, w_in, w_out, s_in, s_out, *, k, capacity_factor, activation, mesh, axis):
    """The step body behind :func:`moe_ffn` (heat_tpu :248); ``s_in`` and
    ``s_out`` as in :func:`_experts`."""
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    tokens = x2.shape[0]
    num_experts = gate_w.shape[1]

    if mesh is None:
        cap = expert_capacity(tokens, num_experts, k, capacity_factor)
        slots, dest, top_w, aux = _dispatch(x2, gate_w, k, cap)
        y = _combine(_experts(slots, w_in, w_out, activation, s_in, s_out), dest, top_w, x.dtype)
        return y.reshape(orig_shape), aux

    n = mesh.size
    if tokens % n:
        raise ValueError(f"token count {tokens} not divisible by mesh axis {axis}={n}")
    if num_experts % n:
        raise ValueError(f"num_experts {num_experts} not divisible by mesh axis {axis}={n}")
    cap = expert_capacity(tokens // n, num_experts, k, capacity_factor)
    y, aux = _moe_positions(x2, gate_w, w_in, w_out, s_in, s_out, k, cap, activation, mesh)
    return y.reshape(orig_shape), aux


def _moe_positions(x2, gate_w, w_in, w_out, s_in, s_out, k: int, cap: int, activation, mesh: MeshComm):
    """:func:`_moe_run`'s expert-parallel step for this process's
    positions (every position in one process): the replicated tokens, the
    router (one copy a position) and the experts (E/N a position) are cut
    (across processes their gradients all-gathered, the router's then
    summed over the copies), the slots cross in ``all_to_all`` both ways
    ((E, C, d) per position -> (E/N, N·C, d): every shard's tokens for the
    resident experts, and back), and the output and the per-position aux
    values are joined on every process, the aux values folded in position
    order.  One :func:`~heat_tpu_torch.parallel.collectives.grad_chain`
    orders the backward's collectives."""
    n = mesh.size
    local = mesh.local_positions
    tb = x2.shape[0] // n
    eb = w_in.shape[0] // n
    rows = {r: (slice(r * tb, (r + 1) * tb), slice(None)) for r in range(n)}
    experts = {r: (slice(r * eb, (r + 1) * eb),) for r in range(n)}
    copies = {r: (slice(r, r + 1),) for r in range(n)}
    tensors = [x2, gate_w, w_in, w_out]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    with collectives.grad_chain(grad):
        xs = collectives.cut(x2, rows, mesh)
        gates = [g[0] for g in collectives.cut(gate_w[None].expand((n,) + tuple(gate_w.shape)), copies, mesh)]
        wis, wos = collectives.cut(w_in, experts, mesh), collectives.cut(w_out, experts, mesh)
        if s_in is not None:
            scales = list(zip(collectives.cut(s_in, experts, mesh), collectives.cut(s_out, experts, mesh)))
        else:
            scales = [(None, None)] * len(local)
        routed = [_dispatch(xs_, g, k, cap) for xs_, g in zip(xs, gates)]
        inputs = all_to_all([r[0] for r in routed], split_axis=0, concat_axis=1, comm=mesh)
        outputs = [_experts(inp, wi, wo, activation, si, so)
                   for inp, wi, wo, (si, so) in zip(inputs, wis, wos, scales)]
        outputs = all_to_all(outputs, split_axis=1, concat_axis=0, comm=mesh)
        y = collectives.join([_combine(o, r[1], r[2], x2.dtype) for o, r in zip(outputs, routed)], rows,
                             tuple(x2.shape), mesh)
    aux = {}
    for key in routed[0][3]:
        with collectives.grad_chain(grad):
            vals = collectives.join([r[3][key].reshape(1) for r in routed], copies, (n,), mesh)
        total = vals[0]
        for i in range(1, n):
            total = total + vals[i]
        aux[key] = total / n
    return y, aux
