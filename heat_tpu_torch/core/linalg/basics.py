"""Linear-algebra basics (counterpart of heat_tpu/core/linalg/basics.py):
``matmul``, ``dot``, ``transpose``, ``tril``/``triu`` and the norms.

``matmul`` of two 2-D arrays runs over the shard list by the operands'
splits, with the JAX package's output split (basics.py:96-112): a row-split
``a`` keeps its rows split, else a column-split ``b`` keeps its columns
split, else the result is replicated.

* ``a`` split 0: each position multiplies its rows by the whole of ``b``;
* ``b`` split 1 (``a`` not split 0): the whole of ``a`` by each column block;
* an inner split (``a`` split 1 and/or ``b`` split 0): each position
  multiplies its block of the inner dimension, and the partial products are
  summed over the positions by ``collectives.psum``;
* neither split: one product.

An operand that must be whole is gathered first.  The local product is
``torch.matmul`` in IEEE float32 (the card's TF32 stays off), as the JAX
package leaves it to XLA; the overlap ring schedules (``parallel/overlap.py``)
are a later slice (ROADMAP item 13).
"""

from __future__ import annotations

import torch

from .. import sanitation, types
from ..dndarray import DNDarray, _wrap
from ...parallel import collectives

__all__ = [
    "dot",
    "matmul",
    "matrix_norm",
    "norm",
    "transpose",
    "tril",
    "triu",
    "vector_norm",
]


def _replicated(t: torch.Tensor, like: DNDarray) -> DNDarray:
    return DNDarray(
        [t] * like.comm.size, tuple(t.shape), types.canonical_heat_type(t.dtype), None, like.device, like.comm
    )


def _inner_block(t: torch.Tensor, dim: int, comm, k: int, r: int) -> torch.Tensor:
    """Position ``r``'s block of dimension ``dim`` (extent ``k``) of ``t``."""
    off, lshape, _ = comm.chunk((k,), 0, rank=r)
    return t.narrow(dim, off, lshape[0])


def _matmul_2d(a: DNDarray, b: DNDarray, tt: torch.dtype) -> DNDarray:
    comm = a.comm
    n_pos = comm.size
    m, k = a.shape
    n = b.shape[1]

    def whole(x: DNDarray) -> torch.Tensor:
        return x.larray.to(tt)

    if a.split == 0 and n_pos > 1:
        bw = whole(b)
        shards = [torch.matmul(s.to(tt), bw) for s in a.shards]
        return DNDarray(shards, (m, n), types.canonical_heat_type(tt), 0, a.device, comm)
    if b.split == 1 and n_pos > 1:
        aw = whole(a)
        shards = [torch.matmul(aw, s.to(tt)) for s in b.shards]
        return DNDarray(shards, (m, n), types.canonical_heat_type(tt), 1, a.device, comm)
    if (a.split == 1 or b.split == 0) and n_pos > 1:
        # inner split: per-position partial products, summed over positions
        parts = []
        for r in range(n_pos):
            ar = a.shards[r] if a.split == 1 else _inner_block(a.shards[0], 1, comm, k, r)
            br = b.shards[r] if b.split == 0 else _inner_block(b.shards[0], 0, comm, k, r)
            parts.append(torch.matmul(ar.to(tt), br.to(tt)))
        return _replicated(collectives.psum(parts)[0], a)
    out = torch.matmul(whole(a), whole(b))
    split = 0 if a.split == 0 else (1 if b.split == 1 else None)
    return _wrap(out, split, a.device, comm)


def matmul(a: DNDarray, b: DNDarray) -> DNDarray:
    """Matrix product (heat_tpu/core/linalg/basics.py:50)."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul: operands must have at least one dimension")
    k_a = a.shape[-1]
    k_b = b.shape[-2] if b.ndim >= 2 else b.shape[0]
    if k_a != k_b:
        raise ValueError(f"matmul: inner dimensions do not match: {a.shape} @ {b.shape}")
    # jnp.matmul's promotion: an integer meets a float at the float's type
    tt = torch.promote_types(a.dtype.torch_type(), b.dtype.torch_type())
    if a.ndim == 2 and b.ndim == 2:
        return _matmul_2d(a, b, tt)
    result = torch.matmul(a.larray.to(tt), b.larray.to(tt))
    nd_out = result.ndim
    if a.ndim >= 2 and a.split == a.ndim - 2:
        split = nd_out - 2 if b.ndim >= 2 else nd_out - 1
    elif b.ndim >= 2 and b.split == b.ndim - 1:
        split = nd_out - 1
    elif a.ndim >= 2 and a.split is not None and a.split < a.ndim - 2:
        split = a.split
    elif b.ndim >= 2 and b.split is not None and b.split < b.ndim - 2:
        split = b.split
    else:
        split = None
    if split is not None and (split < 0 or nd_out == 0):
        split = None
    return _wrap(result, split, a.device, a.comm)


def dot(a: DNDarray, b: DNDarray) -> DNDarray:
    """Dot product (heat_tpu/core/linalg/basics.py:137): of two vectors a
    replicated scalar (partial dot products summed over the positions when
    both are split); otherwise :func:`matmul`."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    if a.ndim == 1 and b.ndim == 1:
        if a.shape != b.shape:
            raise ValueError(f"dot: shapes {a.shape} and {b.shape} differ")
        tt = torch.promote_types(a.dtype.torch_type(), b.dtype.torch_type())
        if a.split == 0 and b.split == 0 and a.comm.size > 1:
            parts = [torch.dot(x.to(tt), y.to(tt)) for x, y in zip(a.shards, b.shards)]
            return _replicated(collectives.psum(parts)[0], a)
        return _replicated(torch.dot(a.larray.to(tt), b.larray.to(tt)), a)
    return matmul(a, b)


def transpose(a: DNDarray, axes=None) -> DNDarray:
    """Axis permutation (heat_tpu/core/linalg/basics.py:356): each shard is
    permuted (into a contiguous copy) and the split follows its axis."""
    sanitation.sanitize_in(a)
    axes = tuple(reversed(range(a.ndim))) if axes is None else tuple(ax % a.ndim for ax in axes)
    if sorted(axes) != list(range(a.ndim)):
        raise ValueError(f"axes {axes} are not a permutation of {a.ndim} dimensions")
    split = axes.index(a.split) if a.split is not None else None
    if a.split is None:
        shards = [a.shards[0].permute(axes).contiguous()] * a.comm.size
    else:
        shards = [s.permute(axes).contiguous() for s in a.shards]
    gshape = tuple(a.shape[ax] for ax in axes)
    return DNDarray(shards, gshape, a.dtype, split, a.device, a.comm)


def _tri(m: DNDarray, k: int, fn) -> DNDarray:
    """``fn`` (torch.tril or torch.triu) over the last two dimensions, with
    the diagonal moved by each shard's offset along a split among them."""
    sanitation.sanitize_in(m)
    if m.ndim == 1:
        # a vector is broadcast to a square matrix first, as jnp.tril does
        v = m.larray
        return _wrap(fn(v.expand(v.shape[0], v.shape[0]), diagonal=k), m.split, m.device, m.comm)
    if m.split is None:
        return DNDarray([fn(m.shards[0], diagonal=k)] * m.comm.size, m.shape, m.dtype, None, m.device, m.comm)
    shards = []
    for r, s in enumerate(m.shards):
        off = m.comm.chunk(m.shape, m.split, rank=r)[0]
        if m.split == m.ndim - 2:
            shift = off
        elif m.split == m.ndim - 1:
            shift = -off
        else:
            shift = 0
        shards.append(fn(s, diagonal=k + shift))
    return DNDarray(shards, m.shape, m.dtype, m.split, m.device, m.comm)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower triangle (heat_tpu/core/linalg/basics.py:370)."""
    return _tri(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper triangle (heat_tpu/core/linalg/basics.py:383)."""
    return _tri(m, k, torch.triu)


def _inexact(t: torch.Tensor) -> torch.Tensor:
    return t if (t.is_floating_point() or t.is_complex()) else t.to(torch.float32)


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector or matrix norm with NumPy's ``ord``/``axis`` rules
    (heat_tpu/core/linalg/basics.py:308).  With neither given, the 2-norm of
    the flattened array: the positions' sums of squares are all-reduced.
    Norms along axes that leave the split axis alone run on each shard."""
    sanitation.sanitize_in(x)
    if axis is None and ord is None:
        parts = [torch.sum(_inexact(s).abs() ** 2) for s in (x.shards if x.split is not None else x.shards[:1])]
        return _replicated(torch.sqrt(collectives.psum(parts)[0]), x)
    axes = None if axis is None else tuple(ax % x.ndim for ax in (axis if isinstance(axis, tuple) else (axis,)))
    dim = None if axes is None else (axes if len(axes) > 1 else axes[0])
    if x.split is not None and axes is not None and x.split not in axes and x.comm.size > 1:
        split = x.split if keepdims else x.split - sum(1 for ax in axes if ax < x.split)
        shards = [torch.linalg.norm(_inexact(s), ord=ord, dim=dim, keepdim=keepdims) for s in x.shards]
        gshape = list(shards[0].shape)
        gshape[split] = x.shape[x.split]
        return DNDarray(
            shards, tuple(gshape), types.canonical_heat_type(shards[0].dtype), split, x.device, x.comm
        )
    result = torch.linalg.norm(_inexact(x.larray), ord=ord, dim=dim, keepdim=keepdims)
    split = None
    if axes is not None and result.ndim > 0 and x.split is not None and x.split not in axes:
        split = x.split if keepdims else x.split - sum(1 for ax in axes if ax < x.split)
    return _wrap(result, split, x.device, x.comm)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=2) -> DNDarray:
    """Vector norm (heat_tpu/core/linalg/basics.py:328): :func:`norm` with
    ``ord=2`` by default."""
    return norm(x, axis=axis, keepdims=keepdims, ord=ord)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm over two axes, Frobenius by default
    (heat_tpu/core/linalg/basics.py:292); the result is replicated."""
    sanitation.sanitize_in(x)
    if axis is None:
        if x.ndim != 2:
            raise ValueError("matrix_norm requires 2-D input or an explicit 2-tuple axis")
        axis = (0, 1)
    result = torch.linalg.norm(_inexact(x.larray), ord=ord, dim=tuple(axis), keepdim=keepdims)
    return _wrap(result, None, x.device, x.comm)


DNDarray.__matmul__ = lambda self, other: matmul(self, other)
