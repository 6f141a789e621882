"""Linear-algebra basics (counterpart of heat_tpu/core/linalg/basics.py):
``matmul``, ``dot``, ``transpose``, ``tril``/``triu``, the norms, ``outer``,
``projection``, ``trace``, ``vdot``, ``vecdot``, ``cross``, ``det`` and
``inv``.

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
package leaves it to XLA.  Before these layouts, a 2-D product goes to the
overlap engine (``parallel/overlap.py``): under fusion it is a lazy node
whose elementwise consumers lower to one ring schedule with them as its
tail, and eagerly the ring dispatcher runs; where the engine declines, the
layouts above run.

``det`` and ``inv`` keep the JAX package's two routes.  A 2-D matrix split
over several positions is eliminated over the shard list with partial
pivoting in the order of its ``_pp_lu_det`` and ``_gj_inv``: each position
keeps its rows (``det`` a copy of A's, ``inv`` the augmented ``[A | I]``),
each position's block a view of one working buffer on the array's device.
The pivot of each column is found and its row swapped into place by index
copies driven by device tensors, so the loop never waits on the host, as
the JAX package's ``fori_loop`` never leaves the device; every position
then updates its own rows.  A split-1 matrix goes through its row-split
transpose.  Every other matrix (replicated, one position, a stack) goes to
``torch.linalg``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import sanitation, types
from ..dndarray import DNDarray, _wrap
from ...parallel import collectives

__all__ = [
    "cross",
    "det",
    "dot",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]


def _replicated(t: torch.Tensor, like: DNDarray) -> DNDarray:
    return DNDarray(
        [t] * like.comm.size, tuple(t.shape), types.canonical_heat_type(t.dtype), None, like.device, like.comm
    )


def _matmul_shards(a_sh, a_split, b_sh, b_split, m: int, k: int, n: int, n_pos: int, tt: torch.dtype, comm=None):
    """The eager 2-D product over the shard lists of a (m, k) array split
    along ``a_split`` and a (k, n) one split along ``b_split``: ``(shards,
    split)`` of the result (the module docstring's layouts).  The overlap
    engine's explore calls time it against the ring.  On a ``comm`` that
    spans processes a whole operand is all-gathered through the exchange,
    the inner split's partial products are summed in position order, and
    this process's positions are computed (``RemoteShard`` for the
    others)."""
    across = comm is not None and comm.spans_processes
    positions = comm.local_positions if across else range(n_pos)

    def whole(shards, split) -> torch.Tensor:
        if split is None or n_pos == 1:
            return shards[positions[0]].to(tt)
        if across:
            return collectives.all_gather(comm.local_shards(shards), dim=split, comm=comm)[0].to(tt)
        return torch.cat(list(shards), dim=split).to(tt)

    def placed(blocks, split):
        if not across:
            return blocks
        if split is None:
            return [blocks[0]] * n_pos
        got = dict(zip(positions, blocks))
        return comm.per_position(lambda r: got[r], (m, n), split)

    if a_split == 0 and n_pos > 1:
        bw = whole(b_sh, b_split)
        return placed([torch.matmul(a_sh[r].to(tt), bw) for r in positions], 0), 0
    if b_split == 1 and n_pos > 1:
        aw = whole(a_sh, a_split)
        return placed([torch.matmul(aw, b_sh[r].to(tt)) for r in positions], 1), 1
    if (a_split == 1 or b_split == 0) and n_pos > 1:
        # inner split: per-position partial products, summed over positions
        parts = []
        for r in positions:
            per = -(-k // n_pos)
            off = min(r * per, k)
            rows = min((r + 1) * per, k) - off
            ar = a_sh[r] if a_split == 1 else a_sh[r].narrow(1, off, rows)
            br = b_sh[r] if b_split == 0 else b_sh[r].narrow(0, off, rows)
            parts.append(torch.matmul(ar.to(tt), br.to(tt)))
        if across:
            total = collectives.psum_in_order(parts, comm=comm)[0]
            return placed([total] * len(parts), None), None
        return [collectives.psum(parts)[0]] * n_pos, None
    out = torch.matmul(whole(a_sh, a_split), whole(b_sh, b_split))
    split = 0 if a_split == 0 else (1 if b_split == 1 else None)
    if across:
        return placed([out[comm.chunk((m, n), split, rank=r)[2]] if split is not None else out for r in positions],
                      split), split
    return [out] * n_pos, split


def _matmul_2d(a: DNDarray, b: DNDarray, tt: torch.dtype) -> DNDarray:
    """The eager product of two 2-D arrays (:func:`_matmul_shards`)."""
    comm = a.comm
    m, k = a.shape
    n = b.shape[1]
    shards, split = _matmul_shards(a.shards, a.split, b.shards, b.split, m, k, n, comm.size, tt, comm)
    return DNDarray(shards, (m, n), types.canonical_heat_type(shards[comm.local_positions[0]].dtype), split, a.device,
                    comm)


def _lazy_matmul(a: DNDarray, b: DNDarray, promoted, split):
    """``a @ b`` deferred as a fusion node of the overlap engine's ``_mm``
    (heat_tpu :115), so that an elementwise chain over it lowers to one ring
    with the chain as its tail.  ``None`` when an operand declines."""
    from .. import _operations, fusion
    from ..dndarray import _tdevice
    from ...parallel import overlap as _overlap

    _overlap.ensure_registered()
    ctx = (a.device, a.comm)
    try:
        na = fusion.cast_node(_operations._lazy_operand(a, a.comm), promoted, ctx)
        nb = fusion.cast_node(_operations._lazy_operand(b, a.comm), promoted, ctx)
        res = fusion.node(_overlap._mm, (na, nb), ctx)
    except fusion.Unfusable:
        fusion.count_fallback()
        return None
    return fusion.defer(res, res.aval.shape, types.canonical_heat_type(res.aval.dtype), split, a.device, a.comm,
                        _tdevice(a))


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Matrix product (heat_tpu/core/linalg/basics.py:50).
    ``allow_resplit`` is accepted for parity; operands are never resplit.
    A quantized right operand (``quantize.quantize_weights``) takes
    :func:`~heat_tpu_torch.core.quantize.matmul_quantized`."""
    from .. import quantize

    if isinstance(b, quantize.QuantizedDNDarray):
        return quantize.matmul_quantized(a, b)
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
        # under fusion the product joins the lazy DAG (an elementwise chain
        # over it lowers to the ring with the chain as its tail); eagerly
        # the ring dispatcher runs; either declines to the layout code
        from .. import fusion
        from ...parallel import overlap as _overlap

        split2 = 0 if a.split == 0 else (1 if b.split == 1 else None)
        if fusion.enabled():
            lazy = _lazy_matmul(a, b, types.canonical_heat_type(tt), split2)
            if lazy is not None:
                return lazy
        ring = _overlap.matmul(a, b, out_split=split2)
        if ring is not None:
            return ring
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


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Dot product (heat_tpu/core/linalg/basics.py:137): of two vectors a
    replicated scalar (partial dot products summed over the positions when
    both are split); otherwise :func:`matmul`.  ``out`` takes the result."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    if a.ndim == 1 and b.ndim == 1:
        if a.shape != b.shape:
            raise ValueError(f"dot: shapes {a.shape} and {b.shape} differ")
        tt = torch.promote_types(a.dtype.torch_type(), b.dtype.torch_type())
        if a.split == 0 and b.split == 0 and a.comm.size > 1:
            parts = [torch.dot(x.to(tt), y.to(tt)) for x, y in zip(a.shards, b.shards)]
            ret = _replicated(collectives.psum(parts)[0], a)
        else:
            ret = _replicated(torch.dot(a.larray.to(tt), b.larray.to(tt)), a)
    else:
        ret = matmul(a, b)
    return _into(out, ret)


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



def _into(out: Optional[DNDarray], ret: DNDarray) -> DNDarray:
    """``ret``, or ``out`` holding its values: as the JAX package's
    ``out.larray = ...`` does, ``out`` keeps its split (and its dtype)."""
    if out is None:
        return ret
    if ret.split != out.split:
        ret = ret._resplit(out.split, exact=True)
    return sanitation.sanitize_out(out, ret)


def _promoted(*arrays: DNDarray) -> torch.dtype:
    t = arrays[0].dtype
    for a in arrays[1:]:
        t = types.promote_types(t, a.dtype)
    return t.torch_type()


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split=None) -> DNDarray:
    """Outer product of the flattened a and b (heat_tpu/core/linalg/basics.py:154).
    The result is split 0 when either input is split, else replicated,
    unless ``split`` says otherwise.  A 1-D split-0 ``a`` gives each
    position its rows against the whole of ``b`` (and a split-0 ``b`` each
    position its columns for ``split=1``); other layouts gather."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    tt = _promoted(a, b)
    shape = (a.size, b.size)
    if split == 0 and a.ndim == 1 and a.split == 0:
        bw = b.larray.reshape(-1).to(tt)
        ret = DNDarray([torch.outer(s.to(tt), bw) for s in a.shards], shape, types.canonical_heat_type(tt), 0,
                       a.device, a.comm)
    elif split == 1 and b.ndim == 1 and b.split == 0:
        aw = a.larray.reshape(-1).to(tt)
        ret = DNDarray([torch.outer(aw, s.to(tt)) for s in b.shards], shape, types.canonical_heat_type(tt), 1,
                       a.device, a.comm)
    else:
        ret = _wrap(torch.outer(a.larray.reshape(-1).to(tt), b.larray.reshape(-1).to(tt)), split, a.device, a.comm)
    return _into(out, ret)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of the vector a onto the vector b, ``b · (a·b)/(b·b)``
    (heat_tpu/core/linalg/basics.py:333), split as b."""
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError("projection requires 1-D vectors")
    scale = dot(a, b).shards[0] / dot(b, b).shards[0]
    shards = [s * scale for s in b.shards]
    return DNDarray(shards, b.shape, types.canonical_heat_type(shards[0].dtype), b.split, b.device, b.comm)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None) -> DNDarray:
    """Sum of the diagonal (heat_tpu/core/linalg/basics.py:343), replicated,
    in the type ``sum`` gives (``dtype`` casts it).  A 2-D array split along
    one of the two axes joins the diagonal's pieces from the positions
    that hold them, never the matrix."""
    sanitation.sanitize_in(a)
    from .. import arithmetics

    ax1, ax2 = axis1 % a.ndim, axis2 % a.ndim
    if a.ndim == 2 and a.split in (ax1, ax2) and a.comm.size > 1:
        pieces = []
        for r, s in enumerate(a.shards):
            off = a.comm.chunk(a.shape, a.split, rank=r)[0]
            shift = off if a.split == ax1 else -off
            pieces.append(torch.diagonal(s, offset=offset + shift, dim1=ax1, dim2=ax2))
        diag = torch.cat(pieces)
    else:
        diag = torch.diagonal(a.larray, offset=offset, dim1=ax1, dim2=ax2)
    ret = arithmetics.sum(_wrap(diag.contiguous(), None, a.device, a.comm), axis=-1)
    if dtype is not None:
        ret = ret.astype(types.canonical_heat_type(dtype))
    return _into(out, ret)


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Dot product of the flattened arrays, the first conjugated
    (heat_tpu/core/linalg/basics.py:396); a replicated scalar."""
    tt = _promoted(x1, x2)
    a, b = x1.larray.reshape(-1).to(tt), x2.larray.reshape(-1).to(tt)
    if a.shape != b.shape:
        raise ValueError(f"vdot: sizes {a.numel()} and {b.numel()} differ")
    return _replicated(torch.sum(a.conj() * b, dtype=tt), x1)


def vecdot(x1: DNDarray, x2: DNDarray, axis: int = -1, keepdims: bool = False) -> DNDarray:
    """Sum of the elementwise product along ``axis``
    (heat_tpu/core/linalg/basics.py:402), no conjugation."""
    from .. import arithmetics

    return arithmetics.sum(arithmetics.mul(x1, x2), axis=axis, keepdims=keepdims)


def _cross(a: torch.Tensor, b: torch.Tensor, axisa: int, axisb: int, axisc: int) -> torch.Tensor:
    """``jnp.cross``'s arithmetic: 2-vectors get a zero third component,
    two 2-vectors give the scalar z component."""
    a, b = a.movedim(axisa, -1), b.movedim(axisb, -1)
    if a.shape[-1] not in (2, 3) or b.shape[-1] not in (2, 3):
        raise ValueError("Dimension must be either 2 or 3 for cross product")
    if a.shape[-1] == 2:
        if b.shape[-1] == 2:
            return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
        a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
    elif b.shape[-1] == 2:
        b = torch.cat([b, torch.zeros_like(b[..., :1])], dim=-1)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])
    return c.movedim(0, axisc)


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """Cross product of vectors along the given axes
    (heat_tpu/core/linalg/basics.py:412).  ``axis`` overrides ``axisa``,
    ``axisb`` and ``axisc``; 2-vectors get a zero third component.  The
    result is split where a's split dimension lands: dropped with the
    vector axis, moved past ``axisc``, or kept (:430-444)."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    if axis != -1:
        axisa = axisb = axisc = axis
    tt = _promoted(a, b)
    result = _cross(a.larray.to(tt), b.larray.to(tt), axisa, axisb, axisc)
    new_split = None
    if a.split is not None:
        axisa_n = axisa % a.ndim
        if a.split != axisa_n:
            pos = [d for d in range(a.ndim) if d != axisa_n].index(a.split)
            if result.ndim == a.ndim:
                new_split = pos if pos < axisc % result.ndim else pos + 1
            else:
                new_split = pos
    return _wrap(result, new_split, a.device, a.comm)


def _square_check(a: DNDarray) -> None:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise RuntimeError(f"expected square matrix, got shape {a.shape}")


def _factor_input(t: torch.Tensor) -> torch.Tensor:
    """Integers as float32 (heat_tpu/core/linalg/basics.py:252); the
    factorizations of LAPACK and cuSOLVER take no 16-bit floats, so those
    raise as in the JAX package."""
    if not (t.is_floating_point() or t.is_complex()):
        return t.to(torch.float32)
    if t.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(f"Unsupported dtype {str(t.dtype).split('.')[-1]}")
    return t


def _row_blocks(a: DNDarray, width: int):
    """The working rows of A (of Aᵀ for a split-1 A), ``width`` columns
    (A's n, or 2n for ``[A | I]``), as one buffer on A's device, and each
    position's block of it (a view) with its global row offset."""
    n = a.shape[0]
    dtype = a.shards[0].dtype
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.float32
    buf = a.shards[0].new_zeros((n, width), dtype=dtype)
    if width > n:
        buf[:, n:].diagonal().fill_(1)
    blocks, offs = [], []
    for r, s in enumerate(a.shards):
        off = a.comm.chunk(a.shape, a.split, rank=r)[0]
        rows = s.T if a.split == 1 else s
        block = buf[off : off + rows.shape[0]]
        block[:, :n] = rows
        blocks.append(block)
        offs.append(off)
    return buf, blocks, offs


def _pivot(buf: torch.Tensor, i: int, rows: torch.Tensor) -> torch.Tensor:
    """Partial pivoting for column i: the first row j ≥ i of the largest
    |A[j, i]| (``jnp.argmax`` over the candidates) is swapped with row i by
    an index copy.  j stays on the device (``rows`` is ``arange(n)``
    there).  Returns ``j != i`` as a 0-d bool tensor."""
    j = torch.argmax(buf[i:, i].abs()) + i
    ij = torch.stack((rows[i], j, j, rows[i]))
    buf[ij[2:]] = buf[ij[:2]]
    return j != i


def _det_by_elimination(buf: torch.Tensor, blocks: List[torch.Tensor], offs: Sequence[int], n: int) -> torch.Tensor:
    """``_pp_lu_det`` over the row blocks: per column the pivot row is
    swapped into place, the determinant multiplied by its pivot, and each
    position subtracts ``(A[j, i] / pivot) · pivot_row`` from its rows
    below the pivot.  Only the columns right of the pivot are updated: the
    others are never read again, so the values are those of the full
    update.  The sign is that of the number of swaps."""
    det = buf.new_ones(())
    swaps = torch.zeros((), dtype=torch.int64, device=buf.device)
    rows = torch.arange(n, device=buf.device)
    for i in range(n):
        swaps += _pivot(buf, i, rows)
        piv = buf[i, i]
        det = det * piv
        denom = torch.where(piv == 0, torch.ones_like(piv), piv)
        pr = buf[i, i + 1 :]
        for b, o in zip(blocks, offs):
            lo = max(i + 1 - o, 0)
            if lo < b.shape[0] and i + 1 < n:
                z = b[lo:, i] / denom
                b[lo:, i + 1 :].addcmul_(z[:, None], pr[None, :], value=-1)
    return torch.where(swaps % 2 == 1, -det, det)


def _inv_by_elimination(buf: torch.Tensor, blocks: List[torch.Tensor], offs: Sequence[int], n: int) -> List[torch.Tensor]:
    """``_gj_inv`` over the rows of ``[A | I]``: per column the pivot row is
    swapped into place and divided by its pivot, and every other row
    subtracts ``A[j, i] · pivot_row``.  The left half's columns up to the
    pivot are not updated (they are never read again); the right half is
    the inverse, returned as a view of each block.  A zero pivot gives
    inf/NaN, as in the JAX package."""
    rows = torch.arange(n, device=buf.device)
    for i in range(n):
        _pivot(buf, i, rows)
        row = buf[i]
        row[i + 1 :].div_(row[i])
        pr = row[i + 1 :]  # no other row's update writes row i
        for b, o in zip(blocks, offs):
            li = i - o
            parts = [(0, li), (li + 1, b.shape[0])] if 0 <= li < b.shape[0] else [(0, b.shape[0])]
            for lo, hi in parts:
                if hi > lo:
                    b[lo:hi, i + 1 :].addcmul_(b[lo:hi, i, None], pr[None, :], value=-1)
    return [b[:, n:] for b in blocks]


def det(a: DNDarray) -> DNDarray:
    """Determinant (heat_tpu/core/linalg/basics.py:245), replicated.  A 2-D
    matrix split over several positions takes the elimination over its
    rows (module docstring); every other matrix, and stacks,
    ``torch.linalg.det``."""
    sanitation.sanitize_in(a)
    _square_check(a)
    if a.ndim == 2 and a.is_distributed():
        buf, blocks, offs = _row_blocks(a, a.shape[0])
        return _replicated(_det_by_elimination(buf, blocks, offs, a.shape[0]), a)
    return _replicated(torch.linalg.det(_factor_input(a.larray)), a)


def inv(a: DNDarray) -> DNDarray:
    """Inverse (heat_tpu/core/linalg/basics.py:264), split as ``a``.  A 2-D
    matrix split over several positions takes Gauss-Jordan elimination on
    the rows of ``[A | I]`` (module docstring); every other matrix, and
    stacks, an LU factorization and solve (``jnp.linalg.inv``'s route).  A
    singular matrix gives inf/NaN, never an exception."""
    sanitation.sanitize_in(a)
    _square_check(a)
    n = a.shape[-1]
    if a.ndim == 2 and a.is_distributed():
        buf, blocks, offs = _row_blocks(a, 2 * n)
        rows = _inv_by_elimination(buf, blocks, offs, n)
        shards = [t.T for t in rows] if a.split == 1 else rows
        return DNDarray(shards, a.shape, types.canonical_heat_type(rows[0].dtype), a.split, a.device, a.comm)
    arr = _factor_input(a.larray)
    lu, piv, _ = torch.linalg.lu_factor_ex(arr)
    eye = torch.eye(n, dtype=arr.dtype, device=arr.device).expand(arr.shape)
    return _wrap(torch.linalg.lu_solve(lu, piv, eye), a.split, a.device, a.comm)


DNDarray.__matmul__ = lambda self, other: matmul(self, other)
