"""Statistics (counterpart of heat_tpu/core/statistics.py).

Reductions over the split axis reduce each shard and merge the partials
across positions: ``max``/``min`` by ``pmax``/``pmin``, ``argmax``/``argmin``
so that the first extremum along the axis wins (a NaN is both, the first
NaN wins), ``mean``/``var``/``std`` and the moments from all-reduced sums.
``var`` is two-pass, as ``jnp.var``: the mean, then the sum of squared
deviations from it.  ``median``/``percentile`` sort the gathered axis and
select, by the JAX package's two routes: along the split axis of a
distributed array its sorted-selection route (positions in float32,
``lo + (hi - lo)·frac``, nearest rounds half to even), otherwise
``jnp.percentile``'s (positions in float64, ``lo·(1 − w) + hi·w``, nearest
rounds half down); NaN in a lane gives NaN on both.  The functions that the
JAX package computes on the gathered array (``average``, ``cov``,
``bincount``, ``histc``/``histogram``, ``digitize``/``bucketize``) do the
same here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _operations, sanitation, types
from .dndarray import DNDarray, _wrap
from .stride_tricks import sanitize_axes_for_reduction, sanitize_axis
from ..parallel.sort import ordered_less

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "mpi_argmax",
    "mpi_argmin",
    "percentile",
    "skew",
    "std",
    "var",
]


def _float_sum(t, dim, keepdim):
    """Sum in the mean's accumulation type: integers in float32, 16-bit
    floats in float32 (the result is cast back), wider floats as they are."""
    if not (t.is_floating_point() or t.is_complex()) or t.element_size() < 4:
        t = t.to(torch.float32)
    return torch.sum(t, dim=dim, keepdim=keepdim)


def mean(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean (heat_tpu/core/statistics.py:297): integers give
    float32, floats keep their type.  Over the split axis, the positions'
    partial sums are all-reduced and divided by the count once."""
    sanitation.sanitize_in(x)
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    count = math.prod(x.shape[a] for a in axes)
    total = _operations._reduce_op(_float_sum, x, axis=axis, keepdims=keepdims, combine="sum")
    tt = x.dtype.torch_type()
    out_type = tt if (tt.is_floating_point or tt.is_complex) else torch.float32
    return _operations._local_op(lambda t: (t / count).to(out_type), total)


def _extreme(t, dim, keepdim, largest: bool):
    """amax/amin; complex values in NumPy's lexicographic order (the
    extreme real part, then the extreme imaginary part among the elements
    that have it)."""
    amx = torch.amax if largest else torch.amin
    if not t.is_complex():
        return amx(t, dim=dim, keepdim=keepdim)
    dims = sorted(d % t.ndim for d in ((dim,) if isinstance(dim, int) else dim))
    kept = [d for d in range(t.ndim) if d not in dims]
    flat = t.permute(*kept, *dims).reshape(*(t.shape[d] for d in kept), math.prod(t.shape[d] for d in dims))
    re = amx(flat.real, dim=-1, keepdim=True)
    fill = float("-inf") if largest else float("inf")
    im = torch.where(flat.real == re, flat.imag, torch.full_like(flat.imag, fill))
    out = torch.complex(re[..., 0], amx(im, dim=-1))
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    return out


def _amin(t, dim, keepdim):
    return _extreme(t, dim, keepdim, largest=False)


def _amax(t, dim, keepdim):
    return _extreme(t, dim, keepdim, largest=True)


def _argmin(t, dim, keepdim):
    # torch.argmin takes no bool: as uint8 the first False is the first 0
    return torch.argmin(t.to(torch.uint8) if t.dtype == torch.bool else t, dim=dim, keepdim=keepdim)


def _argmax(t, dim, keepdim):
    return torch.argmax(t.to(torch.uint8) if t.dtype == torch.bool else t, dim=dim, keepdim=keepdim)


def min(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Minimum; complex values in NumPy's lexicographic order."""
    return _operations._reduce_op(_amin, x, axis=axis, keepdims=keepdims, combine="min", out=out)


def max(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Maximum; complex values in NumPy's lexicographic order."""
    return _operations._reduce_op(_amax, x, axis=axis, keepdims=keepdims, combine="max", out=out)


def _one_axis(axis, name: str):
    if axis is not None and not isinstance(axis, (int, np.integer)):
        raise TypeError(f"{name} takes one axis or None, got {axis!r}")


def argmin(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Index of the (first) minimum; ``axis=None`` indexes the flattened
    array.  For bool, the first False."""
    _one_axis(axis, "argmin")
    return _operations._reduce_op(_argmin, x, axis=axis, keepdims=keepdims, combine="argmin", out=out)


def argmax(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Index of the (first) maximum; ``axis=None`` indexes the flattened
    array.  For bool, the first True."""
    _one_axis(axis, "argmax")
    return _operations._reduce_op(_argmax, x, axis=axis, keepdims=keepdims, combine="argmax", out=out)


def _extremum(largest: bool):
    """An elementwise maximum (minimum) in the operands' common type, NaN
    propagating; complex in NumPy's lexicographic order."""

    def op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.is_complex():
            return torch.where(ordered_less(a, b) if largest else ordered_less(b, a), b, a)
        return (torch.maximum if largest else torch.minimum)(a, b)

    return _operations._promoted(op)


def maximum(x1, x2, out=None, where=None) -> DNDarray:
    """Elementwise maximum; NaN propagates."""
    return _operations._binary_op(_extremum(True), x1, x2, out=out, where=where)


def minimum(x1, x2, out=None, where=None) -> DNDarray:
    """Elementwise minimum; NaN propagates."""
    return _operations._binary_op(_extremum(False), x1, x2, out=out, where=where)


# ----------------------------------------------------------------- moments
def _sq_dev(t: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    c = t - mu
    return c.real * c.real + c.imag * c.imag if c.is_complex() else c * c


def _keep_split(result: DNDarray, x: DNDarray, axes, keepdims: bool) -> DNDarray:
    """``result`` of a reduction of ``x`` over ``axes``, split as the JAX
    package splits it: along ``x``'s split axis when that axis is kept.
    The deviations ``x − mean`` drop a split axis of length 1 in the
    binary-op rule, which the reduction would otherwise carry on."""
    if x.split is None or x.split in axes:
        return result
    split = x.split if keepdims else x.split - sum(a < x.split for a in axes)
    return result if result.split == split else result._resplit(split, exact=True)


def _var(x: DNDarray, axis, ddof: int, keepdims: bool) -> DNDarray:
    """The variance in the moments' working type: integers, bools and
    16-bit floats in float32 (the JAX package accumulates 16-bit input in
    f32), wider floats and complex as they are (real for complex)."""
    sanitation.sanitize_in(x)
    axes, _ = sanitize_axes_for_reduction(x.shape, axis)
    count = math.prod(x.shape[a] for a in axes)
    tt = x.dtype.torch_type()
    xf = x if (tt.is_floating_point and tt.itemsize >= 4) or tt.is_complex else x.astype(types.float32)
    mu = mean(xf, axis=axis, keepdims=True)
    dev = _operations._binary_op(_sq_dev, xf, mu)
    total = _operations._reduce_op(
        lambda t, dim, keepdim: torch.sum(t, dim=dim, keepdim=keepdim), dev, axis=axis, keepdims=keepdims
    )
    return _keep_split(_operations._local_op(lambda t: t / (count - ddof), total), x, axes, keepdims)


def _cast_back(result: DNDarray, x: DNDarray) -> DNDarray:
    """A 16-bit float input's result, computed in f32, in its own type."""
    return result.astype(x.dtype, copy=False) if x.dtype in (types.float16, types.bfloat16) else result


def var(x, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Variance with ``ddof`` delta degrees of freedom: the sum of squared
    deviations from the mean over N − ddof (real for complex input)."""
    return _cast_back(_var(x, axis, ddof, keepdims), x)


def std(x, axis=None, ddof: int = 0, keepdims: bool = False) -> DNDarray:
    """Standard deviation: the square root of :func:`var`."""
    return _cast_back(_operations._local_op(torch.sqrt, _var(x, axis, ddof, keepdims)), x)


def _moment_stat(x, axis, order: int, unbiased: bool, fischer: bool = True) -> DNDarray:
    """Standardised central moment of order 3 (skew) or 4 (kurtosis) with
    the JAX package's bias corrections (heat_tpu/core/statistics.py:217)."""
    sanitation.sanitize_in(x)
    axis_s = sanitize_axis(x.shape, axis)
    n = x.size if axis_s is None else x.shape[axis_s]
    xf = x if x.dtype.torch_type().is_floating_point or x.dtype.torch_type().is_complex else x.astype(types.float32)
    mu = mean(xf, axis=axis_s, keepdims=True)
    centered = _operations._binary_op(torch.sub, xf, mu)
    m2 = mean(_operations._local_op(lambda t: t**2, centered), axis=axis_s)
    mk = mean(_operations._local_op(lambda t: t**order, centered), axis=axis_s)
    if order == 3:
        g = _operations._binary_op(lambda a, b: a / b**1.5, mk, m2)
        if unbiased and n > 2:
            # a NumPy float64 factor, as in the JAX package: the result is float64
            g = _operations._local_op(lambda t: t.to(torch.float64) * float(np.sqrt(n * (n - 1)) / (n - 2)), g)
    else:
        g = _operations._binary_op(lambda a, b: a / b**2, mk, m2)
        if unbiased and n > 3:
            g = _operations._local_op(lambda t: ((n**2 - 1) * t - 3 * (n - 1) ** 2) / ((n - 2) * (n - 3)) + 3, g)
        if fischer:
            g = _operations._local_op(lambda t: t - 3, g)
    return _keep_split(g, x, tuple(range(x.ndim)) if axis_s is None else (axis_s,), False)


def kurtosis(x, axis=None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Kurtosis (Fisher's, excess over 3, with ``Fischer``)."""
    return _moment_stat(x, axis, order=4, unbiased=unbiased, fischer=Fischer)


def skew(x, axis=None, unbiased: bool = True) -> DNDarray:
    """Skewness."""
    return _moment_stat(x, axis, order=3, unbiased=unbiased)


# -------------------------------------------------------------- percentile
def median(x, axis=None, keepdims=False) -> DNDarray:
    """Median: the 50th :func:`percentile`."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


def _take(sv: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(sv, idx, axis)`` for a 0-d or 1-d ``idx``."""
    out = torch.index_select(sv, axis, idx.reshape(-1))
    return out.squeeze(axis) if idx.ndim == 0 else out


def _of_sorted(sv: torch.Tensor, q: torch.Tensor, axis: int, n: int, method: str, keepdims: bool) -> torch.Tensor:
    """The JAX package's sorted-selection route
    (heat_tpu/core/statistics.py:321): positions in float32."""
    scalar_q = q.ndim == 0
    pos = q.to(torch.float32) / 100.0 * (n - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    hi = torch.clamp(torch.ceil(pos).to(torch.int64), 0, n - 1)
    if method == "lower":
        out = _take(sv, lo, axis)
    elif method == "higher":
        out = _take(sv, hi, axis)
    elif method == "nearest":
        out = _take(sv, torch.round(pos).to(torch.int64), axis)
    else:
        vlo, vhi = _take(sv, lo, axis), _take(sv, hi, axis)
        if method == "midpoint":
            out = (vlo + vhi) / 2
        else:
            frac = (pos - lo).reshape((1,) * axis + tuple(q.shape) + (1,) * (sv.ndim - axis - 1))
            out = vlo + (vhi - vlo) * frac
    if not scalar_q:
        out = torch.movedim(out, axis, 0)
    if keepdims:
        out = out.unsqueeze(axis + (0 if scalar_q else 1))
    return out


def _quantile(a: torch.Tensor, q: torch.Tensor, axis, method: str, keepdims: bool) -> torch.Tensor:
    """``jnp.percentile``'s route (jax's ``_quantile``): a lane holding NaN
    gives NaN, positions in q's type (float64 for a Python q)."""
    keepdim = None
    if axis is None:
        if keepdims:
            keepdim = [1] * a.ndim
        a = a.reshape(-1)
        axis = 0
    n = a.shape[axis]
    a = torch.where(torch.isnan(a).any(dim=axis, keepdim=True), torch.full((), float("nan"), dtype=a.dtype), a)
    a = torch.sort(a, dim=axis).values
    qq = q * (n - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    high_w = qq - low
    low_w = 1 - high_w
    low = torch.clamp(low, 0, n - 1).to(torch.int64)
    high = torch.clamp(high, 0, n - 1).to(torch.int64)

    def gather(idx):
        v = torch.index_select(a, axis, idx.reshape(-1))
        v = torch.movedim(v, axis, 0)  # (len q, ...) with the axis gone
        if keepdims:
            v = v.unsqueeze(axis + 1)
        return v if q.ndim else v[0]

    lo_v, hi_v = gather(low), gather(high)
    shape = (-1,) + (1,) * (lo_v.ndim - 1) if q.ndim else ()
    lw, hw = low_w.reshape(shape), high_w.reshape(shape)
    if method == "linear":
        out = lo_v.to(q.dtype) * lw + hi_v.to(q.dtype) * hw
    elif method == "lower":
        out = lo_v
    elif method == "higher":
        out = hi_v
    elif method == "nearest":
        out = torch.where(hw <= 0.5, lo_v, hi_v)
    elif method == "midpoint":
        out = (lo_v + hi_v) * 0.5
    else:
        raise ValueError(f"method={method!r} not recognized")
    if keepdim is not None:
        out = out.reshape(([q.shape[0]] if q.ndim else []) + keepdim)
    return out.to(a.dtype)


def percentile(x, q, axis=None, out=None, interpolation: str = "linear", keepdims=False) -> DNDarray:
    """q-th percentile(s) along ``axis`` (q a scalar or a 1-d sequence in
    [0, 100]; the q axis leads the result), replicated."""
    sanitation.sanitize_in(x)
    if interpolation not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise ValueError("interpolation can only be 'linear', 'lower', 'higher', 'midpoint', or 'nearest'")
    axis_s = sanitize_axis(x.shape, axis)
    if axis_s is None and x.ndim == 1:
        axis_s = 0
    dev = x.shards[0].device
    qv = q.larray if isinstance(q, DNDarray) else torch.as_tensor(np.asarray(q))
    a = x.larray
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(torch.float32)
    if isinstance(axis_s, int) and axis_s == x.split and x.is_distributed():
        sv = torch.sort(a, dim=axis_s).values
        result = _of_sorted(sv, qv.to(dev), axis_s, x.shape[axis_s], interpolation, keepdims)
        last = sv.narrow(axis_s, x.shape[axis_s] - 1, 1)
        nan_lane = torch.isnan(last if keepdims else last.squeeze(axis_s))
        result = torch.where(nan_lane, torch.full((), float("nan"), dtype=result.dtype, device=dev), result)
    else:
        # a float32 q stays float32; any other q works in float64, as jax's
        # inexact promotion of a Python or NumPy q gives with x64 on
        qf = qv.to(torch.float32 if qv.dtype == torch.float32 else torch.float64)
        result = _quantile(a, (qf / 100).to(dev), axis_s, interpolation, keepdims)
    wrapped = _wrap(result, None, x.device, x.comm)
    return wrapped if out is None else sanitation.sanitize_out(out, wrapped)


# ----------------------------------------------- functions of the whole array
def _reduced_split(x: DNDarray, axis_s):
    split = x.split
    if split is not None:
        if axis_s is None or split == axis_s:
            split = None
        elif axis_s < split:
            split -= 1
    return split


def average(x, axis=None, weights=None, returned=False):
    """Weighted average along ``axis`` (``weights`` of x's shape, or 1-d
    along ``axis``); with ``returned`` also the sum of the weights,
    broadcast to the result's shape."""
    sanitation.sanitize_in(x)
    axis_s = sanitize_axis(x.shape, axis)
    a = x.larray
    if weights is None:
        a = a.to(_operations._inexact_type(a.dtype))
        dims = tuple(range(a.ndim)) if axis_s is None else axis_s
        result = torch.mean(a, dim=dims)
        count = a.numel() if axis_s is None else a.shape[axis_s]
        wsum = torch.full((), count, dtype=result.dtype, device=a.device)
    else:
        w = weights.larray if isinstance(weights, DNDarray) else torch.as_tensor(np.asarray(weights))
        w = w.to(a.device)
        t = _operations._inexact_type(torch.promote_types(a.dtype, w.dtype))
        a, w = a.to(t), w.to(t)
        if w.shape != a.shape:
            if axis_s is None or w.ndim != 1 or w.shape[0] != a.shape[axis_s]:
                raise ValueError("1-d weights need an axis and the length of a along it")
            w = w.reshape((1,) * axis_s + (-1,) + (1,) * (a.ndim - axis_s - 1)).expand(a.shape)
        dims = tuple(range(a.ndim)) if axis_s is None else axis_s
        wsum = torch.sum(w, dim=dims)
        result = torch.sum(a * w, dim=dims) / wsum
    split = _reduced_split(x, axis_s)
    avg = _wrap(result, split if result.ndim else None, x.device, x.comm)
    if returned:
        return avg, _wrap(torch.broadcast_to(wsum, result.shape).clone(), split if result.ndim else None, x.device, x.comm)
    return avg


def bincount(x, weights=None, minlength: int = 0) -> DNDarray:
    """Occurrences of each value of a 1-d array of non-negative integers
    (the sums of ``weights`` at them), replicated."""
    sanitation.sanitize_in(x)
    t = x.larray
    w = None
    if weights is not None:
        w = weights.larray if isinstance(weights, DNDarray) else torch.as_tensor(np.asarray(weights))
        w = w.to(t.device)
    result = torch.bincount(t, weights=w, minlength=minlength)
    if w is not None:
        # jnp sums the weights in their own type
        result = result.to(w.dtype if w.is_floating_point() else torch.int64)
    return _wrap(result, None, x.device, x.comm)


def _boundaries(b, like: torch.Tensor) -> torch.Tensor:
    t = b.larray if isinstance(b, DNDarray) else torch.as_tensor(np.asarray(b))
    return t.to(like.device)


def bucketize(input, boundaries, out_int32: bool = False, right: bool = False, out=None) -> DNDarray:
    """Bucket index of each element in increasing ``boundaries``
    (``torch.bucketize``'s rule: right=False → b[i-1] < v <= b[i]); int32,
    as ``jnp.searchsorted`` gives, split like the input."""
    sanitation.sanitize_in(input)
    b = _boundaries(boundaries, input.shards[0])
    t = torch.promote_types(b.dtype, input.dtype.torch_type())
    shards = input.shards if input.split is not None else input.shards[:1]
    res = [torch.searchsorted(b.to(t), s.to(t).contiguous(), right=right).to(torch.int32) for s in shards]
    if input.split is None:
        res = res * input.comm.size
    wrapped = DNDarray(res, input.shape, types.int32, input.split, input.device, input.comm)
    return wrapped if out is None else sanitation.sanitize_out(out, wrapped)


def digitize(x, bins, right: bool = False) -> DNDarray:
    """Index of the bin of each element (``numpy.digitize``; bins
    increasing or decreasing), int32, split like x."""
    sanitation.sanitize_in(x)
    b = _boundaries(bins, x.shards[0])
    t = torch.promote_types(b.dtype, x.dtype.torch_type())
    b = b.to(t)
    decreasing = b.numel() > 1 and bool(b[-1] < b[0])

    def one(s):
        s = s.to(t).contiguous()
        if decreasing:
            return (b.numel() - torch.searchsorted(b.flip(0), s, right=not right)).to(torch.int32)
        return torch.searchsorted(b, s, right=not right).to(torch.int32)

    shards = x.shards if x.split is not None else x.shards[:1]
    res = [one(s) for s in shards]
    if x.split is None:
        res = res * x.comm.size
    return DNDarray(res, x.shape, types.int32, x.split, x.device, x.comm)


def _histogram(a: torch.Tensor, bins: int, lo, hi, weights=None):
    """``jnp.histogram`` with ``bins`` equal bins over [lo, hi]: edges by
    linspace in the inexact type of a (and the weights), a value in the bin whose right edge is
    the first above it (the last bin closed), values outside dropped."""
    dt = a.dtype if weights is None else torch.promote_types(a.dtype, weights.dtype)
    dt = _operations._inexact_type(dt)
    a = a.reshape(-1).to(dt)
    w = torch.ones_like(a) if weights is None else weights.reshape(-1).to(device=a.device, dtype=dt)
    edges = torch.linspace(float(lo), float(hi), bins + 1, dtype=dt, device=a.device)
    idx = torch.searchsorted(edges, a.contiguous(), right=True)
    idx = torch.where(a == edges[-1], torch.full_like(idx, bins), idx)
    keep = (idx >= 1) & (idx <= bins)
    counts = torch.zeros(bins + 1, dtype=w.dtype, device=a.device)
    counts.index_add_(0, idx[keep], w[keep])
    return counts[1:], edges


def histc(input, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """Histogram of ``bins`` equal bins over [min, max] (the data's range
    when both are 0), in the input's dtype, replicated."""
    sanitation.sanitize_in(input)
    a = input.larray
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(torch.min(a)), float(torch.max(a))
    hist, _ = _histogram(a, bins, lo, hi)
    wrapped = _wrap(hist.to(input.dtype.torch_type()), None, input.device, input.comm)
    return wrapped if out is None else sanitation.sanitize_out(out, wrapped)


def histogram(a, bins: int = 10, range=None, normed=None, weights=None, density=None):
    """NumPy's histogram of ``bins`` equal bins over ``range`` (the data's
    range by default): (counts, edges), replicated; ``normed`` is the old
    name of ``density``."""
    sanitation.sanitize_in(a)
    if normed is not None and density is None:
        density = normed
    t = a.larray
    if range is None:
        lo, hi = (float(torch.min(t)), float(torch.max(t))) if t.numel() else (0.0, 1.0)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    else:
        lo, hi = range
    w = None
    if weights is not None:
        w = weights.larray if isinstance(weights, DNDarray) else torch.as_tensor(np.asarray(weights))
    hist, edges = _histogram(t, bins, lo, hi, w)
    if density:
        hist = hist / (hist.sum() * torch.diff(edges))
    return _wrap(hist, None, a.device, a.comm), _wrap(edges, None, a.device, a.comm)


def cov(m, y=None, rowvar: bool = True, bias: bool = False, ddof=None) -> DNDarray:
    """Covariance matrix of the variables in the rows of m (columns
    without ``rowvar``), and of y's; replicated, at least 2-d."""
    sanitation.sanitize_in(m)
    x = m.larray
    if x.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    x = torch.atleast_2d(x)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yt = y.larray if isinstance(y, DNDarray) else torch.as_tensor(np.asarray(y))
        yt = torch.atleast_2d(yt.to(x.device))
        if not rowvar and yt.shape[0] != 1:
            yt = yt.T
        x = torch.cat([x, yt.to(x.dtype) if yt.dtype != x.dtype else yt], dim=0)
    x = x.to(_operations._inexact_type(x.dtype))
    if ddof is None:
        ddof = 0 if bias else 1
    x = x - torch.mean(x, dim=1, keepdim=True)
    c = (x @ x.T.conj()) / (x.shape[1] - ddof)
    return _wrap(torch.atleast_2d(c.squeeze()), None, m.device, m.comm)


# ------------------------------------------------------- packed combiners
def _mpi_argreduce(a, b, pick):
    """Two packed ``(values, indices)`` payloads, each a flat array whose
    first half holds values and second half indices, merged elementwise:
    the value ``pick`` prefers wins, ties take the lower index."""
    lhs, rhs = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    (lv, li), (rv, ri) = torch.chunk(lhs, 2), torch.chunk(rhs, 2)
    take_l, take_r = pick(lv, rv), pick(rv, lv)
    values = torch.where(take_l, lv, rv)
    indices = torch.where(take_l, li, torch.where(take_r, ri, torch.minimum(li, ri)))
    return torch.cat((values, indices))


def mpi_argmax(a, b, _=None):
    """Combine two packed argmax payloads (heat_tpu/core/statistics.py:434);
    :func:`argmax` never needs it."""
    return _mpi_argreduce(a, b, torch.gt)


def mpi_argmin(a, b, _=None):
    """Combine two packed argmin payloads (heat_tpu/core/statistics.py:443)."""
    return _mpi_argreduce(a, b, torch.lt)


DNDarray.argmax = lambda self, axis=None, out=None, keepdims=False: argmax(self, axis, out, keepdims)
DNDarray.argmin = lambda self, axis=None, out=None, keepdims=False: argmin(self, axis, out, keepdims)
DNDarray.max = lambda self, axis=None, out=None, keepdims=False: max(self, axis, out, keepdims)
DNDarray.min = lambda self, axis=None, out=None, keepdims=False: min(self, axis, out, keepdims)
DNDarray.mean = lambda self, axis=None, keepdims=False: mean(self, axis=axis, keepdims=keepdims)
DNDarray.std = lambda self, axis=None, ddof=0: std(self, axis, ddof)
DNDarray.var = lambda self, axis=None, ddof=0: var(self, axis, ddof)
