"""Gaussian naive Bayes (counterpart of heat_tpu/naive_bayes/gaussianNB.py).

``fit``/``partial_fit`` take per-class counts, means and variances of a
batch and merge them into the running ones by Chan et al.'s pairwise
update, as the JAX package does.  For samples split along their rows each
position takes its rows' one-hot sums (``wᵀx``, then ``wᵀ(x − mean)²``
from samples centred on their class mean, never E[x²] − mean²), and the
partial sums are all-reduced; the centred samples are formed a block of
rows at a time.

``predict``/``predict_log_proba``/``predict_proba`` evaluate the JAX
package's joint log-likelihood ``log prior − ½Σ log 2πσ² − ½Σ (x − μ)²/σ²``
with its own formula, but a block of rows at a time: the (samples,
classes, features) broadcast that XLA fuses into its reduction would be
materialised by eager torch (41 GB at 2e7 × 64 with 8 classes); a block
holds ``_JLL_ELEMENTS`` of it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import factories, sanitation, telemetry, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray, _wrap
from ..parallel import collectives

__all__ = ["GaussianNB", "gaussiannb_from_state"]

# rows of x taken at a time by the moments' centred pass and the
# variance (2^18 rows of 64 f32 features: 64 MB beside x)
_MOMENT_ROWS = 1 << 18
# elements of one (rows, classes, features) block of the joint
# log-likelihood (32 MB of f32: a block stays in the card's L2 between its
# four passes)
_JLL_ELEMENTS = 1 << 23


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, DNDarray):
        v = v.larray
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(like.device)


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian naive Bayes classifier (heat_tpu/naive_bayes/gaussianNB.py:23).

    Parameters
    ----------
    priors : array-like, optional
        Class priors; by default the classes' shares of the samples.
    var_smoothing : float
        Share of the largest feature variance added to every variance.
    """

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None

    # ---------------------------------------------------------------- fit
    def _rows(self, x: DNDarray, v, dtype) -> List[torch.Tensor]:
        """``v`` (per-sample values: a DNDarray or array-like) cut as x's
        row blocks, flattened and cast to ``dtype``."""
        if isinstance(v, DNDarray) and v.split == 0 and x.split == 0:
            return [s.reshape(-1).to(dtype) for s in v.shards]
        t = _tensor(v, x.shards[0]).reshape(-1).to(dtype)
        if x.split != 0:
            return [t]
        return [t.narrow(0, x.comm.chunk(x.shape, 0, rank=r)[0], s.shape[0]) for r, s in enumerate(x.shards)]

    @staticmethod
    def _blocks(x: DNDarray) -> List[torch.Tensor]:
        blocks = x.shards if x.split == 0 else [x.larray]
        return [b if b.is_floating_point() else b.to(torch.float32) for b in blocks]

    def _masked_moments(self, xs, onehots, weights=None):
        """Per-class counts, means and variances of the row blocks ``xs``
        (gaussianNB.py:36): weighted one-hot sums all-reduced over the
        blocks, the variance from samples centred on their class mean."""
        ws = onehots if weights is None else [o * w[:, None] for o, w in zip(onehots, weights)]
        counts = collectives.psum([w.sum(0) for w in ws])[0]
        sums = collectives.psum([w.T @ x for w, x in zip(ws, xs)])[0]
        means = sums / torch.clamp(counts, min=1)[:, None]
        parts = []
        for x, o, w in zip(xs, onehots, ws):
            sq = torch.zeros_like(means)
            for lo in range(0, x.shape[0], _MOMENT_ROWS):
                c = x[lo : lo + _MOMENT_ROWS] - o[lo : lo + _MOMENT_ROWS] @ means
                sq += w[lo : lo + _MOMENT_ROWS].T @ c.square_()
            parts.append(sq)
        var = collectives.psum(parts)[0] / torch.clamp(counts, min=1)[:, None]
        return counts, means, torch.clamp(var, min=0.0)

    @staticmethod
    def _feature_var(xs, n: int) -> torch.Tensor:
        """``jnp.var(x, axis=0)`` over the row blocks: the mean, then the
        mean of the squared deviations."""
        mu = collectives.psum([x.sum(0) for x in xs])[0] / n
        parts = []
        for x in xs:
            acc = torch.zeros_like(mu)
            for lo in range(0, x.shape[0], _MOMENT_ROWS):
                acc += torch.sum(torch.square(x[lo : lo + _MOMENT_ROWS] - mu), 0)
            parts.append(acc)
        return collectives.psum(parts)[0] / n

    @telemetry.span("gaussiannb.fit")
    def fit(self, x: DNDarray, y: DNDarray, sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Fit from scratch (gaussianNB.py:51)."""
        self.classes_ = None
        self.theta_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(self, x: DNDarray, y: DNDarray, classes: Optional[DNDarray] = None,
                    sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Merge a batch's per-class moments into the running ones
        (gaussianNB.py:57).  ``classes`` fixes the classes on the first
        call (else the batch's sorted unique labels); ``epsilon_`` is
        ``var_smoothing`` times the batch's largest feature variance."""
        sanitation.sanitize_in(x)
        sanitation.sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2-D, but was {x.ndim}-D")
        # no port kernel on this path: the entry has no work count
        telemetry.ensure_program(telemetry.fingerprint(("gaussiannb_partial_fit", x.shape, str(x.dtype), x.comm.size)),
                                 kind="gaussiannb_fit", mesh={"devices": x.comm.size}, dtype=str(x.dtype))
        xs = self._blocks(x)
        dt = xs[0].dtype
        ys = self._rows(x, y, y.dtype.torch_type())
        if self.classes_ is None:
            if classes is not None:
                cls = _tensor(classes, xs[0])
            else:
                cls = torch.unique(torch.cat(ys), sorted=True)
            self.classes_ = _wrap(cls, None, y.device, y.comm)
            nc, nf = cls.shape[0], x.shape[1]
            self._counts = xs[0].new_zeros((nc,))
            self._means = xs[0].new_zeros((nc, nf))
            self._vars = xs[0].new_zeros((nc, nf))
        cls = self.classes_.shards[0].to(xs[0].device)
        onehots = [(yv[:, None] == cls[None, :]).to(dt) for yv in ys]
        weights = None if sample_weight is None else self._rows(x, sample_weight, dt)
        n_new, mu_new, var_new = self._masked_moments(xs, onehots, weights)

        # pairwise merge (the JAX package's _update_mean_variance)
        n_old, mu_old, var_old = self._counts, self._means, self._vars
        n_tot = n_old + n_new
        safe = torch.clamp(n_tot, min=1)[:, None]
        delta = mu_new - mu_old
        mu_tot = mu_old + delta * (n_new / torch.clamp(n_tot, min=1))[:, None]
        m_tot = var_old * n_old[:, None] + var_new * n_new[:, None] + (delta**2) * ((n_old * n_new)[:, None] / safe)
        var_tot = m_tot / safe
        self._counts, self._means, self._vars = n_tot, mu_tot, var_tot

        self.epsilon_ = self.var_smoothing * float(torch.max(self._feature_var(xs, x.shape[0])))
        if self.priors is not None:
            pri = _tensor(self.priors, xs[0])
        else:
            pri = n_tot / torch.sum(n_tot)
        self._finish(pri, x)
        return self

    def _finish(self, prior: torch.Tensor, like: DNDarray) -> None:
        wrap = lambda t: _wrap(t, None, like.device, like.comm)  # noqa: E731
        self.class_count_ = wrap(self._counts)
        self.class_prior_ = wrap(prior)
        self.theta_ = wrap(self._means)
        self.var_ = wrap(self._vars)

    def fit_stream(self, source, y, dataset: Optional[str] = None, *, classes=None, sample_weight=None, comm=None,
                   budget: Optional[int] = None) -> "GaussianNB":
        raise NotImplementedError(
            "GaussianNB.fit_stream needs core/stream.py, which is not ported yet (ROADMAP queue 1, item 13)"
        )

    # ------------------------------------------------------------ predict
    @staticmethod
    def _jll_block(xb: torch.Tensor, head: torch.Tensor, var: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        """(rows, classes) joint log-likelihood of one block of rows:
        ``head − ½Σ_f (x − μ)²/σ²`` over the block's (rows, classes,
        features) broadcast."""
        d = xb[:, None, :] - mu[None, :, :]
        return torch.add(head[None, :], d.square_().div_(var[None, :, :]).sum(dim=2), alpha=-0.5)

    def _joint_log_likelihood(self, x: DNDarray) -> List[torch.Tensor]:
        """The (rows, classes) joint log-likelihood of each of x's row
        blocks (gaussianNB.py:237)."""
        blocks = self._blocks(x)
        var = self._vars + self.epsilon_
        mu = self._means
        log_prior = torch.log(torch.clamp(self.class_prior_.shards[0], min=1e-300))
        n_ij = -0.5 * torch.sum(torch.log(2.0 * np.pi * var), dim=1)
        head = log_prior + n_ij
        step = max(1, _JLL_ELEMENTS // max(1, x.shape[1] * mu.shape[0]))
        out = []
        for b in blocks:
            d = b.device
            parts = [self._jll_block(b[lo : lo + step], head.to(d), var.to(d), mu.to(d))
                     for lo in range(0, b.shape[0], step)]
            out.append(torch.cat(parts) if parts else b.new_empty((0, mu.shape[0])))
        return out

    def _result(self, x: DNDarray, parts: List[torch.Tensor]) -> DNDarray:
        if x.split == 0:
            gshape = (x.shape[0],) + tuple(parts[0].shape[1:])
            return DNDarray(parts, gshape, types.canonical_heat_type(parts[0].dtype), 0, x.device, x.comm)
        return _wrap(parts[0], x.split, x.device, x.comm)

    def logsumexp(self, a: DNDarray, axis=None, b=None, keepdims: bool = False, return_sign: bool = False):
        """``log(sum(b · exp(a)))`` computed stably (gaussianNB.py:251)."""
        av = a.larray if isinstance(a, DNDarray) else torch.as_tensor(np.asarray(a))
        bv = b.larray if isinstance(b, DNDarray) else (None if b is None else torch.as_tensor(np.asarray(b)))
        dims = tuple(range(av.ndim)) if axis is None else axis
        m = torch.amax(av, dim=dims, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(av - m)
        if bv is not None:
            e = e * bv.to(e.device)
        s = torch.sum(e, dim=dims, keepdim=keepdims)
        sign = torch.sign(s)
        if not keepdims:
            m = m.reshape(s.shape)
        out_v = torch.log(torch.abs(s) if return_sign else s) + m
        if isinstance(a, DNDarray):
            split = a.split if out_v.ndim == av.ndim else None
            out = factories.array(out_v, split=split, device=a.device, comm=a.comm)
            if return_sign:
                return out, factories.array(sign, split=split, device=a.device, comm=a.comm)
            return out
        if return_sign:
            return factories.array(out_v), factories.array(sign)
        return factories.array(out_v)

    def _log_proba(self, x: DNDarray) -> List[torch.Tensor]:
        out = []
        for jll in self._joint_log_likelihood(x):
            norm = jll - torch.amax(jll, dim=1, keepdim=True)
            out.append(norm - torch.log(torch.sum(torch.exp(norm), dim=1, keepdim=True)))
        return out

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Per-class log probabilities (gaussianNB.py:279), split as x."""
        return self._result(x, self._log_proba(x))

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Per-class probabilities (gaussianNB.py:290), split as x."""
        return self._result(x, [torch.exp_(t) for t in self._log_proba(x)])

    @telemetry.span("gaussiannb.predict")
    def predict(self, x: DNDarray) -> DNDarray:
        """The most probable class of each sample (gaussianNB.py:297), the
        lower class on a tie, split as x."""
        if self.theta_ is None:
            raise RuntimeError("fit the model first")
        cls = self.classes_.shards[0]
        labels = [cls.to(j.device)[torch.argmax(j, dim=1)] for j in self._joint_log_likelihood(x)]
        return self._result(x, labels)


def gaussiannb_from_state(classes, theta, var, class_prior, class_count, epsilon: float, priors=None,
                          var_smoothing: float = 1e-9, device=None, comm=None) -> GaussianNB:
    """A fitted :class:`GaussianNB` from a fitted model's state as numpy
    arrays (a heat_tpu model's ``classes_``, ``theta_``, ``var_``,
    ``class_prior_`` and ``class_count_`` ``.numpy()``, and its
    ``epsilon_``), replicated over ``comm`` on ``device``: it predicts as
    that model does, and ``partial_fit`` goes on from its moments."""
    model = GaussianNB(priors=priors, var_smoothing=var_smoothing)
    like = factories.array(np.asarray(theta), device=device, comm=comm)
    t = like.shards[0]
    model.classes_ = factories.array(np.asarray(classes), device=device, comm=comm)
    model._means = t
    model._vars = torch.as_tensor(np.array(var)).to(device=t.device, dtype=t.dtype)
    model._counts = torch.as_tensor(np.array(class_count)).to(device=t.device, dtype=t.dtype)
    model.epsilon_ = float(epsilon)
    model._finish(torch.as_tensor(np.array(class_prior)).to(t.device), like)
    return model
