"""Optimizers (counterpart of heat_tpu/optim/).

``ht.optim.SGD``, ``Adam`` and every other torch-style name fall through to
``torch.optim``, the port's substrate (the JAX package's fall through to
optax).  The lowercase optax names of ``heat_tpu.optim`` compute optax's
update with optax's defaults (:mod:`.optimizers`): ``sgd``, ``adam``,
``adamw``, ``rmsprop`` and ``adagrad`` each return a factory of the
optimizer, bound to the parameters by :class:`DataParallelOptimizer`
(``nn.DataParallel.init``).  ``adadelta``, ``lamb`` and ``lars`` are not
ported yet (ROADMAP item 12).
"""

from functools import partial

import torch.optim as _torch_optim

from . import lr_scheduler, optimizers, utils
from .dp_optimizer import DASO, DataParallelOptimizer
from .utils import DetectMetricPlateau

__all__ = [
    "DASO",
    "DataParallelOptimizer",
    "DetectMetricPlateau",
    "adagrad",
    "adam",
    "adamw",
    "lr_scheduler",
    "optimizers",
    "rmsprop",
    "sgd",
    "utils",
]


def sgd(learning_rate, momentum=None, nesterov=False):
    """``optax.sgd``'s update (:class:`~.optimizers.Sgd`), unbound."""
    return partial(optimizers.Sgd, lr=learning_rate, momentum=momentum, nesterov=nesterov)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam``'s update (:class:`~.optimizers.Adam`), unbound."""
    return partial(optimizers.Adam, lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
    """``optax.adamw``'s update (:class:`~.optimizers.AdamW`), unbound."""
    return partial(optimizers.AdamW, lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False,
            momentum=None, nesterov=False):
    """``optax.rmsprop``'s update (:class:`~.optimizers.RMSprop`), unbound."""
    return partial(optimizers.RMSprop, lr=learning_rate, decay=decay, eps=eps, initial_scale=initial_scale,
                   eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum, nesterov=nesterov)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """``optax.adagrad``'s update (:class:`~.optimizers.Adagrad`), unbound."""
    return partial(optimizers.Adagrad, lr=learning_rate, initial_accumulator_value=initial_accumulator_value, eps=eps)


_NOT_PORTED = ("adadelta", "lamb", "lars")


def __getattr__(name):
    """Fall through to ``torch.optim``; optax's ``adadelta``, ``lamb`` and
    ``lars`` raise until they are ported."""
    if name in _NOT_PORTED:
        def missing(*args, **kwargs):
            raise NotImplementedError(f"optax's {name} is not ported yet: ROADMAP item 12")

        return missing
    try:
        return getattr(_torch_optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute {name!r}")
