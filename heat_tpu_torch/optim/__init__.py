"""Optimizers (counterpart of heat_tpu/optim/).

``ht.optim.SGD``, ``Adam`` and every other torch-style name fall through to
``torch.optim``, the port's substrate (the JAX package's fall through to
optax).  The lowercase optax names of ``heat_tpu.optim`` compute optax's
update with optax's defaults (:mod:`.optimizers`): ``sgd``, ``adam``,
``adamw``, ``rmsprop``, ``adagrad``, ``adadelta``, ``lamb`` and ``lars``
each return a factory of the optimizer, bound to the parameters by
:class:`DataParallelOptimizer` (``nn.DataParallel.init``).  ``Adadelta``,
``LAMB`` and ``LARS`` name those three, as heat_tpu maps them to optax's
(torch has no LAMB or LARS).
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
    "adadelta",
    "adagrad",
    "adam",
    "adamw",
    "lamb",
    "lars",
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


def adadelta(learning_rate=None, rho=0.9, eps=1e-6, weight_decay=0.0, weight_decay_mask=None):
    """``optax.adadelta``'s update (:class:`~.optimizers.Adadelta`), unbound."""
    return partial(optimizers.Adadelta, lr=learning_rate, rho=rho, eps=eps, weight_decay=weight_decay,
                   weight_decay_mask=weight_decay_mask)


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0, mask=None):
    """``optax.lamb``'s update (:class:`~.optimizers.Lamb`), unbound."""
    return partial(optimizers.Lamb, lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                   weight_decay=weight_decay, mask=mask)


def lars(learning_rate, weight_decay=0.0, weight_decay_mask=True, trust_coefficient=0.001, eps=0.0,
         trust_ratio_mask=True, momentum=0.9, nesterov=False):
    """``optax.lars``'s update (:class:`~.optimizers.Lars`), unbound."""
    return partial(optimizers.Lars, lr=learning_rate, weight_decay=weight_decay,
                   weight_decay_mask=weight_decay_mask, trust_coefficient=trust_coefficient, eps=eps,
                   trust_ratio_mask=trust_ratio_mask, momentum=momentum, nesterov=nesterov)


# heat_tpu/optim/__init__.py:20-22 maps these torch-style names to optax's
_OPTAX_NAMES = {"Adadelta": adadelta, "LAMB": lamb, "LARS": lars}


def __getattr__(name):
    """``Adadelta``, ``LAMB`` and ``LARS`` are the optax factories above;
    every other name falls through to ``torch.optim``."""
    if name in _OPTAX_NAMES:
        return _OPTAX_NAMES[name]
    try:
        return getattr(_torch_optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute {name!r}")
