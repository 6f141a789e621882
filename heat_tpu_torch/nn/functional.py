"""Functional NN namespace (counterpart of heat_tpu/nn/functional.py):
:func:`linear` on DNDarrays, and every other name from
``torch.nn.functional``."""

import torch.nn.functional as _F

__all__ = ["func_getattr", "linear"]


def linear(input, weight, bias=None):
    """``input @ weight.T + bias`` (torch's ``F.linear`` convention:
    ``weight`` is (out_features, in_features)) through the port's
    ``matmul`` and ``transpose``, so DNDarray operands keep their split
    rules."""
    from ..core.linalg import basics

    out = basics.matmul(input, basics.transpose(weight))
    if bias is not None:
        out = out + bias
    return out


def func_getattr(name):
    """Resolve ``name`` against ``torch.nn.functional``."""
    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(f"{name!r} is not implemented in torch.nn.functional")


def __getattr__(name):
    return func_getattr(name)
