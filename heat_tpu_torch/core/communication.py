"""The communication context under its core import path (counterpart of
heat_tpu/core/communication.py); it lives in :mod:`heat_tpu_torch.parallel.mesh`.
``MPICommunication`` names the mesh context, and :class:`MPIRequest` stands
for a nonblocking handle."""

import torch

from ..parallel.mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world

__all__ = ["Communication", "MeshComm", "MPICommunication", "MPIRequest", "get_comm", "sanitize_comm", "use_comm", "world"]

#: the reference API's concrete backend class: here the mesh context
MPICommunication = MeshComm


def _streams(value):
    """The CUDA tensors a request's value holds: a tensor, the shards of a
    DNDarray, or those of a list or tuple of either."""
    if isinstance(value, (list, tuple)):
        for v in value:
            yield from _streams(v)
    elif isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif hasattr(value, "shards"):
        yield from _streams(value.shards)


class MPIRequest:
    """A handle on work already queued: ``wait()`` synchronises the current
    stream of every card the value's tensors lie on, then returns the
    value."""

    def __init__(self, value=None):
        self.value = value

    def wait(self):
        for dev in {t.device for t in _streams(self.value)}:
            torch.cuda.current_stream(dev).synchronize()
        return self.value

    Wait = wait
