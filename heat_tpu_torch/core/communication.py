"""The communication context under its core import path (counterpart of
heat_tpu/core/communication.py); it lives in :mod:`heat_tpu_torch.parallel.mesh`."""

from ..parallel.mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world

__all__ = ["Communication", "MeshComm", "get_comm", "sanitize_comm", "use_comm", "world"]
