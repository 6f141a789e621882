"""Mesh context, collectives over shard lists, and sequence parallelism."""

from . import collectives, mesh, sequence
from .mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world

__all__ = [
    "Communication",
    "MeshComm",
    "collectives",
    "get_comm",
    "mesh",
    "sequence",
    "sanitize_comm",
    "use_comm",
    "world",
]
