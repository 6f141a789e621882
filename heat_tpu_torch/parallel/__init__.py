"""Mesh context and collectives over shard lists."""

from . import collectives, mesh
from .mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world

__all__ = [
    "Communication",
    "MeshComm",
    "collectives",
    "get_comm",
    "mesh",
    "sanitize_comm",
    "use_comm",
    "world",
]
