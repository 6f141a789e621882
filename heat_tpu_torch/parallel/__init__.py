"""Mesh context, collectives over shard lists, the transport engine,
distributed selection, and sequence parallelism."""

from . import collectives, mesh, select, sequence, transport
from .mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world

__all__ = [
    "Communication",
    "MeshComm",
    "collectives",
    "get_comm",
    "mesh",
    "select",
    "sequence",
    "sanitize_comm",
    "use_comm",
    "transport",
    "world",
]
