"""Mesh context, collectives over shard lists, the transport engine, the
overlap ring GEMM, distributed selection, and sequence, expert and pipeline
parallelism."""

# transport is imported with the package, so its "transport" counter group
# is in telemetry.snapshot() before any traffic
from . import collectives, expert, mesh, overlap, pipeline, select, sequence, transport
from .expert import moe_ffn
from .mesh import Communication, MeshComm, get_comm, sanitize_comm, use_comm, world
from .pipeline import pipeline_apply, stack_stage_params

__all__ = [
    "Communication",
    "MeshComm",
    "collectives",
    "expert",
    "get_comm",
    "mesh",
    "moe_ffn",
    "overlap",
    "pipeline",
    "pipeline_apply",
    "select",
    "sequence",
    "sanitize_comm",
    "stack_stage_params",
    "use_comm",
    "transport",
    "world",
]
