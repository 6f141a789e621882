"""Shard positions, in one process or across processes (counterpart of
heat_tpu/parallel/mesh.py).

A :class:`MeshComm` is ``size`` shard positions along the split axis.  A
split array keeps one torch tensor per position; which torch device those
tensors live on is the array's :class:`~heat_tpu_torch.core.devices.Device`.
Shards follow the JAX package's chunk rule: even ``ceil(n/N)`` chunks with
the trailing shards truncated, possibly to zero rows.

``MeshComm(n)`` puts all n positions in this process (the single
controller).  After :func:`init_distributed` (``torch.distributed`` under
torchrun, Slurm, Open MPI or PMI) a comm can also span processes: each
process owns a contiguous block of positions (:func:`local_mesh`,
:func:`world`, the dcn tier of :func:`hybrid_mesh`), an array on it holds
only the tensors of this process's positions, and the collectives of
:mod:`~heat_tpu_torch.parallel.collectives` combine the local parts first
and then make one ``torch.distributed`` call on the comm's process group.
The shard of a position that another process owns is a
:class:`RemoteShard`: any direct use of it raises ``NotImplementedError``,
so no code computes over the local shards as if they were the whole array.
Shards move between processes only through one primitive,
:func:`~heat_tpu_torch.parallel.collectives.exchange` (one
``all_to_all_single`` on the comm's group, entered by every process); the
transport engine, select, sort, the DNDarray's members, the estimators'
seeding, the overlap rings, the ring ``cdist``, sequence, expert and
pipeline parallelism ride on it, the last three with autograd across it.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import envparse

__all__ = [
    "Communication",
    "Mesh",
    "MeshComm",
    "RemoteShard",
    "get_comm",
    "hybrid_mesh",
    "init_distributed",
    "local_mesh",
    "sanitize_comm",
    "use_comm",
    "world",
]

#: canonical name of the mesh axis that backs the DNDarray ``split`` dimension
SPLIT_AXIS = "split"


class Communication:
    """Abstract base for communication contexts."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def _process_rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def _process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


class RemoteShard:
    """The shard of a position that another process owns.  It carries the
    chunk rule's metadata (``shape``, ``dtype``, ``device``, ``ndim``) and
    nothing else: any other use, a torch function included, raises
    ``NotImplementedError``; its bytes move only through
    :func:`~heat_tpu_torch.parallel.collectives.exchange`."""

    __slots__ = ("position", "shape", "dtype", "device")

    def __init__(self, position: int, shape, dtype, device):
        object.__setattr__(self, "position", int(position))
        object.__setattr__(self, "shape", torch.Size(shape))
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "device", device)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def _refuse(self, what: str = "reading it"):
        raise NotImplementedError(
            f"position {self.position}'s shard lies in another process; {what} reads it directly: move it "
            f"through collectives.exchange (or the array's own moves) first"
        )

    def __getattr__(self, name):
        self._refuse(f"'.{name}'")

    def __setattr__(self, name, value):
        self._refuse(f"writing '.{name}'")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        for a in list(args) + list((kwargs or {}).values()):
            for item in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(item, RemoteShard):
                    item._refuse(getattr(func, "__name__", str(func)))
        raise NotImplementedError("a shard of another process is read only through collectives.exchange")

    def __repr__(self) -> str:
        return f"RemoteShard(position={self.position}, shape={tuple(self.shape)})"


def _refusing(name):
    def method(self, *args, **kwargs):
        self._refuse(name)

    method.__name__ = name
    return method


for _name in ("__getitem__", "__setitem__", "__iter__", "__len__", "__bool__", "__float__", "__int__",
              "__array__", "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
              "__truediv__", "__rtruediv__", "__matmul__", "__rmatmul__", "__neg__", "__abs__",
              "__pow__", "__lt__", "__le__", "__gt__", "__ge__", "__and__", "__or__", "__invert__"):
    setattr(RemoteShard, _name, _refusing(_name))


class Mesh:
    """Named axes over device positions (the port's ``jax.sharding.Mesh``):
    ``devices`` holds position ids, ``axis_names`` and ``shape`` name its
    axes.  ``per_process`` is the number of consecutive position ids each
    process owns (position id // ``per_process`` is its process); None puts
    every position in this process."""

    def __init__(self, devices, axis_names: Sequence[str], per_process: Optional[int] = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of {self.devices.ndim} dims for axes {self.axis_names}")
        self.per_process = None if per_process is None else int(per_process)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(n) for n in self.devices.shape)))

    def processes_of(self, ids) -> set:
        """The processes owning the position ids ``ids``."""
        if self.per_process is None:
            return {_process_rank()}
        return {int(d) // self.per_process for d in np.asarray(ids).reshape(-1)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, per_process={self.per_process})"


_GROUPS: Dict[Tuple[int, ...], object] = {}


def _group(ranks: Tuple[int, ...]):
    """The process group over ``ranks`` (None: the default group).  Every
    process builds each group, member or not, in the same order, as
    ``torch.distributed.new_group`` requires."""
    d = _dist()
    if d is None or ranks == tuple(range(d.get_world_size())):
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = d.new_group(list(ranks))
    return _GROUPS[ranks]


class MeshComm(Communication):
    """``size`` shard positions along the split axis.

    ``MeshComm(n)`` holds all n positions in this process.  ``MeshComm(mesh,
    split_axis=...)`` takes a :class:`Mesh` (:func:`hybrid_mesh`,
    :func:`local_mesh`): when its positions belong to processes, the comm is
    a *process comm*, whose collectives go through ``torch.distributed`` on
    the group of its processes, each process owning a contiguous block of
    positions.  A position replicated over processes (an ici axis under a
    dcn tier of processes) is held by each of them, and a comm over such
    positions runs in each process alone."""

    def __init__(self, size=1, split_axis: str = SPLIT_AXIS):
        if isinstance(size, Mesh):
            mesh = size
            if split_axis not in mesh.axis_names:
                raise ValueError(f"split_axis {split_axis!r} not in mesh axes {mesh.axis_names}")
            axis = mesh.axis_names.index(split_axis)
            n = int(mesh.devices.shape[axis])
            owners = [mesh.processes_of(np.take(mesh.devices, i, axis=axis)) for i in range(n)]
            if mesh.per_process is None or all(o == owners[0] for o in owners) and len(owners[0]) > 1:
                owner = None  # every process holds every position
            elif all(len(o) == 1 for o in owners):
                owner = tuple(next(iter(o)) for o in owners)
            else:
                raise NotImplementedError(
                    f"positions of axis {split_axis!r} held by several processes each, but not by all "
                    f"alike: {owners}"
                )
        else:
            n = int(size)
            mesh, owner = Mesh(np.arange(max(n, 0)), (split_axis,)), None
        if n < 1:
            raise ValueError(f"a mesh needs at least one position, got {n}")
        self.__size = n
        self.mesh = mesh
        self.split_axis = split_axis
        self.__owner = owner
        me = _process_rank()
        if owner is None:
            self.__ranks: Tuple[int, ...] = ()
            self.__local = tuple(range(n))
            self.__group = None
        else:
            self.__ranks = tuple(sorted(set(owner)))
            self.__local = tuple(r for r in range(n) if owner[r] == me)
            self.__group = _group(self.__ranks)
            if any(b < a for a, b in zip(owner, owner[1:])):
                raise ValueError(f"processes must own contiguous blocks of positions in order, got {owner}")

    @property
    def size(self) -> int:
        """Number of shard positions (all processes' together)."""
        return self.__size

    @property
    def rank(self) -> int:
        """Index of this process among the comm's processes; 0 in one
        process, and -1 in a process that holds none of the positions."""
        if self.__owner is None:
            return 0
        me = _process_rank()
        return self.__ranks.index(me) if me in self.__ranks else -1

    @property
    def nprocs(self) -> int:
        """Number of processes the positions belong to."""
        return len(self.__ranks) if self.__owner is not None else 1

    @property
    def local_positions(self) -> Tuple[int, ...]:
        """The positions whose shards this process holds."""
        return self.__local

    @property
    def is_process_comm(self) -> bool:
        """Whether the collectives go through ``torch.distributed``."""
        return self.__owner is not None

    @property
    def spans_processes(self) -> bool:
        """Whether another process owns some of the positions."""
        return len(self.__local) < self.__size

    @property
    def group(self):
        """The ``torch.distributed`` group of the comm's processes (None:
        the default group)."""
        return self.__group

    def owner(self, position: int) -> int:
        """The global process rank owning ``position``."""
        return _process_rank() if self.__owner is None else self.__owner[position]

    def is_distributed(self) -> bool:
        return self.__size > 1

    def process_index(self, position: int) -> int:
        """The index, among the comm's processes (the rank in
        :attr:`group`), of the process owning ``position``; 0 in one
        process."""
        return 0 if self.__owner is None else self.__ranks.index(self.__owner[position])

    def positions_of(self, index: int) -> Tuple[int, ...]:
        """The positions of the comm's ``index``-th process, in order."""
        if self.__owner is None:
            return tuple(range(self.__size))
        rank = self.__ranks[index]
        return tuple(r for r in range(self.__size) if self.__owner[r] == rank)

    @property
    def backend(self) -> Optional[str]:
        """The ``torch.distributed`` backend of the comm's group; None in
        one process."""
        if self.__owner is None:
            return None
        return str(torch.distributed.get_backend(self.__group))

    def exchange_route(self, device) -> str:
        """How :func:`~heat_tpu_torch.parallel.collectives.exchange` moves
        bytes between this comm's processes for tensors on ``device``,
        read from the backend alone: ``"local"`` when no other process
        owns a position, ``"staged"`` for CUDA tensors on gloo (through
        pinned host buffers), else ``"direct"``.  Gloo's documented table
        promises CUDA tensors only to ``broadcast`` and ``all_reduce``;
        torch 2.11's gloo takes ``all_to_all_single`` on them too, copying
        them through the host itself at the staged route's speed
        (``scripts/probe_gloo_cuda.py``), so the port stages them where the
        copies are its own and counted (``staged_bytes``)."""
        if not self.spans_processes:
            return "local"
        if torch.device(device).type == "cuda" and self.backend == "gloo":
            return "staged"
        return "direct"

    def __repr__(self) -> str:
        if self.__owner is None:
            return f"MeshComm(size={self.__size})"
        cuda = self.exchange_route("cuda") if torch.distributed.is_initialized() else "local"
        return (f"MeshComm(size={self.__size}, processes={self.nprocs}, local={self.__local}, "
                f"backend={self.backend!r}, cuda_exchange={cuda!r})")

    # ------------------------------------------------------------ locality
    def per_position(self, fn: Callable[[int], torch.Tensor], gshape, split) -> List:
        """One entry per position: ``fn(r)`` for this process's positions,
        a :class:`RemoteShard` of the chunk rule's shape for the others.  A
        replicated result (``split`` None) is held whole by every process:
        its first local tensor stands at every position."""
        if not self.spans_processes:
            return [fn(r) for r in range(self.__size)]
        if not self.__local:
            raise ValueError(f"this process holds no position of {self!r}")
        if split is None:
            return [fn(self.__local[0])] * self.__size
        out = [None] * self.__size
        for r in self.__local:
            out[r] = fn(r)
        like = out[self.__local[0]]
        for r in range(self.__size):
            if out[r] is None:
                out[r] = RemoteShard(r, self.chunk(tuple(gshape), split, rank=r)[1], like.dtype, like.device)
        return out

    def local_shards(self, shards: Sequence) -> List[torch.Tensor]:
        """The entries of a per-position list that this process holds."""
        return [shards[r] for r in self.__local]

    # ---------------------------------------------------------- partitions
    def chunk(
        self, shape: Tuple[int, ...], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """(offset, local shape, slices) of one position's shard
        (heat_tpu/parallel/mesh.py:121)."""
        if split is None:
            return 0, tuple(shape), tuple(slice(0, end) for end in shape)
        rank = 0 if rank is None else int(rank)
        dims = len(shape)
        split = split % dims if dims else 0
        size = shape[split]
        per = _ceil_div(size, self.__size) if size > 0 else 0
        start = min(rank * per, size)
        end = min((rank + 1) * per, size)
        lshape = list(shape)
        lshape[split] = end - start
        slices = tuple(
            slice(start, end) if i == split else slice(0, shape[i]) for i in range(dims)
        )
        return start, tuple(lshape), slices

    def lshape_map(self, shape: Tuple[int, ...], split: Optional[int]) -> np.ndarray:
        """(size, ndim) matrix of per-position shard shapes
        (heat_tpu/parallel/mesh.py:149)."""
        n = self.__size
        if len(shape) == 0:
            return np.zeros((n, 0), dtype=np.int64)
        out = np.empty((n, len(shape)), dtype=np.int64)
        for r in range(n):
            out[r] = self.chunk(shape, split, rank=r)[1]
        return out

    # ------------------------------------------------------ sub-communicators
    def _submesh(self, indices) -> "MeshComm":
        """New MeshComm over the given positions along the split axis (other
        mesh axes are preserved; heat_tpu/parallel/mesh.py:193)."""
        if not len(indices):
            raise ValueError("sub-communicator needs at least one device")
        axis = self.mesh.axis_names.index(self.split_axis)
        devices = np.take(self.mesh.devices, np.asarray(indices), axis=axis)
        return MeshComm(Mesh(devices, self.mesh.axis_names, self.mesh.per_process), split_axis=self.split_axis)

    def Split(self, color: int = 0, key: int = 0) -> "MeshComm":
        """Sub-communicator creation (heat_tpu/parallel/mesh.py:203): a
        scalar ``color`` gives a fresh communicator over all positions; a
        sequence of one colour a position gives the group holding position
        ``key`` (:meth:`split_groups` gives every group).  Across processes
        every process must make the same call: each builds every group."""
        colors = np.asarray(color)
        if colors.ndim == 0:
            return self._submesh(list(range(self.size)))
        if colors.shape != (self.size,):
            raise ValueError(f"per-device colors must have shape ({self.size},), got {colors.shape}")
        key = int(key)
        if not 0 <= key < self.size:
            # key names the perspective position: a modulo wrap would pick
            # an arbitrary group for MPI-style key=rank values
            raise ValueError(
                f"key must be a split-axis position in [0, {self.size}), got {key}; "
                "use split_groups() for all groups at once"
            )
        return self.split_groups(colors)[colors.tolist()[key]]

    def split_groups(self, colors) -> dict:
        """All colour-group sub-communicators at once: ``{color: MeshComm}``
        (heat_tpu/parallel/mesh.py:243)."""
        colors = np.asarray(colors)
        if colors.shape != (self.size,):
            raise ValueError(f"per-device colors must have shape ({self.size},), got {colors.shape}")
        return {
            c: self._submesh([i for i in range(self.size) if colors[i] == c])
            for c in np.unique(colors).tolist()
        }


_world_comm: Optional[MeshComm] = None
_default_comm: Optional[MeshComm] = None


def world() -> MeshComm:
    """The all-position context.  In one process: one position, which on
    the card is the one H100.  After :func:`init_distributed` with a
    process group up: one position a process (:func:`local_mesh`)."""
    global _world_comm
    if _world_comm is None:
        _world_comm = local_mesh() if _dist() is not None else MeshComm(1)
    return _world_comm


def get_comm() -> MeshComm:
    """The current default context; starts as :func:`world`."""
    return _default_comm if _default_comm is not None else world()


def use_comm(comm: Optional[MeshComm] = None) -> None:
    """Set the default context (``None`` restores :func:`world`)."""
    global _default_comm
    if comm is not None and not isinstance(comm, MeshComm):
        raise TypeError(f"comm must be a MeshComm, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm: Optional[Communication]) -> MeshComm:
    """Validate-or-default a communication context."""
    if comm is None:
        return get_comm()
    if isinstance(comm, MeshComm):
        return comm
    raise TypeError(f"comm must be None or a MeshComm, got {type(comm)}")


def local_mesh(n: Optional[int] = None, axis: str = SPLIT_AXIS) -> MeshComm:
    """A MeshComm over ``n`` positions (heat_tpu/parallel/mesh.py:292).  In
    one process they all live there (``n`` defaults to 1, the card); with a
    process group up they are dealt to the processes in contiguous blocks
    (``n`` defaults to one a process and must be a multiple of the process
    count), which makes it a process comm."""
    procs = _process_count()
    if _dist() is None:
        return MeshComm(1 if n is None else n, split_axis=axis)
    n = procs if n is None else int(n)
    if n < procs or n % procs:
        raise ValueError(f"{n} positions do not deal evenly over {procs} processes")
    return MeshComm(Mesh(np.arange(n), (axis,), per_process=n // procs), split_axis=axis)


# ------------------------------------------------------------------ bootstrap
#: the launchers' (rank, size, local rank) variables, in the order they are read
_LAUNCHERS = (
    ("torchrun", "RANK", "WORLD_SIZE", "LOCAL_RANK"),
    ("slurm", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    ("openmpi", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
    ("pmi", "PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
)


def _launcher() -> Optional[Tuple[str, int, int, int]]:
    """(launcher, rank, size, local rank) from the first launcher whose
    size variable is set, sizes parsed strictly; None without one."""
    for name, rank_var, size_var, local_var in _LAUNCHERS:
        if os.environ.get(size_var, "").strip():
            size = envparse.env_int(size_var, 1)
            rank = envparse.env_int(rank_var, 0, minimum=0)
            local = envparse.env_int(local_var, 0, minimum=0)
            if rank >= size:
                raise ValueError(f"{rank_var}={rank} is not below {size_var}={size}")
            return name, rank, size, local
    return None


def _looks_multiprocess() -> bool:
    """Does the environment look like one process of many?  (The strict
    parse refuses a malformed size instead of starting alone.)"""
    found = _launcher()
    return found is not None and found[2] > 1


def _backend_for_device() -> str:
    """NCCL when this process's default device is a CUDA card, else gloo."""
    from ..core import devices

    return "nccl" if devices.get_device().device_type == "gpu" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout=None,
) -> Tuple[int, int]:
    """Start the process group (heat_tpu/parallel/mesh.py:300, over
    ``torch.distributed``) and return ``(rank, world_size)``.

    * Already started: returns the group's (rank, size).
    * Explicit arguments: ``init_process_group`` on ``tcp://`` +
      ``coordinator_address`` with that size and rank; errors propagate.
    * No arguments: the launcher's environment (torchrun's ``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``;
      Slurm's ``SLURM_PROCID``/``SLURM_NTASKS``; Open MPI's
      ``OMPI_COMM_WORLD_RANK``/``_SIZE``; PMI's ``PMI_RANK``/``PMI_SIZE``;
      the last three with ``MASTER_ADDR``/``MASTER_PORT`` for the store).
      torchrun's variables start a group even at size 1; the others at a
      size above 1.  No launcher: a plain single-process run, a no-op
      returning ``(0, 1)``.  A launcher environment whose group fails to
      come up raises ``RuntimeError``.

    The backend is NCCL when the process's default device is the card and
    gloo on the CPU; ``backend=`` wins.  Before NCCL starts, the process is
    bound to its local rank's card (``LOCAL_RANK`` or the launcher's own
    variable; 0 without one).  Nothing switches backend or drops to
    one process when a start fails.  ``timeout`` (seconds or a timedelta)
    bounds the store's wait."""
    global _world_comm
    d = _dist()
    if d is not None:
        return d.get_rank(), d.get_world_size()
    if isinstance(timeout, (int, float)):
        timeout = datetime.timedelta(seconds=timeout)
    kw = {} if timeout is None else {"timeout": timeout}
    explicit = coordinator_address is not None or num_processes is not None or process_id is not None
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("explicit start needs coordinator_address, num_processes and process_id")
        backend = backend or _backend_for_device()
        _bind_card(backend, envparse.env_int("LOCAL_RANK", 0, minimum=0))
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
            rank=int(process_id), **kw,
        )
    else:
        found = _launcher()
        if found is None:
            return 0, 1
        name, rank, size, local = found
        if name != "torchrun" and size == 1:
            return 0, 1
        backend = backend or _backend_for_device()
        try:
            _bind_card(backend, local)
            addr, port = os.environ.get("MASTER_ADDR", "").strip(), os.environ.get("MASTER_PORT", "").strip()
            if not addr or not port:
                raise ValueError(f"{name} names no store: set MASTER_ADDR and MASTER_PORT")
            torch.distributed.init_process_group(
                backend, init_method=f"tcp://{addr}:{envparse.env_int('MASTER_PORT', 0)}", world_size=size,
                rank=rank, **kw,
            )
        except Exception as exc:
            raise RuntimeError(
                f"a {name} launcher environment (rank {rank} of {size}) was found but the "
                f"{backend} process group did not come up: {exc}"
            ) from exc
    _world_comm = None
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


def _bind_card(backend: str, local_rank: int) -> None:
    """Bind this process to card ``local_rank`` before NCCL starts, and make
    that card the default device."""
    if backend != "nccl":
        return
    from ..core import devices

    torch.cuda.set_device(local_rank)
    devices.use_device(devices.Device("gpu", local_rank))


def hybrid_mesh(ici: dict, dcn: Optional[dict] = None, *, process_is_granule: bool = False) -> Mesh:
    """A dcn × ici mesh (heat_tpu/parallel/mesh.py:401): ``ici`` names the
    axes inside a granule (tensor, sequence, expert parallelism), ``dcn``
    the axes across granules (data parallelism, DASO's outer tier); dcn
    axes lead.  The port's granule is a process, whatever
    ``process_is_granule`` says: with a process group up, the dcn axes'
    product must equal the process count and each process owns one
    granule's positions; in one process every position lives there.

    >>> mesh = hybrid_mesh({"split": 4}, {"dp": 2})
    >>> MeshComm(mesh, split_axis="dp")   # spans the processes
    """
    dcn = dict(dcn or {})
    ici = dict(ici)
    if not ici:
        raise ValueError("ici must name at least one mesh axis")
    if set(dcn) & set(ici):
        raise ValueError(f"axis names must be distinct across tiers: {sorted(set(dcn) & set(ici))}")
    names = tuple(dcn) + tuple(ici)
    shape = tuple(int(v) for v in dcn.values()) + tuple(int(v) for v in ici.values())
    n_dcn = int(np.prod(tuple(dcn.values()))) if dcn else 1
    n_ici = int(np.prod(tuple(ici.values())))
    devices = np.arange(n_dcn * n_ici).reshape(shape)
    procs = _process_count()
    if _dist() is None:
        return Mesh(devices, names)
    if n_dcn != procs:
        raise ValueError(f"the dcn tier ({n_dcn} granules) must span the {procs} processes")
    return Mesh(devices, names, per_process=n_ici)
