"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

``DataParallelOptimizer`` wraps the optimizer that the training step calls.
It takes a ``torch.optim.Optimizer`` already bound to a model's parameters,
or an unbound factory such as ``ht.optim.adam(1e-3)`` (or any callable of
the parameters), which :meth:`DataParallelOptimizer.init` binds.

``DASO`` is the hierarchical delayed-sync scheme: slices of positions train
their own copies of the model between global syncs, and a sync replaces
every slice's floating variables by their mean over the slices.  As in the
JAX package the slice count is a two-axis (dcn, ici) mesh's dcn size:
:func:`~heat_tpu_torch.parallel.hybrid_mesh` builds one, and after
:func:`~heat_tpu_torch.parallel.init_distributed` its dcn tier is the
processes, each holding its slice, so a sync is one all-reduce a dtype over
the dcn group.  ``DASO(mesh=(n_slices, per_slice))`` names a layout of one
process, with ``n_slices · per_slice == comm.size``; no ``mesh`` means one
slice, as a one-axis JAX mesh gives.  The phase machine (warm-up, cycling,
cool-down, the skip adaptation) is host Python, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import torch

import numpy as np

from ..parallel import collectives
from ..parallel.mesh import Mesh, MeshComm, sanitize_comm

__all__ = ["DASO", "DataParallelOptimizer"]


def _bind(optimizer, params) -> torch.optim.Optimizer:
    """A new optimizer like ``optimizer`` over ``params``: an unbound
    factory is called, a bound optimizer rebuilt with its defaults."""
    if isinstance(optimizer, torch.optim.Optimizer):
        return type(optimizer)(params, **optimizer.defaults)
    return optimizer(params)


class DataParallelOptimizer:
    """Thin wrapper over the optimizer of a data-parallel model.

    ``torch_optimizer`` is a bound ``torch.optim.Optimizer`` or an unbound
    factory of one (``ht.optim.sgd(0.1)``); ``optimizer`` stays as an
    alias."""

    def __init__(self, torch_optimizer=None, blocking: bool = False, optimizer=None):
        if torch_optimizer is None:
            torch_optimizer = optimizer
        if not (isinstance(torch_optimizer, torch.optim.Optimizer) or callable(torch_optimizer)):
            raise TypeError("optimizer must be a torch.optim.Optimizer or a factory of one")
        self.tx = torch_optimizer
        self.torch_optimizer = torch_optimizer
        self.blocking = blocking
        self._model = None

    def _bind_model(self, model) -> None:
        self._model = model

    @property
    def state(self):
        """The bound optimizer's per-parameter state (None before :meth:`init`)."""
        return self.torch_optimizer.state if isinstance(self.torch_optimizer, torch.optim.Optimizer) else None

    def init(self, params) -> None:
        """Bind to ``params``; an optimizer already bound to them stays."""
        params = list(params)
        if isinstance(self.torch_optimizer, torch.optim.Optimizer):
            bound = {id(p) for g in self.torch_optimizer.param_groups for p in g["params"]}
            if bound == {id(p) for p in params}:
                return
        self.torch_optimizer = _bind(self.tx, params)

    def step(self) -> None:
        """One update from the gradients in the parameters' ``.grad``."""
        self.torch_optimizer.step()

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)


class DASO:
    """Hierarchical delayed-sync data parallelism (heat_tpu/optim/dp_optimizer.py:75).

    ``mesh`` is a two-axis (dcn, ici) :class:`~heat_tpu_torch.parallel.Mesh`
    (:func:`~heat_tpu_torch.parallel.hybrid_mesh`) or ``(n_slices,
    per_slice)`` over ``comm``'s positions.
    :class:`heat_tpu_torch.nn.DataParallelMultiGPU` keeps one copy of the
    model and one optimizer state a slice this process holds
    (:attr:`local_slices`), steps each slice on its B/n rows, and averages
    the slices' floating variables whenever :meth:`should_sync_globally`
    says so.  ``reduced_comms`` holds one sub-communicator per intra-slice
    position, spanning the dcn axis (heat_tpu/optim/dp_optimizer.py:150)."""

    def __init__(
        self,
        local_optimizer: DataParallelOptimizer,
        mesh: Optional[Tuple[int, int]] = None,
        comm: Optional[MeshComm] = None,
        total_epochs: int = 1,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler: Optional[Callable] = None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        sending_chunk_size: int = 10_000_000,
        downcast_type=torch.bfloat16,
        use_mpi_groups: bool = True,
        skip_reduction_factor: int = 2,
        local_skip_factor: int = 4,
        verbose: bool = False,
    ):
        self.local_optimizer = local_optimizer
        self.use_mpi_groups = use_mpi_groups
        self.skip_reduction_factor = max(int(skip_reduction_factor), 1)
        self.local_skip_factor = max(int(local_skip_factor), 1)
        self.comm = sanitize_comm(comm)
        if mesh is None:
            mesh = (1, self.comm.size)
        if not isinstance(mesh, Mesh):
            mesh = tuple(int(m) for m in mesh)
            if len(mesh) != 2 or mesh[0] * mesh[1] != self.comm.size:
                raise ValueError(
                    f"mesh {mesh} must be (n_slices, per_slice) with a product of comm.size = {self.comm.size}"
                )
            grid = Mesh(np.arange(mesh[0] * mesh[1]).reshape(mesh), ("dcn", "ici"))
        else:
            grid = mesh
        self.mesh = mesh
        names = grid.axis_names
        self.dcn_axis = names[0] if len(names) > 1 else None
        self.reduced_comms: List[MeshComm] = []
        if self.dcn_axis is not None:
            ici_pos = 1
            for i in range(grid.devices.shape[ici_pos]):
                col = np.take(grid.devices, [i], axis=ici_pos).reshape(-1)
                self.reduced_comms.append(MeshComm(Mesh(col, (self.dcn_axis,), grid.per_process),
                                                   split_axis=self.dcn_axis))
        self._n_slices = int(grid.shape[self.dcn_axis]) if self.dcn_axis else 1
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.scheduler = scheduler
        self.stability_level = stability_level
        self.max_global_skips = max_global_skips
        self.downcast_type = downcast_type
        self.verbose = verbose
        self.global_skip = 0
        self.epoch = 0
        self.batches_seen = 0
        self._last_losses: List[float] = []
        self.optimizers: List[torch.optim.Optimizer] = []

    @property
    def n_slices(self) -> int:
        return self._n_slices

    @property
    def dcn_comm(self) -> Optional[MeshComm]:
        """The comm over the slices along the dcn axis (a process comm when
        the dcn tier is the processes)."""
        return self.reduced_comms[0] if self.reduced_comms else None

    @property
    def across_processes(self) -> bool:
        return self.dcn_comm is not None and self.dcn_comm.is_process_comm

    @property
    def local_slices(self) -> Tuple[int, ...]:
        """The slices whose copies this process holds."""
        return self.dcn_comm.local_positions if self.across_processes else tuple(range(self.n_slices))

    @property
    def tx(self):
        return self.local_optimizer.tx

    def _bind_model(self, model) -> None:
        self.local_optimizer._bind_model(model)

    def stack_tree(self, module: torch.nn.Module) -> List[torch.nn.Module]:
        """One copy of ``module`` a slice this process holds; across
        processes every slice starts from slice 0's variables."""
        if self.across_processes:
            with torch.no_grad():
                for t in module.state_dict(keep_vars=True).values():
                    t.data.copy_(collectives.bcast([t.data], root=0, comm=self.dcn_comm)[0])
        return [module] + [copy.deepcopy(module) for _ in range(len(self.local_slices) - 1)]

    def init(self, replicas: Sequence[torch.nn.Module]) -> None:
        """One optimizer state a slice, over that slice's copy."""
        self.optimizers = [_bind(self.tx, list(r.parameters())) for r in replicas]

    # ---------------------------------------------------------------- phases
    @property
    def phase(self) -> str:
        if self.epoch < self.warmup_epochs:
            return "warmup"
        if self.epoch >= self.total_epochs - self.cooldown_epochs:
            return "cooldown"
        return "cycling"

    def epoch_loss_logic(self, loss: float, loss_globally_averaged: bool = False) -> None:
        """Adapt ``global_skip`` from the epoch loss trend: a stable loss
        skips more syncs, a worsening one fewer."""
        self._last_losses.append(float(loss))
        if len(self._last_losses) < 2:
            self.global_skip = 1 if self.phase == "cycling" else 0
            return
        prev, curr = self._last_losses[-2], self._last_losses[-1]
        if self.phase != "cycling":
            self.global_skip = 0
            return
        rel_impr = (prev - curr) / max(abs(prev), 1e-12)
        if rel_impr < 0:
            self.global_skip = max(self.global_skip // self.skip_reduction_factor, 1)
        elif rel_impr < self.stability_level:
            self.global_skip = min(max(self.global_skip * 2, 1), self.max_global_skips)

    @property
    def local_skip(self) -> int:
        return max(self.global_skip // self.local_skip_factor, 1)

    def add_scaler(self, scaler) -> None:
        self.scaler = scaler

    def set_model(self, model) -> None:
        self._bind_model(model)

    def reset(self) -> None:
        self.global_skip = 0
        self.epoch = 0
        self.batches_seen = 0
        self._last_losses = []

    def next_epoch(self, epoch_loss: float) -> None:
        """Advance the phase machine at an epoch's end."""
        self.epoch_loss_logic(epoch_loss)
        self.epoch += 1

    # ----------------------------------------------------------------- syncs
    def should_sync_globally(self) -> bool:
        """True when this batch ends with the cross-slice average."""
        if self.phase in ("warmup", "cooldown") or self.global_skip <= 1:
            return True
        return self.batches_seen % self.global_skip == 0

    @torch.no_grad()
    def sync(self, replicas: Sequence[torch.nn.Module]) -> None:
        """Every slice's floating parameters and buffers replaced by their
        mean over the slices; other buffers by slice 0's.  ``replicas`` are
        this process's slices; across processes the floating variables are
        summed by one all-reduce a dtype over the dcn group."""
        if self.across_processes:
            return self._sync_across(replicas)
        if len(replicas) < 2:
            return
        states = [r.state_dict(keep_vars=True) for r in replicas]
        for name, first in states[0].items():
            if torch.is_floating_point(first):
                mean = torch.stack([s[name].detach() for s in states]).mean(0).to(first.dtype)
                for s in states:
                    s[name].data.copy_(mean)
            else:
                for s in states[1:]:
                    s[name].data.copy_(first)

    def _sync_across(self, replicas: Sequence[torch.nn.Module]) -> None:
        comm, n = self.dcn_comm, self.n_slices
        states = [r.state_dict(keep_vars=True) for r in replicas]
        floats, others = [], []
        for name, first in states[0].items():
            if torch.is_floating_point(first):
                total = first.detach().clone()
                for st in states[1:]:
                    total += st[name].detach()
                floats.append((name, total))
            else:
                others.append(name)
        collectives.psum_flat([t for _, t in floats], comm)
        for name, t in floats:
            mean = (t / n).to(t.dtype)
            for st in states:
                st[name].data.copy_(mean)
        for name in others:
            value = collectives.bcast([states[0][name].data], root=0, comm=comm)[0]
            for st in states:
                st[name].data.copy_(value)

    def zero_grad(self) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)

    def print0(self, *args, **kwargs) -> None:
        if self.verbose:
            print(*args, **kwargs)
