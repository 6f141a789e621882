"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

``DataParallelOptimizer`` wraps the optimizer that the training step calls.
It takes a ``torch.optim.Optimizer`` already bound to a model's parameters,
or an unbound factory such as ``ht.optim.adam(1e-3)`` (or any callable of
the parameters), which :meth:`DataParallelOptimizer.init` binds.

``DASO`` is the hierarchical delayed-sync scheme: slices of positions train
their own copies of the model between global syncs, and a sync replaces
every slice's floating variables by their mean over the slices.  The JAX
package reads the slice count from a two-axis (dcn, ici) mesh; the port's
``MeshComm`` has one axis, so ``DASO(mesh=(n_slices, per_slice))`` names
the layout, with ``n_slices · per_slice == comm.size``; no ``mesh`` means one
slice, as a one-axis JAX mesh gives.  The phase machine (warm-up, cycling,
cool-down, the skip adaptation) is host Python, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import MeshComm, sanitize_comm

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

    ``mesh`` is ``(n_slices, per_slice)`` over ``comm``'s positions.
    :class:`heat_tpu_torch.nn.DataParallelMultiGPU` keeps one copy of the
    model and one optimizer state a slice, steps each slice on its B/n rows,
    and averages the slices' floating variables whenever
    :meth:`should_sync_globally` says so."""

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
        mesh = tuple(int(m) for m in mesh)
        if len(mesh) != 2 or mesh[0] * mesh[1] != self.comm.size:
            raise ValueError(f"mesh {mesh} must be (n_slices, per_slice) with a product of comm.size = {self.comm.size}")
        self.mesh = mesh
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
        return self.mesh[0]

    @property
    def tx(self):
        return self.local_optimizer.tx

    def _bind_model(self, model) -> None:
        self.local_optimizer._bind_model(model)

    def stack_tree(self, module: torch.nn.Module) -> List[torch.nn.Module]:
        """``n_slices`` copies of ``module``, one a slice."""
        return [module] + [copy.deepcopy(module) for _ in range(self.n_slices - 1)]

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
        mean over the slices; other buffers by slice 0's."""
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

    def zero_grad(self) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)

    def print0(self, *args, **kwargs) -> None:
        if self.verbose:
            print(*args, **kwargs)
