"""Data-parallel training (counterpart of heat_tpu/nn/data_parallel.py).

The JAX package compiles one training step over a batch sharded on the
mesh, with the parameters replicated: GSPMD computes the mean loss over the
whole batch and XLA inserts the gradient all-reduce.  On a comm of one
process every position shares one card, so the step is one forward and
backward over the global batch (the same mean loss, and BatchNorm
statistics over the whole batch) followed by the optimizer's update: there
is nothing to all-reduce.

On a process comm (after :func:`~heat_tpu_torch.parallel.init_distributed`,
e.g. ``world()``) each process runs the forward and backward over its own
rows only (the chunk rule's rows of its positions), with the local mean
loss scaled by its share of the global batch, so the processes' sum is the
global mean.  The gradients, flattened into one buffer with the loss, are
all-reduced once before the optimizer's step; BatchNorm layers all-reduce
their statistics (:func:`~heat_tpu_torch.models.resnet.batch_stats_across`);
:meth:`DataParallel.init` broadcasts the parameters from position 0.

``DataParallelMultiGPU`` with a :class:`~heat_tpu_torch.optim.DASO`
optimizer runs the two-tier step: one copy of the model a slice, each
trained on its B/n rows of the batch with its own optimizer state, and the
slices averaged when DASO schedules a sync.  With a dcn tier of processes
(:func:`~heat_tpu_torch.parallel.hybrid_mesh` after ``init_distributed``)
each process holds its slice and the sync is an all-reduce over the dcn
group.  Inference then uses the slice-averaged model.

Convolutions and products of a step run in IEEE f32 (no TF32).
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..core.dndarray import DNDarray, _wrap
from ..models.resnet import batch_stats_across, no_tf32
from ..parallel import collectives
from ..parallel.mesh import MeshComm, sanitize_comm

__all__ = ["DataParallel", "DataParallelMultiGPU"]


def _default_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """MSE for float targets of the logits' shape, else softmax
    cross-entropy of integer targets (heat_tpu/nn/data_parallel.py:33)."""
    if logits.shape == targets.shape and torch.is_floating_point(targets):
        return torch.mean((logits - targets) ** 2)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(logp.gather(-1, targets.long().unsqueeze(-1)))


def _tensor(x, device: torch.device) -> torch.Tensor:
    """The global tensor of a DNDarray, or ``x`` as a tensor, on ``device``."""
    t = x.larray if isinstance(x, DNDarray) else torch.as_tensor(x)
    return t.to(device)


def _local_rows(x, comm: MeshComm, device: torch.device):
    """(this process's rows of the batch ``x``, the global batch size): a
    DNDarray split 0 on ``comm`` gives its local shards; a replicated batch
    (a tensor, array or replicated DNDarray) the rows the chunk rule gives
    this process's positions."""
    if isinstance(x, DNDarray) and x.split == 0 and x.comm.is_process_comm:
        return torch.cat(x.comm.local_shards(x.shards)).to(device), x.shape[0]
    t = _tensor(x, device)
    local = comm.local_positions
    lo = comm.chunk(tuple(t.shape), 0, rank=local[0])[0]
    n = sum(comm.chunk(tuple(t.shape), 0, rank=r)[1][0] for r in local)
    return t[lo:lo + n], t.shape[0]


class DataParallel:
    """Data-parallel wrapper around a ``torch.nn.Module`` (heat_tpu/nn/data_parallel.py:42).

    ``loss = model.train_step(batch, targets)`` runs one step: the forward
    over the global batch (with ``train=True`` where the module's forward
    takes it), the loss, the backward and the optimizer's update.  The
    loss comes back as a 0-d tensor on the device, with no host sync."""

    def __init__(
        self,
        module: torch.nn.Module,
        comm: Optional[MeshComm] = None,
        optimizer: Optional[Any] = None,
        loss_fn: Optional[Callable] = None,
        blocking: bool = True,
        blocking_parameter_updates: Optional[bool] = None,
    ):
        if blocking_parameter_updates is not None:
            blocking = blocking_parameter_updates
        self.module = module
        self.blocking = blocking
        self.comm = sanitize_comm(comm)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = None
        self._accepts_train = "train" in inspect.signature(module.forward).parameters
        if optimizer is not None and hasattr(optimizer, "_bind_model"):
            optimizer._bind_model(self)

    @property
    def device(self) -> torch.device:
        for t in list(self.module.parameters()) + list(self.module.buffers()):
            return t.device
        return torch.device("cpu")

    # ------------------------------------------------------------------ init
    def init(self, rngs, sample_input) -> "DataParallel":
        """Make the module's parameters where they are not made yet (a
        module with ``needs_init``, e.g. an ``MLP`` without its input width)
        from ``rngs`` (a seed or a ``torch.Generator``) and a sample input;
        a module that is already initialised is taken as it is.  Then the
        optimizer is bound to the parameters."""
        from ..optim.dp_optimizer import DASO

        if isinstance(self.optimizer, DASO) and not isinstance(self, DataParallelMultiGPU):
            raise TypeError("DASO requires the two-tier step: use DataParallelMultiGPU")
        self._init_module(rngs, sample_input)
        self.params = list(self.module.parameters())
        if self.comm.is_process_comm:
            # every process starts from position 0's parameters and buffers
            with torch.no_grad():
                for t in self.params + list(self.module.buffers()):
                    t.copy_(collectives.bcast([t], root=0, comm=self.comm)[0])
        if self.optimizer is not None and not isinstance(self.optimizer, DASO):
            self.optimizer.init(self.params)
        return self

    def _init_module(self, rngs, sample_input) -> None:
        if getattr(self.module, "needs_init", False):
            gen = rngs
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=self.device).manual_seed(int(rngs))
            sample = sample_input.larray if isinstance(sample_input, DNDarray) else torch.as_tensor(sample_input)
            self.module.init_parameters(sample, gen)

    def _loss_and_grads(self, module: torch.nn.Module, b: torch.Tensor, t: torch.Tensor, scale: float = 1.0,
                        across: Optional[MeshComm] = None) -> torch.Tensor:
        """Forward, loss (times ``scale``) and backward of ``module`` on
        (b, t), BatchNorm statistics over every process of ``across``; the
        gradients land in the parameters' ``.grad``."""
        kw = {"train": True} if self._accepts_train else {}
        with no_tf32(), batch_stats_across(across):
            logits = module(b, **kw)
            loss = (self.loss_fn or _default_loss)(logits, t)
            if scale != 1.0:
                loss = loss * scale
            loss.backward()
        return loss.detach()

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def __call__(self, x):
        """The forward pass over the global batch (running statistics);
        a DNDarray input gives a DNDarray split 0."""
        if self.params is None:
            raise RuntimeError("call .init(rng, sample_input) first")
        with no_tf32():
            out = self.module(_tensor(x, self.device))
        if isinstance(x, DNDarray):
            return _wrap(out, 0 if out.ndim else None, x.device, x.comm)
        return out

    def forward(self, x):
        return self(x)

    # ------------------------------------------------------------ train step
    def train_step(self, batch, targets) -> torch.Tensor:
        """One training step over the global batch; returns the loss as a
        0-d device tensor.  On a process comm each process steps on its
        rows and the loss is the global mean (the loss function must be a
        mean over rows, as the default is)."""
        if self.params is None:
            raise RuntimeError("call .init(rng, sample_input) first")
        if self.optimizer is None:
            raise RuntimeError("no optimizer attached")
        dev = self.device
        if self.comm.is_process_comm:
            return self._process_step(batch, targets, dev)
        b, t = _tensor(batch, dev), _tensor(targets, dev)
        self.optimizer.zero_grad()
        loss = self._loss_and_grads(self.module, b, t)
        self.optimizer.step()
        return loss

    def _process_step(self, batch, targets, dev) -> torch.Tensor:
        """The step on a process comm: the local rows' loss scaled by their
        share of the global batch, its backward (BatchNorm statistics over
        every process's rows), one all-reduce of the gradients with the
        loss, then the optimizer's update."""
        b, rows = _local_rows(batch, self.comm, dev)
        t, _ = _local_rows(targets, self.comm, dev)
        if not b.shape[0]:
            raise ValueError(f"process {self.comm.rank} holds no row of a batch of {rows}")
        self.optimizer.zero_grad()
        local = self._loss_and_grads(self.module, b, t, scale=b.shape[0] / rows, across=self.comm)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        total = local.to(torch.float32).reshape(1).clone()
        collectives.psum_flat([p.grad for p in self.params] + [total], self.comm)
        self.optimizer.step()
        return total[0]


class DataParallelMultiGPU(DataParallel):
    """Two-tier data parallelism (heat_tpu/nn/data_parallel.py:228).  With a
    plain optimizer it is :class:`DataParallel`; with a
    :class:`~heat_tpu_torch.optim.DASO` optimizer each slice trains its own
    copy of the model between DASO's global syncs."""

    def __init__(self, module, comm=None, optimizer=None, loss_fn=None):
        super().__init__(module, comm=comm, optimizer=optimizer, loss_fn=loss_fn)
        self.replicas = [module]

    def _daso(self):
        from ..optim.dp_optimizer import DASO

        return self.optimizer if isinstance(self.optimizer, DASO) else None

    def init(self, rngs, sample_input) -> "DataParallelMultiGPU":
        super().init(rngs, sample_input)
        daso = self._daso()
        if daso is not None:
            self.replicas = daso.stack_tree(self.module)
            daso.init(self.replicas)
        return self

    def slice_mean(self) -> torch.nn.Module:
        """A copy of the model holding the slices' mean (floating
        variables; others from slice 0)."""
        model = copy.deepcopy(self.replicas[0])
        if len(self.replicas) > 1 or self._daso().across_processes:
            self._daso().sync([model] + [copy.deepcopy(r) for r in self.replicas[1:]])
        return model

    @torch.no_grad()
    def __call__(self, x):
        daso = self._daso()
        if daso is None or (len(self.replicas) == 1 and not daso.across_processes):
            return super().__call__(x)
        if self.params is None:
            raise RuntimeError("call .init(rng, sample_input) first")
        saved = self.module
        try:
            self.module = self.slice_mean()
            return super().__call__(x)
        finally:
            self.module = saved

    def train_step(self, batch, targets) -> torch.Tensor:
        daso = self._daso()
        if daso is None:
            return super().train_step(batch, targets)
        if self.params is None:
            raise RuntimeError("call .init(rng, sample_input) first")
        n = daso.n_slices
        dev = self.device
        b, t = _tensor(batch, dev), _tensor(targets, dev)
        if b.shape[0] % n:
            raise ValueError(f"batch size {b.shape[0]} not divisible by {n} slices")
        rows = b.shape[0] // n
        losses = []
        for s, replica, opt in zip(daso.local_slices, self.replicas, daso.optimizers):
            opt.zero_grad(set_to_none=True)
            losses.append(self._loss_and_grads(replica, b[s * rows:(s + 1) * rows], t[s * rows:(s + 1) * rows]))
            opt.step()
        daso.batches_seen += 1
        if daso.should_sync_globally():
            daso.sync(self.replicas)
        if daso.across_processes:
            # the slices' mean loss: this process's losses summed over the dcn group
            return collectives.psum([torch.stack(losses).sum().to(torch.float32)], comm=daso.dcn_comm)[0] / n
        return torch.stack(losses).mean()
