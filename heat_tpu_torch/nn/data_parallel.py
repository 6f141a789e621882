"""Data-parallel training (counterpart of heat_tpu/nn/data_parallel.py).

The JAX package compiles one training step over a batch sharded on the
mesh, with the parameters replicated: GSPMD computes the mean loss over the
whole batch and XLA inserts the gradient all-reduce.  Under the port's
single controller every position of a ``MeshComm`` shares one card, so the
step is one forward and backward over the global batch (the same mean
loss, and BatchNorm statistics over the whole batch) followed by the
optimizer's update: there is nothing to all-reduce.  The cross-process
gradient all-reduce and a cross-process BatchNorm come with the
multi-process backend (ROADMAP item 14).

``DataParallelMultiGPU`` with a :class:`~heat_tpu_torch.optim.DASO`
optimizer runs the two-tier step: one copy of the model a slice, each
trained on its B/n rows of the batch with its own optimizer state, and the
slices averaged when DASO schedules a sync.  Inference then uses the
slice-averaged model.

Convolutions and products of a step run in IEEE f32 (no TF32).
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..core.dndarray import DNDarray, _wrap
from ..models.resnet import no_tf32
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

    def _loss_and_grads(self, module: torch.nn.Module, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Forward, loss and backward of ``module`` on (b, t); the
        gradients land in the parameters' ``.grad``."""
        kw = {"train": True} if self._accepts_train else {}
        with no_tf32():
            logits = module(b, **kw)
            loss = (self.loss_fn or _default_loss)(logits, t)
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
        0-d device tensor."""
        if self.params is None:
            raise RuntimeError("call .init(rng, sample_input) first")
        if self.optimizer is None:
            raise RuntimeError("no optimizer attached")
        dev = self.device
        b, t = _tensor(batch, dev), _tensor(targets, dev)
        self.optimizer.zero_grad()
        loss = self._loss_and_grads(self.module, b, t)
        self.optimizer.step()
        return loss


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
        if len(self.replicas) > 1:
            self._daso().sync([model] + [copy.deepcopy(r) for r in self.replicas[1:]])
        return model

    @torch.no_grad()
    def __call__(self, x):
        if self._daso() is None or len(self.replicas) == 1:
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
        for s, (replica, opt) in enumerate(zip(self.replicas, daso.optimizers)):
            opt.zero_grad(set_to_none=True)
            losses.append(self._loss_and_grads(replica, b[s * rows:(s + 1) * rows], t[s * rows:(s + 1) * rows]))
            opt.step()
        daso.batches_seen += 1
        if daso.should_sync_globally():
            daso.sync(self.replicas)
        return torch.stack(losses).mean()
