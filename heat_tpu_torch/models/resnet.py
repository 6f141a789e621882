"""ResNet family (counterpart of heat_tpu/models/resnet.py), the DP training
baseline model of BASELINE.md.

The interface keeps flax's NHWC layout: inputs are (batch, height, width,
channels) and :func:`space_to_depth` folds 2x2 pixel blocks into channels.
Inside, activations run in torch's NCHW with OIHW kernels.  What follows
the flax modules exactly:

* **BatchNorm** is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: the
  batch's statistics in f32 with the fast variance E[x²] − E[x]² clipped
  at 0, the running mean and the **biased** running variance updated as
  ``0.9 · old + 0.1 · batch``, and ``(x − mean) · rsqrt(var + eps) · scale +
  bias``.  ``torch.nn.BatchNorm2d`` keeps the unbiased variance and the
  opposite momentum, so the port has its own :class:`BatchNorm`.
* **Padding.** flax's ``"SAME"`` puts the odd pad after: a 3x3 stride-2
  convolution and the 3x3 stride-2 max pool of an even size pad (0, 1),
  the pool with −inf.  The space-to-depth stem pads (2, 1).  Every pad is
  an explicit ``F.pad``.
* **Precision.** f32 convolutions run in IEEE f32: cuDNN's TF32 is off
  inside the forward (``torch.backends.cudnn.flags(allow_tf32=False)``,
  scoped).  With ``dtype=torch.bfloat16`` the convolutions and the dense
  layer compute in bf16 while the statistics stay f32, and the logits come
  out in f32.
* **Across processes.** Inside :func:`batch_stats_across` with a process
  comm (``DataParallel``'s step sets it), a training BatchNorm all-reduces
  its per-channel sum, sum of squares and row count, so its statistics and
  running buffers are the global batch's, as ``heat_tpu``'s BatchNorm over
  the sharded batch gives.  The all-reduce is an autograd function whose
  backward all-reduces the statistics' gradients (torch's SyncBatchNorm
  does the same).

Parameters are made on an explicit device from an explicit
``torch.Generator`` with flax's initialisers (truncated-normal LeCun
kernels; BatchNorm scale 1, or 0 for a block's last norm; bias 0; running
mean 0 and variance 1); :func:`~heat_tpu_torch.models.convert.resnet_from_flax`
loads a flax variable tree instead.  No Pallas kernel is on this path.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import Dense
from .transformer import _lecun_normal_, _torch_device

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "Conv",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "space_to_depth",
]


def space_to_depth(x, block: int = 2):
    """(B, H, W, C) → (B, H/b, W/b, b·b·C), rows-major within the patch."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5) if isinstance(x, torch.Tensor) else x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def no_tf32():
    """cuDNN's current settings with TF32 off, for a scope: f32
    convolutions (forward and backward) in IEEE f32."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


_ACROSS = threading.local()


@contextmanager
def batch_stats_across(comm):
    """Within the scope, a training :class:`BatchNorm` on this thread takes
    its statistics over the batch rows of every process of ``comm`` (a
    process comm; any other comm changes nothing)."""
    saved = getattr(_ACROSS, "comm", None)
    _ACROSS.comm = comm if comm is not None and comm.is_process_comm else None
    try:
        yield
    finally:
        _ACROSS.comm = saved


class _SumAcross(torch.autograd.Function):
    """All-reduce sum over a process comm whose backward all-reduces the
    gradient: every process's loss reads the summed statistics."""

    @staticmethod
    def forward(ctx, t, comm):
        from ..parallel import collectives

        ctx.comm = comm
        return collectives.psum([t], comm=comm)[0]

    @staticmethod
    def backward(ctx, grad):
        from ..parallel import collectives

        return collectives.psum([grad.contiguous()], comm=ctx.comm)[0], None


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: the odd pad after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax's ``nn.Conv(use_bias=False)`` on NCHW activations with an OIHW
    kernel; ``padding`` is ``"SAME"`` or explicit ((top, bottom), (left,
    right))."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding="SAME", *, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.strides, self.padding, self.dtype = tuple(kernel_size), tuple(strides), padding, dtype
        kh, kw = self.kernel_size
        w = torch.empty(features, in_ch, kh, kw, device=_torch_device(device))
        _lecun_normal_(w, in_ch * kh * kw, generator)
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        if self.padding == "SAME":
            (t, b), (l, r) = _same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw)
        else:
            (t, b), (l, r) = self.padding
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), stride=(sh, sw))


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dimension of NCHW activations (see the module's notes)."""

    def __init__(self, features: int, *, momentum: float = 0.9, epsilon: float = 1e-5, zero_scale: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        dev = _torch_device(device)
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.zeros(features, device=dev) if zero_scale else torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.to(torch.float32)
            comm = getattr(_ACROSS, "comm", None)
            if comm is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            else:
                c = xf.shape[1]
                count = torch.full((1,), xf.numel() // c, dtype=torch.float32, device=xf.device)
                total = _SumAcross.apply(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
                                         comm)
                mean = total[:c] / total[-1]
                var = torch.clamp_min(total[c:2 * c] / total[-1] - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = x - mean.reshape(shape)
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale).reshape(shape)
        return (y + self.bias.reshape(shape)).to(self.dtype)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides=(1, 1), *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_ch, filters, (3, 3), strides, generator=generator, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, (3, 3), generator=generator, **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, **kw)
        if in_ch != filters or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_ch, filters, (1, 1), strides, generator=generator, **kw)
            self.norm_proj = BatchNorm(filters, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = self.norm_proj(self.conv_proj(x), train) if hasattr(self, "conv_proj") else x
        return torch.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides=(1, 1), *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_ch, filters, (1, 1), generator=generator, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, generator=generator, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), generator=generator, **kw)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True, **kw)
        if in_ch != filters * 4 or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_ch, filters * 4, (1, 1), strides, generator=generator, **kw)
            self.norm_proj = BatchNorm(filters * 4, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = self.norm_proj(self.conv_proj(x), train) if hasattr(self, "conv_proj") else x
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """Configurable ResNet over NHWC inputs (batch, height, width, 3), or
    (batch, height/2, width/2, 12) with ``s2d_stem=True``; returns f32
    logits (batch, num_classes).  ``forward(x, train=True)`` normalises
    with the batch's statistics and updates the running ones."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls=BasicBlock,
        num_classes: int = 1000,
        num_filters: int = 64,
        dtype: torch.dtype = torch.float32,
        act=None,
        s2d_stem: bool = False,
        *,
        in_channels: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if act not in (None, torch.relu, F.relu):
            raise NotImplementedError("the port's ResNet uses ReLU, flax's default activation")
        self.stage_sizes, self.block_cls, self.s2d_stem = tuple(stage_sizes), block_cls, s2d_stem
        self.num_classes, self.num_filters, self.dtype = num_classes, num_filters, dtype
        in_ch = (12 if s2d_stem else 3) if in_channels is None else in_channels
        kw = dict(dtype=dtype, device=device)
        if s2d_stem:
            self.conv_init = Conv(in_ch, num_filters, (4, 4), (1, 1), ((2, 1), (2, 1)), generator=generator, **kw)
        else:
            self.conv_init = Conv(in_ch, num_filters, (7, 7), (2, 2), ((3, 3), (3, 3)), generator=generator, **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        self.blocks = nn.ModuleDict()
        ch, idx = num_filters, 0
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2**i
                self.blocks[f"{block_cls.__name__}_{idx}"] = block_cls(ch, filters, strides, generator=generator, **kw)
                ch, idx = filters * block_cls.expansion, idx + 1
        self.Dense_0 = Dense(ch, num_classes, device=device, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.Dense_0.kernel.device).permute(0, 3, 1, 2)
        with no_tf32():
            x = torch.relu(self.bn_init(self.conv_init(x), train))
            (t, b), (l, r) = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3], 3, 2)
            x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
            for block in self.blocks.values():
                x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x.to(self.dtype)).to(torch.float32)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)
