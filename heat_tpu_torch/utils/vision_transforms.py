"""Image transforms (counterpart of heat_tpu/utils/vision_transforms.py).

heat_tpu implements the transforms users reach for on NumPy host arrays
and lets other names fall through to ``torchvision.transforms``.  The port
implements the same transforms on torch tensors, on whatever device the
image sits: a CPU tensor is transformed on the host, a card tensor on the
card, with the same result (crops, pads and flips bit for bit; ``Resize``
and ``Normalize`` within f32 rounding).  Other names still fall through
to torchvision where it is installed.

The layout is heat_tpu's: channels last, (H, W, C) or (H, W).  The random
transforms draw their decisions (offsets, flips) on the host from an
explicit CPU ``torch.Generator`` (``generator=``, or one seeded from
``seed``), so one generator state gives the same decisions for an image
on the card and on the CPU, and drawing adds no device read.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Compose",
    "ToTensor",
    "Normalize",
    "Lambda",
    "CenterCrop",
    "Pad",
    "RandomCrop",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "Resize",
    "Grayscale",
]


def _pair(v) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:  # torchvision accepts length-1 sequences
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _generator(generator: Optional[torch.Generator], seed: Optional[int]) -> torch.Generator:
    if generator is not None:
        return generator
    gen = torch.Generator()
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


def _divide(x: torch.Tensor, by) -> torch.Tensor:
    """``x / by`` as a true division on every device (the card turns a
    division by a host scalar into a product with its reciprocal)."""
    return x / torch.as_tensor(by, dtype=torch.float32, device=x.device)


def _to_uint8(out: torch.Tensor) -> torch.Tensor:
    """``np.clip(np.rint(out), 0, 255).astype(np.uint8)``."""
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


class Compose:
    """Chain transforms (torchvision.transforms.Compose semantics)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def __repr__(self):
        return f"Compose({self.transforms!r})"


class ToTensor:
    """uint8 [0, 255] → float32 [0, 1] (no layout change: HWC stays HWC)."""

    def __call__(self, x):
        x = _tensor(x)
        if x.dtype == torch.uint8:
            return _divide(x.to(torch.float32), 255.0)
        return x.to(torch.float32)


class Normalize:
    """Channel-wise (x − mean) / std over the trailing channel axis; for
    2-D inputs mean/std are scalars."""

    def __init__(self, mean, std):
        self.mean = torch.as_tensor(np.asarray(mean, dtype=np.float32))
        self.std = torch.as_tensor(np.asarray(std, dtype=np.float32))

    def __call__(self, x):
        x = _tensor(x).to(torch.float32)
        return (x - self.mean.to(x.device)) / self.std.to(x.device)


class Lambda:
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)


class CenterCrop:
    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, x):
        x = _tensor(x)
        th, tw = self.size
        h, w = x.shape[:2]
        if h < th or w < tw:
            # torchvision pads smaller images with zeros before cropping
            top = max((th - h) // 2, 0)
            left = max((tw - w) // 2, 0)
            x = Pad((left, top, tw - w - left if w < tw else 0, th - h - top if h < th else 0))(x)
            h, w = x.shape[:2]
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return x[i : i + th, j : j + tw]


class Pad:
    """Constant padding of the two leading (spatial) axes: an int pads
    every side, a pair (left/right, top/bottom), a 4-tuple (left, top,
    right, bottom)."""

    def __init__(self, padding, fill=0):
        self.padding = padding if isinstance(padding, (tuple, list)) else (padding,) * 4
        self.fill = fill

    def __call__(self, x):
        x = _tensor(x)
        if len(self.padding) == 2:
            left, top = self.padding
            right, bottom = left, top
        else:
            left, top, right, bottom = self.padding
        h, w = x.shape[:2]
        out = torch.full((h + top + bottom, w + left + right) + tuple(x.shape[2:]), self.fill, dtype=x.dtype,
                         device=x.device)
        out[top : top + h, left : left + w] = x
        return out


class RandomCrop:
    """A crop at a uniformly drawn offset, after an optional padding."""

    def __init__(self, size, padding: Optional[int] = None, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        self.size = _pair(size)
        self.padding = padding
        self.generator = _generator(generator, seed)

    def __call__(self, x):
        x = _tensor(x)
        if self.padding:
            x = Pad(self.padding)(x)
        th, tw = self.size
        h, w = x.shape[:2]
        if h < th or w < tw:
            raise ValueError(f"crop size {self.size} larger than image size {(h, w)}")
        i = int(torch.randint(0, h - th + 1, (), generator=self.generator))
        j = int(torch.randint(0, w - tw + 1, (), generator=self.generator))
        return x[i : i + th, j : j + tw]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, seed: Optional[int] = None, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = _generator(generator, seed)

    def __call__(self, x):
        x = _tensor(x)
        if float(torch.rand((), generator=self.generator)) < self.p:
            return x.flip(1)
        return x


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5, seed: Optional[int] = None, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = _generator(generator, seed)

    def __call__(self, x):
        x = _tensor(x)
        if float(torch.rand((), generator=self.generator)) < self.p:
            return x.flip(0)
        return x


@functools.lru_cache(maxsize=64)
def _resample_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) triangle-filter weight matrix, align-corners=False
    (heat_tpu/utils/vision_transforms.py:170): on downscale the support
    widens with the scale (PIL/torchvision's antialiasing), on upscale it
    is bilinear interpolation.  Made in f64 on the host, kept in f32."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    taps = np.arange(n_in, dtype=np.float64)
    w = np.maximum(1.0 - np.abs(centers[:, None] - taps[None, :]) / support, 0.0)
    return torch.from_numpy((w / w.sum(axis=1, keepdims=True)).astype(np.float32))


def _bilinear_resize(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Separable resample over the two leading axes, antialiased on
    downscale (heat_tpu/utils/vision_transforms.py:185), as two f32
    products on x's device."""
    h, w = x.shape[:2]
    wy = _resample_weights(h, th).to(x.device)  # (th, h)
    wx = _resample_weights(w, tw).to(x.device)  # (tw, w)
    out = torch.tensordot(wy, x, dims=([1], [0]))  # (th, w, ...)
    return torch.tensordot(wx, out, dims=([1], [1])).movedim(0, 1)  # (th, tw, ...)


class Resize:
    """Bilinear resize: an int size resizes the shorter edge keeping the
    aspect ratio, a (h, w) pair resizes exactly (torchvision semantics).
    uint8 in → uint8 out, so a following ToTensor still scales by 1/255."""

    def __init__(self, size):
        # torchvision: a length-1 sequence means shorter-edge, like an int
        self.exact = isinstance(size, (tuple, list)) and len(size) == 2
        self.size = _pair(size)

    def __call__(self, x):
        x = _tensor(x)
        h, w = x.shape[:2]
        if self.exact:
            th, tw = self.size
        else:
            short = self.size[0]
            if h <= w:
                th, tw = short, max(int(round(w * short / h)), 1)
            else:
                th, tw = max(int(round(h * short / w)), 1), short
        out = _bilinear_resize(x.to(torch.float32), th, tw)
        if x.dtype == torch.uint8:
            return _to_uint8(out)
        return out.to(x.dtype)


class Grayscale:
    """RGB (H, W, 3) → (H, W, out_channels) luma.  uint8 in → uint8 out."""

    def __init__(self, num_output_channels: int = 1):
        self.num_output_channels = num_output_channels

    def __call__(self, x):
        x = _tensor(x)
        weights = torch.tensor([0.2989, 0.587, 0.114], dtype=torch.float32, device=x.device)
        luma = x.to(torch.float32) @ weights
        out = luma[..., None].repeat_interleave(self.num_output_channels, dim=-1)
        if x.dtype == torch.uint8:
            return _to_uint8(out)
        return out.to(x.dtype)


def __getattr__(name):
    # heat_tpu's behaviour: unknown names fall through to torchvision when
    # it is installed (heat_tpu/utils/vision_transforms.py:246)
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        import torchvision.transforms as _tvt
    except ImportError:
        raise AttributeError(f"transform {name!r} is not implemented natively and torchvision is not installed")
    return getattr(_tvt, name)
