"""``heat_tpu_torch.utils.vision_transforms`` against heat_tpu's transforms
on the same numpy images (channels last, uint8 and float32).  The mirror
is ``tests/test_transforms.py``.

The random transforms are compared by their effect under a fixed
decision: heat_tpu draws from numpy's generator, the port from a torch
``Generator``, so each side's draw is replaced by the same offsets or
coin, and the draws themselves are checked for range and determinism.

Tolerance: crops, pads, flips and the uint8 outputs of ``Resize`` and
``Grayscale`` are exact (a uint8 result may differ by one where its f32
value lies within 1e-4 of a rounding midpoint, which these images avoid);
``ToTensor`` is exact (one IEEE division); ``Normalize`` and f32
``Resize``/``Grayscale`` agree to 1e-6 relative (numpy and torch sum the
resampling products in other orders).
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.utils import vision_transforms as TT


@pytest.fixture(scope="module")
def JT():
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    from heat_tpu.utils import vision_transforms

    return vision_transforms


def _img(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(dtype)


IMAGES = [(24, 20, 3), (17, 31, 1), (12, 9)]


def _same(got, want, exact=True):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("shape", IMAGES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_deterministic_transforms_match(JT, shape, dtype):
    x = _img(shape, dtype)
    t = torch.from_numpy(x)
    chans = shape[2] if len(shape) == 3 else None
    mean, std = ([0.4, 0.5, 0.6][:chans], [0.2, 0.25, 0.3][:chans]) if chans else (0.45, 0.22)
    _same(TT.ToTensor()(t), JT.ToTensor()(x))
    _same(TT.Normalize(mean, std)(t), JT.Normalize(mean, std)(x), exact=False)
    for size in (8, (7, 5), (30, 40)):
        _same(TT.CenterCrop(size)(t), JT.CenterCrop(size)(x))
    for pad, fill in ((2, 0), ((1, 3), 7), ((0, 2, 3, 1), 255)):
        _same(TT.Pad(pad, fill)(t), JT.Pad(pad, fill)(x))
    _same(TT.Lambda(lambda a: a[::2])(t), JT.Lambda(lambda a: a[::2])(x))
    chain = ([TT.CenterCrop(8), TT.ToTensor()], [JT.CenterCrop(8), JT.ToTensor()])
    _same(TT.Compose(chain[0])(t), JT.Compose(chain[1])(x))


@pytest.mark.parametrize("shape", IMAGES)
@pytest.mark.parametrize("size", [10, (13, 7), (40, 33), [9]])
def test_resize_matches(JT, shape, size):
    for dtype in (np.uint8, np.float32):
        x = _img(shape, dtype, seed=1)
        _same(TT.Resize(size)(torch.from_numpy(x)), JT.Resize(size)(x), exact=dtype == np.uint8)
    np.testing.assert_allclose(TT._resample_weights(17, 5).numpy(), JT._resample_weights(17, 5), rtol=0, atol=0)
    np.testing.assert_allclose(TT._resample_weights(5, 17).numpy(), JT._resample_weights(5, 17), rtol=0, atol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_grayscale_matches(JT, channels):
    for dtype in (np.uint8, np.float32):
        x = _img((11, 13, 3), dtype, seed=2)
        _same(TT.Grayscale(channels)(torch.from_numpy(x)), JT.Grayscale(channels)(x), exact=dtype == np.uint8)


class _Fixed:
    """A numpy-generator stand-in that gives fixed decisions."""

    def __init__(self, ints=(), coin=0.0):
        self.ints, self.coin = list(ints), coin

    def integers(self, lo, hi):
        return self.ints.pop(0)

    def random(self):
        return self.coin


@pytest.mark.parametrize("padding", [None, 3])
def test_random_crop_under_a_fixed_decision(JT, monkeypatch, padding):
    x = _img((20, 18, 3))
    for i, j in ((0, 0), (4, 7), (11, 9)):
        jt = JT.RandomCrop((9, 9), padding=padding)
        jt._rng = _Fixed([i, j])
        draws = iter([i, j])
        tt = TT.RandomCrop((9, 9), padding=padding)
        monkeypatch.setattr(TT.torch, "randint", lambda lo, hi, size, generator: torch.tensor(next(draws)))
        _same(tt(torch.from_numpy(x)), jt(x))
        monkeypatch.undo()
    with pytest.raises(ValueError):
        TT.RandomCrop(30)(torch.from_numpy(x))
    with pytest.raises(ValueError):
        JT.RandomCrop(30)(x)


@pytest.mark.parametrize("coin", [0.2, 0.7])
def test_random_flips_under_a_fixed_decision(JT, monkeypatch, coin):
    x = _img((6, 5, 3))
    monkeypatch.setattr(TT.torch, "rand", lambda size, generator: torch.tensor(coin))
    for T, J in ((TT.RandomHorizontalFlip, JT.RandomHorizontalFlip), (TT.RandomVerticalFlip, JT.RandomVerticalFlip)):
        jt = J(p=0.5)
        jt._rng = _Fixed(coin=coin)
        _same(T(p=0.5)(torch.from_numpy(x)), jt(x))


def test_random_draws_follow_the_generator():
    x = torch.from_numpy(_img((20, 18, 3)))
    crops = [TT.RandomCrop(9, padding=2, seed=5)(x) for _ in range(2)]
    assert torch.equal(crops[0], crops[1])
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    a = TT.Compose([TT.RandomCrop(9, generator=gen), TT.RandomHorizontalFlip(generator=gen)])(x)
    gen.set_state(state)
    b = TT.Compose([TT.RandomCrop(9, generator=gen), TT.RandomHorizontalFlip(generator=gen)])(x)
    assert torch.equal(a, b)
    # every offset of a 20 → 9 crop (12 of them) is drawn from one generator
    seen = {int(TT.RandomCrop((9, 18), generator=gen)(torch.arange(20)[:, None, None].expand(20, 18, 1))[0, 0, 0])
            for _ in range(400)}
    assert seen == set(range(12))
    flips = [bool(TT.RandomHorizontalFlip(p=0.3, generator=gen)(torch.arange(2)[None, :])[0, 0] == 1) for _ in range(2000)]
    assert 0.25 < np.mean(flips) < 0.35


def test_module_getattr_falls_through_or_raises(JT):
    try:
        import torchvision  # noqa: F401
    except ImportError:
        for mod in (TT, JT):
            with pytest.raises(AttributeError, match="torchvision"):
                mod.ColorJitter
    else:
        assert TT.ColorJitter is JT.ColorJitter
    assert sorted(TT.__all__) == sorted(JT.__all__)
