"""``cluster.packing``: heat_tpu_torch against heat_tpu on the CPU.

``PackedSamples`` keeps heat_tpu's attributes and its (ceil(n/p), p*f)
payload with a zero tail, so ``pack`` must give heat_tpu's bytes exactly and
the same shard layout.  The random factories are held to the same shape,
dtype, layout and zero tail, and to the moments of their distributions:
over 4·10^4 samples a mean is within 0.03 of its value (some 6 standard
errors) and a standard deviation within 0.02 (their values against
heat_tpu's streams are tests/test_torch_threefry.py's).
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.core import random as htt_random

ml_dtypes = pytest.importorskip("ml_dtypes")
BF16 = ml_dtypes.bfloat16
MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    """The JAX package, the reference of the parity tests."""
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _bits(a):
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("f", [1, 3, 4, 20, 64, 127, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_packable(ht, f, dtype):
    assert htt.cluster.packing.packable(f, getattr(htt, dtype)) == ht.cluster.packing.packable(f, getattr(ht, dtype))


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("rows, f", [(120, 4), (123, 16), (121, 64), (1, 64)])
@pytest.mark.parametrize("split", [0, None])
def test_pack_gives_jax_bytes_and_layout(ht, n, rows, f, split):
    x = np.random.default_rng(rows + f).normal(size=(rows, f)).astype(BF16)
    a = ht.cluster.pack(ht.array(x, split=split, comm=ht.parallel.mesh.local_mesh(n)))
    b = htt.cluster.pack(htt.array(x, split=split, comm=htt.MeshComm(n), device="cpu"))
    for attr in ("n", "f", "p", "shape", "ndim", "split"):
        assert getattr(b, attr) == getattr(a, attr), attr
    assert b.dtype is htt.bfloat16 and b.x2.shape == a.x2.shape
    np.testing.assert_array_equal(_bits(b.x2.numpy()), _bits(a.x2.numpy()))
    sa, sb = a.x2.lshards(), b.x2.lshards()
    if split is None:
        sa = sa[:1]
    assert [s.shape for s in sb] == [s.shape for s in sa]
    np.testing.assert_array_equal(_bits(b.unpack().numpy()), _bits(x))
    assert repr(b) == repr(a)
    assert b.device is htt.cpu and b.comm.size == n


def test_pack_is_a_view_when_nothing_pads():
    x = htt.array(np.ones((128, 64), np.float32), dtype=htt.bfloat16, device="cpu")
    b = htt.cluster.pack(x)
    assert b.x2.larray.data_ptr() == x.larray.data_ptr()
    blocks = b.sample_blocks()
    assert len(blocks) == 1 and blocks[0].data_ptr() == x.larray.data_ptr() and blocks[0].shape == (128, 64)


@pytest.mark.parametrize("n", MESHES)
def test_sample_blocks_cover_the_samples_once(n):
    x = np.arange(123 * 16, dtype=np.float32).reshape(123, 16).astype(BF16)
    b = htt.cluster.pack(htt.array(x, split=0, comm=htt.MeshComm(n), device="cpu"))
    blocks = b.sample_blocks()
    assert len(blocks) == n
    got = torch.cat(blocks)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), _bits(x))
    for blk, shard in zip(blocks, b.x2.shards):
        assert blk.numel() == 0 or blk.data_ptr() == shard.data_ptr()


def test_pack_and_packed_samples_reject_what_does_not_pack():
    with pytest.raises(ValueError):
        htt.cluster.pack(htt.array(np.ones((8, 20), np.float32), dtype=htt.bfloat16, device="cpu"))
    with pytest.raises(ValueError):
        htt.cluster.pack(htt.array(np.ones((8, 16), np.float32), device="cpu"))
    with pytest.raises(ValueError):
        htt.cluster.PackedSamples(htt.array(np.ones((5, 128), np.float32), device="cpu"), 11, 64)
    with pytest.raises(ValueError):
        htt.cluster.randn_packed(10, 20)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("kind, mean, std", [("randn", 0.0, 1.0), ("rand", 0.5, 12 ** -0.5)])
@pytest.mark.parametrize("samples, f", [(2501, 16), (1250, 32)])
def test_random_factories(ht, n, kind, mean, std, samples, f):
    a = getattr(ht.cluster, f"{kind}_packed")(samples, f, comm=ht.parallel.mesh.local_mesh(n))
    htt.random.seed(11)
    b = getattr(htt.cluster, f"{kind}_packed")(samples, f, comm=htt.MeshComm(n), device="cpu")
    assert (b.n, b.f, b.p, b.shape, b.split) == (a.n, a.f, a.p, a.shape, a.split)
    assert b.dtype is htt.bfloat16 and b.x2.shape == a.x2.shape
    assert [s.shape for s in b.x2.lshards()] == [s.shape for s in a.x2.lshards()]
    payload = b.x2.numpy().astype(np.float32)
    keep = (samples - (payload.shape[0] - 1) * b.p) * f
    assert np.all(payload[-1, keep:] == 0) and np.all(a.x2.numpy().astype(np.float32)[-1, keep:] == 0)
    vals = b.unpack().numpy().astype(np.float64)
    assert vals.shape == (samples, f)
    assert abs(vals.mean() - mean) <= 0.03 and abs(vals.std() - std) <= 0.02
    if kind == "rand":
        assert vals.min() >= 0 and vals.max() <= 1
    # one seed, one payload at every mesh size
    htt.random.seed(11)
    one = getattr(htt.cluster, f"{kind}_packed")(samples, f, comm=htt.MeshComm(1), device="cpu")
    np.testing.assert_array_equal(_bits(one.x2.numpy()), _bits(b.x2.numpy()))
    km = htt.cluster.KMeans(n_clusters=4, init="random", max_iter=3, tol=-1.0, random_state=0).fit(b)
    assert km.n_iter_ == 3 and km.labels_.shape == (samples,) and np.isfinite(km.inertia_)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_large_16bit_draws_come_in_f32_chunks(monkeypatch, n, dtype):
    # a 16-bit draw above the chunk size is drawn in the JAX package's row
    # blocks (rows = ceil(301 / ceil(f32 bytes / chunk)) = 16, one block key
    # each), never as its whole f32 draw; the result is deterministic and
    # mesh-invariant and has the distribution's moments
    monkeypatch.setattr(htt_random, "_CHUNK_F32_BYTES", 4 * 1000)
    sizes = []
    real = htt_random.t1.threefry
    monkeypatch.setattr(htt_random.t1, "threefry", lambda key, n_, **kw: sizes.append(n_) or real(key, n_, **kw))
    htt.random.seed(5)
    x = htt.random.randn(301, 64, dtype=getattr(htt, dtype), split=0, comm=htt.MeshComm(n), device="cpu")
    assert x.dtype is getattr(htt, dtype) and x.shape == (301, 64)
    assert sizes == [16 * 64] * 18 + [13 * 64]
    vals = x.numpy().astype(np.float64)
    assert abs(vals.mean()) <= 0.03 and abs(vals.std() - 1.0) <= 0.02
    htt.random.seed(5)
    again = htt.random.randn(301, 64, dtype=getattr(htt, dtype), device="cpu")
    np.testing.assert_array_equal(again.numpy().astype(np.float32), vals.astype(np.float32))
    sizes.clear()
    htt.random.randn(301, 64, device="cpu")
    assert sizes == [301 * 64]
