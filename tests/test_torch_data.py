"""The data layer: ``cluster.load_hdf5_packed``, ``utils.data`` (Dataset,
DataLoader and the shuffles, PartialH5Dataset, MNIST, parter, the TFRecord
index helper) of heat_tpu_torch against heat_tpu on the CPU at meshes 1, 4
and 8.

Loads and generators must agree bitwise.  What is checked of the
shuffles here is exact: every row present once and each row with its
labels across the arrays; that their order is heat_tpu's for one seed is
tests/test_torch_threefry.py's.
"""

import struct
import threading

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.utils import data as tdata

MESHES = (1, 4, 8)


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _write_h5(path, **arrays):
    import h5py

    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            f[name] = a


# ----------------------------------------------------------------- packed
@pytest.mark.parametrize("n", (1, 4))
def test_load_hdf5_packed(ht, tmp_path, n):
    """The packed bf16 load equals heat_tpu's, payload bits and shards; 37
    samples of 16 features fill 5 rows of 8, the last 3 slots zero (heat_tpu
    compiles its 8-position packed layout for minutes: meshes 1 and 4)."""
    pytest.importorskip("ml_dtypes")
    x = np.random.default_rng(n).normal(size=(37, 16)).astype(np.float32)
    path = str(tmp_path / "p.h5")
    _write_h5(path, x=x)
    want = ht.cluster.load_hdf5_packed(path, "x", comm=ht.parallel.mesh.local_mesh(n))
    got = htt.cluster.load_hdf5_packed(path, "x", comm=htt.MeshComm(n), device="cpu")
    assert (got.n, got.f, got.p, got.split) == (want.n, want.f, want.p, want.split) == (37, 16, 8, 0)
    assert got.dtype is htt.bfloat16 and got.x2.shape == want.x2.shape == (5, 128)
    a, b = np.asarray(want.x2.numpy()), got.x2.numpy()
    np.testing.assert_array_equal(b.view(np.int16), a.view(np.int16))
    for u, v in zip(want.x2.lshards(), got.x2.lshards()):
        np.testing.assert_array_equal(v.view(np.int16), np.asarray(u).view(np.int16))
    rows = torch.cat([blk.float() for blk in got.sample_blocks()])
    assert torch.equal(rows, torch.from_numpy(x).bfloat16().float())
    with pytest.raises(ValueError):
        htt.cluster.load_hdf5_packed(path, "x", split=1, device="cpu")


# ------------------------------------------------------------- generators
@pytest.mark.parametrize("n", MESHES)
def test_parter(ht, n):
    for split in (None, 0, 1):
        want = ht.utils.data.parter(9, split=split, comm=ht.parallel.mesh.local_mesh(n))
        got = tdata.parter(9, split=split, comm=htt.MeshComm(n), device="cpu")
        assert got.split == want.split and got.dtype is htt.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
        for u, v in zip(want.lshards(), got.lshards()):
            np.testing.assert_array_equal(v, np.asarray(u))


def test_mnist_synthetic_and_idx(ht, tmp_path, monkeypatch):
    """Without files the synthetic stand-in is heat_tpu's, bit for bit; IDX
    files (plain and gzip, torchvision's layout) are read as heat_tpu reads
    them."""
    jm = pytest.importorskip("heat_tpu.utils.data.mnist")
    prev_device = htt.get_device()
    htt.use_device("cpu")
    htt.use_comm(htt.MeshComm(8))  # heat_tpu's default: the conftest's 8 devices
    try:
        for train in (True, False):
            want_x, want_y = jm._synthetic(train)
            ds = tdata.MNISTDataset(str(tmp_path), train=train, split=0)
            np.testing.assert_array_equal(ds.htdata.numpy(), want_x)
            np.testing.assert_array_equal(ds.httargets.numpy(), want_y.astype(np.int64))
        jds = ht.utils.data.MNISTDataset(str(tmp_path), train=False)
        np.testing.assert_array_equal(ds.htdata.numpy(), np.asarray(jds.htdata.numpy()))
        assert (ds.lcl_half, len(ds)) == (jds.lcl_half, len(jds))
        raw = tmp_path / "MNIST" / "raw"
        raw.mkdir(parents=True)
        imgs = np.random.default_rng(0).integers(0, 256, (6, 28, 28), dtype=np.uint8)
        labs = np.arange(6, dtype=np.uint8)
        (raw / "t10k-images-idx3-ubyte").write_bytes(struct.pack(">IIII", 0x803, 6, 28, 28) + imgs.tobytes())
        import gzip

        with gzip.open(raw / "t10k-labels-idx1-ubyte.gz", "wb") as f:
            f.write(struct.pack(">II", 0x801, 6) + labs.tobytes())
        ds = tdata.MNISTDataset(str(tmp_path), train=False, test_set=True)
        assert ds.htdata.split is None
        np.testing.assert_array_equal(ds.htdata.numpy(), imgs)
        img, target = ds[3]
        assert torch.equal(img, torch.from_numpy(imgs[3])) and int(target) == 3
        ds.Shuffle()  # a test set stays in order
        np.testing.assert_array_equal(ds.httargets.numpy(), labs)
        with pytest.raises(FileNotFoundError):
            tdata.MNISTDataset(str(tmp_path / "none"), download=False)
    finally:
        htt.use_device(prev_device)
        htt.use_comm(None)


# --------------------------------------------------------------- datasets
def _rows_and_labels(n_rows=29, f=3, seed=0):
    x = np.random.default_rng(seed).normal(size=(n_rows, f)).astype(np.float32)
    x[:, 0] = np.arange(n_rows)  # a row's id in its first column
    return x, np.arange(n_rows, dtype=np.int64) * 10


def _paired(x, y):
    """Every row present once, each with its own label."""
    ids = x[:, 0].astype(np.int64)
    assert sorted(ids.tolist()) == list(range(x.shape[0]))
    np.testing.assert_array_equal(y, ids * 10)


@pytest.mark.parametrize("n", MESHES)
def test_dataset_shuffles_keep_rows_with_their_labels(n):
    x, y = _rows_and_labels(seed=n)
    comm = htt.MeshComm(n)
    for xs, ys in ((0, 0), (1, 0), (None, 0)):
        ds = tdata.Dataset(htt.array(x, split=xs, comm=comm, device="cpu"), htt.array(y, split=ys, comm=comm, device="cpu"))
        orders = []
        for shuffle in (ds.Shuffle, ds.Ishuffle, lambda: tdata.dataset_shuffle(ds), lambda: tdata.dataset_ishuffle(ds)):
            shuffle()
            tdata.dataset_irecv(ds)
            a, b = ds.arrays
            assert (a.split, b.split) == (xs, ys)
            _paired(a.numpy(), b.numpy())
            orders.append(a.numpy()[:, 0])
        assert any(not np.array_equal(o, x[:, 0]) for o in orders)
        item = ds[4]
        assert torch.equal(item[0], ds.arrays[0].larray[4]) and int(item[1]) == int(item[0][0]) * 10
    fixed = tdata.Dataset(htt.array(x, split=0, comm=comm, device="cpu"), test_set=True)
    fixed.shuffle()
    np.testing.assert_array_equal(fixed.arrays[0].numpy(), x)
    with pytest.raises(ValueError):
        tdata.Dataset(htt.array(x, device="cpu"), htt.array(y[:5], device="cpu"))


@pytest.mark.parametrize("n", MESHES)
def test_dataloader_batches(n):
    x, y = _rows_and_labels(seed=10 + n)
    comm = htt.MeshComm(n)
    ds = tdata.Dataset(htt.array(x, split=0, comm=comm, device="cpu"), htt.array(y, split=0, comm=comm, device="cpu"),
                       transforms=[lambda t: t * 1, None])
    loader = tdata.DataLoader(ds, batch_size=4, shuffle=True)
    assert len(loader) == 8
    for _ in range(2):
        batches = list(loader)
        assert [b[0].shape[0] for b in batches] == [4] * 7 + [1]
        _paired(torch.cat([b[0] for b in batches]).numpy(), torch.cat([b[1] for b in batches]).numpy())
    dropped = tdata.DataLoader(htt.array(x, split=0, comm=comm, device="cpu"), batch_size=4, drop_last=True,
                               collate_fn=lambda b: b.sum())
    assert len(dropped) == 7 and len(list(dropped)) == 7
    whole = tdata.Dataset(htt.array(x, device="cpu"), transform=lambda a: a[0])
    assert float(whole[2]) == 2.0


@pytest.mark.parametrize("n", MESHES)
def test_partial_h5_dataset(tmp_path, n):
    """Slabs in file order, split over the positions, rows with their
    labels; closing mid-epoch stops and joins the readers."""
    x, y = _rows_and_labels(n_rows=53, seed=20 + n)
    path = str(tmp_path / "d.h5")
    _write_h5(path, data=x, labels=y)
    comm = htt.MeshComm(n)
    prev_device = htt.get_device()
    htt.use_device("cpu")
    try:
        ds = tdata.PartialH5Dataset(path, comm=comm, dataset_names=["data", "labels"], initial_load=10, load_length=2)
        assert len(ds) == 53
        slabs = list(ds)
        assert len(slabs) == 6 and all(a.split == 0 and a.comm is comm for a, _ in slabs)
        np.testing.assert_array_equal(np.concatenate([a.numpy() for a, _ in slabs]), x)
        np.testing.assert_array_equal(np.concatenate([b.numpy() for _, b in slabs]), y)
        loader = tdata.DataLoader(ds, collate_fn=lambda b: b)
        assert len(loader) == 6 and len(list(loader)) == 6
        before = threading.active_count()
        with tdata.PartialH5DataLoaderIter(ds) as it:
            next(it)
            readers = list(it._readers)
        assert all(not r.is_alive() for r in readers) and threading.active_count() <= before
        with pytest.raises(StopIteration):
            next(it)
        with pytest.raises(RuntimeError, match="cannot open"):
            tdata.PartialH5DataLoaderIter(tdata.PartialH5Dataset(path, dataset_names=["data", "nope"]))
        single = tdata.PartialH5Dataset(path, comm=comm, initial_load=53, transforms=lambda a: (a * 2,))
        (only,) = list(single)
        np.testing.assert_array_equal(only.numpy(), 2 * x)
    finally:
        htt.use_device(prev_device)


def test_queue_thread_and_tfrecord_index(ht, tmp_path):
    import queue

    from heat_tpu.utils.data import _utils as jutils
    from heat_tpu_torch.utils.data import _utils as tutils
    from heat_tpu_torch.utils.data.partial_dataset import queue_thread

    q, seen = queue.Queue(), []
    worker = threading.Thread(target=queue_thread, args=(q,), daemon=True)
    worker.start()
    q.put((seen.append, 1))
    q.put(lambda: seen.append(2))
    q.put(None)
    worker.join(timeout=5)
    assert not worker.is_alive() and seen == [1, 2]
    for side in ("train", "val", "ti", "vi", "tj", "vj"):
        (tmp_path / side).mkdir()
    with open(tmp_path / "train" / "a.tfrecord", "wb") as f:
        for payload in (b"abc", b"", b"0123456789"):
            f.write(struct.pack("<Q", len(payload)) + b"\0" * 4 + payload + b"\0" * 4)
        f.write(struct.pack("<Q", 999))  # a truncated last record
    d = str(tmp_path)
    tutils.dali_tfrecord2idx(d + "/train", d + "/ti", d + "/val", d + "/vi")
    jutils.dali_tfrecord2idx(d + "/train", d + "/tj", d + "/val", d + "/vj")
    assert (tmp_path / "ti" / "a.tfrecord").read_text() == (tmp_path / "tj" / "a.tfrecord").read_text() != ""
