"""File I/O: heat_tpu_torch's loaders and savers against heat_tpu's on the
CPU at meshes 1, 4 and 8, in every format (HDF5, NetCDF through scipy's
classic format, CSV, ``.npy``), with ``split`` None, 0 and 1.

Loads and saves move values without arithmetic: global values, each
position's shard and the split must agree bitwise (CSV text of float32 is
read back exactly).  Files are written by one package and read by the
other, both ways.  A spy on ``_read_region``/``_write_region`` shows that
no call moves more than one position's slab.  13 rows over 8 positions
leave shards of 2, 2, 2, 2, 2, 2, 1 and 0 rows.
"""

import contextlib
import os

import numpy as np
import pytest

import heat_tpu_torch as htt
from heat_tpu_torch import native
from heat_tpu_torch.core import io as tio

MESHES = (1, 4, 8)
FORMATS = ("h5", "nc", "npy", "csv")
# the public names of heat_tpu that the port still lacks (tpu by design)
MISSING = {"analysis", "tpu"}


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _x(shape=(13, 6), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _write(path, x, fmt):
    """``x`` written by numpy, h5py or scipy alone, as a user's file."""
    if fmt == "h5":
        import h5py

        with h5py.File(path, "w") as f:
            f["x"] = x
    elif fmt == "nc":
        from scipy.io import netcdf_file

        with netcdf_file(path, "w") as f:
            for i, n in enumerate(x.shape):
                f.createDimension(f"d{i}", n)
            f.createVariable("x", "f", tuple(f"d{i}" for i in range(x.ndim)))[:] = x
    elif fmt == "npy":
        np.save(path, x)
    else:
        np.savetxt(path, x, delimiter=",", fmt="%s")


def _load(pkg, path, fmt, split, comm, **kw):
    if fmt in ("h5", "nc"):
        return pkg.load(path, "x", split=split, comm=comm, **kw)
    return pkg.load(path, split=split, comm=comm, **kw)


def _same(a, b):
    """heat_tpu's DNDarray ``a`` and the port's ``b``: shape, dtype, split,
    global values and each position's shard, bitwise."""
    assert tuple(b.shape) == tuple(a.shape) and b.split == a.split
    assert b.dtype.__name__ == a.dtype.__name__
    x, y = np.asarray(a.numpy()), b.numpy()
    assert x.dtype == y.dtype
    np.testing.assert_array_equal(np.atleast_1d(y).view(np.uint8), np.atleast_1d(x).view(np.uint8))
    if b.split is not None:
        for u, v in zip(a.lshards(), b.lshards()):
            assert u.shape == v.shape
            np.testing.assert_array_equal(v, np.asarray(u))


def _pair_comms(ht, n):
    return ht.parallel.mesh.local_mesh(n), htt.MeshComm(n)


# ------------------------------------------------------------------ loads
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_every_format(ht, tmp_path, n, fmt):
    x = _x(seed=n)
    path = str(tmp_path / f"x.{fmt}")
    _write(path, x, fmt)
    jc, tc = _pair_comms(ht, n)
    for split in (None, 0, 1):
        got = _load(htt, path, fmt, split, tc, device="cpu")
        _same(_load(ht, path, fmt, split, jc), got)
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("n", MESHES)
def test_hdf5_slices_with_a_step(ht, tmp_path, n):
    x = _x((29, 7), seed=3)
    path = str(tmp_path / "x.h5")
    _write(path, x, "h5")
    jc, tc = _pair_comms(ht, n)
    for slices in ((slice(1, 26, 3), slice(None, None, 2)), slice(2, 20, 4), (None, slice(5))):
        for split in (0, 1):
            got = htt.load_hdf5(path, "x", split=split, comm=tc, slices=slices, device="cpu")
            _same(ht.load_hdf5(path, "x", split=split, comm=jc, slices=slices), got)
            key = tuple(slice(None) if k is None else k for k in (slices if isinstance(slices, tuple) else (slices,)))
            np.testing.assert_array_equal(got.numpy(), x[key])


def test_bundled_datasets_and_a_scalar(ht, tmp_path):
    """The port's copies of the data files load to heat_tpu's values, and
    so does a 0-d dataset (one mesh: the values do not depend on the
    layout)."""
    jc, tc = _pair_comms(ht, 4)
    scalar = str(tmp_path / "s.h5")
    _write(scalar, np.float32(2.5), "h5")
    _same(ht.load_hdf5(scalar, "x", comm=jc), htt.load_hdf5(scalar, "x", comm=tc, device="cpu"))
    assert htt.datasets.path != ht.datasets.path
    for name in sorted(os.listdir(ht.datasets.path)):
        if name.endswith((".py", "__pycache__")):
            continue
        with open(os.path.join(ht.datasets.path, name), "rb") as f, open(os.path.join(htt.datasets.path, name), "rb") as g:
            assert f.read() == g.read(), name
    cases = [("iris.h5", ("data",), {}), ("diabetes.h5", ("x",), {}), ("diabetes.h5", ("y",), {}),
             ("iris.nc", ("data",), {}), ("iris.csv", (), {"sep": ";"}), ("iris_X_train.csv", (), {"sep": ";"}),
             ("iris_labels.csv", (), {"dtype": htt.int64})]
    for name, args, kw in cases:
        jkw = dict(kw, dtype=ht.int64) if "dtype" in kw else kw
        want = ht.load(os.path.join(ht.datasets.path, name), *args, split=0, comm=jc, **jkw)
        _same(want, htt.load(os.path.join(htt.datasets.path, name), *args, split=0, comm=tc, device="cpu", **kw))


# ---------------------------------------------------------------- saves
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_save_and_load_across_the_packages(ht, tmp_path, n, fmt):
    """The port writes what heat_tpu reads back, and the other way round."""
    x = _x(seed=10 + n)
    jc, tc = _pair_comms(ht, n)
    args = ("x",) if fmt in ("h5", "nc") else ()
    for split in (None, 0, 1):
        ours, theirs = str(tmp_path / f"t{split}.{fmt}"), str(tmp_path / f"j{split}.{fmt}")
        htt.save(htt.array(x, split=split, comm=tc, device="cpu"), ours, *args)
        ht.save(ht.array(x, split=split, comm=jc), theirs, *args)
        for path in (ours, theirs):
            _same(_load(ht, path, fmt, split, jc), _load(htt, path, fmt, split, tc, device="cpu"))
        np.testing.assert_array_equal(_load(htt, ours, fmt, None, tc, device="cpu").numpy(), x)


def test_dndarray_save_members_and_collisions(tmp_path):
    x = htt.array(_x(), split=0, comm=htt.MeshComm(4), device="cpu")
    path = str(tmp_path / "x.h5")
    x.save_hdf5(path, "a")
    x.save(path, "b", mode="a")
    with pytest.raises(ValueError, match="already exists"):
        x.save_hdf5(path, "a", mode="a")
    for name in ("a", "b"):
        np.testing.assert_array_equal(htt.load_hdf5(path, name, device="cpu").numpy(), x.numpy())
    x.save_netcdf(str(tmp_path / "x.nc"), "v")
    np.testing.assert_array_equal(htt.load_netcdf(str(tmp_path / "x.nc"), "v", device="cpu").numpy(), x.numpy())
    with pytest.raises(ValueError, match="extension"):
        htt.save(x, str(tmp_path / "x.bin"))
    with pytest.raises(ValueError, match="extension"):
        htt.load(str(tmp_path / "x.bin"))
    assert htt.supports_hdf5() and htt.supports_netcdf()


def test_csv_header_append_and_dtypes(ht, tmp_path):
    x = _x((11, 3), seed=4)
    jc, tc = _pair_comms(ht, 4)
    path = str(tmp_path / "x.csv")
    tx = htt.array(x, split=1, comm=tc, device="cpu")
    htt.save_csv(tx, path, header_lines=["# a", "# b"], sep=";", decimals=3)
    htt.save_csv(tx, path, sep=";", decimals=3, truncate=False)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[:2] == ["# a", "# b"] and len(lines) == 2 + 2 * 11
    for dtype in ("float32", "float64"):
        for split in (None, 0):
            want = ht.load_csv(path, header_lines=2, sep=";", dtype=getattr(ht, dtype), split=split, comm=jc)
            _same(want, htt.load_csv(path, header_lines=2, sep=";", dtype=getattr(htt, dtype), split=split, comm=tc,
                                     device="cpu"))


def test_csv_native_and_numpy_routes_agree(tmp_path):
    """The native parser (float32) and numpy's give the same bits for each
    position's byte range; the pure-Python row bounds equal the native
    ones."""
    x = (_x((41, 5), seed=5) * 1e3).astype(np.float32)
    path = str(tmp_path / "x.csv")
    np.savetxt(path, x, delimiter=",", fmt="%.9g")
    with open(path, "a") as f:
        f.write("\n# a comment line\n")
    bounds, rows = native.csv_row_bounds(path, 0, 4)
    assert (bounds, rows) == tio._csv_row_bounds_py(path, 0, 4) and rows == 41
    f32 = np.dtype(np.float32)
    for r in range(4):
        fast = tio._csv_parse_byte_range(path, bounds[r], bounds[r + 1], ",", f32, "utf-8", True)
        slow = tio._csv_parse_byte_range(path, bounds[r], bounds[r + 1], ",", f32, "utf-8", False)
        np.testing.assert_array_equal(fast.view(np.uint32), slow.view(np.uint32))
    np.testing.assert_array_equal(native.csv_parse(path).view(np.uint32), x.view(np.uint32))
    np.testing.assert_array_equal(htt.load_csv(path, split=0, comm=htt.MeshComm(4), device="cpu").numpy(), x)


# ------------------------------------------------------------ slab funnel
@contextlib.contextmanager
def _spy(monkeypatch):
    reads, writes = [], []
    read, write = tio._read_region, tio._write_region

    def spy_read(source, sel):
        out = read(source, sel)
        reads.append(np.asarray(out).shape)
        return out

    def spy_write(sink, sel, value):
        writes.append(np.asarray(value).shape)
        return write(sink, sel, value)

    monkeypatch.setattr(tio, "_read_region", spy_read)
    monkeypatch.setattr(tio, "_write_region", spy_write)
    yield reads, writes


@pytest.mark.parametrize("n", (4, 8))
def test_no_call_moves_more_than_one_slab(tmp_path, monkeypatch, n):
    x = _x((29, 11), seed=6)
    comm = htt.MeshComm(n)
    for split in (0, 1):
        slab = -(-x.shape[split] // n)
        a = htt.array(x, split=split, comm=comm, device="cpu")
        for fmt in ("h5", "nc", "npy"):
            path = str(tmp_path / f"s{split}.{fmt}")
            args = ("x",) if fmt != "npy" else ()
            with _spy(monkeypatch) as (reads, writes):
                htt.save(a, path, *args)
                b = htt.load(path, *args, split=split, comm=comm, device="cpu")
            np.testing.assert_array_equal(b.numpy(), x)
            if fmt != "nc":  # scipy's classic writer keeps the variable in memory until it closes
                assert writes and all(w[split] <= slab for w in writes), (fmt, writes)
            assert reads and all(r[split] <= slab for r in reads), (fmt, reads)


# ----------------------------------------------------------------- native
_M64 = (1 << 64) - 1


def _threefry2x64(k0, k1, c0, c1):
    """Threefry-2x64, 20 rounds (Salmon et al. 2011), in Python integers:
    the reference the host library's copy is held to."""
    rot = (16, 42, 12, 31, 16, 32, 24, 21)
    ks = (k0, k1, 0x1BD11BDAA9FC1A22 ^ k0 ^ k1)
    x0, x1 = (c0 + ks[0]) & _M64, (c1 + ks[1]) & _M64
    for r in range(20):
        x0 = (x0 + x1) & _M64
        x1 = ((x1 << rot[r % 8]) | (x1 >> (64 - rot[r % 8]))) & _M64
        x1 ^= x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & _M64
            x1 = (x1 + ks[(s + 1) % 3] + s) & _M64
    return x0, x1


def test_native_threefry_reads_and_build_failure(tmp_path, monkeypatch):
    seed, counter = 7, 3
    want = [_threefry2x64(seed, 0, c & ~1, c | 1)[c & 1] for c in range(counter, counter + 40)]
    np.testing.assert_array_equal(native.threefry_fill(seed, counter, 40), np.array(want, dtype=np.uint64))
    np.testing.assert_array_equal(native.threefry_fill(7, 3, 70_000, nthreads=1), native.threefry_fill(7, 3, 70_000))
    perm = list(range(33))
    for i in range(32, 0, -1):
        j = _threefry2x64(11, 1, i, 0)[0] % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    np.testing.assert_array_equal(native.threefry_permutation(11, 33), perm)
    blob = np.random.default_rng(8).integers(0, 256, 100_003, dtype=np.uint8)
    path = str(tmp_path / "b.bin")
    blob.tofile(path)
    np.testing.assert_array_equal(native.read_bytes(path, 17, 5000), blob[17:5017])
    with native.PrefetchPipeline(path, slab_bytes=4096) as pipe:
        np.testing.assert_array_equal(np.concatenate(list(pipe)), blob)
    assert native.available() and native.lib() is native.lib()
    bad = tmp_path / "src"
    bad.mkdir()
    for name in native.SOURCES:
        (bad / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native library failed"):
        native._build(tmp_path / "build" / "lib.so")


def test_public_names(ht):
    """heat_tpu's public names that the port lacks, as a fresh interpreter
    lists them: heat_tpu's lazily imported subpackages (``nn``, ``optim``,
    ``serving``; items 12 and 13) join its ``dir`` only once some code has
    loaded them."""
    lazy = set(ht._LAZY_SUBPACKAGES)
    names = {n for n in set(dir(ht)) - set(dir(htt)) - lazy if not n.startswith("_")}
    assert names == MISSING
    assert htt.__version__ == ht.__version__ and htt.version.extension == ht.version.extension
    for name in ("load", "load_csv", "load_hdf5", "load_netcdf", "load_npy", "save", "save_csv", "save_hdf5",
                 "save_netcdf", "save_npy", "supports_hdf5", "supports_netcdf"):
        assert getattr(htt, name) is getattr(htt.io, name)
    assert sorted(htt.utils.data.__all__) == sorted(ht.utils.data.__all__)
