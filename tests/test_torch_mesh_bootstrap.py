"""The port's process bootstrap and sub-communicators against heat_tpu's
(tests/test_mesh_bootstrap.py without its graft-entry class).

``init_distributed`` in a plain single-process run is a no-op returning
(0, 1); ``hybrid_mesh`` validates as heat_tpu's does and returns a mesh the
port's ``MeshComm`` and ``DASO`` take; ``MeshComm.Split``/``split_groups``
keep heat_tpu's semantics and errors; a KMeans fit on a sub-communicator
matches heat_tpu's on the same positions; ``DASO.reduced_comms`` spans the
dcn axis once per intra-slice position."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import hybrid_mesh, init_distributed, local_mesh


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


# ------------------------------------------------------------ init_distributed
def test_single_process_noop(ht):
    assert init_distributed() == (0, 1) == ht.parallel.init_distributed()
    assert not torch.distributed.is_initialized()
    assert htt.parallel.world().size == 1 and not htt.parallel.world().is_process_comm


def test_idempotent():
    assert init_distributed() == init_distributed()


def test_local_mesh_in_one_process():
    comm = local_mesh(4)
    assert comm.size == 4 and comm.local_positions == (0, 1, 2, 3) and not comm.is_process_comm
    assert local_mesh().size == 1


# ----------------------------------------------------------------- hybrid_mesh
def test_ici_only(ht):
    mesh = hybrid_mesh({"split": 4, "tp": 2})
    want = ht.parallel.hybrid_mesh({"split": 4, "tp": 2})
    assert mesh.axis_names == tuple(want.axis_names) == ("split", "tp")
    assert dict(mesh.shape) == dict(want.shape) == {"split": 4, "tp": 2}


def test_unit_dcn_axis_is_plain_mesh(ht):
    mesh = hybrid_mesh({"split": 8}, {"dp": 1})
    want = ht.parallel.hybrid_mesh({"split": 8}, {"dp": 1})
    assert mesh.axis_names == tuple(want.axis_names) == ("dp", "split")
    assert dict(mesh.shape) == dict(want.shape) == {"dp": 1, "split": 8}


def test_mesh_drives_sharded_compute():
    mesh = hybrid_mesh({"split": 4, "tp": 2}, {"dp": 1})
    comm = htt.MeshComm(mesh, split_axis="split")
    assert comm.size == 4 and comm.mesh is mesh
    x = htt.array(np.arange(64.0).reshape(8, 8), split=0, comm=comm, device="cpu")
    assert float(htt.sum(x * 2)) == 2 * 63 * 64 / 2
    with pytest.raises(ValueError, match="split_axis"):
        htt.MeshComm(mesh, split_axis="ep")


@pytest.mark.parametrize("ici, dcn", [({}, None), ({"dp": 8}, {"dp": 1})], ids=["empty-ici", "duplicate-axis"])
def test_bad_tiers_rejected(ht, ici, dcn):
    with pytest.raises(ValueError):
        ht.parallel.hybrid_mesh(ici, dcn)
    with pytest.raises(ValueError):
        hybrid_mesh(ici, dcn)


# --------------------------------------------------------------- Split
def test_scalar_color_is_whole_mesh():
    comm = htt.MeshComm(8)
    sub = comm.Split(0)
    assert sub.size == comm.size and sub is not comm


def test_sequence_color_partitions():
    comm = htt.MeshComm(8)
    colors = [i % 2 for i in range(comm.size)]
    even, odd = comm.Split(colors, key=0), comm.Split(colors, key=1)
    assert even.size == (comm.size + 1) // 2 and odd.size == comm.size // 2
    assert sorted(even.mesh.devices.flat) == [0, 2, 4, 6] and sorted(odd.mesh.devices.flat) == [1, 3, 5, 7]


def test_split_groups_covers_all_devices():
    comm = htt.MeshComm(8)
    colors = [i % 3 for i in range(comm.size)]
    groups = comm.split_groups(colors)
    assert set(groups) == set(colors)
    assert sum(g.size for g in groups.values()) == comm.size


def test_bad_color_shape_and_key_rejected(ht):
    comm = htt.MeshComm(8)
    jcomm = ht.parallel.mesh.sanitize_comm(None)
    for c in (comm, jcomm):
        with pytest.raises(ValueError):
            c.Split([0, 1])
        with pytest.raises(ValueError):
            c.split_groups([0, 1])
        colors = [i % 2 for i in range(c.size)]
        for key in (c.size, -1):
            with pytest.raises(ValueError):
                c.Split(colors, key=key)


def test_estimator_fit_on_submesh(ht):
    """A KMeans fit on the first half of 8 positions: the port's centres and
    labels against heat_tpu's on the same sub-mesh, from given centres."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(-5, 0.3, (40, 2)), rng.normal(5, 0.3, (40, 2))]).astype(np.float32)
    colors = [0] * 4 + [1] * 4
    jhalf = ht.parallel.mesh.local_mesh(8).Split(colors, key=0)
    thalf = htt.MeshComm(8).Split(colors, key=0)
    assert jhalf.size == thalf.size == 4
    init = X[[0, 79]]
    jk = ht.cluster.KMeans(n_clusters=2, init=ht.array(init, comm=jhalf), max_iter=20).fit(
        ht.array(X, split=0, comm=jhalf))
    tk = htt.cluster.KMeans(n_clusters=2, init=htt.array(init, comm=thalf, device="cpu"), max_iter=20).fit(
        htt.array(X, split=0, comm=thalf, device="cpu"))
    np.testing.assert_allclose(tk.cluster_centers_.numpy(), np.asarray(jk.cluster_centers_.numpy()), atol=1e-5)
    np.testing.assert_array_equal(tk.labels_.numpy(), np.asarray(jk.labels_.numpy()))
    np.testing.assert_allclose(np.sort(tk.cluster_centers_.numpy()[:, 0]), [-5, 5], atol=0.5)


def test_daso_reduced_comms_parity(ht):
    import jax
    import optax
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ici"))
    jd = ht.optim.DASO(ht.optim.DataParallelOptimizer(optax.sgd(0.1)), mesh=jmesh,
                       comm=ht.parallel.mesh.MeshComm(jmesh, split_axis="ici"))
    mesh = hybrid_mesh({"ici": 4}, {"dcn": 2})
    td = htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1)), mesh=mesh,
                        comm=htt.MeshComm(mesh, split_axis="ici"))
    assert len(td.reduced_comms) == len(jd.reduced_comms) == 4
    assert td.n_slices == jd.n_slices == 2
    for rc, jrc in zip(td.reduced_comms, jd.reduced_comms):
        assert rc.size == jrc.size == 2 and rc.split_axis == "dcn"
    cols = [sorted(rc.mesh.devices.flat) for rc in td.reduced_comms]
    assert cols == [[i, 4 + i] for i in range(4)]
    # the one-process layout by tuple keeps working, with its reduced comms
    tup = htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1)), mesh=(2, 2), comm=htt.MeshComm(4))
    assert tup.n_slices == 2 and [rc.size for rc in tup.reduced_comms] == [2, 2] and not tup.across_processes
