"""The port across processes: 2 gloo processes × 2 positions against
heat_tpu on its CPU mesh of 4.

One module fixture writes the inputs (and heat_tpu's initial variables) to
``tmp_path``, starts the two processes once (``_child`` below, run as
``python -c``, which imports no JAX), computes heat_tpu's results while
they run, and reads theirs back.  The scenarios: reductions through the
collectives' process route (``sum``, ``mean``, ``var``, ``min``/``max``
with a NaN, ``argmin``, ``cumsum`` through ``exscan``; also with fewer
rows than positions, so that one process owns only empty shards),
``array(is_split=)`` assembly and its raise, MLP ``DataParallel`` steps, a ResNet with the
cross-process BatchNorm, DASO with the two processes as slices, KMeans from
given centres; the moves of shards between processes through the one
exchange (resplit, reshape, advanced ``__getitem__``/``__setitem__`` with a
split value, ``shuffle_rows``, mask select, sort/topk/unique/median,
cumprod, ``.larray``, ``lshards()``, the collectives, a forced-``int8``
resplit, KMeans/KMedians/KMedoids seeded across processes), each also run
in the process on ``MeshComm(4)`` to compare shards; the wire arm and the
OOM back-off agreed across processes; and the refusal of a direct read of
another process's shard.  Every process must return the same replicated
values."""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import heat_tpu_torch as htt

ATOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
PROCS, POSITIONS = 2, 4
CHILD_LIMIT = 240  # seconds: a child that hangs fails the fixture
TINY_OPS = ("sum", "mean", "var", "min", "max", "argmin", "cumsum")
# what moves shards between processes, against heat_tpu on its mesh of 4
MOVES = ("r01", "r010", "rNone", "reshape", "reshape_s1", "take", "pair", "flip", "mask", "mask_full", "set_slice",
         "set_mask", "set_int", "set_step", "shuffle", "sort_v", "sort_i", "sortd_v", "sortd_i", "isort_v", "isort_i",
         "csort_v", "topk_v", "topk_i", "unique", "unique_inv", "median", "cumprod", "larray", "tiny_r01", "tiny_sort",
         "colsort_v", "colsort_i", "int8")
KC_KEYS = ("km_random", "km_pp", "kmedians", "kmedoids", "kmedoids_pp")


def _moves(ht, comm, data, psort=None, wire=None) -> dict:
    """The moves' results (DNDarrays, or (values, indices) pairs) of either
    package on ``comm``; ``psort`` is the port's ``parallel.sort`` (the
    columnsort route), ``wire`` the package's wire module."""
    a, m = data["red"], data["red"][:, 0] > 0
    x = ht.array(a, split=0, comm=comm)
    k = ht.array(data["km_x"], split=0, comm=comm)
    v = np.ascontiguousarray(a[::-1] * 2 + 1)
    out = {"r01": x.resplit(1), "r010": x.resplit(1).resplit(0), "rNone": x.resplit(None),
           "reshape": ht.reshape(x, (5, 13), new_split=0), "reshape_s1": ht.reshape(k, (4, 101), new_split=1),
           "take": x[np.array([12, 0, 5, 7, 3])], "pair": x[np.array([1, 5, 12, 0]), np.array([0, 4, 2, 3])],
           "flip": x[::-1], "mask": x[m], "mask_full": x[a > 0]}
    for key, sel, val in (("set_slice", slice(2, 11), v[:9]), ("set_mask", m, v[: int(m.sum())]),
                          ("set_int", np.array([12, 0, 5, 6, 3]), v[:5]), ("set_step", (slice(1, 12, 3), slice(1, 4)),
                                                                            v[:4, :3])):
        y = ht.array(a, split=0, comm=comm)
        y[sel] = ht.array(np.ascontiguousarray(val), split=0, comm=comm)
        out[key] = y
    ht.random.seed(5)
    out["shuffle"] = ht.random.shuffle_rows([ht.array(a, split=0, comm=comm)])[0]
    out["sort_v"], out["sort_i"] = ht.sort(x, axis=0)
    out["sortd_v"], out["sortd_i"] = ht.sort(x, axis=0, descending=True)
    ints = ht.array(data["ints"], split=0, comm=comm)
    out["isort_v"], out["isort_i"] = ht.sort(ints)
    out["csort_v"] = ht.sort(ht.array(data["cplx"], split=0, comm=comm))[0]
    out["topk_v"], out["topk_i"] = ht.topk(x, 3, dim=0)
    out["unique"], out["unique_inv"] = ht.unique(ints, return_inverse=True)
    out["median"] = ht.median(x, axis=0)
    out["cumprod"] = ht.cumprod(x, axis=0)
    out["larray"] = x.larray
    tiny = ht.array(data["tiny"], split=0, comm=comm)
    out["tiny_r01"], out["tiny_sort"] = tiny.resplit(1), ht.sort(tiny, axis=0)[0]
    if psort is None:
        out["colsort_v"], out["colsort_i"] = ht.sort(k, axis=0)
    else:
        vals, idx, _ = psort.distributed_sort(k.shards, 0, method="columnsort", comm=comm)
        out["colsort_v"] = ht.DNDarray(vals, k.shape, k.dtype, 0, k.device, comm)
        out["colsort_i"] = ht.DNDarray(idx, k.shape, ht.int32, 0, k.device, comm)
    old = wire.set_mode("int8")
    try:
        out["int8"] = k.resplit(1)
    finally:
        wire.set_mode(old)
    return out


def _kclusters(ht, comm, data) -> dict:
    """KMeans from "random" and "kmeans++", KMedians and KMedoids, seeded."""
    x = ht.array(data["km_x"], split=0, comm=comm)
    return {"km_random": ht.cluster.KMeans(n_clusters=3, init="random", max_iter=5, tol=-1, random_state=7).fit(x),
            "km_pp": ht.cluster.KMeans(n_clusters=3, init="kmeans++", max_iter=5, tol=-1, random_state=7).fit(x),
            "kmedians": ht.cluster.KMedians(n_clusters=3, init="kmedians++", max_iter=5, random_state=7).fit(x),
            "kmedoids": ht.cluster.KMedoids(n_clusters=3, init="random", max_iter=5, random_state=7).fit(x),
            "kmedoids_pp": ht.cluster.KMedoids(n_clusters=3, init="kmedoids++", max_iter=5, random_state=7).fit(x)}


def _host(v):
    return np.asarray(v.numpy()) if hasattr(v, "numpy") else np.asarray(v)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# --------------------------------------------------------------- the processes
def _child(rank: int, port: int, inputs: str, out: str) -> None:
    """One process of the two: every scenario, results to ``out``."""
    htt.use_device("cpu")
    assert htt.parallel.init_distributed(f"127.0.0.1:{port}", PROCS, rank) == (rank, PROCS)
    assert htt.parallel.init_distributed() == (rank, PROCS)  # idempotent
    comm = htt.parallel.local_mesh(POSITIONS)
    assert comm.is_process_comm and comm.local_positions == (2 * rank, 2 * rank + 1)
    assert htt.parallel.world().size == PROCS and htt.parallel.world().is_process_comm
    data = dict(np.load(inputs))
    res = {}

    a = data["red"]
    x = htt.array(a, split=0, comm=comm)
    assert len(comm.local_shards(x.shards)) == 2
    res["sum0"] = htt.sum(x, axis=0).numpy()
    res["sum"] = htt.sum(x).numpy()
    res["mean0"] = htt.mean(x, axis=0).numpy()
    res["var0"] = htt.var(x, axis=0).numpy()
    res["min0"] = htt.min(x, axis=0).numpy()
    res["max"] = htt.max(x).numpy()
    res["argmin0"] = htt.argmin(x, axis=0).numpy()
    res["cumsum0"] = htt.cumsum(x, axis=0).numpy()
    res["rowsum"] = htt.sum(x * 2 + 1, axis=1).numpy()
    res["isum"] = htt.sum(htt.array(data["ints"], split=0, comm=comm)).numpy()
    res["cmin"] = htt.min(htt.array(data["cplx"], split=0, comm=comm)).numpy()
    # fewer rows than positions: process 1 owns only empty positions
    tiny = htt.array(data["tiny"], split=0, comm=comm)
    assert all(s.shape[0] == 0 for s in comm.local_shards(tiny.shards)) == (rank == 1)
    for name in TINY_OPS:
        res[f"tiny_{name}0"] = getattr(htt, name)(tiny, axis=0).numpy()
    one_row = htt.array(data["tiny"][:1], split=0, comm=htt.parallel.world())
    res["tiny_max_world"], res["tiny_sum_world"] = htt.max(one_row).numpy(), htt.sum(one_row).numpy()

    # is_split: this process's chunk by the chunk rule; a wrong chunk raises
    rows = [comm.chunk(a.shape, 0, rank=r)[2][0] for r in comm.local_positions]
    chunk = a[rows[0].start:rows[-1].stop]
    y = htt.array(chunk, is_split=0, comm=comm)
    assert y.shape == a.shape and y.split == 0
    res["is_split"] = y.numpy()
    try:
        htt.array(a[: 7 if rank == 0 else 6], is_split=0, comm=comm)
        res["is_split_raises"] = np.array(False)
    except ValueError:
        res["is_split_raises"] = np.array(True)

    _child_moves(rank, comm, data, res)

    # refusals: what still refuses across processes is a direct read of
    # another process's shard (its bytes move only through the exchange)
    refused = []
    for name, fn in (("remote shard", lambda: x.shards[2 - 2 * rank] + 1),
                     ("remote shard read", lambda: x.shards[2 - 2 * rank].sum())):
        try:
            fn()
        except NotImplementedError as err:
            refused.append(name if "collectives.exchange" in str(err) else f"{name}: {err}")
    res["refused"] = np.array(json.dumps(refused))

    # MLP DataParallel: each process steps on its rows
    mlp = htt.models.mlp_from_flax(_nest(data, "mlp/"), device="cpu")
    dp = htt.nn.DataParallel(mlp, comm=comm, optimizer=htt.optim.DataParallelOptimizer(
        htt.optim.sgd(0.05, momentum=0.9))).init(0, data["mlp_x"])
    res["mlp_loss"] = np.array([float(dp.train_step(htt.array(data["mlp_x"], split=0, comm=comm),
                                                    htt.array(data["mlp_y"], split=0, comm=comm)))
                                for _ in range(3)])
    for i, layer in enumerate(mlp.layers):
        res[f"mlp_k{i}"], res[f"mlp_b{i}"] = layer.kernel.detach().numpy(), layer.bias.detach().numpy()

    # ResNet with the cross-process BatchNorm, against a one-process run
    for tag, c in (("rn", comm), ("rn1", htt.MeshComm(POSITIONS))):
        net = htt.models.resnet_from_flax(_nest(data, "resnet/"), stage_sizes=(1,), device="cpu")
        dpr = htt.nn.DataParallel(net, comm=c, optimizer=htt.optim.DataParallelOptimizer(
            htt.optim.sgd(0.1, momentum=0.9))).init(0, data["rn_x"])
        losses = [float(dpr.train_step(data["rn_x"], data["rn_y"]))]
        for key, v in net.state_dict().items():
            if key.endswith(".mean") or key.endswith(".var"):
                res[f"{tag}_stats1/{key}"] = v.numpy().copy()
        losses.append(float(dpr.train_step(data["rn_x"], data["rn_y"])))
        res[f"{tag}_loss"] = np.array(losses)
        for key, v in net.state_dict().items():
            res[f"{tag}/{key}"] = v.numpy()

    # DASO: the two processes are the dcn slices
    mesh = htt.parallel.hybrid_mesh({"ici": 2}, {"dcn": 2})
    ici = htt.MeshComm(mesh, split_axis="ici")
    daso = htt.optim.DASO(htt.optim.DataParallelOptimizer(htt.optim.sgd(0.1, momentum=0.9)), mesh=mesh, comm=ici,
                          total_epochs=10, warmup_epochs=0, cooldown_epochs=0)
    assert daso.across_processes and daso.local_slices == (rank,) and len(daso.reduced_comms) == 2
    dm = htt.nn.DataParallelMultiGPU(htt.models.mlp_from_flax(_nest(data, "daso/"), device="cpu"), comm=ici,
                                     optimizer=daso).init(0, data["daso_x"][:4])
    daso.global_skip, daso.batches_seen = 3, 1
    kernels, losses = [], []
    for _ in range(2, 9):
        losses.append(float(dm.train_step(data["daso_x"], data["daso_y"])))
        kernels.append(dm.replicas[0].layers[0].kernel.detach().numpy().copy())
    res["daso_k"], res["daso_loss"] = np.stack(kernels), np.array(losses)

    # KMeans from given centres, K1's plain version per position
    xk = htt.array(data["km_x"], split=0, comm=comm)
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(data["km_init"], comm=comm), max_iter=6, tol=-1).fit(xk)
    res["km_centers"], res["km_labels"] = km.cluster_centers_.numpy(), km.labels_.numpy()
    res["km_inertia"] = np.array(km.inertia_)
    res["km_predict"] = km.predict(xk).numpy()
    np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _child_moves(rank: int, comm, data, res) -> None:
    """The moves across processes, each also on ``MeshComm(4)`` in this
    process: global values, this process's shards of both, the K7 calls of
    the reshape, the collectives, the seeded estimators, the wire arm's and
    the OOM back-off's agreement, the exchange's counters."""
    from heat_tpu_torch.core import wire as twire
    from heat_tpu_torch.ops import repack as k7
    from heat_tpu_torch.parallel import collectives, transport
    from heat_tpu_torch.parallel import sort as psort
    from heat_tpu_torch.utils import fault

    one = htt.MeshComm(POSITIONS)
    os.environ["HEAT_TPU_WIRE_MIN_BYTES"] = "1"
    transport.reset_stats()
    calls = {}
    for tag, c in (("mv", comm), ("one", one)):
        before = k7.calls
        x = htt.array(data["red"], split=0, comm=c)
        htt.reshape(x, (5, 13), new_split=0)
        calls[tag] = k7.calls - before
        for key, val in _moves(htt, c, data, psort, twire).items():
            if tag == "mv":
                res[f"mv/{key}"] = _host(val.larray if isinstance(val, htt.DNDarray) else val)
            if isinstance(val, htt.DNDarray) and val.split is not None:
                for r in comm.local_positions:
                    res[f"{tag}s/{key}/{r}"] = val.shards[r].numpy()
    res["k7_calls"], res["k7_calls_one"] = np.array(calls["mv"]), np.array(calls["one"])
    x = htt.array(data["red"], split=0, comm=comm)
    res["lshards"] = np.array([s.shape[0] for s in x.lshards()])
    for i, sh in enumerate(x.lshards()):
        res[f"lshard/{i}"] = sh
    stats = transport.stats()
    res["exchange"] = np.array([stats["exchanges"], stats["sent_bytes"], stats["staged_bytes"]])
    res["repr"] = np.array(repr(comm))

    # the collectives: the process route against the single controller's
    blocks = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    parts = [torch.from_numpy(blocks[4 * r: 4 * r + 4]) for r in range(POSITIONS)]
    mine = [parts[r] for r in comm.local_positions]
    perm = [(0, 2), (2, 1), (1, 3)]
    for key, got, want in (
        ("all_to_all", collectives.all_to_all(mine, 0, 1, comm=comm), collectives.all_to_all(parts, 0, 1)),
        ("ppermute", collectives.ppermute(mine, perm, comm=comm), collectives.ppermute(parts, perm)),
        ("ring_shift", collectives.ring_shift(mine, 1, comm=comm), collectives.ring_shift(parts, 1)),
        ("ring_shift3", collectives.ring_shift(mine, 3, comm=comm), collectives.ring_shift(parts, 3)),
    ):
        res[f"coll/{key}"] = np.stack([t.numpy() for t in got])
        res[f"coll1/{key}"] = np.stack([want[r].numpy() for r in comm.local_positions])

    # the estimators seeded across processes: the seeding centres and the fits
    for tag, c in (("kc", comm), ("kc1", one)):
        for key, est in _kclusters(htt, c, data).items():
            res[f"{tag}/{key}/centres"] = est.cluster_centers_.numpy()
            res[f"{tag}/{key}/labels"] = est.labels_.numpy()
        for init in ("random", "kmeans++"):
            est = htt.cluster.KMeans(n_clusters=3, init=init, random_state=7)
            est._initialize_cluster_centers(htt.array(data["km_x"], split=0, comm=c))
            res[f"{tag}/seed_{init}"] = est.cluster_centers_.numpy()

    # the wire arm agreed: process 1's own table would pick int8 at once;
    # process 0's explores, and both follow process 0
    prev_auto, prev_mode = htt.core.autotune.set_enabled(True), twire.set_mode("on")
    real = twire.choose
    if rank == 1:
        twire.choose = lambda *a, **kw: ("wire_int8", None)
    try:
        kx = htt.array(data["km_x"], split=0, comm=comm)
        res["wire_agreed"] = np.stack([kx.resplit(1).numpy() for _ in range(5)])
    finally:
        twire.choose = real
        htt.core.autotune.set_enabled(prev_auto)
        twire.set_mode(prev_mode)
        htt.core.autotune.reset()

    # the OOM back-off in step: process 0 alone runs out of memory
    x = htt.array(data["red"], split=0, comm=comm)
    for tag, times in (("oom_once", 1), ("oom_exhausted", 100)):
        transport.reset_stats()
        inj = fault.FaultInjector().oom_in("transport.resplit", times=times)
        try:
            if rank == 0:
                with fault.injected(inj):
                    y = x.resplit(1).numpy()
            else:
                y = x.resplit(1).numpy()
            res[f"{tag}/raised"] = np.array(False)
            res[f"{tag}/value"] = y
        except torch.OutOfMemoryError:
            res[f"{tag}/raised"] = np.array(True)
        st = transport.stats()
        res[f"{tag}/stats"] = np.array([st["oom_retries"], st["oom_exhausted"]])


def _start(inputs: str, outdir: str):
    port = _free_port()
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {HERE!r})
        import test_torch_distributed as t
        t._child(int(sys.argv[1]), {port}, {inputs!r}, sys.argv[2])
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen([sys.executable, "-c", code, str(r), os.path.join(outdir, f"rank{r}.npz")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(PROCS)]


# ----------------------------------------------------------------- heat_tpu
class _JitInit:
    def __init__(self, module):
        self._module = module

    def init(self, rngs, sample):
        import jax

        return jax.jit(self._module.init)(rngs, sample)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory, worker_id):
    """The scenarios' (inputs, heat_tpu's results, the two processes'
    results).  Under xdist the first worker to get here computes them and
    the others read its pickle (one run a session, not one a worker)."""
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    if worker_id == "master":
        return _run(tmp_path_factory)
    from filelock import FileLock

    cache = tmp_path_factory.getbasetemp().parent / "torch_distributed_run.pkl"
    with FileLock(str(cache) + ".lock"):
        if cache.exists():
            return pickle.loads(cache.read_bytes())
        result = _run(tmp_path_factory)
        cache.write_bytes(pickle.dumps(result))
        return result


def _run(tmp_path_factory):
    import heat_tpu as ht
    import jax
    import optax
    from heat_tpu.models import resnet as jr
    from jax.sharding import Mesh

    tmp = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(0)
    red = rng.normal(size=(13, 5)).astype(np.float32)
    red[3, 2] = np.nan
    inputs = {
        "red": red,
        "ints": rng.integers(-50, 50, 11),
        "cplx": (rng.integers(-3, 3, 9) + 1j * rng.integers(-3, 3, 9)).astype(np.complex64),
        "mlp_x": rng.normal(size=(16, 3, 4)).astype(np.float32),
        "mlp_y": rng.integers(0, 5, 16),
        "rn_x": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
        "rn_y": rng.integers(0, 5, 8),
        "daso_x": rng.standard_normal((32, 4)).astype(np.float32),
        "daso_y": rng.integers(0, 2, 32),
        "km_x": rng.normal(size=(101, 4)).astype(np.float32),
        "tiny": rng.normal(size=(2, 3)).astype(np.float32),
    }
    inputs["km_init"] = inputs["km_x"][[0, 50, 100]]

    # heat_tpu's initial variables, which the processes load
    jc = ht.parallel.mesh.local_mesh(POSITIONS)
    jm = ht.nn.DataParallel(_JitInit(ht.models.MLP(features=(16, 5))), comm=jc,
                            optimizer=ht.optim.DataParallelOptimizer(optax.sgd(0.05, momentum=0.9)))
    jm.init(0, inputs["mlp_x"])
    inputs.update({f"mlp/{k}": v for k, v in _flat(_tree(jm.variables)).items()})
    net = jr.ResNet(stage_sizes=(1,), block_cls=jr.BasicBlock, num_filters=4, num_classes=5)
    rn_vars = _tree(jax.jit(net.init)(jax.random.PRNGKey(1), inputs["rn_x"]))
    inputs.update({f"resnet/{k}": v for k, v in _flat(rn_vars).items()})
    dmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    dc = ht.parallel.mesh.MeshComm(dmesh, split_axis="ici")
    jd = ht.optim.DASO(ht.optim.DataParallelOptimizer(optax.sgd(0.1, momentum=0.9)), mesh=dmesh, comm=dc,
                       total_epochs=10, warmup_epochs=0, cooldown_epochs=0)
    jdm = ht.nn.DataParallelMultiGPU(ht.models.MLP(features=(8, 2)), comm=dc, optimizer=jd)
    jdm.init(0, inputs["daso_x"][:4])
    first = jax.tree_util.tree_map(lambda v: np.asarray(v)[0], jdm.variables)
    inputs.update({f"daso/{k}": v for k, v in _flat(first).items()})
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    procs = _start(path, str(tmp))
    try:
        want = _reference(ht, inputs, jm, jc, net, rn_vars, jd, jdm)
        got, deadline = [], time.monotonic() + CHILD_LIMIT
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert p.returncode == 0, f"process {r} failed:\n{out[-4000:]}"
            got.append(dict(np.load(os.path.join(tmp, f"rank{r}.npz"))))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return inputs, want, got


def _reference(ht, inputs, jm, jc, net, rn_vars, jd, jdm) -> dict:
    """heat_tpu's results, computed while the processes run."""
    import jax

    red = inputs["red"]
    want = {}
    # heat_tpu's min/max over 4 CPU positions drop a NaN (XLA's cross-device
    # reduction), over one they propagate it, as numpy and the port do
    one = ht.array(red, split=0, comm=ht.parallel.mesh.local_mesh(1))
    want["min0"], want["max"] = np.asarray(ht.min(one, axis=0).numpy()), np.asarray(ht.max(one).numpy())
    x = ht.array(red, split=0, comm=jc)
    for key, fn in (("sum0", lambda: ht.sum(x, axis=0)), ("sum", lambda: ht.sum(x)), ("mean0", lambda: ht.mean(x, axis=0)),
                    ("var0", lambda: ht.var(x, axis=0)),
                    ("argmin0", lambda: ht.argmin(x, axis=0)), ("cumsum0", lambda: ht.cumsum(x, axis=0)),
                    ("rowsum", lambda: ht.sum(x * 2 + 1, axis=1)),
                    ("isum", lambda: ht.sum(ht.array(inputs["ints"], split=0, comm=jc)))):
        want[key] = np.asarray(fn().numpy())
    tiny = ht.array(inputs["tiny"], split=0, comm=jc)
    for name in TINY_OPS:
        want[f"tiny_{name}0"] = np.asarray(getattr(ht, name)(tiny, axis=0).numpy())
    one_row = ht.array(inputs["tiny"][:1], split=0, comm=ht.parallel.mesh.local_mesh(2))
    want["tiny_max_world"], want["tiny_sum_world"] = np.asarray(ht.max(one_row).numpy()), np.asarray(ht.sum(one_row).numpy())
    for _ in range(3):
        jm.train_step(ht.array(inputs["mlp_x"], split=0, comm=jc), ht.array(inputs["mlp_y"], split=0, comm=jc))
    want["mlp"] = _flat(_tree(jm.variables["params"]))
    # BatchNorm: the running statistics after one training forward on the global batch
    _, stats = jax.jit(lambda v, b: net.apply(v, b, train=True, mutable=["batch_stats"]))(rn_vars, inputs["rn_x"])
    want["rn_stats1"] = htt.models.resnet_from_flax({"params": rn_vars["params"], **_tree(stats)}, stage_sizes=(1,),
                                                    device="cpu").state_dict()
    jd.global_skip, jd.batches_seen = 3, 1
    dk, dl = [], []
    for _ in range(2, 9):
        dl.append(float(jdm.train_step(ht.array(inputs["daso_x"]), ht.array(inputs["daso_y"]))))
        dk.append(np.asarray(jdm.variables["params"]["Dense_0"]["kernel"]))
    want["daso_k"], want["daso_loss"] = np.stack(dk), np.array(dl)
    jk = ht.cluster.KMeans(n_clusters=3, init=ht.array(inputs["km_init"], comm=jc), max_iter=6, tol=-1).fit(
        ht.array(inputs["km_x"], split=0, comm=jc))
    want["km_centers"], want["km_labels"] = np.asarray(jk.cluster_centers_.numpy()), np.asarray(jk.labels_.numpy())
    want["km_inertia"] = float(jk.inertia_)
    from heat_tpu.core import wire as jwire

    prev = os.environ.get("HEAT_TPU_WIRE_MIN_BYTES")
    os.environ["HEAT_TPU_WIRE_MIN_BYTES"] = "1"
    try:
        for key, val in _moves(ht, jc, inputs, wire=jwire).items():
            want[f"mv/{key}"] = _host(val)
    finally:
        if prev is None:
            os.environ.pop("HEAT_TPU_WIRE_MIN_BYTES", None)
        else:
            os.environ["HEAT_TPU_WIRE_MIN_BYTES"] = prev
    for key, est in _kclusters(ht, jc, inputs).items():
        want[f"kc/{key}/centres"] = np.asarray(est.cluster_centers_.numpy())
        want[f"kc/{key}/labels"] = np.asarray(est.labels_.numpy())
    return want


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=ATOL, equal_nan=True, **kw)


# ----------------------------------------------------------------------- tests
@pytest.mark.parametrize("key", ["sum0", "sum", "mean0", "var0", "min0", "max", "argmin0", "cumsum0", "rowsum", "isum"]
                         + [f"tiny_{name}0" for name in TINY_OPS] + ["tiny_max_world", "tiny_sum_world"])
def test_reductions_across_processes(run, key):
    _, want, got = run
    for res in got:
        _close(res[key], want[key], err_msg=key)
        assert res[key].dtype == want[key].dtype, (key, res[key].dtype, want[key].dtype)


def test_complex_min_keeps_lexicographic_order(run):
    inputs, _, got = run
    for res in got:
        assert res["cmin"] == np.min(inputs["cplx"])


def test_is_split_assembles_process_chunks(run):
    inputs, _, got = run
    for res in got:
        np.testing.assert_array_equal(res["is_split"], inputs["red"])
        assert bool(res["is_split_raises"])


def test_shard_moves_across_processes_raise(run):
    """What still refuses a comm that spans processes: a direct read of
    another process's shard, by an operator or a torch function, names the
    exchange that moves it."""
    for res in run[2]:
        assert json.loads(str(res["refused"])) == ["remote shard", "remote shard read"]


@pytest.mark.parametrize("key", MOVES)
def test_moves_across_processes_match_heat_tpu(run, key):
    """Each move's global value and dtype against heat_tpu on its mesh of
    4, on both processes; the value's shards on this process's positions
    bit for bit the single controller's (``MeshComm(4)`` in the process)."""
    _, want, got = run
    for rank, res in enumerate(got):
        a, b = res[f"mv/{key}"], want[f"mv/{key}"]
        if key == "shuffle":  # the Feistel route: the port's own order, the same rows
            np.testing.assert_array_equal(np.sort(a, axis=0), np.sort(b, axis=0))
        elif key in ("int8", "cumprod"):  # the wire's quantization; XLA's order of the scan's products
            _close(a, b)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        for r in (2 * rank, 2 * rank + 1):
            if f"mvs/{key}/{r}" in res:
                np.testing.assert_array_equal(res[f"mvs/{key}/{r}"], res[f"ones/{key}/{r}"], err_msg=f"{key} {r}")
    np.testing.assert_array_equal(got[0][f"mv/{key}"], got[1][f"mv/{key}"])


def test_k7_calls_per_process_follow_the_plan(run):
    """The split-crossing reshape (13, 5) -> (5, 13) over 4 positions:
    destinations with rows 0, 1, 2; each process calls K7 once for each of
    its own, the single controller once for each."""
    got = run[2]
    assert [int(res["k7_calls"]) for res in got] == [2, 1]
    assert all(int(res["k7_calls_one"]) == 3 for res in got)


def test_lshards_are_this_process_s(run):
    inputs, _, got = run
    for rank, res in enumerate(got):
        assert res["lshards"].tolist() == ([4, 4] if rank == 0 else [4, 1])
        np.testing.assert_array_equal(res["lshard/0"], inputs["red"][8 * rank: 8 * rank + 4])


def test_one_exchange_carries_the_moves(run):
    """Bytes crossed through the exchange, none staged on the CPU, and the
    comm names its backend and the route of CUDA tensors."""
    for res in run[2]:
        exchanges, sent, staged = res["exchange"].tolist()
        assert exchanges > 0 and sent > 0 and staged == 0
        assert "backend='gloo'" in str(res["repr"]) and "cuda_exchange='staged'" in str(res["repr"])


@pytest.mark.parametrize("key", ["all_to_all", "ppermute", "ring_shift", "ring_shift3"])
def test_collectives_across_processes(run, key):
    for res in run[2]:
        np.testing.assert_array_equal(res[f"coll/{key}"], res[f"coll1/{key}"])


@pytest.mark.parametrize("key", KC_KEYS)
def test_kclusters_seeded_across_processes(run, key):
    """The fits against heat_tpu (centres within 1e-5, labels equal) and,
    bit for bit, the single controller's labels; KMedians' and KMedoids'
    centres bit for bit the single controller's too (exact selections)."""
    _, want, got = run
    for res in got:
        _close(res[f"kc/{key}/centres"], want[f"kc/{key}/centres"])
        np.testing.assert_array_equal(res[f"kc/{key}/labels"], want[f"kc/{key}/labels"])
        np.testing.assert_array_equal(res[f"kc/{key}/labels"], res[f"kc1/{key}/labels"])
        if key.startswith("kmed"):
            np.testing.assert_array_equal(res[f"kc/{key}/centres"], res[f"kc1/{key}/centres"])


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_seeding_bitwise_the_single_controller(run, init):
    for res in run[2]:
        np.testing.assert_array_equal(res[f"kc/seed_{init}"], res[f"kc1/seed_{init}"])


def test_wire_arm_agreed_across_processes(run):
    """Process 1's table is patched to pick int8 at once; both processes
    follow process 0's explores (exact values) in step."""
    inputs, _, got = run
    np.testing.assert_array_equal(got[0]["wire_agreed"], got[1]["wire_agreed"])
    for res in got:
        for i in range(3):
            np.testing.assert_array_equal(res["wire_agreed"][i], inputs["km_x"])


def test_oom_backoff_in_step_across_processes(run):
    """An OOM injected in process 0 alone: both processes retry once and
    agree on the values; at the floor both raise."""
    inputs, _, got = run
    for res in got:
        assert not bool(res["oom_once/raised"]) and res["oom_once/stats"].tolist() == [1, 0]
        np.testing.assert_array_equal(res["oom_once/value"], inputs["red"])
        assert bool(res["oom_exhausted/raised"]) and res["oom_exhausted/stats"][1] == 1


def test_data_parallel_mlp_matches_global_batch_step(run):
    _, want, got = run
    for res in got:
        for i in range(2):
            _close(res[f"mlp_k{i}"], want["mlp"][f"Dense_{i}/kernel"])
            _close(res[f"mlp_b{i}"], want["mlp"][f"Dense_{i}/bias"])
    np.testing.assert_array_equal(got[0]["mlp_loss"], got[1]["mlp_loss"])
    assert got[0]["mlp_loss"][-1] < got[0]["mlp_loss"][0]


def test_batchnorm_statistics_across_processes(run):
    _, want, got = run
    stats = {k: v for k, v in want["rn_stats1"].items() if k.endswith(".mean") or k.endswith(".var")}
    assert len(stats) == 6  # mean and var of the stem's and the block's two BatchNorms
    for res in got:
        for key, value in stats.items():
            _close(res[f"rn_stats1/{key}"], value.numpy(), err_msg=key)
        # two steps: the state of the one-process global-batch run
        keys = [k[len("rn1/"):] for k in res if k.startswith("rn1/")]
        for key in keys:
            _close(res[f"rn/{key}"], res[f"rn1/{key}"], err_msg=key)
        _close(res["rn_loss"], res["rn1_loss"])
    for key in keys:
        np.testing.assert_array_equal(got[0][f"rn/{key}"], got[1][f"rn/{key}"])


def test_daso_slices_across_processes(run):
    _, want, got = run
    for rank, res in enumerate(got):
        _close(res["daso_k"], want["daso_k"][:, rank])
        _close(res["daso_loss"], want["daso_loss"])


def test_kmeans_given_centres_across_processes(run):
    _, want, got = run
    for res in got:
        _close(res["km_centers"], want["km_centers"])
        np.testing.assert_array_equal(res["km_labels"], want["km_labels"])
        np.testing.assert_array_equal(res["km_predict"], want["km_labels"])
        assert abs(float(res["km_inertia"]) - want["km_inertia"]) <= 1e-5 * abs(want["km_inertia"])


# ------------------------------------------------------------------- bootstrap
def test_single_process_start_is_a_noop():
    assert htt.parallel.init_distributed() == (0, 1) == htt.parallel.init_distributed()
    assert not torch.distributed.is_initialized()


def test_malformed_launcher_size_refuses(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "two")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        htt.parallel.init_distributed()
    assert not torch.distributed.is_initialized()


def test_launcher_that_cannot_come_up_raises():
    """A torchrun environment of two processes with only one started: the
    store's short timeout passes and the start raises RuntimeError, in its
    own process under its own time limit."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    code = ("import heat_tpu_torch as ht; ht.use_device('cpu'); "
            "ht.parallel.init_distributed(timeout=2)")
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "RuntimeError" in p.stderr and "torchrun launcher environment (rank 0 of 2)" in p.stderr, p.stderr[-2000:]
