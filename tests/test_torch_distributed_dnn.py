"""The port's rings, sequence, expert and pipeline parallelism, checkpoints
and elastic restarts across processes: 2 gloo processes × 2 positions
against heat_tpu on its CPU mesh of 4 and against the port's own
``MeshComm(4)`` in one process.

One module fixture writes the inputs (and heat_tpu's initial TransformerLM
variables) to ``tmp_path``, starts the two processes once (``_child``
below, run as ``python -c``, which imports no JAX), computes heat_tpu's
results with ``jax.jit``-compiled functions while they run, and reads
theirs back.  Each child runs every scenario on ``local_mesh(4)`` (its two
positions of four) and on ``MeshComm(4)`` in its own process.

Tolerances.  Across processes against one process: bitwise where each
position computes the same blocks in the same order and the folds run in
position order (the rings, the ring ``cdist``, KMeans' update, the
orthogonality defect, every forward and the MoE aux values); gradients,
whose per-position contributions autograd accumulates in another order,
to ``GRAD_TOL`` (1e-6 absolute and relative).  Against heat_tpu:
``ATOL`` (1e-5) for products and distances, ``ATTN_TOL`` (2e-5) for
attention and its gradients, ``JAX_GRAD_TOL`` (1e-4 relative, 1e-5
absolute) for the MoE and pipeline gradients (XLA's fused reductions
round differently), ``LM_TOL`` (1e-6 absolute, 1e-5 relative) for the
losses and trained parameters of the TransformerLMs' SGD steps (they
differ by ~6e-8; leaving out the MoE loss's aux term moves them ~8e-4)."""

import importlib
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
ATTN_TOL = 2e-5
GRAD_TOL = 1e-6
JAX_GRAD_TOL = 1e-4
LM_TOL = 1e-6
HERE = os.path.dirname(os.path.abspath(__file__))
PROCS, POSITIONS = 2, 4
CHILD_LIMIT = 180  # seconds: a child that hangs fails the fixture
LM = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=4, mlp_ratio=2, max_seq_len=16)
MOE_LM = dict(LM, moe_experts=4)
LM_BATCH, LM_STEPS, LM_LR = 2, 2, 0.1
MOE = dict(k=2, capacity_factor=2.0)
N_MICRO = 4
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_FAULT = 6, 2, 3
RINGS = ("ag", "rs", "col", "fused", "int8", "cdist", "knn", "knn_int8", "km_update", "qr_defect")
ATTN = ("ring", "ulysses", "ring_dp", "ulysses_dp")


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


# --------------------------------------------------------------- the port
def _rings(ht, comm, data, quantize, qr) -> dict:
    """The overlap rings and their callers on ``comm`` (DNDarrays of either
    package; ``quantize`` and ``qr`` are its modules)."""
    a, b, c = data["mm_a"], data["mm_b"], data["mm_c"]
    out = {"ag": ht.matmul(ht.array(a, split=0, comm=comm), ht.array(b, split=0, comm=comm)),
           "rs": ht.matmul(ht.array(a, split=1, comm=comm), ht.array(b, split=0, comm=comm)),
           "col": ht.matmul(ht.array(a, split=1, comm=comm), ht.array(b, split=1, comm=comm))}
    out["fused"] = ht.abs(ht.matmul(ht.array(a, split=0, comm=comm), ht.array(b, split=0, comm=comm))
                          + ht.array(c, comm=comm))
    qw = quantize.quantize_weights(ht.array(b, split=0, comm=comm), "int8", axis=1)
    out["int8"] = quantize.matmul_quantized(ht.array(a, split=0, comm=comm), qw, arm="int8")
    x, y = ht.array(data["cd_x"], split=0, comm=comm), ht.array(data["cd_y"], split=0, comm=comm)
    out["cdist"] = ht.spatial.cdist(x, y)
    out["knn"] = ht.classification.KNeighborsClassifier(n_neighbors=3).fit(
        y, ht.array(data["cd_lab"], split=0, comm=comm)).predict(x)
    out["knn_int8"] = ht.classification.KNeighborsClassifier(n_neighbors=3).fit(
        y, ht.array(data["cd_lab"], split=0, comm=comm)).quantize_("int8").predict(x)
    km = ht.cluster.KMeans(n_clusters=3)
    km._cluster_centers = ht.array(data["km_c"], comm=comm)
    out["km_update"] = km._update_centroids(ht.array(data["km_x"], split=0, comm=comm),
                                            ht.array(data["km_lab"], split=0, comm=comm))
    out["qr_defect"] = qr.orthogonality_defect(ht.array(data["qr_q"], split=0, comm=comm))
    return out


def _attention(comm, mesh2, data) -> dict:
    """Ring and Ulysses attention, forward and the gradients of
    ``sum(out * g)``, over ``comm`` and with the dp axis over ``mesh2``."""
    from heat_tpu_torch.parallel.sequence import sequence_parallel_attention

    out = {}
    for key in ATTN:
        strategy = key.split("_")[0]
        q, k, v = (torch.tensor(data[f"att_{n}"], requires_grad=True) for n in "qkv")
        where, axis = (mesh2, "sp") if key.endswith("_dp") else (comm, None)
        o = sequence_parallel_attention(q, k, v, where, axis, causal=True, strategy=strategy)
        (o * torch.from_numpy(data["att_g"])).sum().backward()
        out[key] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    return out


def _moe(mesh, data) -> list:
    """The MoE layer: y, the two aux values, the gradients of ``sum(y * g)
    + load_balance_loss`` for x, the router and both expert weights."""
    from heat_tpu_torch.parallel import expert

    ts = [torch.tensor(data[f"moe_{n}"], requires_grad=True) for n in ("x", "gate", "w_in", "w_out")]
    y, aux = expert.moe_ffn(*ts, mesh=mesh, axis="ep", **MOE)
    ((y * torch.from_numpy(data["moe_g"])).sum() + aux["load_balance_loss"]).backward()
    return ([y.detach().numpy(), aux["load_balance_loss"].detach().numpy(), aux["fraction_dropped"].detach().numpy()]
            + [t.grad.numpy() for t in ts])


def _pipeline(mesh, data) -> list:
    """The pipeline's output and the gradients of ``sum(out * g)`` for the
    stacked stage weights and the input."""
    from heat_tpu_torch.parallel import pipeline

    params = pipeline.stack_stage_params(
        [{"w": torch.from_numpy(data["pp_w"][i]), "b": torch.from_numpy(data["pp_b"][i])} for i in range(POSITIONS)],
        mesh)
    params = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    x = torch.tensor(data["pp_x"], requires_grad=True)
    out = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params, x, mesh=mesh,
                                  n_micro=N_MICRO)
    (out * torch.from_numpy(data["pp_g"])).sum().backward()
    return [out.detach().numpy(), params["w"].grad.numpy(), params["b"].grad.numpy(), x.grad.numpy()]


def _lm_steps(data, **config) -> dict:
    """``LM_STEPS`` SGD steps of a TransformerLM from heat_tpu's initial
    variables: the losses and the parameters after them."""
    prefix = "moe_lm/" if "ep_mesh" in config else "lm/"
    model = htt.models.transformer_from_flax(_nest(data, prefix), device="cpu", **config)
    tokens = torch.from_numpy(data["lm_tokens"])
    targets = torch.roll(tokens, -1, dims=1)
    losses = []
    for _ in range(LM_STEPS):
        model.zero_grad()
        logits = model(tokens)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        if "ep_mesh" in config:
            loss = loss + 0.01 * sum(model.moe_aux_losses())
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= LM_LR * p.grad
        losses.append(float(loss))
    return {"losses": np.array(losses), **{n: p.detach().numpy().copy() for n, p in model.named_parameters()}}


def _elastic(comm, data, directory, fault_rank=None):
    """``run_elastic`` over a state of a replicated tensor and a split
    DNDarray, checkpointing every ``ELASTIC_EVERY`` steps into
    ``directory``; process ``fault_rank`` raises once at step
    ``ELASTIC_FAULT``."""
    from heat_tpu_torch.utils import checkpointing, fault

    rank = torch.distributed.get_rank()
    inj = fault.FaultInjector().raise_at(ELASTIC_FAULT) if rank == fault_rank else None

    def step_fn(state, batch):
        w = state["w"] - 0.1 * (state["w"] - batch)
        d = state["d"] * 0.5 + ht_sum(state["d"])
        if inj is not None:
            inj.fire(state["step"], w.sum())
        return {"w": w, "d": d, "step": state["step"] + 1}, {"loss": (w - batch).pow(2).sum()}

    def ht_sum(d):
        return htt.sum(d)

    init = {"w": torch.from_numpy(data["el_w"]), "d": htt.array(data["el_d"], split=0, comm=comm), "step": 0}
    state, report = fault.run_elastic(step_fn, init, lambda s: torch.full((4,), float(s)), ELASTIC_STEPS,
                                      checkpointer=checkpointing.Checkpointer(directory, max_to_keep=2),
                                      checkpoint_every=ELASTIC_EVERY)
    kinds = [e["kind"] for e in report.events]
    return state, kinds, report.restarts


def _child(rank: int, port: int, inputs: str, out: str, tmp: str) -> None:
    """One process of the two: every scenario on the process comm and on
    ``MeshComm(4)``, results to ``out``."""
    from heat_tpu_torch.parallel import collectives, overlap, transport
    from heat_tpu_torch.utils import checkpointing

    htt.use_device("cpu")
    htt.wire.set_mode("off")
    assert htt.parallel.init_distributed(f"127.0.0.1:{port}", PROCS, rank) == (rank, PROCS)
    comm = htt.parallel.local_mesh(POSITIONS)
    one = htt.MeshComm(POSITIONS)
    mesh2 = htt.parallel.hybrid_mesh({"sp": 2}, {"dp": 2})
    one2 = htt.parallel.Mesh(np.arange(POSITIONS).reshape(2, 2), ("dp", "sp"))
    data = dict(np.load(inputs))
    res = {}

    # §1: two processes save into one directory through the Checkpointer,
    # with retention, and restore alike, also onto a comm of another size
    ck = checkpointing.Checkpointer(os.path.join(tmp, "ckpt"), max_to_keep=2)
    for step in range(3):
        tree = {"d": htt.array(data["km_x"] + step, split=0, comm=comm), "t": torch.from_numpy(data["el_w"]) * step,
                "s": step, "nested": [1.5, {"n": np.arange(3) + step}]}
        ck.save(step, tree)
    res["ck_steps"] = np.array(ck.all_steps())
    for tag, c in (("same", comm), ("other", htt.parallel.local_mesh(2))):
        got = ck.restore_latest(comm=c, device="cpu")
        res[f"ck_{tag}/d"] = got["d"].numpy()
        res[f"ck_{tag}/shards"] = np.array([s.shape[0] for s in c.local_shards(got["d"].shards)])
        res[f"ck_{tag}/t"], res[f"ck_{tag}/s"] = got["t"].numpy(), np.array(got["s"])
        res[f"ck_{tag}/n"] = np.asarray(got["nested"][1]["n"])
    # a tree over one process's MeshComm(4) is this process's own: process 0
    # saves it alone, and each process keeps its own Checkpointer
    if rank == 0:
        checkpointing.save_checkpoint(os.path.join(tmp, "alone"), {
            "d": htt.array(data["km_x"], split=0, comm=one), "t": torch.from_numpy(data["el_w"])})
    own = checkpointing.Checkpointer(os.path.join(tmp, f"own{rank}"), max_to_keep=1)
    for step in range(2):
        own.save(step, {"d": htt.array(data["km_x"] + step, split=0, comm=one), "r": rank})
    res["own/steps"] = np.array(own.all_steps())
    got = own.restore_latest(comm=one, device="cpu")
    res["own/r"], res["own/d"] = np.array(got["r"]), got["d"].numpy()
    torch.distributed.barrier()
    if rank == 1:
        got = checkpointing.load_checkpoint(os.path.join(tmp, "alone"), comm=one, device="cpu")
        res["alone/d"], res["alone/t"] = got["d"].numpy(), got["t"].numpy()

    overlap.set_mode("ring")
    transport.reset_stats()
    overlap.reset_stats()
    from heat_tpu_torch.core import quantize

    qr = importlib.import_module("heat_tpu_torch.core.linalg.qr")
    for tag, c in (("p", comm), ("o", one)):
        for key, val in _rings(htt, c, data, quantize, qr).items():
            res[f"{tag}/{key}"] = val.numpy()
            if val.split is not None:
                for r in comm.local_positions:
                    res[f"{tag}s/{key}/{r}"] = val.shards[r].numpy()
    st, hops = overlap.stats(), overlap.hop_stats()
    res["ring_calls"] = np.array([st["by_schedule"]["ring_ag"], st["by_schedule"]["ring_rs"],
                                  st["by_schedule"]["ring_col"]])
    res["hops"] = np.array([hops["hops"], hops["async_hops"]])
    res["exchanges"] = np.array(transport.stats()["exchanges"])
    overlap.set_mode(None)

    for tag, c, c2 in (("p", comm, mesh2), ("o", one, one2)):
        for key, vals in _attention(c, c2, data).items():
            for i, v in enumerate(vals):
                res[f"{tag}/att_{key}/{i}"] = v
        for i, v in enumerate(_moe(c, data)):
            res[f"{tag}/moe/{i}"] = v
        for i, v in enumerate(_pipeline(c, data)):
            res[f"{tag}/pp/{i}"] = v
        for name, config in (("sp_ring", dict(attention="ring", sp_mesh=c)),
                             ("sp_ulysses_dp", dict(attention="ulysses", sp_mesh=c2, sp_axis="sp")),
                             ("moe_lm", dict(ep_mesh=c))):
            for key, v in _lm_steps(data, **config).items():
                res[f"{tag}/{name}/{key}"] = v

    # the agreed decisions: process 1's own table would take the eager arm
    # (and int8 for the quantized arm) at once; both follow process 0's
    from heat_tpu_torch.core import autotune

    prev = htt.core.autotune.set_enabled(True)
    real = autotune.decide
    if rank == 1:
        autotune.decide = lambda key, prior, desc="", arms=autotune.ARMS: autotune.Decision(arms[-1], "cached", False,
                                                                                            key)
    try:
        overlap.reset_stats()
        a = htt.array(data["mm_a"], split=0, comm=comm)
        b = htt.array(data["mm_b"], split=0, comm=comm)
        os.environ["HEAT_TPU_MATMUL_RING_MIN_BYTES"] = "1"
        res["agreed_mm"] = np.stack([htt.matmul(a, b).numpy() for _ in range(4)])
        st = overlap.stats()
        res["agreed_calls"] = np.array([st["ring_calls"], st["gspmd_calls"]])
        qw = quantize.quantize_weights(b, "int8", axis=1)
        res["agreed_q"] = np.stack([quantize.matmul_quantized(a, qw).numpy() for _ in range(4)])
    finally:
        os.environ.pop("HEAT_TPU_MATMUL_RING_MIN_BYTES", None)
        autotune.decide = real
        htt.core.autotune.set_enabled(prev)
        autotune.reset()

    # run_elastic: a fault on process 1 at one step against a fault-free run
    for tag, fr in (("clean", None), ("fault", 1)):
        state, kinds, restarts = _elastic(comm, data, os.path.join(tmp, f"elastic_{tag}"), fr)
        res[f"el_{tag}/w"], res[f"el_{tag}/d"] = state["w"].numpy(), state["d"].numpy()
        res[f"el_{tag}/step"], res[f"el_{tag}/restarts"] = np.array(state["step"]), np.array(restarts)
        res[f"el_{tag}/kinds"] = np.array(json.dumps(kinds))

    # what still refuses: a direct read of another process's shard
    x = htt.array(data["km_x"], split=0, comm=comm)
    try:
        x.shards[2 - 2 * rank] + 1
        res["refused"] = np.array("")
    except NotImplementedError as err:
        res["refused"] = np.array(str(err))
    np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    del collectives


def _start(inputs: str, outdir: str):
    port = _free_port()
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {HERE!r})
        import test_torch_distributed_dnn as t
        t._child(int(sys.argv[1]), {port}, {inputs!r}, sys.argv[2], {outdir!r})
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return [subprocess.Popen([sys.executable, "-c", code, str(r), os.path.join(outdir, f"rank{r}.npz")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(PROCS)]


# ----------------------------------------------------------------- heat_tpu
def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "mm_a": f32(24, 22), "mm_b": f32(22, 12), "mm_c": f32(12),
        "cd_x": f32(16, 5), "cd_y": f32(24, 5), "cd_lab": rng.integers(0, 3, 24),
        "km_x": f32(40, 3), "km_lab": rng.integers(0, 3, 40).astype(np.int64), "km_c": f32(3, 3),
        "qr_q": f32(32, 4),
        "att_q": f32(4, 4, 16, 8), "att_k": f32(4, 4, 16, 8), "att_v": f32(4, 4, 16, 8), "att_g": f32(4, 4, 16, 8),
        "moe_x": f32(16, 8), "moe_gate": f32(8, 4, scale=0.5), "moe_w_in": f32(4, 8, 16, scale=0.3),
        "moe_w_out": f32(4, 16, 8, scale=0.3), "moe_g": f32(16, 8),
        "pp_w": f32(POSITIONS, 8, 8, scale=8 ** -0.5), "pp_b": f32(POSITIONS, 8, scale=0.01), "pp_x": f32(8, 8),
        "pp_g": f32(8, 8),
        "lm_tokens": rng.integers(0, LM["vocab_size"], (LM_BATCH, LM["max_seq_len"])),
        "el_w": f32(4), "el_d": f32(8, 2),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory, worker_id):
    """The scenarios' (inputs, heat_tpu's results, the two processes'
    results, the shared directory).  Under xdist the first worker to get
    here computes them and the others read its pickle (one run a
    session)."""
    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    if worker_id == "master":
        return _run(tmp_path_factory)
    from filelock import FileLock

    cache = tmp_path_factory.getbasetemp().parent / "torch_distributed_dnn_run.pkl"
    with FileLock(str(cache) + ".lock"):
        if cache.exists():
            return pickle.loads(cache.read_bytes())
        result = _run(tmp_path_factory)
        cache.write_bytes(pickle.dumps(result))
        return result


def _run(tmp_path_factory):
    import heat_tpu as ht
    import jax

    tmp = tmp_path_factory.mktemp("distributed_dnn")
    inputs = _inputs()
    for prefix, config in (("lm/", LM), ("moe_lm/", MOE_LM)):
        model = ht.models.TransformerLM(**config)
        variables = jax.jit(model.init)(jax.random.PRNGKey(3), inputs["lm_tokens"])
        inputs.update({f"{prefix}{k}": v for k, v in _flat(jax.tree_util.tree_map(np.asarray, variables)).items()})
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    procs = _start(path, str(tmp))
    try:
        want = _reference(ht, inputs)
        deadline = time.monotonic() + CHILD_LIMIT
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"process {r} failed:\n{outs[r][-4000:]}\nprocess {1 - r}:\n{outs[1 - r][-2000:]}"
        got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(PROCS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return inputs, want, got, str(tmp)


def _reference(ht, inputs) -> dict:
    """heat_tpu's results on its CPU mesh of 4, computed while the
    processes run."""
    import functools

    import jax
    import jax.numpy as jnp
    from heat_tpu.core import quantize as JQ
    from heat_tpu.parallel import expert as jex
    from heat_tpu.parallel import overlap as JO
    from heat_tpu.parallel import pipeline as jpp
    from heat_tpu.parallel.sequence import sequence_parallel_attention as jspa
    from jax.sharding import Mesh

    jqr = importlib.import_module("heat_tpu.core.linalg.qr")
    jc = ht.parallel.mesh.local_mesh(POSITIONS)
    want = {}
    prev = JO.set_mode("ring")
    try:
        for key, val in _rings(ht, jc, inputs, JQ, jqr).items():
            want[key] = np.asarray(val.numpy())
    finally:
        JO.set_mode(prev)

    devs = np.array(jax.devices()[:POSITIONS])
    mesh1, mesh2 = Mesh(devs, ("sp",)), Mesh(devs.reshape(2, 2), ("dp", "sp"))
    g = jnp.asarray(inputs["att_g"])
    for key in ATTN:
        mesh = mesh2 if key.endswith("_dp") else mesh1
        fn = functools.partial(jspa, mesh=mesh, axis_name="sp", causal=True, strategy=key.split("_")[0])
        out, vjp = jax.jit(lambda q, k, v, fn=fn: jax.vjp(fn, q, k, v))(
            *(jnp.asarray(inputs[f"att_{n}"]) for n in "qkv"))
        want[f"att_{key}"] = [np.asarray(out)] + [np.asarray(t) for t in jax.jit(vjp)(g)]

    emesh = Mesh(devs, ("ep",))

    def moe_loss(x, gate, w_in, w_out):
        y, aux = jex.moe_ffn(x, gate, w_in, w_out, mesh=emesh, axis="ep", **MOE)
        return jnp.sum(y * jnp.asarray(inputs["moe_g"])) + aux["load_balance_loss"], (y, aux)

    args = [jnp.asarray(inputs[f"moe_{n}"]) for n in ("x", "gate", "w_in", "w_out")]
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(moe_loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    want["moe"] = ([np.asarray(y), np.asarray(aux["load_balance_loss"]), np.asarray(aux["fraction_dropped"])]
                   + [np.asarray(t) for t in grads])

    pmesh = Mesh(devs, ("pp",))

    def pp_loss(params, x):
        out = jpp.pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params, x, mesh=pmesh, axis="pp",
                                 n_micro=N_MICRO)
        return jnp.sum(out * jnp.asarray(inputs["pp_g"])), out

    params = {"w": jnp.asarray(inputs["pp_w"]), "b": jnp.asarray(inputs["pp_b"])}
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(pp_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(inputs["pp_x"]))
    want["pp"] = [np.asarray(out), np.asarray(gp["w"]), np.asarray(gp["b"]), np.asarray(gx)]

    # LM_STEPS SGD steps of heat_tpu's sequence-parallel and expert-parallel
    # models (the MoE loss with its 0.01 aux term), as _lm_steps takes them
    tokens = jnp.asarray(inputs["lm_tokens"])
    for name, prefix, model in (
            ("sp_ring", "lm/", ht.models.TransformerLM(**LM, attention="ring", sp_mesh=mesh1)),
            ("sp_ulysses_dp", "lm/", ht.models.TransformerLM(**LM, attention="ulysses", sp_mesh=mesh2)),
            ("moe_lm", "moe_lm/", ht.models.TransformerLM(**MOE_LM, ep_mesh=emesh))):

        def loss(v, model=model, moe=name == "moe_lm"):
            logits, state = model.apply(v, tokens, mutable=["intermediates"])
            logp = jax.nn.log_softmax(logits, axis=-1)
            ce = -jnp.mean(jnp.take_along_axis(logp, jnp.roll(tokens, -1, axis=1)[..., None], axis=-1))
            return ce + 0.01 * sum(jnp.sum(a) for a in jax.tree.leaves(state)) if moe else ce

        @jax.jit
        def step(v, loss=loss):
            val, grads = jax.value_and_grad(loss)(v)
            return val, jax.tree.map(lambda p, g: p - LM_LR * g, v, grads)

        variables, losses = _nest(inputs, prefix), []
        for _ in range(LM_STEPS):
            val, variables = step(variables)
            losses.append(float(val))
        want[f"{name}/losses"] = np.array(losses)
        want[f"{name}/params"] = _flat(jax.tree_util.tree_map(np.asarray, variables))
    return want


# ----------------------------------------------------------------------- tests
def _close(a, b, atol=ATOL, rtol=ATOL, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol, equal_nan=True, **kw)


def test_checkpoint_of_one_process_stays_its_own(run):
    """With the group up, a tree that spans no processes is saved by the
    process that asks: process 0 alone (no barrier its peer never
    enters), and each process into its own directory with retention."""
    inputs, _, got, _ = run
    np.testing.assert_array_equal(got[1]["alone/d"], inputs["km_x"])
    np.testing.assert_array_equal(got[1]["alone/t"], inputs["el_w"])
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["own/steps"], [1])
        assert int(res["own/r"]) == r
        np.testing.assert_array_equal(res["own/d"], inputs["km_x"] + 1)


def test_checkpoint_saved_by_two_processes_is_whole(run):
    """§1: both processes save into one directory through the Checkpointer
    with retention; both restore the last step whole, on the comm it was
    saved from and on one of another size (one position a process)."""
    inputs, _, got, _ = run
    for res in got:
        np.testing.assert_array_equal(res["ck_steps"], [1, 2])
        for tag in ("same", "other"):
            np.testing.assert_array_equal(res[f"ck_{tag}/d"], inputs["km_x"] + 2)
            np.testing.assert_array_equal(res[f"ck_{tag}/t"], inputs["el_w"] * 2)
            assert int(res[f"ck_{tag}/s"]) == 2
            np.testing.assert_array_equal(res[f"ck_{tag}/n"], np.arange(3) + 2)
    assert list(got[0]["ck_same/shards"]) == [10, 10] and list(got[0]["ck_other/shards"]) == [20]
    assert list(got[1]["ck_same/shards"]) == [10, 10] and list(got[1]["ck_other/shards"]) == [20]


@pytest.mark.parametrize("key", RINGS)
def test_rings_across_processes(run, key):
    """The ``ag``/``rs``/``col`` rings (k = 22 over 4 positions: uneven
    k-blocks), a chain over one, the int8 ring, the ring cdist, the KNN
    batch predict (also over the int8 corpus's quantized ring), KMeans'
    update ring and the orthogonality defect: the
    global value against heat_tpu, and bit for bit against ``MeshComm(4)``,
    shard by shard."""
    _, want, got, _ = run
    for res in got:
        if key.startswith("knn"):
            np.testing.assert_array_equal(res[f"p/{key}"], want[key])
        else:
            _close(res[f"p/{key}"], want[key], err_msg=key)
        np.testing.assert_array_equal(res[f"p/{key}"], res[f"o/{key}"])
        shards = [k for k in res if k.startswith(f"ps/{key}/")]
        for name in shards:
            np.testing.assert_array_equal(res[name], res["o" + name[1:]])


def test_rings_took_the_ring_and_crossed(run):
    """Both processes ran each schedule twice (process comm, one process)
    and their hops crossed processes, issued before the step's GEMM."""
    _, _, got, _ = run
    for res in got:
        # a comm: ag plain, fused and int8; rs plain, KMeans and the defect; col
        assert list(res["ring_calls"]) == [6, 6, 2], res["ring_calls"]
        hops, async_hops = res["hops"]
        assert hops > 0 and async_hops == hops
        assert int(res["exchanges"]) > 0


@pytest.mark.parametrize("key", ATTN)
def test_sequence_parallel_across_processes(run, key):
    """Ring and Ulysses over 4 positions across the processes, and over the
    (dp=2 across the processes) × (sp=2 inside) mesh: the output and the
    gradients for q, k and v against heat_tpu and ``MeshComm(4)``."""
    _, want, got, _ = run
    for res in got:
        for i in range(4):
            _close(res[f"p/att_{key}/{i}"], want[f"att_{key}"][i], atol=ATTN_TOL, rtol=ATTN_TOL, err_msg=f"{key} {i}")
        np.testing.assert_array_equal(res[f"p/att_{key}/0"], res[f"o/att_{key}/0"])
        for i in range(1, 4):
            _close(res[f"p/att_{key}/{i}"], res[f"o/att_{key}/{i}"], atol=GRAD_TOL, rtol=GRAD_TOL)
    for i in range(4):
        np.testing.assert_array_equal(got[0][f"p/att_{key}/{i}"], got[1][f"p/att_{key}/{i}"])


def test_moe_layer_across_processes(run):
    """The expert-parallel MoE layer: y and the aux values bitwise as one
    process computes them, the gradients whole and equal on both
    processes, all against heat_tpu's ``jax.grad``."""
    _, want, got, _ = run
    for res in got:
        for i in range(7):
            _close(res[f"p/moe/{i}"], want["moe"][i], atol=ATOL, rtol=JAX_GRAD_TOL, err_msg=f"moe {i}")
        for i in range(3):
            np.testing.assert_array_equal(res[f"p/moe/{i}"], res[f"o/moe/{i}"])
        for i in range(3, 7):
            _close(res[f"p/moe/{i}"], res[f"o/moe/{i}"], atol=GRAD_TOL, rtol=GRAD_TOL)
    for i in range(7):
        np.testing.assert_array_equal(got[0][f"p/moe/{i}"], got[1][f"p/moe/{i}"])


def test_pipeline_across_processes(run):
    """Four stages, two a process, four microbatches: the output and the
    stage weights' and input's gradients, whole on both processes."""
    _, want, got, _ = run
    for res in got:
        for i in range(4):
            _close(res[f"p/pp/{i}"], want["pp"][i], atol=ATOL, rtol=JAX_GRAD_TOL, err_msg=f"pp {i}")
            _close(res[f"p/pp/{i}"], res[f"o/pp/{i}"], atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_array_equal(res["p/pp/0"], res["o/pp/0"])
    for i in range(4):
        np.testing.assert_array_equal(got[0][f"p/pp/{i}"], got[1][f"p/pp/{i}"])


@pytest.mark.parametrize("name", ["sp_ring", "sp_ulysses_dp", "moe_lm"])
def test_training_steps_across_processes(run, name):
    """SGD steps of the sequence-parallel (ring; Ulysses over the dp × sp
    mesh) and the expert-parallel TransformerLM (its loss with the 0.01
    aux term): the same parameters on both processes, as one process's,
    and the losses and trained parameters as heat_tpu's on its mesh of 4
    (``LM_TOL``)."""
    _, want, got, _ = run
    keys = [k for k in got[0] if k.startswith(f"p/{name}/")]
    assert len(keys) > 10
    for key in keys:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
        _close(got[0][key], got[0]["o" + key[1:]], atol=GRAD_TOL, rtol=1e-5, err_msg=key)
    _close(got[0][f"p/{name}/losses"], want[f"{name}/losses"], atol=LM_TOL, rtol=10 * LM_TOL)
    ref = htt.models.transformer_from_flax(_nest(want[f"{name}/params"], ""), device="cpu")
    names = [n for n, _ in ref.named_parameters()]
    assert sorted(f"p/{name}/{n}" for n in names) == sorted(k for k in keys if not k.endswith("/losses"))
    for n, p in ref.named_parameters():
        _close(got[0][f"p/{name}/{n}"], p.detach().numpy(), atol=LM_TOL, rtol=10 * LM_TOL, err_msg=n)


def test_decisions_agreed_across_processes(run):
    """Process 1's own tables would take the eager arm and the int8 arm at
    once; both processes follow process 0's explore (ring result, bf16
    result), so they run the same collectives and return the same values."""
    _, _, got, _ = run
    for key in ("agreed_mm", "agreed_q", "agreed_calls"):
        np.testing.assert_array_equal(got[0][key], got[1][key])


def test_elastic_across_processes(run):
    """A fault on process 1 at one step: both processes restore from the
    checkpoint in step, and the run ends bitwise as a fault-free run."""
    _, _, got, _ = run
    for res in got:
        assert int(res["el_clean/restarts"]) == 0 and int(res["el_fault/restarts"]) == 1
        assert "restore" in json.loads(str(res["el_fault/kinds"]))
        for key in ("w", "d", "step"):
            np.testing.assert_array_equal(res[f"el_fault/{key}"], res[f"el_clean/{key}"])
    assert str(got[0]["el_fault/kinds"]) == str(got[1]["el_fault/kinds"])


def test_elastic_restart_onto_one_process(run):
    """A restart from the two processes' checkpoint onto one process's
    ``MeshComm(4)``: the restored state is the run's final state."""
    from heat_tpu_torch.utils import checkpointing

    _, _, got, tmp = run
    ck = checkpointing.Checkpointer(os.path.join(tmp, "elastic_fault"), max_to_keep=2)
    assert ck.latest_step() == ELASTIC_STEPS
    state = ck.restore_latest(comm=htt.MeshComm(POSITIONS), device="cpu")["state"]
    assert state["d"].comm.size == POSITIONS and len(state["d"].shards) == POSITIONS
    np.testing.assert_array_equal(state["d"].numpy(), got[0]["el_fault/d"])
    np.testing.assert_array_equal(state["w"].numpy(), got[0]["el_fault/w"])
