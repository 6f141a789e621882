"""heat_tpu_torch and chip_smoke.py stand alone: they import neither jax nor
anything of heat_tpu.  A fresh interpreter imports the port and runs a tiny
KMeans fit, QR, Lasso fit, sparse product, sparse Spectral fit, the
TransformerLM forward (dense and sequence-parallel), ``pallas_matmul`` and
the transport engine (a split-crossing reshape, resplit, a mask getitem and
an int-array take), one split assignment and one ``shuffle_rows``, an HDF5
round trip and a CSV load through the native parser (built by g++ from
``native/src/``), one ``random.randn`` on the Threefry streams, one MLP ``train_step``, one
expert-parallel MoE TransformerLM step with ``lamb``, a pipeline of two
stages, a vision-transform chain, the telemetry, memtrack, roofline
and guard planes, and a quantized product and KNN corpus through the
autotune, wire and quantize planes; a scan of every import statement in the port (no jax,
flax, optax or heat_tpu) backs it up, and the new modules export
heat_tpu's names."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "heat_tpu"}
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "heat_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]

FIT = """
import sys
import numpy as np
import heat_tpu_torch as ht
ht.use_device("cpu")
x = ht.array(np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32), split=0, comm=ht.MeshComm(4))
km = ht.cluster.KMeans(n_clusters=2, init="kmeans++", max_iter=5, random_state=0).fit(x)
assert km.predict(x).shape == (40, 1)
q, r = ht.linalg.qr(x)
assert q.shape == (40, 3) and r.shape == (3, 3)
y = ht.matmul(x, ht.array(np.ones((3, 1), np.float32), comm=x.comm))
assert ht.regression.Lasso(lam=0.01, max_iter=3).fit(x, y).predict(x).shape == (40, 1)
a = ht.sparse.sparse_csr_matrix(np.eye(40, dtype=np.float32), split=0, comm=x.comm)
assert ht.sparse.matmul(a, x).shape == (40, 3)
s = ht.cluster.Spectral(n_clusters=2, affinity="knn", n_neighbors=4, n_lanczos=8).fit(x)
assert s.labels_.shape == (40, 1)
import torch
lm = ht.models.TransformerLM(vocab_size=20, num_layers=1, num_heads=2, head_dim=4, max_seq_len=8, device="cpu")
tok = torch.randint(0, 20, (2, 8))
assert lm(tok).shape == (2, 8, 20)
sp = ht.models.TransformerLM(vocab_size=20, num_layers=1, num_heads=2, head_dim=4, max_seq_len=8,
                             attention="ulysses", sp_mesh=ht.MeshComm(2), device="cpu")
sp.load_state_dict(lm.state_dict())
assert torch.allclose(sp(tok), lm(tok), atol=1e-5)
assert ht.ops.pallas_matmul(torch.ones(3, 4), torch.ones(4, 2)).shape == (3, 2)
z = ht.reshape(x, (20, 6), new_split=1)
assert z.split == 1 and np.array_equal(z.numpy(), x.numpy().reshape(20, 6))
assert ht.resplit(x, 1).split == 1 and x.split == 0
assert np.array_equal(x[x.larray[:, 0] > 0].numpy(), x.numpy()[x.numpy()[:, 0] > 0])
assert np.array_equal(x[np.array([39, 0, 7])].numpy(), x.numpy()[[39, 0, 7]])
assert ht.ops.repack.calls > 0
w = ht.zeros((40, 3), split=0, comm=x.comm)
w[5:25] = x[10:30]
assert np.array_equal(w.numpy()[5:25], x.numpy()[10:30])
xs, labels = ht.random.shuffle_rows([x, ht.arange(40, split=0, comm=x.comm)])
assert np.array_equal(xs.numpy(), x.numpy()[labels.numpy()])
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    ht.save_hdf5(x, os.path.join(tmp, "x.h5"), "x")
    assert np.array_equal(ht.load_hdf5(os.path.join(tmp, "x.h5"), "x", split=0, comm=x.comm).numpy(), x.numpy())
    ht.save_csv(x, os.path.join(tmp, "x.csv"))
    assert np.array_equal(ht.load_csv(os.path.join(tmp, "x.csv"), split=0, comm=x.comm).numpy(), x.numpy())
assert ht.native.lib() is not None
ht.random.seed(0)
z = ht.random.randn(4, 3, split=0, comm=x.comm)
assert z.shape == (4, 3) and ht.random.get_state() == ("Threefry", 0, 1, 0, 0.0)
dp = ht.nn.DataParallel(ht.models.MLP((8, 2)), comm=x.comm,
                        optimizer=ht.optim.DataParallelOptimizer(ht.optim.adam(1e-2))).init(0, x)
loss = dp.train_step(x, ht.zeros(40, dtype=ht.int64, split=0, comm=x.comm))
assert loss.ndim == 0 and bool(torch.isfinite(loss))
moe = ht.models.TransformerLM(vocab_size=20, num_layers=1, num_heads=2, head_dim=4, max_seq_len=8, moe_experts=4,
                              ep_mesh=ht.MeshComm(2), device="cpu")
opt = ht.optim.lamb(1e-3)(list(moe.parameters()))
logits = moe(tok)
(torch.nn.functional.cross_entropy(logits.reshape(-1, 20), tok.reshape(-1)) + 0.01 * sum(moe.moe_aux_losses())).backward()
opt.step()
stages = ht.parallel.stack_stage_params([{"w": torch.eye(3)}, {"w": 2 * torch.eye(3)}], ht.MeshComm(2))
assert torch.equal(ht.parallel.pipeline_apply(lambda p, a: a @ p["w"], stages, torch.ones(4, 3), mesh=ht.MeshComm(2),
                                              n_micro=2), 2 * torch.ones(4, 3))
T = ht.utils.vision_transforms
img = T.Compose([T.RandomCrop(6, padding=1, seed=0), T.RandomHorizontalFlip(seed=0), T.ToTensor(),
                 T.Normalize([0.5] * 3, [0.25] * 3), T.Resize(8)])(torch.zeros(6, 6, 3, dtype=torch.uint8))
assert img.shape == (8, 8, 3)
ht.telemetry.set_level("events")
with ht.telemetry.span("probe"):
    kept = ht.zeros((4,), split=0, comm=x.comm)
assert ht.memtrack.summary()["live_buffers"] >= 1 and ht.telemetry.events("span_end")
assert ht.roofline.detect_peaks()["known"] is False and ht.guard.mode() == "warn"
qw = ht.quantize.quantize_weights(ht.array(np.ones((3, 2), np.float32), comm=x.comm), axis=1)
assert ht.matmul(x, qw).shape == (40, 2) and ht.wire.mode() == "on"
knn = ht.classification.KNeighborsClassifier(3).fit(x, ht.arange(40, split=0, comm=x.comm) % 2)
assert knn.quantize_("fp8").predict(x).shape == (40,) and knn.x is None
assert ht.autotune.report()["device_kind"] == "cpu:cpu" and "rows" in ht.telemetry.autotune_report()
import heat_tpu_torch.analysis.sanitize as sanitize
assert not sanitize.enabled() and sanitize.collective_fingerprint()["n"] == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "heat_tpu"})
print("LOADED", bad)
"""


def test_port_runs_without_jax_or_heat_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", FIT], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_heat_tpu_import(rel):
    found = set(_imported_roots(ROOT / rel)) & FORBIDDEN
    assert not found, f"{rel} imports {sorted(found)}"


NEW_MODULES = [
    ("parallel.expert", "parallel.expert"),
    ("parallel.pipeline", "parallel.pipeline"),
    ("utils.vision_transforms", "utils.vision_transforms"),
    ("core.telemetry", "core.telemetry"),
    ("core.memtrack", "core.memtrack"),
    ("core.roofline", "core.roofline"),
    ("core.guard", "core.guard"),
    ("core.autotune", "core.autotune"),
    ("core.wire", "core.wire"),
    ("core.quantize", "core.quantize"),
]


@pytest.mark.parametrize("port, ref", NEW_MODULES)
def test_new_modules_export_heat_tpus_names(port, ref):
    import importlib

    pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")
    theirs = importlib.import_module(f"heat_tpu.{ref}")
    ours = importlib.import_module(f"heat_tpu_torch.{port}")
    assert set(theirs.__all__) <= set(ours.__all__), sorted(set(theirs.__all__) - set(ours.__all__))
    for name in ours.__all__:
        assert hasattr(ours, name), name
