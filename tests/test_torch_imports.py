"""heat_tpu_torch and chip_smoke.py stand alone: they import neither jax nor
anything of heat_tpu.  A fresh interpreter imports the port and runs a tiny
KMeans fit, QR, Lasso fit, sparse product and sparse Spectral fit; a scan of
every import statement in the port backs it up."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "heat_tpu"}
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
bad = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "jaxlib", "heat_tpu"})
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
