"""chip_smoke.py's tuning and quantization phases alone, at full size, on the
card: builds K1 and K3-K7, makes one tuning row of each kernel site with
small QR, Lasso, sparse-product and reshape calls, then runs quant_paths,
qknn_paths, wire_paths and autotune_paths.  Run from the repo root with
``PYTHONPATH=. python3 scripts/probe_tuning_phases.py``."""
import sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
import heat_tpu_torch as ht
from heat_tpu_torch.ops import attention as k3, cdist as k1, qr_panel as k4, lasso_sweep as k5, spmv as k6, repack as k7
dev = torch.device("cuda", 0)
card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
print(card, torch.__version__, flush=True)
t0 = time.perf_counter()
with ThreadPoolExecutor(6) as pool:
    for f in [pool.submit(m._kernel) for m in (k1, k3, k4, k5, k6, k7)]:
        f.result()
print(f"built {time.perf_counter() - t0:.1f} s", flush=True)
ht.wire.set_mode("off")
# the kernel sites on the card: QR, Lasso, SpMV, a split-crossing reshape
gen = torch.Generator(device=dev).manual_seed(0)
a = ht.array(torch.randn(100_000, 64, generator=gen, device=dev))
for _ in range(5):
    ht.linalg.qr(a)
y = ht.array(torch.randn(100_000, 1, generator=gen, device=dev))
for _ in range(4):
    ht.regression.Lasso(lam=0.01, max_iter=3, tol=-1.0).fit(a, y)
import scipy.sparse as sp
m = sp.random(20000, 20000, density=0.002, format="csr", dtype=np.float32, random_state=0)
A = ht.sparse.sparse_csr_matrix(m, split=0)
xv = ht.array(torch.randn(20000, generator=gen, device=dev))
for _ in range(5):
    ht.sparse.matmul(A, xv)
z = ht.array(torch.randn(999_999, 20, generator=gen, device=dev), split=0, comm=ht.MeshComm(4))
for _ in range(5):
    ht.reshape(z, (1_999_998, 10), new_split=0)
torch.cuda.synchronize()
rows = [r for r in ht.autotune.report()["rows"] if r["arms"] == ("kernel",)]
for r in rows:
    print("ROW", r["desc"], r["kernel_min_s"], r["kernel_samples"], r["winner"], flush=True)
res = {}
for name, fn in (("quant", lambda: cs.quant_paths(ht, k3, 0, dev, card)),
                 ("qknn", lambda: cs.qknn_paths(ht, k1, 0, dev, card)),
                 ("wire", lambda: cs.wire_paths(ht, k7, 0, dev, card)),
                 ("autotune", lambda: cs.autotune_paths(ht, k1, 0, dev, card, rows,
                                                        {"K4": 2, "K5": 3, "K6": 1, "K7": 4}, res["quant"]))):
    t0 = time.perf_counter()
    try:
        res[name] = fn()
        print(name, {k: v for k, v in res[name].items() if k != "table"}, f"{time.perf_counter() - t0:.1f} s", flush=True)
    except Exception as e:
        import traceback; traceback.print_exc()
        print(name, "FAILED", e, flush=True)
        if name == "quant":
            break
print(cs.run(["nvidia-smi", "--query-gpu=name,clocks.max.sm,clocks.sm,power.limit", "--format=csv,noheader"]))
