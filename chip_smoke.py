"""Drive heat_tpu_torch's KMeans, QR, Lasso and sparse Spectral paths on one
CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases: (1) identity of the card and toolchain; (2) build every kernel of
the paths from the sources in this checkout, all at once; (3) each kernel
against its plain torch version at the shapes the paths give it; (4) kernel
timing beside the plain version, one library call where there is one, and
the card's bound; (5) each path end to end through the entry points a user
calls, with the kernels' launch counts set to 0 just before it and read just
after: KMeans(k=8, kmeans++) fit and predict on 2e7 x 64 f32 Gaussian blobs;
``linalg.qr`` on the repo's three QR shapes (1e6 x 128, 5e5 x 1000, 2048^2,
benchmarks/cb/config.py:152-158); a Lasso fit on the repo's regression
recipe at 5e5 x 1000 (benchmarks/cb/regression.py:17-24); ``sparse.matmul``
on the repo's SpMV cell (131072^2 at density 0.002, k = 1 and 4;
benchmarks/cb/sparse.py:78-127) and ``Spectral(affinity="knn")`` on its
two-blob cell (65536 x 16, k = 6, 32 Lanczos steps; sparse.py:130-165,
config.py:220-223), and a dense ``affinity="rbf"`` fit at 16384 x 16; each
with data made on the card from ``--seed``, and a small input of each on the
card and on the CPU; (6) one JSON line per kernel.  The last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero before that
line; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# |Δd2| <= TOL * (|x|^2 + |y|^2): the kernel sums in another order than the
# plain version, and the expansion cancels
TOL = 1e-5
# the repo's Lloyd benchmark shape (benchmarks/cb/config.py): 2e7 x 64 f32, k = 8
ROWS = 20_000_000
# K4: |ΔR|_F <= TOL_QR |R|_F and the same for R^-1 (sums in other orders)
TOL_QR = 1e-5
# K5: max |Δθ| <= TOL_LASSO max |θ| after one sweep
TOL_LASSO = 1e-5
# the repo's QR benchmark shapes (benchmarks/cb/config.py:152-153, :158) and
# the K4 launches each must make: two passes per CholeskyQR2 leaf, and the
# square splits into two 2048 x 1024 leaves
QR_SHAPES = [((1_000_000, 128), 2), ((500_000, 1_000), 2), ((2048, 2048), 4)]
# the repo's Lasso benchmark shape (benchmarks/cb/config.py:178)
LASSO_M, LASSO_N, LASSO_SWEEPS = 500_000, 1_000, 10
# K6: |Δy| <= TOL_SPMV * Σⱼ|vals·x| per row (sums in other orders)
TOL_SPMV = 1e-5
# the repo's sparse cells (benchmarks/cb/config.py:220-223): the SpMV
# matrix, its right-hand sides, and the k-NN Spectral fit on two blobs
SPMV_N, SPMV_DENSITY, SPMV_K = 131_072, 0.002, 4
KNNG_N, KNNG_F, KNNG_K, KNNG_LANCZOS = 65_536, 16, 6, 32
RBF_N = 16_384


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{' '.join(cmd)} failed: {proc.stderr}")
    return proc.stdout.strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cdist_bound_ms(m: int, n: int, d: int):
    """Least time for (m,d)x(n,d)->(m,n) f32: each input read once and the
    output written once, against the cross term's and norms' FMAs."""
    nbytes = 4.0 * (m * d + n * d + m * n)
    flops = 2.0 * m * n * d + 2.0 * (m + n) * d + 3.0 * m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare_cdist(k1, x, y, sqrt: bool):
    """Kernel against plain on the same inputs: (max abs err, max err
    relative to |x|^2+|y|^2)."""
    got = k1.cdist(x, y, sqrt=sqrt)
    want = k1.reference_cdist(x, y, sqrt=sqrt)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (x.shape[0], y.shape[0]), f"shape {tuple(got.shape)}")
    if got.numel() == 0:
        return 0.0, 0.0
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    abs_err = float((got - want).abs().max())
    g2, w2 = (got * got, want * want) if sqrt else (got, want)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    rel = float(((g2 - w2).abs() / scale.clamp_min(1e-30)).max())
    return abs_err, rel


def make_blobs(rows: int, dim: int, k: int, seed: int, dev, scale: float = 300.0):
    """Gaussian blobs (sigma 1) around k centres drawn at ``scale`` (at 300
    and dim 64 every pair of centres lies ~3400 apart); made on the card
    from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = scale * torch.randn(k, dim, generator=gen, device=dev)
    labels = torch.randint(0, k, (rows,), generator=gen, device=dev)
    x = torch.randn(rows, dim, generator=gen, device=dev)
    step = 1 << 20
    for s in range(0, rows, step):
        x[s : s + step] += centres[labels[s : s + step]]
    return x, centres


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qr_panel_bound_ms(m: int, n: int):
    """Least time for one panel pass over (m, n) f32: the panel read once
    and R, R^-1 written once, against the Gram's upper triangle (m n (n+1)
    flops: the kernel exploits symmetry), the Cholesky (n^3/3) and the
    triangular inverse (n^3/3)."""
    return bound(4.0 * (m * n + 2 * n * n), m * n * (n + 1) + 2.0 * n**3 / 3)


def lasso_sweep_bound_ms(m: int, n: int):
    """Least time for one sweep over (m, n) f32: X, y, θ read once and θ'
    written once, against r0 = y - Xθ (2 m n flops) and, per coordinate,
    r + θ_j x_j, the dot and the residual update (6 m flops)."""
    return bound(4.0 * (m * n + m + 2 * n), 8.0 * m * n)


def spmv_bound_ms(nnz: int, nrows: int, ncols: int, k: int):
    """Least time for y = A x over a CSR matrix: each nonzero's value and
    column read once (8 bytes), x read once and y written once, against
    2 flops per nonzero and right-hand side."""
    return bound(8.0 * nnz + 4.0 * ncols * k + 4.0 * nrows * k, 2.0 * nnz * k)


def random_csr(nrows: int, ncols: int, density: float, gen, dev):
    """A CSR triple (values, int32 columns, int64 row pointers) with
    distinct uniformly random positions and U[0, 1) values, the
    distribution of ``scipy.sparse.random``, made on the card."""
    target = int(round(density * nrows * ncols))
    lin = torch.unique(torch.randint(0, nrows * ncols, (target,), generator=gen, device=dev))
    indptr = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(lin // ncols, minlength=nrows), 0)
    return torch.rand(lin.numel(), generator=gen, device=dev), (lin % ncols).to(torch.int32), indptr


def to_scipy(vals, cols, indptr, shape):
    import scipy.sparse

    return scipy.sparse.csr_matrix((vals.cpu().numpy(), cols.cpu().numpy(), indptr.cpu().numpy()), shape=shape)


def compare_spmv(k6, vals, cols, x):
    """Kernel against plain on the same slabs: (kernel's y, max abs err,
    max err relative to Σⱼ|vals·x|)."""
    got = k6.spmv_ell(vals, cols, x)
    want = k6.reference_spmv_ell(vals, cols, x)
    scale = k6.reference_spmv_ell(vals.abs(), cols, x.abs())
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(want.shape), f"spmv shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite spmv output")
    err = (got - want).abs()
    return got, float(err.max()), float((err / scale.clamp_min(1e-30)).max())


def two_blobs(n: int, f: int, gen, dev):
    """The repo's Spectral recipe (benchmarks/cb/sparse.py:131-135): the
    first half N(0, 0.3), the second N(3, 0.3), on the card."""
    x = 0.3 * torch.randn(n, f, generator=gen, device=dev)
    x[n // 2 :] += 3.0
    truth = torch.zeros(n, dtype=torch.int64, device=dev)
    truth[n // 2 :] = 1
    return x, truth


def blob_agreement(labels, truth) -> float:
    """Share of points whose label matches the generating blob, under the
    better of the two namings of two clusters."""
    same = float((labels.reshape(-1).to(truth.device) == truth).float().mean())
    return max(same, 1.0 - same)


def component_agreement(y0, degree, truth) -> float:
    """The blobs as the embedding's first column shows them.  The graph of
    two far blobs has two components, so the Laplacian's null space holds
    D^1/2 1_A and D^1/2 1_B, and the first Ritz vector is a combination of
    the two: y0 / sqrt(deg) takes one value per component.  Splitting it at
    its largest gap must give the blobs."""
    r = y0 / torch.sqrt(degree.clamp_min(1e-30))
    o = torch.sort(r).values
    i = int(torch.argmax(o[1:] - o[:-1]))
    return blob_agreement((r > (o[i] + o[i + 1]) / 2).to(torch.int64), truth)


def compare_qr_panel(k4, x):
    """Kernel against plain: (max abs err of R and R^-1, relative errors)."""
    r, rinv = k4.fused_gram_chol(x)
    rr, rri = k4.reference_fused_gram_chol(x)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(r).all()) and bool(torch.isfinite(rinv).all()), "non-finite qr_panel output")
    check(torch.equal(torch.tril(r, -1), torch.zeros_like(r)), "R is not upper triangular")
    abs_err = max(float((r - rr).abs().max()), float((rinv - rri).abs().max()))
    return abs_err, float((r - rr).norm() / rr.norm()), float((rinv - rri).norm() / rri.norm())


def trace(label: str, fn, iters: int) -> None:
    """Device time per unit by kernel, from torch.profiler, and the device's
    idle share of the traced window; ``fn`` runs ``iters`` units."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels only: an operator's entry repeats its kernels' device time
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[trace] the profiler saw no device time")
        return
    print(f"[trace] {label} x{iters}: device busy {busy / 1e3 / iters:.4f} ms per unit of "
          f"{wall_us / 1e3 / iters:.4f} ms wall under the profiler, idle share {1 - busy / wall_us:.4f}")
    for us, count, name in sorted(rows, reverse=True)[:10]:
        print(f"[trace]   {us / 1e3 / iters:9.4f} ms/unit  x{count / iters:<5g} {name[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # ---------------------------------------------------------- 1. identity
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import kmeans as km_mod
    from heat_tpu_torch.ops import _build
    from heat_tpu_torch.ops import cdist as k1
    from heat_tpu_torch.ops import lasso_sweep as k5
    from heat_tpu_torch.ops import qr_panel as k4
    from heat_tpu_torch.ops import spmv as k6
    from heat_tpu_torch.regression import lasso as lasso_mod
    from heat_tpu_torch.sparse import knn as knn_mod
    # the package's ``matmul`` function shadows its module of that name
    spmm_mod = importlib.import_module("heat_tpu_torch.sparse.matmul")

    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    print(f"[identity] {card}")
    print(f"[identity] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[identity] nvcc: {run([_build.nvcc_path(), '--version']).splitlines()[-1]}")
    print(
        f"[identity] tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    dev = torch.device("cuda", 0)

    # ------------------------------------------------------------- 2. build
    # one nvcc per library, all started together
    libs = {"heat_cdist": k1, "heat_qr_panel": k4, "heat_lasso_sweep": k5, "heat_spmv": k6}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(mod._kernel) for mod in libs.values()]:
            fut.result()
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f} s wall (with load)")
    for name in libs:
        info = _build.BUILD_INFO[name]
        print(f"[build] {name}: {info['seconds']:.2f} s nvcc")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")

    # --------------------------------------------------- 3. kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rows = ROWS
    x = torch.randn(rows, 64, generator=gen, device=dev)
    cases = [
        ("lloyd step", x, torch.randn(8, 64, generator=gen, device=dev), False),
        ("kmeans++ column", x, torch.randn(1, 64, generator=gen, device=dev), True),
    ]
    xr = torch.randn(1_000_003, 67, generator=gen, device=dev)
    yr = torch.randn(257, 67, generator=gen, device=dev)
    cases += [("ragged", xr, yr, False), ("ragged", xr, yr, True)]
    cases += [("zero rows", torch.empty(0, 64, device=dev), torch.randn(8, 64, generator=gen, device=dev), False)]
    max_abs = 0.0
    for name, a, b, sqrt in cases:
        abs_err, rel = compare_cdist(k1, a, b, sqrt)
        print(f"[check] cdist {name} {tuple(a.shape)}x{tuple(b.shape)} sqrt={sqrt}: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e}")
        check(rel <= TOL, f"cdist {name} sqrt={sqrt}: relative error {rel:.3e} > {TOL}")
        max_abs = max(max_abs, abs_err)
    del xr, yr

    # K4 at the QR path's panels: 1e6 x 128, the square's 2048 x 1024
    # leaves, 5e5 x 1000; a ragged panel and the narrowest one
    k4_abs = 0.0
    for m, n in [(1_000_000, 128), (2048, 1024), (500_000, 1_000), (100_003, 67), (1000, 2)]:
        xq = torch.randn(m, n, generator=gen, device=dev)
        abs_err, rel_r, rel_ri = compare_qr_panel(k4, xq)
        print(f"[check] qr_panel ({m},{n}): max_abs_err={abs_err:.3e} |dR|/|R|={rel_r:.3e} |dRinv|/|Rinv|={rel_ri:.3e}")
        check(rel_r <= TOL_QR and rel_ri <= TOL_QR, f"qr_panel ({m},{n}): relative error above {TOL_QR}")
        k4_abs = max(k4_abs, abs_err)
        del xq
    # a rank-deficient panel (a zero column): both latch NaN in the same places
    xq = torch.randn(3000, 40, generator=gen, device=dev)
    xq[:, 7] = 0
    r, rinv = k4.fused_gram_chol(xq)
    rr, rri = k4.reference_fused_gram_chol(xq)
    torch.cuda.synchronize()
    same_nan = torch.equal(torch.isnan(r), torch.isnan(rr)) and torch.equal(torch.isnan(rinv), torch.isnan(rri))
    print(f"[check] qr_panel rank-deficient (3000,40): NaN in R {int(torch.isnan(r).sum())}/{r.numel()}, "
          f"in Rinv {int(torch.isnan(rinv).sum())}/{rinv.numel()}, same places as plain {same_nan}")
    check(same_nan and bool(torch.isnan(r).any()) and bool(torch.isnan(rinv).all()), "qr_panel NaN latch differs")

    # K5: one sweep at the Lasso path's 5e5 x 1001 from θ = 0 and from a
    # non-zero θ, and a ragged 9999 x 37 (λ small enough that most
    # coordinates stay non-zero)
    k5_abs = 0.0
    xt_l = torch.randn(LASSO_N + 1, LASSO_M, generator=gen, device=dev)
    y_l = torch.randn(LASSO_M, generator=gen, device=dev)
    xt_r = torch.randn(37, 9_999, generator=gen, device=dev)
    y_r = torch.randn(9_999, generator=gen, device=dev)
    for name, xt_, y_, nonzero in [("5e5x1001", xt_l, y_l, False), ("5e5x1001", xt_l, y_l, True),
                                   ("ragged 9999x37", xt_r, y_r, False), ("ragged 9999x37", xt_r, y_r, True)]:
        th = 0.1 * torch.randn(xt_.shape[0], generator=gen, device=dev) if nonzero else torch.zeros(xt_.shape[0], device=dev)
        got = k5.sweep(xt_, y_, th, 1e-4)
        want = k5.reference_sweep(xt_, y_, th, 1e-4)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "non-finite lasso_sweep output")
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"[check] lasso_sweep {name} theta0={'nonzero' if nonzero else 'zero'}: max_abs_err={err:.3e} "
              f"max|theta|={scale:.3e} nonzero coords {int((want != 0).sum())}/{want.numel()}")
        check(err <= TOL_LASSO * scale, f"lasso_sweep {name}: error {err:.3e} > {TOL_LASSO} * {scale:.3e}")
        k5_abs = max(k5_abs, err)
    del xt_r, y_r

    # K6 at the SpMV cell (k = 1 and 4), the Spectral cell's k-NN
    # Laplacian, a ragged matrix (empty rows, one row of 1000 entries) and
    # integer-valued data (bitwise)
    k6_abs = 0.0
    sp_vals, sp_cols, sp_ptr = random_csr(SPMV_N, SPMV_N, SPMV_DENSITY, gen, dev)
    sp_nnz = sp_vals.numel()
    sp_w = k6.ell_width(int((sp_ptr[1:] - sp_ptr[:-1]).max()))
    ell_v, ell_c = k6.ell_pack(sp_vals, sp_cols, sp_ptr, sp_w)
    sp_x = torch.randn(SPMV_N, SPMV_K, generator=gen, device=dev)
    k6_cases = [("spmv cell k=1", ell_v, ell_c, sp_x[:, 0]), ("spmv cell k=4", ell_v, ell_c, sp_x)]
    blobs, _ = two_blobs(KNNG_N, KNNG_F, gen, dev)
    lap = ht.graph.laplacian_sparse(ht.sparse.knn_graph(ht.array(blobs, split=0), KNNG_K, sigma=0.5**0.5))
    lap_v, lap_c = spmm_mod._ell_slabs(lap)[0]
    k6_cases.append(("knn laplacian", lap_v, lap_c, torch.sin(torch.arange(1, KNNG_N + 1, dtype=torch.float32, device=dev))))
    rg_rows = 100_003
    rg_cnt = torch.randint(0, 17, (rg_rows,), generator=gen, device=dev)
    rg_cnt[::7] = 0
    rg_cnt[rg_rows // 2] = 1000
    rg_ptr = torch.zeros(rg_rows + 1, dtype=torch.int64, device=dev)
    rg_ptr[1:] = torch.cumsum(rg_cnt, 0)
    rg_nnz = int(rg_ptr[-1])
    rg_v, rg_c = k6.ell_pack(torch.randn(rg_nnz, generator=gen, device=dev),
                             torch.randint(0, 50_000, (rg_nnz,), generator=gen, device=dev, dtype=torch.int32),
                             rg_ptr, k6.ell_width(1000))
    k6_cases.append(("ragged", rg_v, rg_c, torch.randn(50_000, 3, generator=gen, device=dev)))
    for name, v_, c_, x_ in k6_cases:
        _, abs_err, rel = compare_spmv(k6, v_, c_, x_)
        print(f"[check] spmv {name} slabs {tuple(v_.shape)} x {tuple(x_.shape)}: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel:.3e} (|dy| / sum|vals x|)")
        check(rel <= TOL_SPMV, f"spmv {name}: relative error {rel:.3e} > {TOL_SPMV}")
        k6_abs = max(k6_abs, abs_err)
    int_v = torch.where(ell_c >= 0, torch.randint(1, 8, ell_v.shape, generator=gen, device=dev).float(), ell_v)
    int_x = torch.randint(-4, 5, (SPMV_N, SPMV_K), generator=gen, device=dev).float()
    y_int = k6.spmv_ell(int_v, ell_c, int_x)
    same = torch.equal(y_int, k6.reference_spmv_ell(int_v, ell_c, int_x))
    print(f"[check] spmv integer-valued spmv cell k={SPMV_K}: bitwise equal to plain {same}")
    check(same, "spmv on integer-valued data is not bitwise equal to its plain version")
    del lap, lap_v, lap_c, rg_v, rg_c, int_v, int_x, y_int, k6_cases, blobs
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. timing
    y8 = cases[0][2]
    kernel_ms = time_ms(lambda: k1.cdist(x, y8, sqrt=False), reps=20)
    plain_ms = time_ms(lambda: k1.reference_cdist(x, y8, sqrt=False), reps=5)
    library_ms = time_ms(lambda: torch.cdist(x, y8).square(), reps=5)
    kernel_ms_2 = time_ms(lambda: k1.cdist(x, y8, sqrt=False), reps=20)
    bound_ms, bound_by = cdist_bound_ms(rows, 8, 64)
    print(
        f"[time] cdist ({rows},64)x(8,64): kernel_ms={kernel_ms:.4f} (again {kernel_ms_2:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"on {card}"
    )
    del x, cases
    torch.cuda.empty_cache()

    xq = torch.randn(1_000_000, 128, generator=gen, device=dev)
    eye = torch.eye(128, device=dev)
    k4_ms = time_ms(lambda: k4.fused_gram_chol(xq), reps=10)
    k4_plain_ms = time_ms(lambda: k4.reference_fused_gram_chol(xq), reps=10)
    # the library chain: cuBLAS Gram, cuSOLVER Cholesky, triangular solve
    k4_library_ms = time_ms(
        lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(xq.T @ xq)[0], eye, upper=False), reps=10
    )
    k4_ms_2 = time_ms(lambda: k4.fused_gram_chol(xq), reps=10)
    k4_bound_ms, k4_bound_by = qr_panel_bound_ms(1_000_000, 128)
    print(
        f"[time] qr_panel (1000000,128): kernel_ms={k4_ms:.4f} (again {k4_ms_2:.4f}) plain_ms={k4_plain_ms:.4f} "
        f"library_ms={k4_library_ms:.4f} (cholesky_ex(x.T@x) + solve_triangular) "
        f"bound_ms={k4_bound_ms:.4f} ({k4_bound_by}) on {card}"
    )
    del xq
    for m, n in [(500_000, 1_000), (2048, 1024)]:
        xq = torch.randn(m, n, generator=gen, device=dev)
        eye_n = torch.eye(n, device=dev)
        t_k = time_ms(lambda: k4.fused_gram_chol(xq), reps=3, warmup=1)
        t_p = time_ms(lambda: k4.reference_fused_gram_chol(xq), reps=3, warmup=1)
        t_l = time_ms(
            lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(xq.T @ xq)[0], eye_n, upper=False),
            reps=3, warmup=1,
        )
        b_ms, b_by = qr_panel_bound_ms(m, n)
        print(f"[time] qr_panel ({m},{n}): kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"(cholesky_ex(x.T@x) + solve_triangular) bound_ms={b_ms:.4f} ({b_by}) on {card}")
        del xq, eye_n
    th0 = torch.zeros(LASSO_N + 1, device=dev)
    k5_ms = time_ms(lambda: k5.sweep(xt_l, y_l, th0, 0.01), reps=10)
    k5_plain_ms = time_ms(lambda: k5.reference_sweep(xt_l, y_l, th0, 0.01), reps=2, warmup=1)
    k5_ms_2 = time_ms(lambda: k5.sweep(xt_l, y_l, th0, 0.01), reps=10)
    k5_bound_ms, k5_bound_by = lasso_sweep_bound_ms(LASSO_M, LASSO_N + 1)
    print(
        f"[time] lasso_sweep ({LASSO_M},{LASSO_N + 1}): kernel_ms={k5_ms:.4f} (again {k5_ms_2:.4f}) "
        f"plain_ms={k5_plain_ms:.4f} library_ms=null (no library call computes a coordinate-descent sweep) "
        f"bound_ms={k5_bound_ms:.4f} ({k5_bound_by}) on {card}"
    )
    del xt_l, y_l
    torch.cuda.empty_cache()

    # K6 at the SpMV cell; the library call is cuSPARSE's CSR product
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch marks its sparse CSR tensors as beta
        sp_torch = torch.sparse_csr_tensor(sp_ptr, sp_cols.to(torch.int64), sp_vals, (SPMV_N, SPMV_N))
    pad_share = 1.0 - sp_nnz / ell_v.numel()
    k6_times = {}
    for k in (1, SPMV_K):
        xk = sp_x[:, :k].contiguous()
        t_k = time_ms(lambda: k6.spmv_ell(ell_v, ell_c, xk), reps=50, warmup=5)
        t_p = time_ms(lambda: k6.reference_spmv_ell(ell_v, ell_c, xk), reps=5)
        t_l = time_ms(lambda: sp_torch @ xk, reps=50, warmup=5)
        t_k2 = time_ms(lambda: k6.spmv_ell(ell_v, ell_c, xk), reps=50, warmup=5)
        b_ms, b_by = spmv_bound_ms(sp_nnz, SPMV_N, SPMV_N, k)
        k6_times[k] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"[time] spmv ({SPMV_N}^2, nnz {sp_nnz}, ELL width {sp_w}) k={k}: kernel_ms={t_k:.4f} (again {t_k2:.4f}) "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} (torch.sparse_csr_tensor @ x, cuSPARSE) bound_ms={b_ms:.4f} "
              f"({b_by}; the ELL padding adds {pad_share:.4f} of the slab slots) on {card}")
    del sp_torch, ell_v, ell_c
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 5. end to end
    k, iters = 8, 10
    data, centres = make_blobs(rows, 64, k, args.seed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    t0 = time.perf_counter()
    x_ht = ht.array(data, split=0, copy=False)
    model = ht.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=iters, tol=-1, random_state=args.seed)
    model.fit(x_ht)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x_ht)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = k1.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = k + iters + 1 + 1  # kmeans++ rounds, Lloyd steps, labels_, predict
    print(f"[e2e] fit {fit_s:.3f} s, predict {predict_s:.3f} s, peak {peak_gb:.2f} GB, cdist launches {launches} (expected {expected})")
    check(launches == expected, f"cdist launches {launches} != {expected}")
    check(model.n_iter_ == iters, f"n_iter_ {model.n_iter_} != {iters}")
    fitted = model.cluster_centers_.larray.float()
    check(bool(torch.isfinite(fitted).all()) and tuple(fitted.shape) == (k, 64), "bad centres")
    # centres match the generating ones up to a permutation: the mean of
    # ~2.5e6 unit-variance samples sits within ~1e-3 of its centre
    dist = torch.cdist(fitted, centres)
    match = dist.argmin(dim=1)
    centre_err = float(dist.min(dim=1).values.max())
    print(f"[e2e] centre error {centre_err:.4e} (tolerance 0.05), matched {match.tolist()}")
    check(sorted(match.tolist()) == list(range(k)), "fitted centres are not a permutation of the generating ones")
    check(centre_err <= 0.05, f"centre error {centre_err} > 0.05")
    check(model.inertia_ > 0 and model.inertia_ == model.inertia_, f"inertia {model.inertia_}")
    # labels against the plain version wherever the top-two margin exceeds
    # the kernel's tolerance
    pred = labels.larray.reshape(-1)
    d2 = k1.reference_cdist(data, fitted, sqrt=False)
    top2 = d2.topk(2, dim=1, largest=False)
    margin = top2.values[:, 1] - top2.values[:, 0]
    scale = (data * data).sum(1) + (fitted * fitted).sum(1).max()
    clear = margin > 2 * TOL * scale
    disagree = int(((pred != top2.indices[:, 0]) & clear).sum())
    print(f"[e2e] labels vs plain: {disagree} disagreements over {int(clear.sum())} rows with a clear margin")
    check(disagree == 0, f"{disagree} labels disagree with the plain version")
    del d2, top2, margin, scale, clear
    # ms per Lloyd iteration, timed after the counted run
    blocks = [s.contiguous() for s in x_ht.shards]
    start = fitted.to(data.dtype)
    km_mod._lloyd_loop(blocks, start, k, 1, -1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km_mod._lloyd_loop(blocks, start, k, iters, -1.0)
    torch.cuda.synchronize()
    iter_ms = 1e3 * (time.perf_counter() - t0) / iters
    print(f"[e2e] lloyd {iter_ms:.4f} ms/iter, {rows / (iter_ms / 1e3):.4e} samples/s, inertia {model.inertia_:.6e} on {card}")
    trace("Lloyd iteration", lambda: km_mod._lloyd_loop(blocks, start, k, 2, -1.0), 2)

    # small input: the same fit on the card and on the CPU (plain version)
    # (blobs near the origin, started near their centres: no near-ties)
    small, small_centres = make_blobs(5000, 16, 4, args.seed + 2, dev, scale=3.0)
    init = small_centres + 0.1
    mesh = ht.MeshComm(4)
    on_card = ht.cluster.KMeans(n_clusters=4, init=ht.array(init), max_iter=20).fit(
        ht.array(small, split=0, comm=mesh)
    )
    on_cpu = ht.cluster.KMeans(n_clusters=4, init=ht.array(init.cpu(), device="cpu"), max_iter=20).fit(
        ht.array(small.cpu(), split=0, comm=mesh, device="cpu")
    )
    same_labels = bool((on_card.labels_.larray.cpu() == on_cpu.labels_.larray).all())
    c_err = float((on_card.cluster_centers_.larray.cpu() - on_cpu.cluster_centers_.larray).abs().max())
    print(f"[e2e] small input card vs cpu: n_iter {on_card.n_iter_}/{on_cpu.n_iter_}, labels equal {same_labels}, centre max diff {c_err:.3e}")
    check(same_labels and on_card.n_iter_ == on_cpu.n_iter_ and c_err <= 1e-4, "small-input fit differs between card and CPU")

    del data, centres, x_ht, model, labels, pred, fitted, blocks, start, small, on_card, on_cpu
    torch.cuda.empty_cache()

    # QR on the repo's three shapes, split 0 over the card's one position
    qr_launches = 0
    for (m, n), want in QR_SHAPES:
        ht.random.seed(args.seed)
        a = ht.random.randn(m, n, split=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k4.launches = 0
        t0 = time.perf_counter()
        q, r = ht.linalg.qr(a)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        got = k4.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        qm, rm, am = q.larray, r.larray, a.larray
        rec = float(torch.linalg.matrix_norm(qm @ rm - am) / torch.linalg.matrix_norm(am))
        orth = float(ht.linalg.orthogonality_defect(q))
        orth_tol = 1e-4 if m >= 2 * n else 1e-3
        tri = torch.equal(torch.tril(rm, -1), torch.zeros_like(rm)) and bool((torch.diagonal(rm) > 0).all())
        t0 = time.perf_counter()
        for _ in range(3):
            ht.linalg.qr(a)
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t0) / 3
        print(f"[e2e] qr ({m},{n}): {call_ms:.4f} ms/call (first call {1e3 * call_s:.1f} ms), peak {peak_gb:.2f} GB, "
              f"qr_panel launches {got} (expected {want}), |QR-A|/|A| {rec:.3e}, orthogonality defect {orth:.3e} "
              f"(tolerance {orth_tol:g}) on {card}")
        check(got == want, f"qr ({m},{n}): qr_panel launches {got} != {want}")
        check(tuple(qm.shape) == (m, n) and tuple(rm.shape) == (n, n) and q.split == 0, "qr: bad shapes or split")
        check(rec <= 1e-5, f"qr ({m},{n}): reconstruction {rec:.3e} > 1e-5")
        check(orth <= orth_tol, f"qr ({m},{n}): orthogonality defect {orth:.3e} > {orth_tol}")
        check(tri, f"qr ({m},{n}): R is not upper triangular with a positive diagonal")
        if (m, n) == QR_SHAPES[0][0]:
            trace(f"qr ({m},{n}) call", lambda: [ht.linalg.qr(a) for _ in range(2)], 2)
        qr_launches += got
        del a, q, r, qm, rm, am
        torch.cuda.empty_cache()

    # Lasso on the repo's regression recipe: unit-RMS features, β = 2 on
    # every 62nd feature, y = xβ + 0.01 noise, all through the entry points
    m, n = LASSO_M, LASSO_N
    ht.random.seed(args.seed)
    xl = ht.random.randn(m, n, split=0)
    norm = ht.sqrt(ht.mean(xl * xl, axis=0)) + 1e-12
    xl = xl / ht.reshape(norm, (1, -1))
    beta = torch.zeros(n, 1, device=dev)
    beta[:: max(n // 16, 1)] = 2.0
    yl = ht.matmul(xl, ht.array(beta)) + 0.01 * ht.random.randn(m, 1, split=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5.launches = 0
    t0 = time.perf_counter()
    est = ht.regression.Lasso(lam=0.01, max_iter=LASSO_SWEEPS, tol=-1.0).fit(xl, yl)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    lasso_launches = k5.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    theta = est.theta.larray
    print(f"[e2e] lasso fit ({m},{n}) x{LASSO_SWEEPS} sweeps: {fit_s:.3f} s, peak {peak_gb:.2f} GB, "
          f"lasso_sweep launches {lasso_launches} (expected {LASSO_SWEEPS}), n_iter {est.n_iter}")
    check(lasso_launches == LASSO_SWEEPS, f"lasso_sweep launches {lasso_launches} != {LASSO_SWEEPS}")
    check(est.n_iter == LASSO_SWEEPS, f"n_iter {est.n_iter} != {LASSO_SWEEPS}")
    check(tuple(theta.shape) == (n + 1, 1) and bool(torch.isfinite(theta).all()), "bad theta")
    # ms per sweep, timed after the counted run (Xᵀ made once, outside)
    xt = lasso_mod._augmented_t(xl.larray)
    yv = yl.larray.reshape(-1).contiguous()
    th0 = torch.zeros(n + 1, device=dev)
    lasso_mod._cd_fit(xt, yv, th0, 0.01, 1, -1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lasso_mod._cd_fit(xt, yv, th0, 0.01, LASSO_SWEEPS, -1.0)
    torch.cuda.synchronize()
    sweep_ms = 1e3 * (time.perf_counter() - t0) / LASSO_SWEEPS
    print(f"[e2e] lasso {sweep_ms:.4f} ms/sweep ({m},{n + 1}) on {card}")
    trace("Lasso sweep", lambda: lasso_mod._cd_fit(xt, yv, th0, 0.01, 2, -1.0), 2)
    del xt, yv
    torch.cuda.empty_cache()
    # at the default tol the fit recovers β's support
    est2 = ht.regression.Lasso(lam=0.01).fit(xl, yl)
    coef = est2.coef_.larray.reshape(-1)
    support = set((coef.abs() > 1e-3).nonzero().flatten().tolist())
    true_support = set(range(0, n, max(n // 16, 1)))
    coef_err = float((coef - beta.reshape(-1)).abs().max())
    rmse = est2.rmse(yl, est2.predict(xl))
    print(f"[e2e] lasso default tol: n_iter {est2.n_iter}, support {len(support)} features "
          f"(true {len(true_support)}, equal {support == true_support}), max|coef-beta| {coef_err:.4e}, "
          f"intercept {float(est2.intercept_):.3e}, rmse {rmse:.6e}")
    check(support == true_support, "the Lasso fit did not recover beta's support")
    check(coef_err <= 0.05, f"max|coef - beta| {coef_err} > 0.05")
    del xl, yl, est, est2
    torch.cuda.empty_cache()

    # small inputs: QR and Lasso on the card and on the CPU (plain versions)
    mesh = ht.MeshComm(4)
    small = torch.randn(4096, 64, generator=gen, device=dev)
    qa = ht.linalg.qr(ht.array(small, split=0))
    qb = ht.linalg.qr(ht.array(small.cpu(), split=0, device="cpu"))
    r_diff = float((qa.R.larray.cpu() - qb.R.larray).abs().max() / qb.R.larray.abs().max())
    q_diff = float((qa.Q.larray.cpu() - qb.Q.larray).abs().max())
    print(f"[e2e] small qr (4096,64) card vs cpu: max|dR|/max|R| {r_diff:.3e}, max|dQ| {q_diff:.3e}")
    check(r_diff <= 1e-5 and q_diff <= 1e-4, "small qr differs between card and CPU")
    xs = torch.randn(5000, 30, generator=gen, device=dev)
    ys = xs[:, ::3].sum(1, keepdim=True) + 0.01 * torch.randn(5000, 1, generator=gen, device=dev)
    la = ht.regression.Lasso(lam=0.01).fit(ht.array(xs, split=0, comm=mesh), ht.array(ys, split=0, comm=mesh))
    lb = ht.regression.Lasso(lam=0.01).fit(
        ht.array(xs.cpu(), split=0, comm=mesh, device="cpu"), ht.array(ys.cpu(), split=0, comm=mesh, device="cpu")
    )
    t_diff = float((la.theta.larray.cpu() - lb.theta.larray).abs().max())
    print(f"[e2e] small lasso (5000,30) card vs cpu: n_iter {la.n_iter}/{lb.n_iter}, max|dtheta| {t_diff:.3e}")
    check(la.n_iter == lb.n_iter and t_diff <= 1e-5, "small Lasso fit differs between card and CPU")
    del xs, ys, la, lb, qa, qb, small
    torch.cuda.empty_cache()

    # ht.sparse.matmul at the SpMV cell: the matrix enters as a scipy CSR,
    # as a user's would; its ELL slabs are packed on the card at first use
    t0 = time.perf_counter()
    a_sp = ht.sparse.sparse_csr_matrix(to_scipy(sp_vals, sp_cols, sp_ptr, (SPMV_N, SPMV_N)), split=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k6.launches = 0
    calls = 0
    spmv_call_ms = {}
    for k in (1, SPMV_K):
        xv = ht.array(sp_x[:, 0] if k == 1 else sp_x)
        y = ht.sparse.matmul(a_sp, xv)
        torch.cuda.synchronize()
        calls += 1
        want = k6.reference_spmv_ell(*spmm_mod._ell_slabs(a_sp)[0], xv.larray)
        err = float((y.larray - want).abs().max())
        t0 = time.perf_counter()
        for _ in range(20):
            y = ht.sparse.matmul(a_sp, xv)
        torch.cuda.synchronize()
        spmv_call_ms[k] = 1e3 * (time.perf_counter() - t0) / 20
        calls += 20
        print(f"[e2e] sparse.matmul ({SPMV_N}^2, nnz {a_sp.nnz}) k={k}: {spmv_call_ms[k]:.4f} ms/call, "
              f"max|y - plain| {err:.3e}, shape {y.shape} split {y.split} on {card}")
        check(tuple(y.shape) == ((SPMV_N,) if k == 1 else (SPMV_N, k)) and y.split == 0, "sparse.matmul: bad shape or split")
        check(err <= 1e-4, f"sparse.matmul k={k}: error {err:.3e} against the plain version")
    matmul_launches = k6.launches
    print(f"[e2e] sparse.matmul: matrix set-up {setup_s:.3f} s (host canonicalisation and copy), "
          f"spmv launches {matmul_launches} over {calls} calls")
    check(matmul_launches == calls, f"spmv launches {matmul_launches} != calls {calls}")
    del a_sp, y, want, sp_vals, sp_cols, sp_ptr, sp_x
    torch.cuda.empty_cache()

    # Spectral(affinity="knn") on the repo's two blobs
    sigma = 0.5**0.5  # gamma = 1
    data, truth = two_blobs(KNNG_N, KNNG_F, gen, dev)
    x_ht = ht.array(data, split=0)
    ht.random.seed(args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k6.launches = 0
    k1.launches = 0
    t0 = time.perf_counter()
    spec = ht.cluster.Spectral(n_clusters=2, gamma=1.0, affinity="knn", n_neighbors=KNNG_K, n_lanczos=KNNG_LANCZOS)
    spec.fit(x_ht)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    spectral_launches, spectral_k1 = k6.launches, k1.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    km_iters = spec._cluster.n_iter_
    label_share = blob_agreement(spec.labels_.larray, truth)
    print(f"[e2e] spectral knn fit ({KNNG_N},{KNNG_F}) k={KNNG_K} m={KNNG_LANCZOS}: {fit_s:.3f} s, peak {peak_gb:.3f} GB "
          f"(a dense affinity would be {4 * KNNG_N**2 / 1e9:.1f} GB), spmv launches {spectral_launches} "
          f"(expected {KNNG_LANCZOS}), cdist launches {spectral_k1} (kmeans++ 2 + Lloyd {km_iters} + labels 1), "
          f"labels agree with the blobs on {label_share:.6f} of points on {card}")
    check(spectral_launches == KNNG_LANCZOS, f"spmv launches {spectral_launches} != {KNNG_LANCZOS}")
    check(spectral_k1 == 2 + km_iters + 1, f"cdist launches {spectral_k1} != {3 + km_iters}")
    check(peak_gb <= 4.0, f"spectral fit peak {peak_gb:.3f} GB > 4 GB")
    check(tuple(spec.labels_.shape) == (KNNG_N, 1), "spectral: bad labels shape")
    # the fit's stages one by one, each ending in a synchronize
    stage = {}

    def staged(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage[name] = time.perf_counter() - t
        return out

    xs_ = data.contiguous()
    sq = torch.sum(xs_ * xs_, dim=1)
    staged("distance tiles + top-k", lambda: [knn_mod._knn_tile(xs_[o : o + knn_mod._TILE_ROWS], xs_, sq, o, KNNG_K)
                                               for o in range(0, KNNG_N, knn_mod._TILE_ROWS)])
    graph = staged("knn_graph", lambda: ht.sparse.knn_graph(x_ht, KNNG_K, sigma=sigma, bucket_cap=True))
    lap = staged("laplacian", lambda: ht.graph.laplacian_sparse(graph))
    v0 = ht.array(torch.sin(torch.arange(1, KNNG_N + 1, dtype=torch.float32, device=dev)))
    V, T = staged("lanczos", lambda: ht.lanczos(lap, KNNG_LANCZOS, v0=v0))
    evals, evecs = staged("eigh + embedding", lambda: torch.linalg.eigh(T.larray))
    emb = V.larray @ evecs
    staged("kmeans", lambda: ht.cluster.KMeans(n_clusters=2, init="kmeans++").fit(ht.array(emb[:, :2].contiguous(), split=0)))
    host_s = stage["knn_graph"] - stage["distance tiles + top-k"]
    print("[e2e] spectral knn stages: " + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in stage.items())
          + f"; of knn_graph, {1e3 * host_s:.2f} ms is the host's scipy assembly and copies, nnz {graph.nnz}")
    trace(f"Lanczos over the knn Laplacian ({KNNG_N}, nnz {lap.nnz}, {KNNG_LANCZOS} steps)",
          lambda: ht.lanczos(lap, KNNG_LANCZOS, v0=v0), 1)
    # Lanczos over K6 against the same recurrence over the plain version
    from heat_tpu_torch.core.linalg import solver as solver_mod

    slabs = spmm_mod._ell_slabs(lap)
    vn = v0.larray / torch.linalg.vector_norm(v0.larray)
    _, pa, pb = solver_mod._lanczos_loop(
        slabs, vn, KNNG_LANCZOS, lambda ops, v: torch.cat([k6.reference_spmv_ell(a, c, v) for a, c in ops])
    )
    t_plain = torch.diag(pa) + torch.diag(pb, 1) + torch.diag(pb, -1)
    ritz_err = float((torch.linalg.eigvalsh(t_plain)[:4] - evals[:4]).abs().max())
    degree = torch.zeros(KNNG_N, device=dev)
    for (d_, i_, p_), (lo, _) in zip(graph._shards, [graph._row_range(r) for r in range(graph.nshards)]):
        rows_ = torch.repeat_interleave(torch.arange(p_.numel() - 1, device=dev), (p_[1:] - p_[:-1]).long()) + lo
        degree.index_add_(0, rows_, torch.where(i_.long() == rows_, torch.zeros_like(d_), d_))
    comp_share = component_agreement(emb[:, 0], degree, truth)
    print(f"[e2e] spectral knn: smallest Ritz values {evals[:4].tolist()}, against the plain recurrence "
          f"max|dtheta| {ritz_err:.3e} (tolerance 1e-4); the first embedding column splits the blobs on "
          f"{comp_share:.6f} of points")
    check(ritz_err <= 1e-4, f"spectral knn: Ritz values {ritz_err:.3e} from the plain recurrence")
    check(comp_share >= 0.999, f"spectral knn: the embedding splits the blobs on {comp_share:.6f} < 0.999")
    check(bool(torch.isfinite(emb).all()), "spectral knn: non-finite embedding")
    del data, x_ht, spec, graph, lap, V, T, emb, slabs, degree, xs_, sq
    torch.cuda.empty_cache()

    # dense Spectral(affinity="rbf") on the same recipe at 16384 points
    data, truth = two_blobs(RBF_N, KNNG_F, gen, dev)
    x_ht = ht.array(data, split=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    t0 = time.perf_counter()
    spec = ht.cluster.Spectral(n_clusters=2, gamma=1.0, affinity="rbf", n_lanczos=KNNG_LANCZOS).fit(x_ht)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rbf_k1 = k1.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    km_iters = spec._cluster.n_iter_
    label_share = blob_agreement(spec.labels_.larray, truth)
    evals, emb = spec._spectral_embedding(x_ht)
    aff = ht.spatial.rbf(x_ht, sigma=sigma).larray
    degree = aff.sum(1) - torch.diagonal(aff)
    comp_share = component_agreement(emb[:, 0], degree, truth)
    print(f"[e2e] spectral rbf fit ({RBF_N},{KNNG_F}) m={KNNG_LANCZOS}: {fit_s:.3f} s, peak {peak_gb:.3f} GB, cdist "
          f"launches {rbf_k1} (rbf 1 + kmeans++ 2 + Lloyd {km_iters} + labels 1), labels agree with the blobs on "
          f"{label_share:.6f} of points, the first embedding column splits them on {comp_share:.6f} on {card}")
    check(rbf_k1 == 1 + 2 + km_iters + 1, f"rbf cdist launches {rbf_k1} != {4 + km_iters}")
    check(comp_share >= 0.999, f"spectral rbf: the embedding splits the blobs on {comp_share:.6f} < 0.999")
    check(bool(torch.isfinite(emb).all()), "spectral rbf: non-finite embedding")
    del data, x_ht, spec, emb, aff, degree
    torch.cuda.empty_cache()

    # small input: a k-NN fit on the card and on the CPU (two blobs whose
    # graph is connected, 60 Lanczos steps: a well-posed clustering; the
    # recipe of tests/test_torch_spectral.py::_blobs)
    rng = np.random.default_rng(args.seed + 3)
    sx = torch.from_numpy(np.concatenate([rng.normal(0, 1, (200, 4)), rng.normal(3, 1, (200, 4))]).astype(np.float32)).to(dev)
    mesh = ht.MeshComm(4)
    kw = dict(n_clusters=2, gamma=1.0, affinity="knn", n_neighbors=6, n_lanczos=60)
    sa = ht.cluster.Spectral(**kw).fit(ht.array(sx, split=0, comm=mesh))
    sb = ht.cluster.Spectral(**kw).fit(ht.array(sx.cpu(), split=0, comm=mesh, device="cpu"))
    la_, lb_ = sa.labels_.larray.reshape(-1).cpu(), sb.labels_.larray.reshape(-1)
    same_small = bool(torch.equal(la_, lb_) or torch.equal(la_, 1 - lb_))
    small_share = blob_agreement(la_, torch.arange(400) >= 200)
    print(f"[e2e] small spectral knn (400,4) card vs cpu: labels equal up to naming {same_small}, "
          f"blobs recovered on {small_share:.4f} of points")
    check(same_small, "small spectral fit differs between card and CPU")

    # ---------------------------------------------------------- 6. summary
    kernels = [
        {
            "name": "cdist",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/cdist.cu",
            "replaces": "heat_tpu/ops/cdist.py:32",
            "launches": launches,
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        },
        {
            "name": "qr_panel",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/qr_panel.cu",
            "replaces": "heat_tpu/ops/qr_panel.py:89",
            "launches": qr_launches,
            "max_abs_err": k4_abs,
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound_ms,
            "bound_by": k4_bound_by,
            "library_ms": k4_library_ms,
        },
        {
            "name": "lasso_sweep",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/lasso_sweep.cu",
            "replaces": "heat_tpu/ops/lasso_sweep.py:66",
            "launches": lasso_launches,
            "max_abs_err": k5_abs,
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound_ms,
            "bound_by": k5_bound_by,
            "library_ms": None,
            "library_note": "no library call computes a coordinate-descent sweep",
        },
        {
            "name": "spmv",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/spmv.cu",
            "replaces": "heat_tpu/ops/spmv.py:117",
            "launches": matmul_launches + spectral_launches,
            "max_abs_err": k6_abs,
            "ms": k6_times[1][0],
            "plain_ms": k6_times[1][1],
            "bound_ms": k6_times[1][3],
            "bound_by": k6_times[1][4],
            "library_ms": k6_times[1][2],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
