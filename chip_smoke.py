"""Drive heat_tpu_torch's KMeans, QR, Lasso, sparse Spectral, TransformerLM
and transport (reshape, resplit, advanced getitem) paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed 0]

Phases: (1) identity of the card and toolchain; (2) build every kernel of
the paths from the sources in this checkout, all at once; (3) each kernel
against its plain torch version at the shapes the paths give it, with a
trace showing that a bf16 call of K3 and of K2 runs only its tensor-core
kernel; (4) kernel
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
config.py:220-223), and a dense ``affinity="rbf"`` fit at 16384 x 16; the
default ``TransformerLM`` (vocab 32000, 4 layers, 8 heads x 64, built from a
flax-layout tree made from ``--seed``) forward on 8 x 2048 tokens,
``sequence_parallel_attention`` (ring, Ulysses) over 4 positions and
``ops.pallas_matmul`` at 8192^2 (benchmarks/cb/config.py:151); and over
``MeshComm(4)`` positions of the card the transport engine: split-crossing
``reshape`` at the benchmark's (999999, 20) -> (1999998, 10) and at 2.4 GB,
a shift-carrying and a split-1 reshape, ``resplit`` at (4e6, 128), a mask
getitem and an int-array take over 1e7 rows (benchmarks/cb/kernels.py:57-85,
manipulations.py:16-30, :138-148); each with
data made on the card from ``--seed``, and a small input of each on the card
and on the CPU; (6) one JSON line per kernel.  The last line is
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
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16/f16 tensor cores
# K3: |Δo| <= TOL_ATTN (f32; unit-normal inputs, sums in other orders); for
# bf16/f16 |Δo| <= TOL_ATTN_16 + 2^-7 |o|: both round p to the input's type
# (at other points: the kernel its running, unnormalised p), the plain
# version also rounds the scores, and each output is rounded once (a bf16
# half-ulp is 2^-8 |o|)
TOL_ATTN, TOL_ATTN_16 = 2e-5, 1e-2
# K2: |Δc| <= TOL_MM * max(|a|·|b|) in f32; in bf16 one rounding of the f32 sum,
# |Δc| <= 2^-7 |c| + 1e-3
TOL_MM = 1e-5
# the model's logits against the same model with the plain attention, and
# the card against the CPU: |Δ| <= TOL_LM * max|logit|
TOL_LM = 1e-4
# TransformerLM's defaults (heat_tpu/models/transformer.py:157-171) at
# batch 8 x 2048 tokens; the benchmark's attention and GEMM shapes
# (benchmarks/cb/config.py:174, :151)
LM = dict(vocab_size=32_000, num_layers=4, num_heads=8, head_dim=64, mlp_ratio=4, max_seq_len=2048)
LM_BATCH = 8
ATTN_BH, ATTN_S, ATTN_D = 16, 4096, 128
MATMUL_N = 8192
# K7 and the transport engine over 4 positions of the one card: the
# benchmark's reshape_repack (benchmarks/cb/config.py:186-188,
# benchmarks/cb/kernels.py:57-85) and a 30x larger one past 2^31 bytes; a
# shift-carrying reshape whose source position 3 is empty; the
# split-crossing chain of benchmarks/cb/manipulations.py:16-30 at its
# largest size (config.py:169); resplit_at_scale (manipulations.py:138-148,
# config.py:173); a mask getitem and an int-array take over 1e7 rows
TRANSPORT_MESH = 4
REPACK_IN, REPACK_OUT = (999_999, 20), (1_999_998, 10)
REPACK_BIG_IN, REPACK_BIG_OUT = (29_999_999, 20), (59_999_998, 10)
SHIFT_IN, SHIFT_OUT = (6, 4_000_000), (2_400_000, 10)
CHAIN_IN, CHAIN_OUT = (1000, 40_000), (4_000_000, 10)
RESPLIT_N = 4_000_000
SELECT_ROWS, TAKE_ROWS = 10_000_000, 2_000_000


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


def trace(label: str, fn, iters: int) -> list:
    """Device time per unit by kernel, from torch.profiler, and the device's
    idle share of the traced window; ``fn`` runs ``iters`` units.  Returns
    the CUDA-typed rows (device µs, count, name)."""
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
        return rows
    print(f"[trace] {label} x{iters}: device busy {busy / 1e3 / iters:.4f} ms per unit of "
          f"{wall_us / 1e3 / iters:.4f} ms wall under the profiler, idle share {1 - busy / wall_us:.4f}")
    for us, count, name in sorted(rows, reverse=True)[:10]:
        print(f"[trace]   {us / 1e3 / iters:9.4f} ms/unit  x{count / iters:<5g} {name[:100]}")
    return rows


def attention_bound_ms(bh: int, sq: int, sk: int, d: int, causal: bool, itemsize: int):
    """Least time for one attention call: q, k, v read once and o written
    once, against 4 flops per live (query, key) pair and feature (the two
    products); causal counts only the pairs on or below the diagonal.  f32
    at the CUDA cores' peak, 16-bit types at the dense tensor-core peak."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    nbytes = itemsize * bh * d * (2 * sq + 2 * sk)
    peak = F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4.0 * bh * pairs * d / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def matmul_bound_ms(m: int, k: int, n: int, itemsize: int):
    """Least time for (m,k)x(k,n): each operand read once and c written
    once, against 2 m n k flops (f32 at the CUDA cores' peak, 16-bit types at
    the dense tensor-core peak)."""
    peak = F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    t_bytes, t_ops = itemsize * (m * k + k * n + m * n) / HBM_BYTES_PER_S, 2.0 * m * n * k / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(k3, gen, dev):
    """K3 against its plain version at the model's shape, the benchmark's
    shape in bf16 and f32, a ragged cross attention, the tensor-core
    kernel's head dims 64 and 256 and a row of 40 bytes (d = 20, which TMA
    cannot describe), and its reruns; returns the largest f32 and 16-bit
    |Δo|."""
    worst, worst_16 = 0.0, 0.0
    cases = [((64, 2048, 2048, 64), torch.float32, True)]
    cases += [((ATTN_BH, ATTN_S, ATTN_S, ATTN_D), dt, c) for dt in (torch.bfloat16, torch.float32) for c in (True, False)]
    cases += [((4, 1000, 1337, 24), torch.float32, c) for c in (True, False)]
    cases += [((4, 1000, 1337, 24), torch.float16, True), ((2, 77, 77, 256), torch.float32, True)]
    cases += [((ATTN_BH, 2048, 2048, 64), torch.bfloat16, True), ((4, 1024, 1024, 256), torch.bfloat16, False)]
    cases += [((4, 1000, 1337, 20), torch.bfloat16, c) for c in (True, False)]
    for (bh, sq, sk, d), dt, causal in cases:
        q, k, v = (torch.randn(bh, n, d, generator=gen, device=dev).to(dt) for n in (sq, sk, sk))
        got = k3.flash_attention(q, k, v, causal=causal)
        again = k3.flash_attention(q, k, v, causal=causal)
        want = k3.reference_flash_attention(q, k, v, causal=causal)
        exact = k3.reference_flash_attention(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        check(got.dtype == dt and tuple(got.shape) == (bh, sq, d), f"attention shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()), "non-finite attention output")
        check(torch.equal(got, again), f"attention ({bh},{sq},{sk},{d}) {dt}: reruns are not bitwise equal")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        err_exact = float((got.float() - exact).abs().max())
        if dt == torch.float32:
            ok, tol = err <= TOL_ATTN, f"{TOL_ATTN:g}"
        else:
            ok, tol = bool((diff <= TOL_ATTN_16 + 2.0**-7 * want.float().abs()).all()), f"{TOL_ATTN_16:g} + 2^-7 |o|"
        print(f"[check] attention ({bh},{sq},{d})x({bh},{sk},{d}) {str(dt)[6:]} causal={causal}: max_abs_err={err:.3e} "
              f"(tolerance {tol}), against f32 plain on the same inputs {err_exact:.3e}, reruns bitwise equal")
        check(ok, f"attention ({bh},{sq},{sk},{d}) {dt} causal={causal}: error {err:.3e} above {tol}")
        if dt == torch.float32:
            worst = max(worst, err)
        else:
            worst_16 = max(worst_16, err)
        del q, k, v, got, again, want, exact
    torch.cuda.empty_cache()
    return worst, worst_16


def offset_randn(shape, dtype, gen, dev) -> torch.Tensor:
    """A contiguous normal matrix whose base lies 2 bytes past a 16-byte
    boundary (a view one element into its buffer)."""
    n = shape[0] * shape[1]
    return torch.randn(n + 1, generator=gen, device=dev).to(dtype)[1:].view(shape)


def check_matmul(k2, gen, dev):
    """K2 against its plain version at 8192^2 (f32, bf16), a ragged
    (1000x777)(777x1333) in f32, bf16 and f16 (rows of 1554 and 2666 bytes,
    which TMA cannot describe), 1x1, bf16 operands off 16-byte alignment,
    and bf16 at k = 8200 (not a multiple of the 64-deep tile); every case
    reruns bitwise equal.  Returns the largest f32 and 16-bit |Δc|."""
    worst, worst_16 = 0.0, 0.0
    cases = [((m, k, n), dt, False) for (m, k, n) in [(MATMUL_N, MATMUL_N, MATMUL_N), (1000, 777, 1333), (1, 1, 1)]
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1000, 777, 1333), torch.float16, False), ((2048, 2048, 2048), torch.bfloat16, True),
              ((1000, 777, 1333), torch.bfloat16, True), ((MATMUL_N, MATMUL_N + 8, MATMUL_N), torch.bfloat16, False)]
    for (m, k, n), dt, offset in cases:
        if offset:
            a, b = offset_randn((m, k), dt, gen, dev), offset_randn((k, n), dt, gen, dev)
            check(a.data_ptr() % 16 != 0 and b.data_ptr() % 16 != 0, "offset operands are aligned")
        else:
            a = torch.randn(m, k, generator=gen, device=dev).to(dt)
            b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        got = k2.matmul(a, b)
        again = k2.matmul(a, b)
        want = k2.reference_matmul(a, b).float()
        torch.cuda.synchronize()
        check(got.dtype == dt and tuple(got.shape) == (m, n), f"matmul shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()), "non-finite matmul output")
        check(torch.equal(got, again), f"matmul ({m},{k})x({k},{n}) {dt}: reruns are not bitwise equal")
        err = float((got.float() - want).abs().max())
        if dt == torch.float32:
            scale = float((a.abs() @ b.abs()).max())
            ok, tol = err <= TOL_MM * scale, f"{TOL_MM:g} * max(|a||b|) = {TOL_MM * scale:.3e}"
            worst = max(worst, err)
        else:
            ok, tol = bool(((got.float() - want).abs() <= 2.0**-7 * want.abs() + 1e-3).all()), "2^-7 |c| + 1e-3"
            worst_16 = max(worst_16, err)
        where = ", bases off 16-byte alignment" if offset else ""
        print(f"[check] matmul ({m},{k})x({k},{n}) {str(dt)[6:]}{where}: max_abs_err={err:.3e} (tolerance {tol}), "
              f"reruns bitwise equal")
        check(ok, f"matmul ({m},{k})x({k},{n}) {dt}: error {err:.3e} above tolerance")
        del a, b, got, again, want
    torch.cuda.empty_cache()
    return worst, worst_16


def tensor_core_trace(k3, k2, gen, dev) -> None:
    """One bf16 call of each of K3 and K2 under torch.profiler: each runs
    its tensor-core kernel and no other kernel (no SDPA, no cuBLAS, no
    CUDA-core K2/K3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (torch.randn(ATTN_BH, ATTN_S, ATTN_D, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    a, b = (torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    for name, fn, want in [("flash_attention", lambda: k3.flash_attention(q, k, v), "flash_fwd_kernel_tc"),
                           ("pallas_matmul", lambda: k2.matmul(a, b), "mm_tc_kernel")]:
        fn()
        # a trace that recorded no device event at all is taken again: it
        # says nothing about which kernels ran
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if names:
                break
        print(f"[trace] one bf16 {name} call runs: {names}")
        check(len(names) == 1 and want in names[0], f"bf16 {name} ran {names}, not {want} alone")
    del q, k, v, a, b
    torch.cuda.empty_cache()


def time_attention(k3, gen, dev, card: str) -> dict:
    """K3 beside its plain version, SDPA (a yardstick only) and its bound:
    at the model's (64, 2048, 64) f32 causal, and at the benchmark's
    (16, 4096, 128) in bf16 causal and not, and f32 causal."""
    import torch.nn.functional as F

    times = {}
    for bh, s, d, dt, causal in [(64, 2048, 64, torch.float32, True), (ATTN_BH, ATTN_S, ATTN_D, torch.bfloat16, True),
                                 (ATTN_BH, ATTN_S, ATTN_D, torch.bfloat16, False), (ATTN_BH, ATTN_S, ATTN_D, torch.float32, True)]:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev).to(dt) for _ in range(3))
        q4, k4_, v4 = q[None], k[None], v[None]
        t_k = time_ms(lambda: k3.flash_attention(q, k, v, causal=causal), reps=10)
        t_p = time_ms(lambda: k3.reference_flash_attention(q, k, v, causal=causal), reps=3)
        t_l = time_ms(lambda: F.scaled_dot_product_attention(q4, k4_, v4, is_causal=causal), reps=10)
        t_k2 = time_ms(lambda: k3.flash_attention(q, k, v, causal=causal), reps=10)
        b_ms, b_by = attention_bound_ms(bh, s, s, d, causal, q.element_size())
        times[(bh, s, d, str(dt)[6:], causal)] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"[time] attention ({bh},{s},{d}) {str(dt)[6:]} causal={causal}: kernel_ms={t_k:.4f} (again {t_k2:.4f}) "
              f"plain_ms={t_p:.4f} library_ms={t_l:.4f} (F.scaled_dot_product_attention) bound_ms={b_ms:.4f} ({b_by}) on {card}")
        del q, k, v, q4, k4_, v4
    torch.cuda.empty_cache()
    return times


def time_matmul(k2, gen, dev, card: str) -> dict:
    """K2 at 8192^2 in f32 and bf16 beside its plain version (the f32
    product, cast), torch.matmul with TF32 off, and the 2n^3 bound."""
    times = {}
    n = MATMUL_N
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn(n, n, generator=gen, device=dev).to(dt)
        b = torch.randn(n, n, generator=gen, device=dev).to(dt)
        t_k = time_ms(lambda: k2.matmul(a, b), reps=5)
        t_p = time_ms(lambda: k2.reference_matmul(a, b), reps=5)
        t_l = time_ms(lambda: torch.matmul(a, b), reps=5)
        t_k2 = time_ms(lambda: k2.matmul(a, b), reps=5)
        b_ms, b_by = matmul_bound_ms(n, n, n, a.element_size())
        times[str(dt)[6:]] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"[time] matmul {n}^2 {str(dt)[6:]}: kernel_ms={t_k:.4f} (again {t_k2:.4f}) plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} (torch.matmul, tf32 off) bound_ms={b_ms:.4f} ({b_by}) on {card}")
        del a, b
    torch.cuda.empty_cache()
    return times


def flax_layout_params(seed: int, vocab_size, num_layers, num_heads, head_dim, mlp_ratio, max_seq_len) -> dict:
    """A TransformerLM parameter tree in flax's layout and names, as numpy
    arrays drawn from ``seed`` with flax's initialisers: normal embeddings of
    std 1/sqrt(D), truncated-normal (±2σ) LeCun kernels, unit scales."""
    rng = np.random.default_rng(seed)
    dim = num_heads * head_dim

    def lecun(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        bad = np.abs(x) > 2
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum())).astype(np.float32)
            bad = np.abs(x) > 2
        return x * np.float32(1.0 / np.sqrt(shape[0]) / 0.87962566103423978)

    def embed(n):
        return {"embedding": rng.standard_normal((n, dim)).astype(np.float32) / np.float32(np.sqrt(dim))}

    params = {"embed": embed(vocab_size), "pos_embed": embed(max_seq_len), "final_norm": {"scale": np.ones(dim, np.float32)}}
    for i in range(num_layers):
        params[f"block_{i}"] = {
            "LayerNorm_0": {"scale": np.ones(dim, np.float32)},
            "LayerNorm_1": {"scale": np.ones(dim, np.float32)},
            "attn": {"qkv": {"kernel": lecun(dim, 3, num_heads, head_dim)}, "out": {"kernel": lecun(dim, dim)}},
            "mlp_in": {"kernel": lecun(dim, dim * mlp_ratio)},
            "mlp_out": {"kernel": lecun(dim * mlp_ratio, dim)},
        }
    return {"params": params}


def forward_shares(rows) -> None:
    """Print the device time of a traced forward by kind (``rows`` from
    :func:`trace`): K3, the GEMMs, and everything else (layer norms, GELU,
    adds, the embedding gather, copies)."""
    kinds = {"attention (K3)": 0.0, "GEMM": 0.0, "other": 0.0}
    for us, _, name in rows:
        kind = "attention (K3)" if "flash_fwd_kernel" in name else "GEMM" if "gemm" in name.lower() else "other"
        kinds[kind] += us / 1e3
    busy = sum(kinds.values())
    if busy:
        print("[trace] forward by kind: " + ", ".join(f"{k} {v:.4f} ms ({v / busy:.4f})" for k, v in kinds.items()))


def transformer_paths(ht, k3, k2, seed: int, dev, card: str) -> dict:
    """The slice end to end: the default TransformerLM forward at 8 x 2048
    tokens (K3 launches, logits against the plain attention, causality,
    time, memory, trace), sequence-parallel attention at the model's width,
    K3's gradient, a small model on the card and the CPU, and
    ``ops.pallas_matmul`` at 8192^2.  Returns the launch counts."""
    tmod = importlib.import_module("heat_tpu_torch.models.transformer")
    t0 = time.perf_counter()
    params = flax_layout_params(seed, **LM)
    model = ht.models.transformer_from_flax(params, device="gpu")
    model.eval()
    del params
    torch.cuda.synchronize()
    print(f"[e2e] TransformerLM {LM} from a flax-layout tree made from seed {seed}: {time.perf_counter() - t0:.3f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    tokens = torch.randint(0, LM["vocab_size"], (LM_BATCH, LM["max_seq_len"]), generator=gen, device=dev)
    n_tok = tokens.numel()
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k3.launches = 0
        t0 = time.perf_counter()
        logits = model(tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        forward_launches = k3.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(forward_launches == LM["num_layers"], f"attention launches {forward_launches} != {LM['num_layers']}")
        check(tuple(logits.shape) == (LM_BATCH, LM["max_seq_len"], LM["vocab_size"]), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            model(tokens)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0) / reps
        print(f"[e2e] forward ({LM_BATCH},{LM['max_seq_len']}): {fwd_ms:.4f} ms per forward ({n_tok / fwd_ms * 1e3:.4e} tokens/s; "
              f"first call {1e3 * first_s:.1f} ms), peak {peak_gb:.3f} GB, attention launches {forward_launches} "
              f"(expected {LM['num_layers']}), max|logit| {float(logits.abs().max()):.4f} on {card}")
        forward_shares(trace("TransformerLM forward", lambda: model(tokens), 1))
        # the same model with the plain attention in place of K3
        orig = tmod.flash_attention
        tmod.flash_attention = k3.reference_flash_attention
        try:
            plain = model(tokens)
        finally:
            tmod.flash_attention = orig
        scale = float(plain.abs().max())
        err = float((logits - plain).abs().max())
        del plain
        print(f"[e2e] logits against the plain attention: max_abs_err {err:.3e} (tolerance {TOL_LM:g} * {scale:.4f})")
        check(err <= TOL_LM * scale, f"logits differ from the plain attention's by {err:.3e}")
        # causality: a new last token leaves every earlier position unchanged
        changed = tokens.clone()
        changed[:, -1] = (changed[:, -1] + 1) % LM["vocab_size"]
        other = model(changed)
        before = float((other[:, :-1] - logits[:, :-1]).abs().max())
        last = float((other[:, -1] - logits[:, -1]).abs().max())
        print(f"[e2e] causality: changing the last token moves earlier logits by {before:.3e} (tolerance "
              f"{TOL_LM * 0.01:g} * max|logit|), the last position's by {last:.3e}")
        check(before <= TOL_LM * 0.01 * scale and last > 0, "a change of the last token reached an earlier position")
        del logits, other, changed

        # sequence parallelism over 4 positions, one layer at the model's width
        h, d, s = LM["num_heads"], LM["head_dim"], LM["max_seq_len"]
        q, k, v = (torch.randn(LM_BATCH, h, s, d, generator=gen, device=dev) for _ in range(3))
        dense = k3.flash_attention(q, k, v, causal=True)
        ulysses_launches = 0
        for strategy in ("ulysses", "ring"):
            k3.launches = 0
            t0 = time.perf_counter()
            got = ht.parallel.sequence.sequence_parallel_attention(q, k, v, ht.MeshComm(4), causal=True, strategy=strategy)
            torch.cuda.synchronize()
            call_ms = 1e3 * (time.perf_counter() - t0)
            want_launches = 4 if strategy == "ulysses" else 0
            err = float((got - dense).abs().max())
            print(f"[e2e] sequence_parallel_attention {strategy} ({LM_BATCH},{h},{s},{d}) over MeshComm(4): "
                  f"{call_ms:.3f} ms, attention launches {k3.launches} (expected {want_launches}), "
                  f"max|Δ| against dense flash_attention {err:.3e} (tolerance {TOL_ATTN:g})")
            check(k3.launches == want_launches, f"{strategy}: attention launches {k3.launches} != {want_launches}")
            check(err <= TOL_ATTN, f"{strategy}: error {err:.3e} against dense flash_attention")
            if strategy == "ulysses":
                ulysses_launches = k3.launches
        del q, k, v, dense, got

    # K3's gradient (backward recomputes the plain version) against autograd
    q, k, v = (torch.randn(2, 8, 512, 64, generator=gen, device=dev).requires_grad_() for _ in range(3))
    w = torch.randn(2, 8, 512, 64, generator=gen, device=dev)
    (k3.flash_attention(q, k, v, causal=True) * w).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (k3.reference_flash_attention(q, k, v, causal=True) * w).sum().backward()
    gerr = max(float((a - t.grad).abs().max()) for a, t in zip(grads, (q, k, v)))
    print(f"[e2e] flash_attention gradient (2,8,512,64) causal against autograd through the plain version: max|Δ| {gerr:.3e} (tolerance 1e-5)")
    check(gerr <= 1e-5, f"flash_attention gradient differs by {gerr:.3e}")
    del q, k, v, w, grads

    # a small model on the card and on the CPU
    small = dict(vocab_size=50, num_layers=2, num_heads=4, head_dim=8, max_seq_len=32)
    cpu_model = ht.models.TransformerLM(**small, device="cpu", generator=torch.Generator().manual_seed(seed))
    card_model = ht.models.TransformerLM(**small, device="gpu")
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(0, 50, (2, 32), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a_, b_ = card_model(toks.to(dev)).cpu(), cpu_model(toks)
    serr = float((a_ - b_).abs().max())
    print(f"[e2e] small TransformerLM {small} card vs cpu: max|Δlogit| {serr:.3e} (tolerance {TOL_LM:g} * {float(b_.abs().max()):.4f})")
    check(serr <= TOL_LM * float(b_.abs().max()), "small TransformerLM differs between card and CPU")

    # ops.pallas_matmul through the entry point
    n = MATMUL_N
    a = torch.randn(n, n, generator=gen, device=dev)
    b = torch.randn(n, n, generator=gen, device=dev)
    k2.launches = 0
    t0 = time.perf_counter()
    c = ht.ops.pallas_matmul(a, b)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    mm_launches = k2.launches
    err = float((c - a @ b).abs().max())
    scale = float((a.abs() @ b.abs()).max())
    print(f"[e2e] ops.pallas_matmul {n}^2 f32: {call_ms:.3f} ms, matmul launches {mm_launches} (expected 1), "
          f"max|Δ| against torch.matmul {err:.3e} (tolerance {TOL_MM:g} * {scale:.1f}) on {card}")
    check(mm_launches == 1, f"matmul launches {mm_launches} != 1")
    check(err <= TOL_MM * scale, f"pallas_matmul error {err:.3e}")
    del a, b, c, model
    torch.cuda.empty_cache()
    return {"attention": forward_launches + ulysses_launches, "matmul": mm_launches}


def raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t``, row-major: bitwise comparison for every dtype."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def repack_bound_ms(nbytes: int):
    """Least time to move ``nbytes``: each byte read once and written once
    over the card's memory rate; a copy does no operations."""
    return 1e3 * 2.0 * nbytes / HBM_BYTES_PER_S, "bytes"


def random_of(total: int, dtype, gen, dev) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.rand(total, generator=gen, device=dev) < 0.5
    if dtype.is_floating_point:
        return torch.randn(total, generator=gen, device=dev, dtype=dtype)
    return torch.randint(-100, 100, (total,), generator=gen, device=dev, dtype=dtype)


def check_repack(k7, gen, dev) -> int:
    """K7 against its plain version on the raw bytes: the benchmark's
    (19999980,) -> (1999998, 10) f32, the 2.4 GB (599999980,) ->
    (59999998, 10) past 2^31 bytes, five other dtypes at a ragged shape,
    three int8 segments at odd byte offsets, zero rows, and two reruns.
    Returns what it measured: whether every case was bitwise equal to its
    plain version, and the largest |kernel - plain| over the float cases."""
    all_equal, max_abs = True, 0.0
    cases = [((REPACK_OUT[0] * REPACK_OUT[1],), REPACK_OUT, torch.float32),
             ((REPACK_BIG_OUT[0] * REPACK_BIG_OUT[1],), REPACK_BIG_OUT, torch.float32)]
    cases += [((1_234_567 * 7,), (1_234_567, 7), dt) for dt in (torch.bfloat16, torch.int8, torch.bool, torch.float64, torch.int64)]
    for (total,), shape, dt in cases:
        flat = random_of(total, dt, gen, dev)
        got = k7.repack(flat, shape)
        want = k7.reference_repack(flat, shape)
        torch.cuda.synchronize()
        same = tuple(got.shape) == shape and got.dtype == dt and torch.equal(raw(got), raw(want))
        if dt.is_floating_point:
            max_abs = max(max_abs, float((got - want).abs().max()))
        all_equal = all_equal and same
        print(f"[check] repack ({total},) -> {shape} {str(dt)[6:]} ({total * flat.element_size() / 1e9:.3f} GB): "
              f"bitwise equal to plain {same}")
        check(same, f"repack {shape} {dt}: not bitwise equal to its plain version")
        if shape == REPACK_OUT:
            reruns = [k7.repack(flat, shape) for _ in range(2)]
            torch.cuda.synchronize()
            again = all(torch.equal(raw(r), raw(got)) for r in reruns)
            all_equal = all_equal and again
            print(f"[check] repack {shape} f32: two reruns bitwise equal {again}")
            check(again, "repack reruns differ")
        del flat, got, want
        torch.cuda.empty_cache()
    a, b, c = (random_of(n, torch.int8, gen, dev) for n in (1_000_003, 777_777, 33))
    segs = [(a, 1, 500_001), (c, 5, 27), (b, 3, 700_000), (a, 600_001, 15)]
    total = sum(n for _, _, n in segs)
    got = k7.repack_segments(segs, (total,))
    want = k7.reference_repack_segments(segs, (total,))
    lib = torch.cat([t[o : o + n] for t, o, n in segs])
    torch.cuda.synchronize()
    same = torch.equal(raw(got), raw(want)) and torch.equal(raw(got), raw(lib))
    all_equal = all_equal and same
    print(f"[check] repack_segments int8, 4 segments at byte offsets 1, 5, 3, 600001: bitwise equal to plain and torch.cat {same}")
    check(same, "repack_segments at odd offsets differs")
    n0 = k7.launches
    empty = k7.repack_segments([(a, 7, 0)], (0, 10))
    check(tuple(empty.shape) == (0, 10) and k7.launches == n0, "zero rows launched or misshaped")
    print("[check] repack zero rows: (0, 10), no launch")
    return all_equal, max_abs


def time_repack(k7, gen, dev, card: str) -> dict:
    """K7 beside its plain version, the library copy (``flat.clone()`` for
    one segment, ``torch.cat`` for three) and its bytes bound."""
    times = {}
    for shape, reps in ((REPACK_OUT, 50), (REPACK_BIG_OUT, 10)):
        total = shape[0] * shape[1]
        buf = torch.randn(total + 1, generator=gen, device=dev)
        flat = buf[:total]
        t_k = time_ms(lambda: k7.repack(flat, shape), reps=reps)
        t_p = time_ms(lambda: k7.reference_repack(flat, shape), reps=reps)
        t_l = time_ms(lambda: flat.clone(), reps=reps)
        t_k2 = time_ms(lambda: k7.repack(flat, shape), reps=reps)
        b_ms, b_by = repack_bound_ms(4 * total)
        times[shape] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"[time] repack ({total},) -> {shape} f32: kernel_ms={t_k:.4f} (again {t_k2:.4f}) plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} (flat.clone()) bound_ms={b_ms:.4f} ({b_by}), {2 * 4 * total / t_k / 1e6:.1f} GB/s on {card}")
        # a source one element off 16-byte alignment: the kernel copies 4-byte words
        t_m = time_ms(lambda: k7.repack_segments([(buf, 1, total)], shape), reps=reps)
        t_ml = time_ms(lambda: buf[1:].clone(), reps=reps)
        times[(shape, "misaligned")] = (t_m, t_ml)
        print(f"[time] repack ({total},) -> {shape} f32 from element offset 1 (4-byte common alignment): "
              f"kernel_ms={t_m:.4f} library_ms={t_ml:.4f} (buf[1:].clone()) on {card}")
        del flat, buf
        torch.cuda.empty_cache()
    third = REPACK_OUT[0] * REPACK_OUT[1] // 3
    parts = [torch.randn(third + 5, generator=gen, device=dev) for _ in range(3)]
    segs = [(p, o, third) for p, o in zip(parts, (0, 1, 5))]
    shape = (3 * third,)
    t_k = time_ms(lambda: k7.repack_segments(segs, shape), reps=50)
    t_p = time_ms(lambda: k7.reference_repack_segments(segs, shape), reps=50)
    t_l = time_ms(lambda: torch.cat([p[o : o + n] for p, o, n in segs]), reps=50)
    b_ms, b_by = repack_bound_ms(4 * 3 * third)
    times["segments"] = (t_k, t_p, t_l, b_ms, b_by)
    print(f"[time] repack_segments 3 x {third} f32 at element offsets 0, 1, 5: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
          f"library_ms={t_l:.4f} (torch.cat) bound_ms={b_ms:.4f} ({b_by}) on {card}")
    del parts, segs
    torch.cuda.empty_cache()
    return times


def same_shards(got, want_global: torch.Tensor, mesh) -> bool:
    """``got``'s shards against the chunk rule's cut of ``want_global``,
    bitwise."""
    for r, s in enumerate(got.shards):
        sl = mesh.chunk(tuple(want_global.shape), got.split, rank=r)[2]
        if tuple(s.shape) != tuple(want_global[sl].shape) or not torch.equal(raw(s), raw(want_global[sl])):
            return False
    return True


def card_vs_cpu(ht, dev, mesh, x: np.ndarray, split, op) -> bool:
    """``op`` on a small array on the card and on the CPU: equal shards,
    split and shape, bitwise."""
    a = op(ht.array(torch.from_numpy(x).to(dev), split=split, comm=mesh))
    b = op(ht.array(x, split=split, comm=mesh, device="cpu"))
    torch.cuda.synchronize()
    return a.shape == b.shape and a.split == b.split and all(
        torch.equal(raw(u.cpu()), raw(v)) for u, v in zip(a.shards, b.shards)
    )


def k7_destinations(gout, mesh) -> int:
    """Destination positions with rows in the rechunk's split-0 layout:
    K7's launches per split-crossing reshape."""
    return sum(1 for r in range(mesh.size) if mesh.chunk(gout, 0, rank=r)[1][0] > 0)


def transport_paths(ht, k7, seed: int, dev, card: str) -> dict:
    """The slice end to end over ``MeshComm(4)`` on the card: split-crossing
    reshapes (the benchmark's, 2.4 GB, shift-carrying, the split-1 chain),
    ``resplit`` and ``resplit_`` at (4e6, 128), a mask getitem and an
    int-array take over 1e7 rows; launches, bitwise checks, ms/call, GB/s,
    peak memory, a trace, and each at a small size against the CPU.
    Returns the K7 launches of the path's first calls."""
    mesh = ht.MeshComm(TRANSPORT_MESH)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    total_launches = 0
    out = {}
    for name, gin, si, gout, so, reps in [
        ("reshape_repack", REPACK_IN, 0, REPACK_OUT, 0, 20),
        ("reshape 2.4 GB", REPACK_BIG_IN, 0, REPACK_BIG_OUT, 0, 5),
        ("shift-carrying reshape", SHIFT_IN, 0, SHIFT_OUT, 0, 20),
        ("split-1 reshape chain", CHAIN_IN, 1, CHAIN_OUT, 1, 10),
    ]:
        src = torch.randn(gin, generator=gen, device=dev)
        a = ht.array(src, split=si, comm=mesh, copy=False)
        plan = ht.parallel.transport.rechunk_plan(gin[0], src.numel() // gin[0], gout[0], src.numel() // gout[0], mesh.size)
        expect = k7_destinations(gout, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k7.launches = 0
        t0 = time.perf_counter()
        b = ht.reshape(a, gout, new_split=so)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches = k7.launches
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        total_launches += launches
        exact = b.shape == gout and b.split == so and same_shards(b, src.reshape(gout), mesh)
        del b
        t0 = time.perf_counter()
        for _ in range(reps):
            ht.reshape(a, gout, new_split=so)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        nbytes = 4 * src.numel()
        src_rows = [int(m[si]) for m in mesh.lshape_map(gin, si)]
        print(f"[e2e] {name} {gin} split {si} -> {gout} split {so} over MeshComm({mesh.size}): {ms:.4f} ms/call "
              f"({2 * nbytes / ms / 1e6:.1f} GB/s of 2 x {nbytes / 1e9:.3f} GB; first call {first_ms:.3f} ms), "
              f"peak {peak_gb:.3f} GB above the input, repack launches {launches} (expected {expect}), "
              f"plan shifts {[e[0] for e in plan]}, source extents {src_rows}, bitwise equal to torch's reshape {exact} on {card}")
        check(launches == expect, f"{name}: repack launches {launches} != {expect}")
        check(exact, f"{name}: shards differ from torch's reshape")
        out[name] = (ms, launches, peak_gb)
        if name == "reshape 2.4 GB":
            trace(f"ht.reshape {gin} -> {gout} over MeshComm({mesh.size})", lambda: ht.reshape(a, gout, new_split=so), 1)
        if name == "shift-carrying reshape":
            check([e[0] for e in plan] == [0, 1] and src_rows[-1] == 0, f"{name}: plan {plan}")
        del a, src
        torch.cuda.empty_cache()

    # resplit 0 -> 1 at (4e6, 128) f32, out of place and in place
    src = torch.randn(RESPLIT_N, 128, generator=gen, device=dev)
    a = ht.array(src, split=0, comm=mesh, copy=False)
    k7.launches = 0
    b = ht.resplit(a, 1)
    torch.cuda.synchronize()
    exact = b.split == 1 and same_shards(b, src, mesh) and same_shards(a, src, mesh)
    del b
    ms = time_ms(lambda: ht.resplit(a, 1), reps=10)
    c = ht.array(src.clone(), split=0, comm=mesh, copy=False)
    c.resplit_(1)
    c.resplit_(0)
    torch.cuda.synchronize()
    round_trip = c.split == 0 and same_shards(c, src, mesh)
    nbytes = 4 * src.numel()
    print(f"[e2e] resplit ({RESPLIT_N},128) 0 -> 1 over MeshComm({mesh.size}): {ms:.4f} ms/call "
          f"({2 * nbytes / ms / 1e6:.1f} GB/s), repack launches {k7.launches} (expected 0), bitwise equal {exact}, "
          f"resplit_ 0 -> 1 -> 0 round trip bitwise equal {round_trip} on {card}")
    check(exact and round_trip and k7.launches == 0, "resplit differs or launched repack")
    out["resplit"] = (ms, 0, None)
    del a, c, src
    torch.cuda.empty_cache()

    # a mask getitem and an int-array take over 1e7 rows
    src = torch.randn(SELECT_ROWS, 4, generator=gen, device=dev)
    a = ht.array(src, split=0, comm=mesh, copy=False)
    mask = src[:, 0] > 0
    rows = torch.randint(0, SELECT_ROWS, (TAKE_ROWS,), generator=gen, device=dev)
    for name, key, want in [("mask getitem", mask, src[mask]), ("int-array take", rows, src[rows])]:
        got = a[key]
        torch.cuda.synchronize()
        exact = got.split == 0 and same_shards(got, want, mesh)
        del got
        t0 = time.perf_counter()
        for _ in range(5):
            a[key]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 5
        print(f"[e2e] {name} ({SELECT_ROWS},4) split 0 over MeshComm({mesh.size}) -> {tuple(want.shape)}: {ms:.4f} ms/call, "
              f"bitwise equal to torch's indexing {exact} on {card}")
        check(exact, f"{name} differs from torch's indexing")
        out[name] = (ms, 0, None)
    del a, src, mask, rows
    torch.cuda.empty_cache()

    # each at a small size, card against CPU
    small = [
        ("reshape_repack", rng.standard_normal((999, 20)).astype(np.float32), 0, lambda x: ht.reshape(x, (1998, 10))),
        ("shift-carrying reshape", rng.standard_normal((6, 40)).astype(np.float32), 0, lambda x: ht.reshape(x, (24, 10))),
        ("split-1 chain", rng.standard_normal((10, 400)).astype(np.float32), 1, lambda x: ht.reshape(x, (400, 10), new_split=1)),
        ("int8 reshape", rng.integers(-9, 9, (37, 15)).astype(np.int8), 0, lambda x: ht.reshape(x, (555,))),
        ("resplit", rng.standard_normal((4001, 12)).astype(np.float32), 0, lambda x: ht.resplit(x, 1)),
        ("mask getitem", rng.standard_normal((10_007, 4)).astype(np.float32), 0, lambda x: x[x.larray[:, 0] > 0]),
        ("int-array take", rng.standard_normal((10_007, 4)).astype(np.float32), 0,
         lambda x: x[(torch.arange(3000, device=x.shards[0].device) * 7919) % 10_007]),
    ]
    for name, x, split, op in small:
        same = card_vs_cpu(ht, dev, mesh, x, split, op)
        print(f"[e2e] small {name} {x.shape} {x.dtype} split {split}: card vs cpu bitwise equal {same}")
        check(same, f"small {name} differs between card and CPU")
    out["launches"] = total_launches
    return out


def manipulation_paths(ht, seed: int, dev, card: str) -> None:
    """Sort, top-k and unique along the split axis over ``MeshComm(4)`` at
    1e7 elements (the merge-split network of parallel/sort.py) against
    torch's on the whole array, bitwise; then each manipulation at a small
    size on the card against the CPU."""
    mesh = ht.MeshComm(TRANSPORT_MESH)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    src = torch.randint(0, 1000, (SELECT_ROWS,), generator=gen, device=dev).float()
    a = ht.array(src, split=0, comm=mesh, copy=False)
    want = torch.sort(src, stable=True)
    t0 = time.perf_counter()
    v, i = ht.sort(a)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    exact = same_shards(v, want.values, mesh) and same_shards(i, want.indices.to(torch.int32), mesh)
    tv, ti = ht.topk(a, 10)
    tw = torch.sort(src, descending=True, stable=True)
    top_ok = torch.equal(tv.larray, tw.values[:10]) and torch.equal(ti.larray, tw.indices[:10])
    u = ht.unique(a)
    uniq_ok = torch.equal(u.larray, torch.unique(src))
    print(f"[e2e] sort ({SELECT_ROWS},) f32 with ties over MeshComm({mesh.size}): {ms:.3f} ms (first call), bitwise equal "
          f"to torch.sort(stable=True) {exact}; topk 10 equal {top_ok}; unique ({u.shape[0]}) equal {uniq_ok} on {card}")
    check(exact and top_ok and uniq_ok, "sort, topk or unique differs from torch's")
    del a, src, want, v, i, tw
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 9)
    x = rng.standard_normal((37, 6)).astype(np.float32)
    ops = [
        ("flatten", lambda d: ht.flatten(d)), ("expand_dims", lambda d: ht.expand_dims(d, 1)),
        ("swapaxes", lambda d: ht.swapaxes(d, 0, 1)), ("moveaxis", lambda d: ht.moveaxis(d, 0, 1)),
        ("flip", lambda d: ht.flip(d, 0)), ("roll", lambda d: ht.roll(d, 5, 0)), ("rot90", lambda d: ht.rot90(d)),
        ("pad", lambda d: ht.pad(d, ((2, 1), (0, 3)))), ("repeat", lambda d: ht.repeat(d, 2, axis=1)),
        ("tile", lambda d: ht.tile(d, (2, 1))), ("broadcast_to", lambda d: ht.broadcast_to(d, (3, 37, 6))),
        ("stack", lambda d: ht.stack([d, d], axis=1)), ("vstack", lambda d: ht.vstack([d, d])),
        ("split", lambda d: ht.split(d, 3, axis=1)[1]), ("diagonal", lambda d: ht.diagonal(d)),
        ("sort", lambda d: ht.sort(d, axis=0, descending=True)[1]), ("topk", lambda d: ht.topk(d, 3, dim=0)[1]),
        ("unique", lambda d: ht.unique(ht.flatten(d))), ("nonzero", lambda d: ht.nonzero(d > 0)),
        ("where", lambda d: ht.where(d > 0, d, 0.0)),
    ]
    bad = [name for name, op in ops if not card_vs_cpu(ht, dev, mesh, x, 0, op)]
    print(f"[e2e] {len(ops)} manipulations at (37, 6) split 0 over MeshComm({mesh.size}): card vs cpu bitwise equal "
          f"for all but {bad}")
    check(not bad, f"manipulations differ between card and CPU: {bad}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. identity
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import kmeans as km_mod
    from heat_tpu_torch.ops import _build
    from heat_tpu_torch.ops import attention as k3
    from heat_tpu_torch.ops import cdist as k1
    from heat_tpu_torch.ops import matmul as k2
    from heat_tpu_torch.ops import lasso_sweep as k5
    from heat_tpu_torch.ops import qr_panel as k4
    from heat_tpu_torch.ops import repack as k7
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
    libs = {"heat_cdist": k1, "heat_qr_panel": k4, "heat_lasso_sweep": k5, "heat_spmv": k6,
            "heat_attention": k3, "heat_matmul": k2, "heat_repack": k7}
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
    # leaves, 5e5 x 1000; a ragged panel and the narrowest one; the wide
    # path's geometry: one block past the small path (166), ragged last
    # blocks (191, 1000 = 15 * 64 + 40), whole blocks (192), and a row pitch
    # off 16 bytes (1025: the Gram's 4-byte copies)
    k4_abs = 0.0
    for m, n in [(1_000_000, 128), (2048, 1024), (500_000, 1_000), (100_003, 67), (1000, 2),
                 (4096, 166), (4096, 191), (4096, 192), (20_000, 1000), (3000, 1025)]:
        xq = torch.randn(m, n, generator=gen, device=dev)
        abs_err, rel_r, rel_ri = compare_qr_panel(k4, xq)
        print(f"[check] qr_panel ({m},{n}): max_abs_err={abs_err:.3e} |dR|/|R|={rel_r:.3e} |dRinv|/|Rinv|={rel_ri:.3e}")
        check(rel_r <= TOL_QR and rel_ri <= TOL_QR, f"qr_panel ({m},{n}): relative error above {TOL_QR}")
        k4_abs = max(k4_abs, abs_err)
        del xq
    # reruns are bitwise equal (fixed-order sums, no float atomics)
    xq = torch.randn(2048, 1024, generator=gen, device=dev)
    r1, ri1 = k4.fused_gram_chol(xq)
    r2, ri2 = k4.fused_gram_chol(xq)
    torch.cuda.synchronize()
    same = torch.equal(r1, r2) and torch.equal(ri1, ri2)
    print(f"[check] qr_panel (2048,1024) rerun: bitwise equal {same}")
    check(same, "qr_panel reruns differ")
    # a rank-deficient panel (a zero column): both latch NaN in the same
    # places, on the small path and in the first and a late 64-column block
    # of the wide one
    for m, n, col in [(3000, 40, 7), (5000, 1000, 0), (5000, 1000, 700)]:
        xq = torch.randn(m, n, generator=gen, device=dev)
        xq[:, col] = 0
        r, rinv = k4.fused_gram_chol(xq)
        rr, rri = k4.reference_fused_gram_chol(xq)
        torch.cuda.synchronize()
        same_nan = torch.equal(torch.isnan(r), torch.isnan(rr)) and torch.equal(torch.isnan(rinv), torch.isnan(rri))
        print(f"[check] qr_panel rank-deficient ({m},{n}), column {col} zero: NaN in R {int(torch.isnan(r).sum())}/"
              f"{r.numel()}, in Rinv {int(torch.isnan(rinv).sum())}/{rinv.numel()}, same places as plain {same_nan}")
        check(same_nan and bool(torch.isnan(r).any()) and bool(torch.isnan(rinv).all())
              and torch.equal(torch.nan_to_num(r), torch.nan_to_num(rr)), "qr_panel NaN latch differs")
    del xq, r1, r2, ri1, ri2

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

    # K4 at the three QR panels, each with its device time by kernel (Gram,
    # reduce, factorisation) from one traced pass
    k4_times = {}
    for m, n in [(1_000_000, 128), (500_000, 1_000), (2048, 1024)]:
        xq = torch.randn(m, n, generator=gen, device=dev)
        eye_n = torch.eye(n, device=dev)
        reps = 3 if n == 1_000 else 10
        t_k = time_ms(lambda: k4.fused_gram_chol(xq), reps=reps, warmup=1)
        t_p = time_ms(lambda: k4.reference_fused_gram_chol(xq), reps=reps, warmup=1)
        # the library chain: cuBLAS Gram, cuSOLVER Cholesky, triangular solve
        t_l = time_ms(
            lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(xq.T @ xq)[0], eye_n, upper=False),
            reps=reps, warmup=1,
        )
        t_k2 = time_ms(lambda: k4.fused_gram_chol(xq), reps=reps, warmup=1)
        b_ms, b_by = qr_panel_bound_ms(m, n)
        k4_times[(m, n)] = (t_k, t_p, t_l, b_ms, b_by)
        print(f"[time] qr_panel ({m},{n}): kernel_ms={t_k:.4f} (again {t_k2:.4f}) plain_ms={t_p:.4f} "
              f"library_ms={t_l:.4f} (cholesky_ex(x.T@x) + solve_triangular) bound_ms={b_ms:.4f} ({b_by}) "
              f"kernel/library={t_k / t_l:.3f} on {card}")
        trace(f"qr_panel ({m},{n}) one pass, by kernel", lambda: k4.fused_gram_chol(xq), 1)
        del xq, eye_n
    k4_ms, k4_plain_ms, k4_library_ms, k4_bound_ms, k4_bound_by = k4_times[(1_000_000, 128)]
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

    # K3 and K2: against their plain versions, then timed
    k3_abs, k3_abs_16 = check_attention(k3, gen, dev)
    k2_abs, k2_abs_16 = check_matmul(k2, gen, dev)
    tensor_core_trace(k3, k2, gen, dev)
    att_times = time_attention(k3, gen, dev, card)
    mm_times = time_matmul(k2, gen, dev, card)

    # K7: against its plain version bitwise, then timed
    k7_equal, k7_abs = check_repack(k7, gen, dev)
    k7_times = time_repack(k7, gen, dev, card)

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
    del sa, sb, sx
    torch.cuda.empty_cache()

    # the TransformerLM forward, sequence parallelism and ops.pallas_matmul
    lm = transformer_paths(ht, k3, k2, args.seed, dev, card)

    # the transport engine: reshape, resplit and advanced getitem
    tr = transport_paths(ht, k7, args.seed, dev, card)
    manipulation_paths(ht, args.seed, dev, card)

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
            "at": "(1000000, 128)",
            **{f"{key}_{m}x{n}": val for (m, n), t in k4_times.items() if n != 128
               for key, val in zip(("ms", "plain_ms", "library_ms", "bound_ms"), t[:4])},
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
        {
            "name": "attention",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/attention.cu",
            "replaces": "heat_tpu/ops/attention.py:37",
            "launches": lm["attention"],
            "max_abs_err": k3_abs,
            "ms": att_times[(64, 2048, 64, "float32", True)][0],
            "plain_ms": att_times[(64, 2048, 64, "float32", True)][1],
            "bound_ms": att_times[(64, 2048, 64, "float32", True)][3],
            "bound_by": att_times[(64, 2048, 64, "float32", True)][4],
            "library_ms": att_times[(64, 2048, 64, "float32", True)][2],
            "at": "(64, 2048, 64) f32 causal, the model's shape",
            "max_abs_err_16": k3_abs_16,
            **{f"{key}_bf16{tag}": att_times[(ATTN_BH, ATTN_S, ATTN_D, "bfloat16", causal)][i]
               for causal, tag in ((False, ""), (True, "_causal"))
               for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))},
            "at_bf16": f"({ATTN_BH}, {ATTN_S}, {ATTN_D}) bf16, tensor cores",
        },
        {
            "name": "matmul",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/matmul.cu",
            "replaces": "heat_tpu/ops/matmul.py:33",
            "launches": lm["matmul"],
            "max_abs_err": k2_abs,
            "ms": mm_times["float32"][0],
            "plain_ms": mm_times["float32"][1],
            "bound_ms": mm_times["float32"][3],
            "bound_by": mm_times["float32"][4],
            "library_ms": mm_times["float32"][2],
            "at": "8192^2 f32",
            "max_abs_err_16": k2_abs_16,
            **{f"{key}_bf16": mm_times["bfloat16"][i] for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))},
            "at_bf16": "8192^2 bf16, tensor cores",
        },
        {
            "name": "repack",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/repack.cu",
            "replaces": "heat_tpu/ops/repack.py:75",
            "launches": tr["launches"],
            "max_abs_err": k7_abs,
            "bitwise_equal": k7_equal,
            "ms": k7_times[REPACK_OUT][0],
            "plain_ms": k7_times[REPACK_OUT][1],
            "bound_ms": k7_times[REPACK_OUT][3],
            "bound_by": k7_times[REPACK_OUT][4],
            "library_ms": k7_times[REPACK_OUT][2],
            "library_call": "flat.clone()",
            "at": f"({REPACK_OUT[0] * REPACK_OUT[1]},) f32 -> {REPACK_OUT}, 80 MB",
            "ms_2p4GB": k7_times[REPACK_BIG_OUT][0],
            "plain_ms_2p4GB": k7_times[REPACK_BIG_OUT][1],
            "bound_ms_2p4GB": k7_times[REPACK_BIG_OUT][3],
            "library_ms_2p4GB": k7_times[REPACK_BIG_OUT][2],
        },
    ]
    print(f"[summary] {time.perf_counter() - t_start:.1f} s from start to summary")
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
