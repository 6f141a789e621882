"""Drive heat_tpu_torch's KMeans, KMedians/KMedoids (the repo's cluster
benchmark), QR, Lasso, sparse Spectral, TransformerLM, transport
(reshape, resplit, advanced getitem), runtime-core (assignment, random,
factories, printing), linear-algebra and classifier (KNN, GaussianNB,
svd, det/inv, convolve, pad, tiles), I/O (files to the card and back),
training (TransformerLM, ResNet, DASO) and random (the Threefry streams)
paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases: (1) identity of the card and toolchain; (2) build every kernel of
the paths from the sources in this checkout, all at once; (3) each kernel
against its plain torch version at the shapes the paths give it (K1 also
in bf16 and f16 at the north star's shapes, K6 also at its panels' edges
and rerun bitwise at the SpMV cell), with a
trace showing that a bf16 call of K3 and of K2 runs only its tensor-core
kernel and an f32 call only its CUDA-core kernel; (4) kernel
timing beside the plain version, one library call where there is one, and
the card's bound (K6 also at the k-NN Laplacian, with the profiler's device
time and the bytes a model of its loads and copies gives); (5) each path end to end through the entry points a user
calls, with the kernels' launch counts set to 0 just before it and read just
after: KMeans(k=8, kmeans++) fit and predict on 2e7 x 64 f32 Gaussian blobs;
BASELINE.md's north star, ``KMeans(k=8, init="random", tol=-1).fit`` of
``cluster.randn_packed(1e8, 64)`` bf16 (benchmarks/cb/cluster.py:65-95;
ms/iter as the chain delta of max_iter 12 and 2, and the peak allocation
above the input), and the same fit on bf16 blobs made chunk by chunk;
the repo's cluster benchmark (benchmarks/cb/cluster.py:97-107):
``KMeans("kmeans++")``, ``KMedians("kmedians++")`` and
``KMedoids("kmedoids++")`` at k = 4 on
``utils.data.spherical.create_spherical_dataset(250000)`` (1e6 x 3 f32),
a warm-up and a timed fit each, K1 also at its d = 3; KMedians and
KMedoids (k = 8, kmedians++/kmedoids++, 8 iterations) on the 2e7 x 64 f32
blobs, ms/iter, the peak above the input and an iteration's trace by kind;
small KMedians/KMedoids fits and one call of each op of the elementwise and
statistics surface on the card and on the CPU;
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
manipulations.py:16-30, :138-148); and over ``MeshComm(4)`` the runtime
core at the Lloyd shape, 2e7 x 64 f32: the data pipeline (``randint``
labels, mask assignments of ``randn`` draws, ``shuffle_rows``, a KMeans
fit through K1), assignments across position bounds (a split value
re-cut by K7 into the shards, an integer put, a full mask), the
factories at size, ``str`` and one call of each new name on card and
CPU; and over ``MeshComm(4)`` linear algebra and the classifiers:
``KNeighborsClassifier(5)`` on the served benchmark's 65536 x 64 corpus
(benchmarks/cb/config.py:211-212, quantize.py:157-170; K1 at its blocks,
a batch of 65536 split queries, 128 replicated requests of 1-8 rows,
each label against a float64 top-5 vote), ``GaussianNB`` on the 2e7 x 64
blobs (fit, predict, predict_proba, four partial fits), ``svd`` at
1e6 x 128 (TSQR) and 2048^2, ``det``/``inv`` at 2048^2 split 0, split 1
(the elimination) and replicated (LU), ``convolve`` of 1e8 samples with a
1025-tap filter in three modes against a float64 FFT, five ``pad`` modes
along the split axis of the 2e7 x 64 blobs, and the tiles of 2048^2;
and the I/O phase on the 2e7 x 64 f32 blobs: ``save_npy`` over
``MeshComm(4)``, ``load_npy(split=0)`` over ``MeshComm(1)`` and
``MeshComm(4)`` (bitwise, GB/s beside numpy's read alone and a pinned
host-to-card copy, the host's peak by tracemalloc and the card's),
KMeans through K1 on the loaded array, ``cluster.load_hdf5_packed`` in
bf16 and KMeans on it, a split-1 load and ``resplit(0)``, CSV at 1e6 x 64
(the native parser against numpy's) and NetCDF at 8e6 x 64, and the
DCSR members of the Spectral cell's k-NN graph against K6 (files in a
temporary directory removed at the end);
each with
data made on the card from ``--seed``, and a small input of each on the card
and on the CPU; (6) one JSON line per kernel.  The last line is
``{"ok": true, "device": {...}}``.  Any failure exits nonzero before that
line; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
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
# BASELINE.md's north star (benchmarks/cb/config.py:166-168,
# benchmarks/cb/cluster.py::_northstar_slope): 1e8 x 64 bf16 KMeans, k = 8;
# ms/iter is the chain delta between max_iter = NS_ITERS and 2
NS_ROWS, NS_F, NS_K, NS_ITERS = 100_000_000, 64, 8, 12
# the gate on the north star's peak allocation above its input: one f32
# copy of the 12.8 GB payload would be 25.6 GB
NS_PEAK_GATE = 12.8e9
# rows a plain-version comparison widens at a time (the plain version of a
# 16-bit operand makes its f32 copy; 1e8 x 64 at once would be 25.6 GB)
PLAIN_ROWS = 1 << 24
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
# the runtime core over MeshComm(4) at the Lloyd shape (benchmarks/cb/config.py:159-162):
# the data pipeline (randint labels, mask assignment of normal draws,
# shuffle_rows, KMeans through K1), assignments across position bounds
# (the slice crosses two), the factories at size and str()
RT_ROWS, RT_F, RT_K, RT_ITERS = ROWS, 64, 8, 10
RT_LO, RT_SLICE = 4_999_990, 10_000_000
RT_PUT, RT_PERM = 2_000_000, 100_000_000
RT_EYE, RT_LIN = 32_768, 100_000_000
# linspace within 2 ulps of its scale of torch's, logspace within 32 ulps
# (float64; the CPU tests' tolerances against heat_tpu)
TOL_LIN_ULPS, TOL_LOG_ULPS = 2, 32


# the I/O phase: the Lloyd shape (2e7 x 64 f32, 5.12 GB) written to a file
# and loaded back split over MeshComm(1) and MeshComm(4); the chip
# machine's temporary directory (75 GB free) holds it uncut.  h5py and
# netCDF4 are not installed there, so the HDF5 steps read and write .npy
# through the same slab funnel (load_hdf5_packed opens it through
# stream.open_source), and NetCDF goes through scipy's classic format,
# whose 32-bit offsets keep a file under 2 GiB: IO_NC_ROWS x 64 f32 is
# 2.048 GB.  CSV at 1e6 x 64.
IO_ROWS, IO_F, IO_K, IO_ITERS = ROWS, 64, 8, 10
IO_CSV_ROWS, IO_NC_ROWS = 1_000_000, 8_000_000
# a split load's host peak (tracemalloc, which sees numpy's buffers): one
# position's slab plus 64 MiB for everything else the load allocates
IO_HOST_MARGIN = 64 << 20


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


def device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` from torch.profiler: its CUDA-typed
    events over ``reps`` calls.  For a call shorter than its host work,
    which CUDA events then measure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / reps


def cdist_bound_ms(m: int, n: int, d: int, x_bytes: int = 4, y_bytes: int = 4):
    """Least time for (m,d)x(n,d)->(m,n) f32: each input read once (x and y
    of ``x_bytes``/``y_bytes`` an element) and the output written once,
    against the cross term's and norms' FMAs."""
    nbytes = x_bytes * m * d + y_bytes * n * d + 4.0 * m * n
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


def compare_cdist_rows(k1, x, y, sqrt: bool):
    """``compare_cdist`` for a large 16-bit x: the kernel runs once on the
    whole of x, its plain version on PLAIN_ROWS rows at a time (rows are
    independent); also whether a rerun of the kernel is bitwise equal."""
    got = k1.cdist(x, y, sqrt=sqrt)
    same = torch.equal(got, k1.cdist(x, y, sqrt=sqrt))
    check(tuple(got.shape) == (x.shape[0], y.shape[0]), f"shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    yf = y.float()
    abs_err = rel = 0.0
    for lo in range(0, x.shape[0], PLAIN_ROWS):
        xs, gs = x[lo : lo + PLAIN_ROWS], got[lo : lo + PLAIN_ROWS]
        want = k1.reference_cdist(xs, y, sqrt=sqrt)
        abs_err = max(abs_err, float((gs - want).abs().max()))
        g2, w2 = (gs * gs, want * want) if sqrt else (gs, want)
        scale = (xs.float() ** 2).sum(1)[:, None] + (yf * yf).sum(1)[None, :]
        rel = max(rel, float(((g2 - w2).abs() / scale.clamp_min(1e-30)).max()))
        del want, g2, w2, scale
    torch.cuda.synchronize()
    return abs_err, rel, same


def randn_rows(rows: int, dim: int, dtype, gen, dev) -> torch.Tensor:
    """Standard-normal rows of a 16-bit type, drawn in f32 chunks into the
    16-bit buffer (no full-size f32 intermediate)."""
    out = torch.empty(rows, dim, dtype=dtype, device=dev)
    for lo in range(0, rows, PLAIN_ROWS):
        out[lo : lo + PLAIN_ROWS] = torch.randn(min(PLAIN_ROWS, rows - lo), dim, generator=gen, device=dev)
    return out


def check_cdist16(k1, gen, dev) -> float:
    """K1's 16-bit variants against the plain version at the shapes the
    north star and the 16-bit paths give it: bf16 x bf16, bf16 x f32 and
    f16 x f16 at (1e8, 64) x (8, 64), the kmeans++ column (n = 1), n = 300,
    d = 20 (4-byte loads) and a base 2 bytes off (2-byte loads); reruns
    bitwise equal.  Returns the largest absolute error."""
    max_abs = 0.0
    x = randn_rows(NS_ROWS, NS_F, torch.bfloat16, gen, dev)
    y32 = torch.randn(NS_K, NS_F, generator=gen, device=dev)
    cases = [
        ("north star bf16 x bf16", lambda: (x, y32.to(torch.bfloat16)), False),
        ("north star bf16 x f32", lambda: (x, y32), False),
        ("kmeans++ column bf16", lambda: (x, y32[:1].to(torch.bfloat16)), True),
        ("n = 300 bf16", lambda: (x[:1_000_000], torch.randn(300, NS_F, generator=gen, device=dev).bfloat16()), False),
        ("d = 20 bf16", lambda: (randn_rows(10_000_000, 20, torch.bfloat16, gen, dev),
                                 torch.randn(NS_K, 20, generator=gen, device=dev).bfloat16()), False),
        ("base 2 bytes off bf16", lambda: (torch.cat([x.new_zeros(1), x[:10_000_000].reshape(-1)])[1:].view(-1, NS_F),
                                           y32.to(torch.bfloat16)), False),
    ]
    for name, make, sqrt in cases:
        a, b = make()
        abs_err, rel, same = compare_cdist_rows(k1, a, b, sqrt)
        print(f"[check] cdist16 {name} {tuple(a.shape)} {str(a.dtype)[6:]} x {tuple(b.shape)} {str(b.dtype)[6:]} "
              f"sqrt={sqrt} base%16={a.data_ptr() % 16}: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
              f"rerun bitwise equal {same}")
        check(rel <= TOL, f"cdist16 {name}: relative error {rel:.3e} > {TOL}")
        check(same, f"cdist16 {name}: reruns differ")
        max_abs = max(max_abs, abs_err)
        del a, b
    del x
    torch.cuda.empty_cache()
    xh = randn_rows(NS_ROWS, NS_F, torch.float16, gen, dev)
    abs_err, rel, same = compare_cdist_rows(k1, xh, y32.to(torch.float16), False)
    print(f"[check] cdist16 north star f16 x f16 {tuple(xh.shape)}: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
          f"rerun bitwise equal {same}")
    check(rel <= TOL and same, "cdist16 f16: error above tolerance or reruns differ")
    del xh
    torch.cuda.empty_cache()
    return max(max_abs, abs_err)


def time_cdist16(k1, gen, dev, card: str) -> dict:
    """K1 bf16 at the north star's (1e8, 64) x (8, 64), beside its plain
    version (on PLAIN_ROWS rows at a time: at once it would hold ~64 GB of
    f32 copies), ``torch.cdist`` on the same bf16 tensors and the bound."""
    x = randn_rows(NS_ROWS, NS_F, torch.bfloat16, gen, dev)
    y = torch.randn(NS_K, NS_F, generator=gen, device=dev).bfloat16()

    def plain():
        for lo in range(0, NS_ROWS, PLAIN_ROWS):
            k1.reference_cdist(x[lo : lo + PLAIN_ROWS], y, sqrt=False)

    t_k = time_ms(lambda: k1.cdist(x, y, sqrt=False), reps=20)
    t_p = time_ms(plain, reps=2, warmup=1)
    t_l = time_ms(lambda: torch.cdist(x, y).square(), reps=5, warmup=1)
    t_k2 = time_ms(lambda: k1.cdist(x, y, sqrt=False), reps=20)
    b_ms, b_by = cdist_bound_ms(NS_ROWS, NS_K, NS_F, x_bytes=2, y_bytes=2)
    print(f"[time] cdist16 bf16 ({NS_ROWS},{NS_F})x({NS_K},{NS_F}): kernel_ms={t_k:.4f} (again {t_k2:.4f}) "
          f"plain_ms={t_p:.4f} (in {PLAIN_ROWS}-row blocks) library_ms={t_l:.4f} (torch.cdist(x,y).square() on the "
          f"bf16 tensors, bf16 out) bound_ms={b_ms:.4f} ({b_by}) kernel/bound={t_k / b_ms:.3f} on {card}")
    del x, y
    torch.cuda.empty_cache()
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by}


def make_blobs16(rows: int, dim: int, k: int, seed: int, dev, scale: float = 300.0):
    """``make_blobs`` in bf16, made chunk by chunk (no f32 copy of the
    data), with the generating labels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = scale * torch.randn(k, dim, generator=gen, device=dev)
    labels = torch.randint(0, k, (rows,), generator=gen, device=dev)
    x = torch.empty(rows, dim, dtype=torch.bfloat16, device=dev)
    for lo in range(0, rows, PLAIN_ROWS):
        part = labels[lo : lo + PLAIN_ROWS]
        x[lo : lo + PLAIN_ROWS] = torch.randn(part.numel(), dim, generator=gen, device=dev) + centres[part]
    return x, centres, labels


def bf16_blob_gate(k1, model, blocks, centres, truth, what: str) -> None:
    """The gate on a bf16 KMeans fit of blobs: the centres a permutation of
    the generating ones, each coordinate within half a bf16 ulp of its
    generating value (the update rounds the f32 mean to bf16) plus 0.05
    (the mean of millions of samples sits within ~1e-3 of its centre); the
    labels the plain version's wherever the top-two margin is clear, and the
    generating blob recovered on more than 0.9999 of the rows.  ``blocks``
    are the samples, in order, as bf16 (count, f) tensors."""
    fitted = model.cluster_centers_.larray.float()
    k = fitted.shape[0]
    dist = torch.cdist(fitted, centres)
    match = dist.argmin(dim=1)
    check(sorted(match.tolist()) == list(range(k)), f"{what}: centres are not a permutation of the generating ones")
    true = centres[match]
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(true.abs(), fitted.abs()).clamp_min(2.0**-14))) - 7)
    off = (fitted - true).abs() - 0.5 * ulp
    worst = int(torch.argmax(off))
    excess = float(off.max()) - 0.05
    print(f"[e2e] {what}: centre error {float(dist.min(dim=1).values.max()):.4e}, "
          f"worst coordinate {excess:+.4e} past half a bf16 ulp + 0.05 (fitted {float(fitted.view(-1)[worst]):.6g}, "
          f"generating {float(true.view(-1)[worst]):.6g}, ulp {float(ulp.view(-1)[worst]):.6g}), matched {match.tolist()}")
    check(excess <= 0, f"{what}: centres are off their generating ones")
    pred = model.labels_.larray.reshape(-1)
    disagree = clear_rows = at = 0
    for block in blocks:
        for lo in range(0, block.shape[0], PLAIN_ROWS):
            xs_ = block[lo : lo + PLAIN_ROWS]
            d2 = k1.reference_cdist(xs_, model.cluster_centers_.larray, sqrt=False)
            top2 = d2.topk(2, dim=1, largest=False)
            margin = top2.values[:, 1] - top2.values[:, 0]
            scale = (xs_.float() ** 2).sum(1) + (fitted * fitted).sum(1).max()
            clear = margin > 2 * TOL * scale
            disagree += int(((pred[at + lo : at + lo + xs_.shape[0]] != top2.indices[:, 0]) & clear).sum())
            clear_rows += int(clear.sum())
            del d2, top2, margin, scale, clear
        at += block.shape[0]
    agree_truth = float((match[pred.long()] == truth).float().mean())
    print(f"[e2e] {what} labels vs plain: {disagree} disagreements over {clear_rows} rows with a clear margin; "
          f"generating blob recovered on {agree_truth:.6f}")
    check(disagree == 0, f"{what}: {disagree} labels disagree with the plain version")
    check(agree_truth > 0.9999, f"{what}: labels do not recover the blobs")


def northstar_paths(ht, k1, km_mod, seed: int, dev, card: str) -> dict:
    """BASELINE.md's north star through the entry points, as
    ``_northstar_slope`` runs it: ``KMeans(k=8, init="random", tol=-1)``
    on ``cluster.randn_packed(1e8, 64)``; then the same fit (kmeans++
    seeding, which finds the blobs) on bf16 blobs, and small bf16 inputs on
    the card and the CPU."""
    out = {}
    ht.random.seed(seed)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    xs = ht.cluster.randn_packed(NS_ROWS, NS_F)
    torch.cuda.synchronize()
    input_gb = (torch.cuda.memory_allocated() - before) / 1e9
    check(xs.dtype is ht.bfloat16 and xs.shape == (NS_ROWS, NS_F) and xs.x2.shape == (NS_ROWS // 2, 2 * NS_F),
          f"randn_packed gave {xs}")

    def fit(iters: int):
        model = ht.cluster.KMeans(n_clusters=NS_K, init="random", max_iter=iters, tol=-1.0, random_state=seed)
        model.fit(xs)
        torch.cuda.synchronize()
        return model

    fit(1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k1.launches = 0
    t0 = time.perf_counter()
    model = fit(NS_ITERS)
    fit_s = time.perf_counter() - t0
    launches = k1.launches
    peak_above = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"[e2e] north star KMeans(k={NS_K}, random, tol=-1, max_iter={NS_ITERS}).fit(randn_packed({NS_ROWS}, "
          f"{NS_F})): fit {fit_s:.3f} s, input {input_gb:.4f} GB, peak above the input {peak_above:.4f} GB "
          f"(gate {NS_PEAK_GATE / 1e9:.1f}), cdist launches {launches} (expected {NS_ITERS + 1}) on {card}")
    check(launches == NS_ITERS + 1, f"north star cdist launches {launches} != {NS_ITERS + 1}")
    check(peak_above * 1e9 < NS_PEAK_GATE, f"north star peak above the input {peak_above:.3f} GB >= 12.8 GB")
    check(model.n_iter_ == NS_ITERS, f"north star n_iter_ {model.n_iter_}")
    fitted = model.cluster_centers_.larray
    check(fitted.dtype == torch.bfloat16 and tuple(fitted.shape) == (NS_K, NS_F)
          and bool(torch.isfinite(fitted.float()).all()), "north star centres")
    check(model.labels_.shape == (NS_ROWS,) and model.labels_.dtype is ht.int32
          and 0 <= int(model.labels_.larray.min()) and int(model.labels_.larray.max()) < NS_K, "north star labels")
    check(model.inertia_ > 0 and model.inertia_ == model.inertia_, f"north star inertia {model.inertia_}")
    # the Lloyd step's f32 one-hot sums over the 1e8 bf16 rows, against
    # the same sums in f64
    xs_rows = xs.sample_blocks()[0]
    onehot = (model.labels_.larray[:, None] == torch.arange(NS_K, device=dev)[None, :]).bfloat16()
    got = km_mod._onehot_sums(onehot, xs_rows).double()
    want = torch.zeros_like(got)
    for lo in range(0, NS_ROWS, PLAIN_ROWS):
        want += onehot[lo : lo + PLAIN_ROWS].T.double() @ xs_rows[lo : lo + PLAIN_ROWS].double()
    sums_rel = float((got - want).abs().max() / want.abs().max())
    print(f"[e2e] north star one-hot sums (f32 out of bf16) vs f64: max error {sums_rel:.3e} of max|sum| (tolerance 1e-5)")
    check(sums_rel <= 1e-5, f"one-hot sums off by {sums_rel:.3e}")
    del model, onehot, got, want, xs_rows
    # ms/iter: the chain delta between max_iter = NS_ITERS and 2, twice
    deltas = []
    for _ in range(2):
        t0 = time.perf_counter()
        fit(2)
        t2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit(NS_ITERS)
        tk = time.perf_counter() - t0
        deltas.append(1e3 * (tk - t2) / (NS_ITERS - 2))
    iter_ms = min(deltas)
    read_ms = 1e3 * 2.0 * NS_ROWS * NS_F / HBM_BYTES_PER_S
    print(f"[e2e] north star lloyd {iter_ms:.4f} ms/iter (chain deltas {', '.join(f'{d:.4f}' for d in deltas)}), "
          f"{NS_ROWS / (iter_ms / 1e3):.4e} samples/s, one read of the payload {read_ms:.4f} ms = "
          f"{read_ms / iter_ms:.4f} of an iteration, on {card}")
    blocks = xs.sample_blocks()
    start = blocks[0][:: NS_ROWS // NS_K][:NS_K].clone()
    trace("north-star Lloyd iteration (1e8 x 64 bf16, k = 8)",
          lambda: km_mod._lloyd_loop(blocks, start, NS_K, 2, -1.0, with_inertia=False), 2)
    out.update(iter_ms=iter_ms, peak_above_gb=peak_above, launches=launches, fit_s=fit_s)
    del xs, blocks, start
    torch.cuda.empty_cache()

    # the same fit on bf16 blobs (kmeans++ seeding on the 2^18-sample
    # prefix finds all eight; a stratified random start would not)
    data, centres, truth = make_blobs16(NS_ROWS, NS_F, NS_K, seed + 3, dev)
    packed = ht.cluster.pack(ht.array(data, split=0, copy=False))
    check(packed.x2.larray.data_ptr() == data.data_ptr(), "pack copied the payload")
    model = ht.cluster.KMeans(n_clusters=NS_K, init="kmeans++", max_iter=10, tol=-1.0, random_state=seed).fit(packed)
    bf16_blob_gate(k1, model, [data], centres, truth, f"bf16 blobs {tuple(data.shape)}")
    del data, centres, truth, packed, model
    torch.cuda.empty_cache()

    # small bf16 inputs: the same fits on the card and on the CPU, dense
    # and packed (explicit starts near the blob centres: no near-ties)
    small, small_centres = make_blobs(5000, 16, 4, seed + 2, dev, scale=3.0)
    small = small.bfloat16()
    init = (small_centres + 0.1).bfloat16()
    mesh = ht.MeshComm(4)
    for label, wrap in (("dense", lambda d: d), ("packed", ht.cluster.pack)):
        card_fit = ht.cluster.KMeans(n_clusters=4, init=ht.array(init), max_iter=20).fit(
            wrap(ht.array(small, split=0, comm=mesh)))
        cpu_fit = ht.cluster.KMeans(n_clusters=4, init=ht.array(init.cpu(), device="cpu"), max_iter=20).fit(
            wrap(ht.array(small.cpu(), split=0, comm=mesh, device="cpu")))
        same_labels = bool((card_fit.labels_.larray.cpu() == cpu_fit.labels_.larray).all())
        c_err = float((card_fit.cluster_centers_.larray.float().cpu() - cpu_fit.cluster_centers_.larray.float()).abs().max())
        print(f"[e2e] small bf16 {label} input card vs cpu: n_iter {card_fit.n_iter_}/{cpu_fit.n_iter_}, labels equal "
              f"{same_labels}, centre max diff {c_err:.3e}, inertia {card_fit.inertia_:.6e}/{cpu_fit.inertia_:.6e}")
        check(same_labels and card_fit.n_iter_ == cpu_fit.n_iter_ and c_err <= 2.0**-6
              and abs(card_fit.inertia_ - cpu_fit.inertia_) <= 1e-4 * cpu_fit.inertia_,
              f"small bf16 {label} fit differs between card and CPU")
    return out


# the repo's cluster benchmark (benchmarks/cb/cluster.py:97-107): four
# spherical clusters of CLUSTER_N samples each (config.py:159) at
# ±4·(1,1,1) and ±8·(1,1,1), fitted by KMeans, KMedians and KMedoids at k = 4
CLUSTER_N, CLUSTER_K = 250_000, 4
CLUSTER_TRUTH = [(4.0,) * 3, (8.0,) * 3, (-4.0,) * 3, (-8.0,) * 3]
# a fit that misses a ball is held to the CPU's fit from the same random
# state: centres within WITNESS_TOL (f32 sums in other orders), labels equal
# but at ties
WITNESS_TOL = 1e-4
# KMedians/KMedoids at the Lloyd shape (2e7 x 64 f32, k = 8, config.py:163):
# iterations a fit; the gate on the peak above the input is one (n, k, f)
# f32 buffer, which the eager broadcast |x - c| would allocate
MED_ITERS = 8
MED_PEAK_GATE = 4.0 * ROWS * 8 * 64
# kinds of a median-loop iteration's kernels, by name (first match wins)
ITER_KINDS = [
    ("K1", ("cdist",)),
    ("argmin", ("ArgMin", "argmin")),
    ("sort or select", ("Sort", "sort", "Radix", "radix", "KthValue", "kthvalue", "index", "Index", "gather")),
    ("L1", ("abs", "Abs", "sub", "add", "Add", "sum", "Sum", "reduce")),
]


def by_kind(rows) -> dict:
    """A trace's device time (ms) by ITER_KINDS, the rest as "other"."""
    out = {}
    for us, _, name in rows:
        kind = next((k for k, keys in ITER_KINDS if any(key in name for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return out


def fixed_point_medoid_gate(x, medoids, labels, k: int) -> float:
    """For each medoid of a converged KMedoids fit: its exact (f64) squared
    distance to its cluster's median (the plain order statistics of the
    fit's labels, averaged in f32) minus the least over the rows, against
    K1's bound 2·TOL·(max|x|² + |m|²).  Returns the largest excess over the
    bound (<= 0 passes)."""
    worst = -float("inf")
    x64 = x.double()
    for j in range(k):
        rows = x[labels == j]
        s = torch.sort(rows, dim=0).values
        c = rows.shape[0]
        med = (s[(c - 1) // 2] + s[c // 2]) * 0.5
        d2 = ((x64 - med.double()) ** 2).sum(1)
        got = float(((medoids[j].double() - med.double()) ** 2).sum())
        bound_ = 2 * TOL * (float((x64 * x64).sum(1).max()) + float((med.double() ** 2).sum()))
        worst = max(worst, got - float(d2.min()) - bound_)
    return worst


def l1_label_disagreements(x, centres, labels, margin: float):
    """Labels against an f64 L1 argmin where the top-two margin exceeds
    ``margin``: (disagreements, rows with a clear margin)."""
    d = torch.cdist(x.double(), centres.double(), p=1)
    top2 = d.topk(2, dim=1, largest=False)
    clear = (top2.values[:, 1] - top2.values[:, 0]) > margin
    return int(((labels != top2.indices[:, 0]) & clear).sum()), int(clear.sum())


def card_vs_cpu_ops(ht, dev) -> int:
    """One call of each op of the elementwise and statistics surface on the
    card and on the CPU, on the same small inputs: transcendental results
    within 4 ulps of f32 (relative, and as much absolute), sums taken in
    other orders within 1e-5, the rest bitwise.  Returns the count of calls
    compared."""
    gen = torch.Generator().manual_seed(5)
    xf = (torch.rand(64, 6, generator=gen) * 4 - 2).float()
    pos = xf.abs() + 0.5
    unit = xf / 2.5
    xi = (xf * 5).round().to(torch.int32)
    yi = torch.where(xi == 0, 3, xi).abs()
    mask = xf > 0
    xc = torch.complex(xf, unit)
    ulp4 = 4 * 2.0**-23
    unary = {
        "sin": xf, "cos": xf, "tan": unit, "arcsin": unit, "arccos": unit, "arctan": xf, "sinh": xf, "cosh": xf,
        "tanh": xf, "arcsinh": xf, "arccosh": pos + 1, "arctanh": unit, "deg2rad": xf, "rad2deg": xf, "sinc": xf,
        "exp": xf, "expm1": xf, "exp2": xf, "log": pos, "log2": pos, "log10": pos, "log1p": pos, "cbrt": xf,
        "sqrt": pos, "angle": xc,
    }
    exact_unary = {
        "ceil": xf, "floor": xf, "trunc": xf, "fabs": xf, "round": xf * 3, "abs": xi, "sign": xf, "square": xi,
        "pos": xf, "neg": xi, "bitwise_not": xi, "logical_not": xf, "isfinite": xf, "isinf": xf, "isnan": xf,
        "isneginf": xf, "isposinf": xf, "signbit": xf, "conj": xc, "real": xc, "imag": xc,
    }
    binary = {
        "arctan2": (xf, unit, ulp4), "logaddexp": (xf, unit, ulp4), "logaddexp2": (xf, unit, ulp4),
        "hypot": (xf, unit, ulp4), "copysign": (xf, unit, 0), "floordiv": (xi, yi, 0), "mod": (xi, yi, 0),
        "fmod": (xi, yi, 0), "bitwise_and": (xi, yi, 0), "bitwise_or": (xi, yi, 0), "bitwise_xor": (xi, yi, 0),
        "left_shift": (xi, yi % 4, 0), "right_shift": (xi, yi % 4, 0), "logical_and": (mask, xf, 0),
        "logical_or": (mask, xf, 0), "logical_xor": (mask, xf, 0), "isclose": (xf, xf + 1e-6, 0),
        "maximum": (xf, unit, 0), "minimum": (xf, unit, 0), "greater": (xf, unit, 0), "less_equal": (xf, unit, 0),
        "not_equal": (xi, yi, 0),
    }
    reductions = [
        ("cumsum", lambda m, a: m.cumsum(a, 0), pos, 1e-5), ("cumprod", lambda m, a: m.cumprod(a, 1), unit, 1e-5),
        ("prod", lambda m, a: m.prod(a, axis=0), pos, 1e-5), ("nansum", lambda m, a: m.nansum(a, axis=0), xf, 1e-5),
        ("nanprod", lambda m, a: m.nanprod(a), unit, 1e-5), ("all", lambda m, a: m.all(a, axis=0), mask, 0),
        ("any", lambda m, a: m.any(a, axis=1), mask, 0), ("diff", lambda m, a: m.diff(a, axis=0), xf, 0),
        ("max", lambda m, a: m.max(a, axis=0), xf, 0), ("argmax", lambda m, a: m.argmax(a, axis=0), xf, 0),
        ("var", lambda m, a: m.var(a, axis=0, ddof=1), xf, 1e-5), ("std", lambda m, a: m.std(a), xf, 1e-5),
        ("median", lambda m, a: m.median(a, axis=0), xf, 0),
        ("percentile", lambda m, a: m.percentile(a, [10, 50, 90], axis=0, interpolation="nearest"), xf, 0),
        ("percentile linear", lambda m, a: m.percentile(a, 30, axis=0), xf, 1e-5),
        ("average", lambda m, a: m.average(a, axis=0, weights=m.abs(a)), xf, 1e-5),
        ("cov", lambda m, a: m.cov(a), xf, 1e-5), ("bincount", lambda m, a: m.bincount(a), xi.abs().reshape(-1), 0),
        ("histc", lambda m, a: m.histc(a, bins=4, min=-2.0, max=2.0), xf.round() + 0.5, 0),
        ("histogram", lambda m, a: m.histogram(a, bins=4, range=(-2.0, 2.0))[0], xf.round() + 0.5, 0),
        ("kurtosis", lambda m, a: m.kurtosis(a, axis=0), xf, 1e-4), ("skew", lambda m, a: m.skew(a, axis=0), xf, 1e-4),
        ("digitize", lambda m, a: m.digitize(a, [-1.0, 0.0, 1.0]), xf, 0),
        ("bucketize", lambda m, a: m.bucketize(a, [-1.0, 0.0, 1.0]), xf, 0),
        ("clip", lambda m, a: m.clip(a, -1.0, 1.0), xf, 0),
    ]
    mesh = ht.MeshComm(4)
    cases = [(name, lambda m, a, name=name: getattr(m, name)(a), (t,), ulp4) for name, t in unary.items()]
    cases += [(name, lambda m, a, name=name: getattr(m, name)(a), (t,), 0) for name, t in exact_unary.items()]
    cases += [(name, lambda m, a, b, name=name: getattr(m, name)(a, b), (a_, b_), tol)
              for name, (a_, b_, tol) in binary.items()]
    cases += [(name, fn, (t,), tol) for name, fn, t, tol in reductions]
    for name, fn, tensors, tol in cases:
        outs = []
        for device in ("gpu", "cpu"):
            arrays = [ht.array(t.to(dev) if device == "gpu" else t, split=0, comm=mesh, device=device) for t in tensors]
            outs.append(fn(ht, *arrays).larray.cpu())
        card, cpu = outs
        check(card.dtype == cpu.dtype and card.shape == cpu.shape, f"card vs cpu {name}: {card.dtype} vs {cpu.dtype}")
        if tol:
            wide = torch.complex128 if card.is_complex() else torch.float64
            ok = bool(torch.isclose(card.to(wide), cpu.to(wide), rtol=tol, atol=tol, equal_nan=True).all())
        else:
            same = card == cpu
            if card.is_floating_point():
                same |= torch.isnan(card) & torch.isnan(cpu)
            ok = bool(same.all())
        check(ok, f"card vs cpu {name}: differs beyond {tol:g}")
    a = ht.array(xf.to(dev), split=0, comm=mesh)
    check(ht.equal(a, a) and ht.allclose(a, a * (1 + 1e-6)) and not ht.equal(a, a + 1), "card equal/allclose")
    return len(cases) + 1


def witness_gate(x, centres, labels, w_centres, w_labels, l1: bool):
    """The card's fit against the CPU's from the same random state: the
    largest centre difference, the rows whose labels differ, and how many
    of those are not ties (the two centres' f64 distances, L1 or squared
    Euclidean, apart by more than 1e-4 of the distance plus 1e-4)."""
    cerr = float((centres.cpu().double() - w_centres.double()).abs().max())
    diff = (labels.cpu() != w_labels).nonzero().reshape(-1)
    xs = x[diff.to(x.device)].cpu().double()

    def dist(c):
        return (xs - c).abs().sum(1) if l1 else ((xs - c) ** 2).sum(1)

    c64 = w_centres.double()
    near, mine = dist(c64[w_labels[diff]]), dist(c64[labels.cpu()[diff]])
    bad = int(((mine - near).abs() > 1e-4 * (1 + near)).sum())
    return cerr, int(diff.numel()), bad


def cluster_benchmark_paths(ht, k1, seed: int, dev, card: str) -> dict:
    """The repo's cluster benchmark through the entry points: (a)
    ``benchmarks/cb/cluster.py::run()``'s three fits at its own size, one
    warm-up and one timed fit each, as ``_timed_fit`` runs them; (b)
    KMedians and KMedoids at the Lloyd shape on phase 5's blobs, ms per
    iteration, the peak above the input and one iteration's trace by kind;
    (c) small inputs of both and one call of each op of the elementwise and
    statistics surface on the card and on the CPU.  Returns K1's launches
    on the paths and its times at the benchmark's d = 3."""
    from heat_tpu_torch.cluster import _kcluster

    out = {"launches": 0}
    # ------------------------------------------------- (a) the benchmark
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = ht.utils.data.spherical.create_spherical_dataset(
        CLUSTER_N, radius=1.0, offset=4.0, dtype=ht.float32, random_state=seed
    )
    torch.cuda.synchronize()
    x = data.larray
    truth = torch.tensor(CLUSTER_TRUTH, device=dev)
    positions = sum(1 for s in data.shards if s.shape[0])
    print(f"[e2e] cluster benchmark data {data.shape} {data.dtype.__name__} split {data.split}: "
          f"made in {time.perf_counter() - t0:.3f} s over {data.comm.size} position(s)")
    check(data.shape == (4 * CLUSTER_N, 3) and data.split == 0 and bool(torch.isfinite(x).all()), "bad spherical data")
    for name, cls, init in (("KMeans", ht.cluster.KMeans, "kmeans++"), ("KMedians", ht.cluster.KMedians, "kmedians++"),
                            ("KMedoids", ht.cluster.KMedoids, "kmedoids++")):
        cls(n_clusters=CLUSTER_K, init=init).fit(data)  # warm-up, as _timed_fit
        torch.cuda.synchronize()
        state = ht.random.get_state()
        k1.launches = 0
        t0 = time.perf_counter()
        est = cls(n_clusters=CLUSTER_K, init=init).fit(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = k1.launches
        out["launches"] += got
        # seeding: k rounds; KMeans: a step an iteration and labels_;
        # KMedoids: a snap an iteration; per position with rows
        per = {"KMeans": CLUSTER_K + est.n_iter_ + 1, "KMedians": CLUSTER_K, "KMedoids": CLUSTER_K + est.n_iter_}[name]
        centres = est.cluster_centers_.larray.float()
        dist = torch.cdist(centres, truth)
        match = dist.argmin(dim=1)
        err = float(dist.min(dim=1).values.max())
        labels = est.labels_.larray.reshape(-1)
        print(f"[e2e] cluster benchmark {name}({init}) on {tuple(data.shape)}: fit {fit_s:.4f} s, n_iter {est.n_iter_}, "
              f"inertia {est.inertia_:.6e}, cdist launches {got} (expected {per * positions}), centre error {err:.4e} "
              f"(tolerance 0.05), matched {match.tolist()} on {card}")
        check(got == per * positions, f"{name}: cdist launches {got} != {per * positions}")
        if not (sorted(match.tolist()) == list(range(CLUSTER_K)) and err <= 0.05):
            # a ++ seeding that leaves a ball without a seed can end in a
            # local optimum with two centres in one ball.  Such a fit must be
            # the one the CPU gives: the same estimator from the same random
            # state on a CPU copy of the data (plain versions, no kernel)
            after = ht.random.get_state()
            ht.random.set_state(state)
            witness = cls(n_clusters=CLUSTER_K, init=init).fit(ht.array(x.cpu(), split=0, comm=data.comm, device="cpu"))
            ht.random.set_state(after)
            cerr, n_diff, bad = witness_gate(x, centres, labels, witness.cluster_centers_.larray.float(),
                                             witness.labels_.larray.reshape(-1), l1=name != "KMeans")
            w_match = torch.cdist(witness.cluster_centers_.larray.float(), truth.cpu()).argmin(dim=1)
            print(f"[e2e] cluster benchmark {name}: the fit's centres are nearest to balls {match.tolist()}; the CPU "
                  f"fit from the same random state: balls {w_match.tolist()}, n_iter {witness.n_iter_}, centres within "
                  f"{cerr:.3e} (tolerance {WITNESS_TOL:g}), labels differ on {n_diff} rows, {bad} of them off a tie "
                  f"(tolerance 0)")
            check(cerr <= WITNESS_TOL and bad == 0,
                  f"{name}: fitted centres are not the four generating ones, nor the CPU's fit from the same state")
            del witness
        if name == "KMeans":
            d2 = k1.reference_cdist(x, centres, sqrt=False)
            top2 = d2.topk(2, dim=1, largest=False)
            clear = (top2.values[:, 1] - top2.values[:, 0]) > 2 * TOL * ((x * x).sum(1) + (centres**2).sum(1).max())
            bad, n_clear = int(((labels != top2.indices[:, 0]) & clear).sum()), int(clear.sum())
        else:
            # f32 L1 sums of three terms of ~12 are within ~1e-5 of exact
            bad, n_clear = l1_label_disagreements(x, centres, labels, margin=1e-4)
        print(f"[e2e] cluster benchmark {name}: labels vs f64 argmin: {bad} disagreements over {n_clear} rows "
              f"with a clear margin")
        check(bad == 0, f"{name}: labels disagree with the exact argmin")
        if name == "KMedoids":
            rows = bool(all(bool((x == m).all(dim=1).any()) for m in centres))
            excess = fixed_point_medoid_gate(x, centres, labels, CLUSTER_K)
            print(f"[e2e] cluster benchmark KMedoids: every medoid a row of x {rows}; exact d2 to its median minus "
                  f"the least over the rows, past K1's bound: {excess:+.4e} (converged: n_iter {est.n_iter_} < "
                  f"max_iter {est.max_iter})")
            check(rows, "a medoid is not a row of x")
            check(est.n_iter_ < est.max_iter and excess <= 0, "a medoid is not the nearest sample to its median")
        del est
    # K1 at the benchmark's geometry, d = 3
    y4 = truth + 0.5
    for sqrt in (False, True):
        abs_err, rel = compare_cdist(k1, x, y4, sqrt)
        print(f"[check] cdist d=3 {tuple(x.shape)}x{tuple(y4.shape)} sqrt={sqrt}: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel:.3e}")
        check(rel <= TOL, f"cdist d=3: relative error {rel:.3e} > {TOL}")
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0), abs_err)
    xc = x.contiguous()
    t_k = time_ms(lambda: k1.cdist(xc, y4, sqrt=False), reps=50)
    t_p = time_ms(lambda: k1.reference_cdist(xc, y4, sqrt=False), reps=20)
    t_l = time_ms(lambda: torch.cdist(xc, y4).square(), reps=20)
    t_k2 = time_ms(lambda: k1.cdist(xc, y4, sqrt=False), reps=50)
    b_ms, b_by = cdist_bound_ms(x.shape[0], CLUSTER_K, 3)
    print(f"[time] cdist d=3 ({x.shape[0]},3)x({CLUSTER_K},3): kernel_ms={t_k:.4f} (again {t_k2:.4f}) plain_ms={t_p:.4f} "
          f"library_ms={t_l:.4f} (torch.cdist(x,y).square()) bound_ms={b_ms:.4f} ({b_by}) on {card}")
    out.update(ms_d3=t_k, plain_ms_d3=t_p, library_ms_d3=t_l, bound_ms_d3=b_ms, bound_by_d3=b_by)
    del data, x, xc
    torch.cuda.empty_cache()

    # ------------------------------------ (b) at the Lloyd shape, 2e7 x 64
    k = 8
    blobs, _ = make_blobs(ROWS, 64, k, seed, dev)
    x_ht = ht.array(blobs, split=0, copy=False)
    blocks = [s.contiguous() for s in x_ht.shards]
    for name, est, snap in (
        ("KMedians", ht.cluster.KMedians(n_clusters=k, init="kmedians++", tol=-1.0, max_iter=MED_ITERS, random_state=seed), False),
        ("KMedoids", ht.cluster.KMedoids(n_clusters=k, init="kmedoids++", max_iter=MED_ITERS, random_state=seed), True),
    ):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        t0 = time.perf_counter()
        est.fit(x_ht)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = k1.launches
        out["launches"] += got
        peak = torch.cuda.max_memory_allocated() - before
        want = k + (est.n_iter_ if snap else 0)
        centres = est.cluster_centers_.larray
        check(bool(torch.isfinite(centres).all()) and tuple(centres.shape) == (k, 64), f"{name}: bad centres")
        # ms per iteration: the loop alone from the fitted centres, tol = -1
        start = centres.clone()
        _kcluster._median_loop(blocks, start, k, 1, -1.0, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _kcluster._median_loop(blocks, start, k, MED_ITERS, -1.0, snap)
        torch.cuda.synchronize()
        iter_ms = 1e3 * (time.perf_counter() - t0) / MED_ITERS
        print(f"[e2e] {name}({k}, ++) on ({ROWS}, 64) f32: fit {fit_s:.3f} s, n_iter {est.n_iter_}, inertia "
              f"{est.inertia_:.6e}, cdist launches {got} (expected {want}), {iter_ms:.4f} ms/iter ({MED_ITERS} "
              f"iterations), peak {peak / 1e9:.3f} GB above the {blobs.numel() * 4 / 1e9:.2f} GB input (gate "
              f"{MED_PEAK_GATE / 1e9:.2f} GB, one (n, k, f) f32 buffer) on {card}")
        check(got == want, f"{name}: cdist launches {got} != {want}")
        check(peak < MED_PEAK_GATE, f"{name}: peak {peak / 1e9:.3f} GB above the input")
        rows = trace(f"{name} iteration at ({ROWS}, 64), k={k}",
                     lambda: _kcluster._median_loop(blocks, start, k, 1, -1.0, snap), 1)
        kinds = by_kind(rows)
        print(f"[trace] {name} iteration by kind: " + ", ".join(f"{kk} {v:.4f} ms" for kk, v in
                                                               sorted(kinds.items(), key=lambda kv: -kv[1])))
        out[f"{name.lower()}_ms_per_iter"] = iter_ms
        del est, start
    del blobs, x_ht, blocks
    torch.cuda.empty_cache()

    # ------------------------------------------- (c) the card and the CPU
    rng = np.random.default_rng(seed + 4)
    base = np.array([[-6.0, -6.0, 0.0], [6.0, -5.0, 2.0], [0.0, 6.0, -3.0]])
    small = torch.from_numpy(np.round(np.concatenate([rng.normal(c, 1.0, (400, 3)) for c in base]) * 2)).float()
    init = small[[0, 400, 800]] + 0.5
    mesh = ht.MeshComm(4)
    for name in ("KMedians", "KMedoids"):
        fits = [
            getattr(ht.cluster, name)(n_clusters=3, init=ht.array(init.to(dev) if d == "gpu" else init, device=d),
                                      max_iter=30).fit(ht.array(small.to(dev) if d == "gpu" else small, split=0,
                                                                comm=mesh, device=d))
            for d in ("gpu", "cpu")
        ]
        a, b = fits
        same = torch.equal(a.labels_.larray.cpu(), b.labels_.larray) and torch.equal(
            a.cluster_centers_.larray.cpu(), b.cluster_centers_.larray)
        print(f"[e2e] small {name} (1200,3) card vs cpu: n_iter {a.n_iter_}/{b.n_iter_}, labels and centres equal "
              f"{same}, inertia {a.inertia_:.6e}/{b.inertia_:.6e}")
        check(same and a.n_iter_ == b.n_iter_ and abs(a.inertia_ - b.inertia_) <= 1e-5 * b.inertia_,
              f"small {name} fit differs between card and CPU")
    n_ops = card_vs_cpu_ops(ht, dev)
    print(f"[e2e] card vs cpu: {n_ops} calls of the elementwise and statistics surface agree (transcendentals "
          f"within 4 f32 ulps, sums within 1e-5, the rest bitwise)")
    return out

def make_blobs(rows: int, dim: int, k: int, seed: int, dev, scale: float = 300.0, return_labels: bool = False):
    """Gaussian blobs (sigma 1) around k centres drawn at ``scale`` (at 300
    and dim 64 every pair of centres lies ~3400 apart); made on the card
    from ``seed``.  ``(x, centres)``, and the labels with
    ``return_labels``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = scale * torch.randn(k, dim, generator=gen, device=dev)
    labels = torch.randint(0, k, (rows,), generator=gen, device=dev)
    x = torch.randn(rows, dim, generator=gen, device=dev)
    step = 1 << 20
    for s in range(0, rows, step):
        x[s : s + step] += centres[labels[s : s + step]]
    return (x, centres, labels) if return_labels else (x, centres)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qr_panel_bound_ms(m: int, n: int):
    """Least time for one panel pass over (m, n) f32: the panel read once
    and R, R^-1 written once, against the Gram's upper triangle (m n (n+1)
    flops: the kernel exploits symmetry), the Cholesky (n^3/3) and the
    triangular inverse (n^3/3)."""
    return bound(4.0 * (m * n + 2 * n * n), m * n * (n + 1) + 2.0 * n**3 / 3)


def lasso_sweep_bound_ms(m: int, n: int, reads_of_x: int = 2):
    """Least time for one sweep over (m, n) f32 as ``sweep`` computes it: X
    read twice (once by the r0 = y - Xθ GEMV, once by the sweep), y and θ
    read once and θ' written once, against r0 (2 m n flops) and, per
    coordinate, r + θ_j x_j, the dot and the residual update (6 m flops).
    ``reads_of_x=1`` is the sweep's alone, r0 given."""
    return bound(4.0 * (reads_of_x * m * n + m + 2 * n), 8.0 * m * n)


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


def compare_spmv(k6, panels, x):
    """Kernel against plain on the same repacking: (kernel's y, max abs
    err, max err relative to Σⱼ|vals·x|)."""
    got = k6.spmv(panels, x)
    want = k6.reference_spmv(panels, x)
    scale = k6.reference_spmv(panels._replace(vals=panels.vals.abs()), x.abs())
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(want.shape), f"spmv shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite spmv output")
    err = (got - want).abs()
    return got, float(err.max()), float((err / scale.clamp_min(1e-30)).max())


def spmv_traffic(k6, panels, k: int, ell_width: int) -> str:
    """What a model of one K6 call moves, from its repacking and launch
    plan (no counter reads it: ``ncu`` does not run on the card's
    machine): the entries' bytes (the bound's), the bytes its 16-byte quad
    loads request (whole quads of each run; a quad at a run's end is
    requested by both runs it touches), the run bounds, and x: the panels
    the CTAs copy from L2 (tiles x passes x ncols x KC x 4) when staged,
    else a 32-byte sector a gather.  Beside it the pad share the JAX
    package's ELL slabs of ``ell_width`` would hold (none stored or read)."""
    staged = panels.staged
    geo = k6.plan(panels.rows, panels.ncols, panels.nnz, k,
                  torch.cuda.get_device_properties(panels.off.device).multi_processor_count, staged)
    off = panels.off.to(torch.int64)
    a, b = off[:-1], off[1:]
    quads = int(torch.where(b > a, (b + 3) // 4 - a // 4, torch.zeros_like(a)).sum())
    x_bytes = geo.tiles * geo.passes * panels.ncols * geo.kc * 4 if staged else 32 * panels.nnz * geo.passes
    return (f"ELL pad share {1.0 - panels.nnz / max(1, panels.rows * ell_width):.4f} (none stored or read); "
            f"modelled from the repacking: quad loads {32 * quads * geo.passes / 1e6:.2f} MB (entries "
            f"{8 * panels.nnz * geo.passes / 1e6:.2f}), run bounds {4 * off.numel() * geo.passes / 1e6:.2f} MB, x "
            + (f"panels {x_bytes / 1e6:.2f} MB copied from L2" if staged else f"gathers {x_bytes / 1e6:.2f} MB of sectors")
            + f" ({'staged' if staged else 'from memory, one run a row'}; {geo.tiles} tiles x {geo.panels} panels, "
            f"{geo.tpr} threads a row); the repacking holds "
            f"{(panels.vals.numel() + panels.cols.numel() + off.numel()) * 4 / 1e6:.2f} MB")


def check_spmv_geometries(k6, gen, dev) -> int:
    """K6 at its panels' edges against the plain version: x over 3 (k = 1)
    or 10 (k = 4) panels at k = 1, 2, 4, 5, also x and the CSR arrays one
    element off 16 bytes; every row's entries inside one panel, a third of
    the rows empty; one row over all of 70001 columns; ~12 entries a row
    of 60001 columns (one run a row, x gathered from memory); row counts
    off the tile.
    Each within TOL_SPMV, each rerun bitwise.  Returns the cases."""
    cases = 0

    def one(what, sv, sc, sp, ncols, k, x_off=0):
        nonlocal cases
        if x_off:  # the CSR arrays one element off too: the kernel reads their repacking
            sv, sc = (torch.cat([a.new_zeros(1), a])[1:] for a in (sv, sc))
        t = k6.csr_panels(sv, sc, sp, ncols)
        shape = (ncols,) if k is None else (ncols, k)
        x = torch.randn(ncols * (k or 1) + x_off, generator=gen, device=dev)[x_off:].view(shape)
        got, err, rel = compare_spmv(k6, t, x)
        again = k6.spmv(t, x)
        torch.cuda.synchronize()
        check(rel <= TOL_SPMV, f"spmv {what} k={k}: relative error {rel:.3e} > {TOL_SPMV}")
        check(torch.equal(got, again), f"spmv {what} k={k}: a rerun differs")
        cases += 1

    for k in (None, 1, 2, 4, 5):
        sv, sc, sp = random_csr(3001, 60_001, 0.01, gen, dev)
        one("3001 x 60001", sv, sc, sp, 60_001, k)
        one("3001 x 60001, x and the CSR one element off 16 bytes", sv, sc, sp, 60_001, k, x_off=1)
        sv, sc, sp = random_csr(2050, 6144, 0.02, gen, dev)
        row_of = torch.repeat_interleave(torch.arange(2050, device=dev), sp[1:] - sp[:-1])
        keep = row_of % 3 != 0
        sp2 = torch.zeros_like(sp)
        sp2[1:] = torch.cumsum(torch.bincount(row_of[keep], minlength=2050), 0)
        one("2050 rows in one panel, a third empty", sv[keep], sc[keep] + 30_720, sp2, 50_000, k)
        cnt = torch.tensor([0, 3, 70_001, 1, 0, 2, 5], device=dev)
        sp = torch.zeros(8, dtype=torch.int64, device=dev)
        sp[1:] = torch.cumsum(cnt, 0)
        sc = torch.cat([torch.sort(torch.randperm(70_001, generator=gen, device=dev)[: int(n)]).values for n in cnt])
        one("a row over all 70001 columns", torch.randn(int(sp[-1]), generator=gen, device=dev), sc.to(torch.int32),
            sp, 70_001, k)
        sv, sc, sp = random_csr(20_000, 60_001, 0.0002, gen, dev)
        one("20000 sparse rows, one run a row", sv, sc, sp, 60_001, k)
    return cases


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
    cannot describe), the f32 kernel at d = 20 (its 4-byte copies) and
    d = 256 with sq != sk, and its reruns; returns the largest f32 and
    16-bit |Δo|."""
    worst, worst_16 = 0.0, 0.0
    cases = [((64, 2048, 2048, 64), torch.float32, True)]
    cases += [((ATTN_BH, ATTN_S, ATTN_S, ATTN_D), dt, c) for dt in (torch.bfloat16, torch.float32) for c in (True, False)]
    cases += [((4, 1000, 1337, 24), torch.float32, c) for c in (True, False)]
    cases += [((4, 1000, 1337, 24), torch.float16, True), ((2, 77, 77, 256), torch.float32, True)]
    cases += [((ATTN_BH, 2048, 2048, 64), torch.bfloat16, True), ((4, 1024, 1024, 256), torch.bfloat16, False)]
    cases += [((4, 1000, 1337, 20), torch.bfloat16, c) for c in (True, False)]
    cases += [((4, 1000, 1337, 20), torch.float32, c) for c in (True, False)]
    cases += [((4, 700, 900, 256), torch.float32, c) for c in (True, False)]
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
    and bf16 at k = 8200 (not a multiple of the 64-deep tile); in f32 also
    (1000x777)(777x1333) on bases off 16 bytes and (513x1024)(1024x260),
    ragged tiles on the 16-byte copies; every case reruns bitwise equal.
    Returns the largest f32 and 16-bit |Δc|."""
    worst, worst_16 = 0.0, 0.0
    cases = [((m, k, n), dt, False) for (m, k, n) in [(MATMUL_N, MATMUL_N, MATMUL_N), (1000, 777, 1333), (1, 1, 1)]
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1000, 777, 1333), torch.float16, False), ((2048, 2048, 2048), torch.bfloat16, True),
              ((1000, 777, 1333), torch.bfloat16, True), ((MATMUL_N, MATMUL_N + 8, MATMUL_N), torch.bfloat16, False)]
    cases += [((1000, 777, 1333), torch.float32, True), ((513, 1024, 260), torch.float32, False)]
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


def kernel_trace(k3, k2, gen, dev) -> None:
    """One call of each of K3 and K2 in bf16 and in f32 under torch.profiler:
    each runs its own kernel and no other (no SDPA, no cuBLAS; bf16 the
    tensor-core kernels, f32 the CUDA-core ones)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for dt, want_k3, want_k2 in [(torch.bfloat16, "flash_fwd_kernel_tc", "mm_tc_kernel"),
                                 (torch.float32, "flash_fwd_kernel<", "mm_kernel<")]:
        q, k, v = (torch.randn(ATTN_BH, ATTN_S, ATTN_D, generator=gen, device=dev).to(dt) for _ in range(3))
        a, b = (torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev).to(dt) for _ in range(2))
        for name, fn, want in [("flash_attention", lambda: k3.flash_attention(q, k, v), want_k3),
                               ("pallas_matmul", lambda: k2.matmul(a, b), want_k2)]:
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
            print(f"[trace] one {str(dt)[6:]} {name} call runs: {names}")
            check(len(names) == 1 and want in names[0], f"{dt} {name} ran {names}, not {want} alone")
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
    (59999998, 10) past 2^31 bytes and the same bytes one f32 element off
    16-byte alignment, five other dtypes at a ragged shape, int8 segments
    at odd byte offsets and at every (source, destination) alignment pair
    mod 16, zero rows, and two reruns.
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
        if shape == REPACK_BIG_OUT:
            # the same bytes one f32 element off 16-byte alignment
            del got, want
            torch.cuda.empty_cache()
            segs = [(flat, 1, total - 1)]
            got = k7.repack_segments(segs, (total - 1,))
            want = k7.reference_repack_segments(segs, (total - 1,))
            torch.cuda.synchronize()
            same = torch.equal(raw(got), raw(want))
            all_equal = all_equal and same
            print(f"[check] repack ({total - 1},) f32 from element offset 1 ({4 * (total - 1) / 1e9:.3f} GB): "
                  f"bitwise equal to plain {same}")
            check(same, "repack from a misaligned source: not bitwise equal to its plain version")
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
    # every (source mod 16, destination mod 16) pair, int8: a first segment
    # of `do` bytes puts the second one's destination there
    pairs = 0
    for so in range(16):
        for do in range(16):
            segs = ([(a, 200, do)] if do else []) + [(a, so, 70_001)]
            total = sum(n for _, _, n in segs)
            pairs += torch.equal(raw(k7.repack_segments(segs, (total,))), raw(k7.reference_repack_segments(segs, (total,))))
    all_equal = all_equal and pairs == 256
    print(f"[check] repack_segments int8 at every (source, destination) alignment pair mod 16: {pairs}/256 bitwise equal to plain")
    check(pairs == 256, "repack_segments differs at some alignment pair")
    n0 = k7.launches
    empty = k7.repack_segments([(a, 7, 0)], (0, 10))
    check(tuple(empty.shape) == (0, 10) and k7.launches == n0, "zero rows launched or misshaped")
    print("[check] repack zero rows: (0, 10), no launch")
    return all_equal, max_abs


def time_repack(k7, gen, dev, card: str) -> dict:
    """K7 beside its plain version, the library copy (``flat.clone()`` for
    one segment, ``torch.cat`` for three) and its bytes bound.  Kernel and
    library are timed in turns (library, kernel, kernel, library), aligned
    and from a source one f32 element off 16-byte alignment; each keeps the
    smaller of its two times."""
    times = {}
    for shape, reps in ((REPACK_OUT, 50), (REPACK_BIG_OUT, 10)):
        total = shape[0] * shape[1]
        buf = torch.randn(total + 1, generator=gen, device=dev)
        flat = buf[:total]
        t_p = time_ms(lambda: k7.reference_repack(flat, shape), reps=reps)
        b_ms, b_by = repack_bound_ms(4 * total)
        for off in (0, 1):
            src = buf[off : off + total]
            t_l1 = time_ms(lambda: src.clone(), reps=reps)
            t_k1 = time_ms(lambda: k7.repack_segments([(buf, off, total)], shape), reps=reps)
            t_k2 = time_ms(lambda: k7.repack_segments([(buf, off, total)], shape), reps=reps)
            t_l2 = time_ms(lambda: src.clone(), reps=reps)
            t_k, t_l = min(t_k1, t_k2), min(t_l1, t_l2)
            if off == 0:
                times[shape] = (t_k, t_p, t_l, b_ms, b_by)
                print(f"[time] repack ({total},) -> {shape} f32: kernel_ms={t_k:.4f} ({t_k1:.4f} {t_k2:.4f}) "
                      f"plain_ms={t_p:.4f} library_ms={t_l:.4f} ({t_l1:.4f} {t_l2:.4f}, flat.clone()) "
                      f"bound_ms={b_ms:.4f} ({b_by}), {2 * 4 * total / t_k / 1e6:.1f} GB/s, "
                      f"kernel/library={t_k / t_l:.3f} on {card}")
            else:
                # the kernel realigns 16-byte source words to 16-byte stores
                times[(shape, "misaligned")] = (t_k, t_l)
                print(f"[time] repack ({total},) -> {shape} f32 from element offset 1 (source 4 bytes off 16-byte "
                      f"alignment): kernel_ms={t_k:.4f} ({t_k1:.4f} {t_k2:.4f}) library_ms={t_l:.4f} "
                      f"({t_l1:.4f} {t_l2:.4f}, buf[1:].clone()) kernel/library={t_k / t_l:.3f} on {card}")
        del flat, buf, src
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


def timed_call(fn):
    """``fn()`` once on the card: (result, ms by the host clock around a
    synchronize, peak bytes allocated above what existed before the call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated() - base


def destinations_with_rows(mesh, n: int, rows: torch.Tensor) -> int:
    """Positions of a split-0 extent ``n`` over ``mesh`` that own one of the
    (sorted or not) global ``rows``: K7's launches for an assignment."""
    ends = torch.tensor([mesh.chunk((n,), 0, rank=r)[0] + mesh.chunk((n,), 0, rank=r)[1][0] for r in range(mesh.size)],
                        device=rows.device)
    return int(torch.unique(torch.searchsorted(ends, rows, right=True)).numel())


def runtime_card_vs_cpu(ht, dev, card_device: str = "gpu") -> int:
    """One call of each name of the runtime core on the card and on the CPU
    over ``MeshComm(4)``, on the same small inputs: bitwise, ``logspace``
    within 32 float64 ulps (the card's ``pow``); random draws, whose
    generators differ between card and CPU, by their properties.  Returns
    the count of calls compared."""
    mesh = ht.MeshComm(4)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((37, 6)).astype(np.float32)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    mask = x[:, 0] > 0
    small = rng.standard_normal((int(mask.sum()), 6)).astype(np.float32)

    def put(key, value, split=0, src=x):
        def op(d):
            a = ht.array(src, split=split, comm=mesh, device=d)
            v = value(d) if callable(value) else value
            a[key] = v
            return a
        return op

    def arr(v, split=0):
        return lambda d: ht.array(v, split=split, comm=mesh, device=d)

    def lloc_put(d):
        a = arr(x, 1)(d)
        a.lloc[0:2] = 1.0
        return a

    cases = [
        ("full", lambda d: ht.full((37, 6), 2.5, split=0, comm=mesh, device=d)),
        ("full_like", lambda d: ht.full_like(arr(x)(d), -1)),
        ("zeros_like", lambda d: ht.zeros_like(arr(x, 1)(d))),
        ("ones_like", lambda d: ht.ones_like(arr(x)(d), dtype=ht.int8)),
        ("empty_like", lambda d: ht.zeros(ht.empty_like(arr(x)(d)).shape, split=0, comm=mesh, device=d)),
        ("eye", lambda d: ht.eye((37, 29), split=0, comm=mesh, device=d)),
        ("eye split 1", lambda d: ht.eye(33, split=1, comm=mesh, device=d)),
        ("linspace", lambda d: ht.linspace(-3.5, 7.25, 1001, split=0, comm=mesh, device=d)),
        ("linspace f32", lambda d: ht.linspace(0, 1, 999, endpoint=False, dtype=ht.float32, split=0, comm=mesh, device=d)),
        ("meshgrid", lambda d: ht.meshgrid(arr(x[:, 0])(d), arr(x[0], None)(d))[0]),
        ("asarray", lambda d: ht.asarray(x, dtype=ht.float64, is_split=0, comm=mesh, device=d)),
        ("from_partitioned", lambda d: ht.from_partitioned(arr(x)(d), comm=mesh)),
        ("copy", lambda d: ht.copy(arr(x)(d))),
        ("iscomplex", lambda d: ht.iscomplex(arr(z)(d))),
        ("isreal", lambda d: ht.isreal(arr(z)(d))),
        ("real", lambda d: arr(z)(d).real),
        ("imag", lambda d: arr(z)(d).imag),
        ("transpose", lambda d: arr(x)(d).transpose()),
        ("scalar_to_1d", lambda d: ht.scalar_to_1d(ht.array(np.float32(2.5), comm=mesh, device=d))),
        ("sanitize_distribution", lambda d: ht.sanitize_distribution(arr(x)(d), target=arr(x, 1)(d))),
        ("fill_diagonal", lambda d: arr(x)(d).fill_diagonal(-2.0)),
        ("fill_diagonal split 1", lambda d: arr(x, 1)(d).fill_diagonal(-2.0)),
        ("setitem slice", put(slice(3, 30), lambda d: arr(x[:27] * 2)(d))),
        ("setitem strided", put((slice(3, 30), slice(1, 4)), lambda d: arr(x[:27, :3] * 2)(d))),
        ("setitem negative step", put(slice(30, 3, -2), 7.0)),
        ("setitem row mask", put(mask, lambda d: arr(small)(d))),
        ("setitem full mask", put(x > 0.5, 0.0)),
        ("setitem int array", put(np.array([36, 0, -5, 11]), lambda d: arr(x[:4])(d))),
        ("setitem mixed", put((slice(None), np.array([5, 1])), 3.0, split=1)),
        ("setitem split-1 value", put(slice(2, 8), lambda d: arr(x[10:16], 1)(d))),
        ("setitem replicated", put(slice(0, 2), 1.0, split=None)),
        ("lloc", lloc_put),
    ]
    for name, op in cases:
        a, b = op(card_device), op("cpu")
        torch.cuda.synchronize()
        ok = a.shape == b.shape and a.split == b.split and a.dtype is b.dtype and all(
            torch.equal(raw(u.cpu()), raw(v)) for u, v in zip(a.shards, b.shards))
        check(ok, f"runtime card vs cpu {name} differs")
    a = ht.logspace(0, 3, 777, split=0, comm=mesh, device=card_device).larray.cpu()
    b = ht.logspace(0, 3, 777, split=0, comm=mesh, device="cpu").larray
    eps = torch.finfo(torch.float64).eps
    check(bool(torch.isclose(a, b, rtol=32 * eps, atol=0).all()), "runtime card vs cpu logspace differs")
    # members and printing: equal values, the string up to the device's name
    a, b = arr(x)(card_device), arr(x)("cpu")
    check(a.tolist() == b.tolist() and a.counts_displs() == b.counts_displs() and a.nbytes == b.nbytes
          and a.strides == b.strides and torch.equal(a.lloc[1:3], b.lloc[1:3].to(dev))
          and torch.equal(a.cpu().larray, b.larray), "runtime card vs cpu members differ")
    check(str(a).replace(str(a.device), "cpu:0") == str(b), "runtime card vs cpu str differs")
    # random draws: properties on the card
    ht.random.seed(3)
    p = ht.random.randperm(1001, split=0, comm=mesh).larray
    check(torch.equal(torch.sort(p).values, torch.arange(1001, dtype=torch.int32, device=dev)), "card randperm")
    r = ht.random.randint(0, 256, (5000,), dtype=ht.uint8, split=0, comm=mesh).larray
    check(int(r.min()) == 0 and int(r.max()) == 255, "card randint bounds")
    xs, idx = ht.random.shuffle_rows([arr(x)(card_device), ht.arange(37, split=0, comm=mesh)])
    check(torch.equal(xs.larray, torch.from_numpy(x).to(dev)[idx.larray]), "card shuffle_rows")
    q = ht.random.permutation(arr(x, 1)(card_device)).larray
    check(torch.equal(torch.sort(q[:, 0]).values, torch.sort(torch.from_numpy(x[:, 0]).to(dev)).values), "card permutation")
    nrm = ht.random.normal(ht.array(torch.full((4,), 5.0, device=dev), comm=mesh), 0.5, (200_000, 4), split=0, comm=mesh)
    check(abs(float(nrm.larray.mean()) - 5) < 0.01, "card normal")
    state = ht.random.get_state()
    first = ht.random.rand(5).larray
    ht.random.set_state(state)
    check(torch.equal(ht.random.rand(5).larray, first), "card get_state/set_state")
    return len(cases) + 9


def runtime_core_paths(ht, k1, k7, seed: int, dev, card: str, card_device: str = "gpu") -> dict:
    """The runtime core over ``MeshComm(4)`` on the card at the Lloyd shape:
    (a) the data pipeline users write to feed a fit (randint labels, mask
    assignments of normal draws, ``shuffle_rows``, ``KMeans`` through K1);
    (b) assignments across position bounds (a split value re-cut by K7, an
    integer put, a full mask); (c) the factories at size; (d) ``str`` of
    the 5.12 GB array; (e) one call of each new name on card and CPU.
    Returns the K1 and K7 launches of (a) and (b)."""
    mesh = ht.MeshComm(TRANSPORT_MESH)
    ht.random.seed(seed + 14)
    n, f, k = RT_ROWS, RT_F, RT_K
    out = {}

    # (a) the data pipeline
    k1.launches = 0
    k7.launches = 0
    centres = ht.random.normal(0, 300, (k, f), comm=mesh)
    labels = ht.random.randint(0, k, n, split=0, comm=mesh)
    x = ht.empty((n, f), split=0, comm=mesh)
    blocks, ms, peaks, k7_want = [], [], [], 0
    for c in range(k):
        m = labels == c
        blk = ht.random.randn(int(m.sum()), f, split=0, comm=mesh) + centres[c]
        k7_want += destinations_with_rows(mesh, n, torch.nonzero(m.larray).reshape(-1))
        _, t_ms, peak = timed_call(lambda: x.__setitem__(m, blk))
        blocks.append(blk)
        ms.append(t_ms)
        peaks.append(peak)
    pipeline_k7 = k7.launches
    lab = labels.larray
    want = torch.empty(n, f, device=dev)
    for c, blk in enumerate(blocks):
        want[lab == c] = blk.larray
    built = same_shards(x, want, mesh)
    print(f"[e2e] runtime x[labels == c] = randn(count_c, {f}) + centres[c] for {k} clusters, ({n},{f}) f32 split 0 over "
          f"MeshComm({mesh.size}): {sum(ms) / k:.4f} ms per assignment (max {max(ms):.4f}), peak above x, key and value "
          f"{max(peaks) / 1e9:.6f} GB, repack launches {pipeline_k7} (expected {k7_want}), every row its block's row "
          f"bitwise {built} on {card}")
    check(built, "runtime: the mask assignments differ from torch's")
    check(pipeline_k7 == k7_want, f"runtime: repack launches {pipeline_k7} != {k7_want}")
    check(max(peaks) <= 4 * f * max(b.shape[0] for b in blocks), "runtime: a mask assignment held more than its value")
    del blocks
    out["mask_ms"] = sum(ms) / k
    state = ht.random.get_state()
    (xs, ls), shuffle_ms, shuffle_peak = timed_call(lambda: ht.random.shuffle_rows([x, labels]))
    ht.random.set_state(state)
    (idx,) = ht.random.shuffle_rows([ht.arange(n, split=0, comm=mesh)])
    moved = (n * f + n) * 4
    idx_t = idx.larray
    paired = same_shards(xs, want[idx_t], mesh) and same_shards(ls, lab[idx_t], mesh)
    print(f"[e2e] runtime shuffle_rows([x, labels]) over MeshComm({mesh.size}): {shuffle_ms:.4f} ms, "
          f"{2 * moved / shuffle_ms / 1e6:.1f} GB/s (2 x {moved / 1e9:.3f} GB moved), peak above the inputs "
          f"{shuffle_peak / 1e9:.3f} GB, rows paired with their generating rows through the permutation bitwise {paired} on {card}")
    check(paired, "runtime: shuffle_rows lost a row's pairing")
    # one copy of the inputs, plus the permutation and its draw (eight int64
    # words a row bound torch.randperm's sort on the card)
    check(shuffle_peak <= moved + 64 * n, "runtime: shuffle_rows held more than one copy of its inputs and the permutation")
    del x, labels, want, lab, idx, idx_t
    torch.cuda.empty_cache()
    out["shuffle_ms"] = shuffle_ms
    perm, perm_ms, perm_peak = timed_call(lambda: ht.random.randperm(RT_PERM, split=0, comm=mesh))
    is_perm = torch.equal(torch.sort(perm.larray).values, torch.arange(RT_PERM, dtype=torch.int32, device=dev))
    print(f"[e2e] runtime randperm({RT_PERM}, split=0): {perm_ms:.4f} ms, peak {perm_peak / 1e9:.3f} GB, "
          f"its sort equals arange {is_perm} on {card}")
    check(is_perm, "runtime: randperm is not a permutation")
    del perm
    torch.cuda.empty_cache()

    k1.launches = 0
    model, fit_ms, _ = timed_call(lambda: ht.cluster.KMeans(n_clusters=k, init=centres, max_iter=RT_ITERS, tol=-1).fit(xs))
    fit_k1 = k1.launches
    fitted = model.cluster_centers_.larray.float()
    gen_c = centres.larray
    centre_err = float((fitted - gen_c).norm(dim=1).max())
    pred = model.labels_.larray.reshape(-1)
    truth = ls.larray.to(pred.dtype)
    d2 = torch.cat([k1.reference_cdist(s, fitted, sqrt=False) for s in xs.shards])
    top2 = d2.topk(2, dim=1, largest=False)
    scale = torch.cat([(s * s).sum(1) for s in xs.shards]) + (fitted * fitted).sum(1).max()
    clear = (top2.values[:, 1] - top2.values[:, 0]) > 2 * TOL * scale
    disagree = int(((pred != truth) & clear).sum())
    k1_want = (RT_ITERS + 1) * mesh.size
    print(f"[e2e] runtime KMeans(k={k}, init=centres, max_iter={RT_ITERS}, tol=-1).fit(shuffled x): {fit_ms:.3f} ms, "
          f"centre error {centre_err:.4e} (tolerance 0.05), labels vs the generating labels: {disagree} disagreements "
          f"over {int(clear.sum())} rows with a clear margin, cdist launches {fit_k1} (expected {k1_want}) on {card}")
    check(centre_err <= 0.05, f"runtime: centre error {centre_err} > 0.05")
    check(disagree == 0, f"runtime: {disagree} labels differ from the generating ones")
    check(fit_k1 == k1_want, f"runtime: cdist launches {fit_k1} != {k1_want}")
    out["k1"] = fit_k1
    del model, d2, top2, scale, clear, pred, truth, ls
    torch.cuda.empty_cache()

    # (b) assignments across position bounds, on the shuffled x
    x = xs
    g = torch.cat(x.shards)
    hi = RT_LO + RT_SLICE
    y = ht.random.randn(RT_SLICE, f, split=0, comm=mesh)
    g[RT_LO:hi] = y.larray
    k7.launches = 0
    _, first_ms, peak = timed_call(lambda: x.__setitem__(slice(RT_LO, hi), y))
    slice_k7 = k7.launches
    exact = same_shards(x, g, mesh)
    slice_ms = time_ms(lambda: x.__setitem__(slice(RT_LO, hi), y), reps=5, warmup=1)
    vbytes = RT_SLICE * f * 4
    bound_ms = 1e3 * 2 * vbytes / HBM_BYTES_PER_S
    k7_want = destinations_with_rows(mesh, n, torch.arange(RT_LO, hi, device=dev))
    print(f"[e2e] runtime x[{RT_LO}:{hi}] = y ({RT_SLICE},{f}) f32 split 0 over MeshComm({mesh.size}): {slice_ms:.4f} ms/call "
          f"(first {first_ms:.4f}), bound {bound_ms:.4f} ms (2 x {vbytes / 1e9:.3f} GB / 3.35 TB/s), peak above x, key "
          f"and value {peak / 1e9:.6f} GB, repack launches {slice_k7} (expected {k7_want}), bitwise equal to torch's "
          f"{exact} on {card}")
    check(exact, "runtime: x[lo:hi] = y differs from torch's")
    check(slice_k7 == k7_want == 3, f"runtime: repack launches {slice_k7} != {k7_want}")
    check(peak <= vbytes, f"runtime: x[lo:hi] = y held {peak} bytes above x, key and value")
    out["slice_ms"], out["slice_bound_ms"], out["k7"] = slice_ms, bound_ms, pipeline_k7 + slice_k7
    del y
    torch.cuda.empty_cache()
    rows = ht.random.randperm(n, split=0, comm=mesh)[:RT_PUT]
    v = ht.random.randn(RT_PUT, f, split=0, comm=mesh)
    g[rows.larray.long()] = v.larray
    _, put_ms, peak = timed_call(lambda: x.__setitem__(rows, v))
    exact = same_shards(x, g, mesh)
    print(f"[e2e] runtime x[rows] = v, rows {RT_PUT} of a randperm({n}), v ({RT_PUT},{f}) split 0: {put_ms:.4f} ms, "
          f"peak above x, key and value {peak / 1e9:.6f} GB (the value {RT_PUT * f * 4 / 1e9:.3f} GB), bitwise equal "
          f"to torch's {exact} on {card}")
    check(exact, "runtime: x[rows] = v differs from torch's")
    check(peak <= RT_PUT * f * 4, "runtime: x[rows] = v held more than its value")
    del rows, v
    mk = x > 2.5
    g[mk.larray] = 0.0
    _, mask_ms, peak = timed_call(lambda: x.__setitem__(mk, 0.0))
    exact = same_shards(x, g, mesh)
    print(f"[e2e] runtime x[x > 2.5] = 0 (a full-ndim mask, scalar value): {mask_ms:.4f} ms, peak above x, key and the "
          f"value on the card {peak} bytes, bitwise equal to torch's {exact} on {card}")
    check(exact, "runtime: x[mask] = 0 differs from torch's")
    check(peak <= 512, "runtime: x[mask] = 0 held more than the value's 512-byte block")
    del mk, g
    torch.cuda.empty_cache()

    # (d) str of the 5.12 GB array
    s, str_ms, _ = timed_call(lambda: str(x))
    moved = ht.printing.last_bytes_moved
    host = x.numpy()
    with np.printoptions(precision=4, threshold=1000, edgeitems=3, linewidth=120):
        body = np.array2string(host)
    same_str = s == f"DNDarray({body}, dtype=ht.float32, device={x.device}, split=0)"
    print(f"[e2e] runtime str(x) of ({n},{f}) f32: {str_ms:.4f} ms, {moved} bytes to the host, equal to numpy's "
          f"array2string of the host copy {same_str} on {card}")
    check(same_str, "runtime: str(x) differs from numpy's array2string")
    del host, x, xs
    torch.cuda.empty_cache()

    # (c) factories at size, each against torch on the card
    e, eye_ms, eye_peak = timed_call(lambda: ht.eye(RT_EYE, split=0, comm=mesh))
    ebytes = RT_EYE * RT_EYE * 4
    ge = torch.eye(RT_EYE, device=dev)
    eye_ok = same_shards(e, ge, mesh)
    _, diag_ms, diag_peak = timed_call(lambda: e.fill_diagonal(5.0))
    ge.diagonal().fill_(5.0)
    diag_ok = same_shards(e, ge, mesh)
    print(f"[e2e] runtime eye({RT_EYE}, split=0) f32 ({ebytes / 1e9:.3f} GB): {eye_ms:.4f} ms, peak {eye_peak / 1e9:.4f} GB, "
          f"bitwise torch.eye {eye_ok}; fill_diagonal {diag_ms:.4f} ms, peak {diag_peak} bytes, bitwise {diag_ok} on {card}")
    check(eye_ok and diag_ok, "runtime: eye or fill_diagonal differs from torch's")
    check(eye_peak <= ebytes * 1.001 and diag_peak <= 512, "runtime: eye held more than itself, or fill_diagonal allocated")
    del e, ge
    torch.cuda.empty_cache()
    lin, lin_ms, lin_peak = timed_call(lambda: ht.linspace(0, 1, RT_LIN, split=0, comm=mesh))
    ref = torch.linspace(0, 1, RT_LIN, dtype=torch.float64, device=dev)
    eps = torch.finfo(torch.float64).eps
    lin_err = float((lin.larray - ref).abs().max()) / eps
    del lin, ref
    lg, log_ms, _ = timed_call(lambda: ht.logspace(0, 2, RT_LIN // 10, split=0, comm=mesh))
    ref = torch.pow(10.0, torch.linspace(0, 2, RT_LIN // 10, dtype=torch.float64, device=dev))
    log_err = float(((lg.larray - ref).abs() / ref).max()) / eps
    del lg, ref
    print(f"[e2e] runtime linspace(0, 1, {RT_LIN}, split=0) f64: {lin_ms:.4f} ms, peak {lin_peak / 1e9:.3f} GB, "
          f"max |d| against torch.linspace {lin_err:.2f} ulps of 1 (tolerance {TOL_LIN_ULPS}); logspace(0, 2, "
          f"{RT_LIN // 10}) {log_ms:.4f} ms, max relative |d| against 10 ** torch.linspace {log_err:.2f} ulps "
          f"(tolerance {TOL_LOG_ULPS}) on {card}")
    check(lin_err <= TOL_LIN_ULPS and log_err <= TOL_LOG_ULPS, "runtime: linspace or logspace off torch's")
    torch.cuda.empty_cache()
    like = ht.empty((n, f), split=0, comm=mesh)
    for name, make, value in [("full", lambda: ht.full((n, f), 2.5, split=0, comm=mesh), 2.5),
                              ("zeros_like", lambda: ht.zeros_like(like), 0.0),
                              ("ones_like", lambda: ht.ones_like(like), 1.0),
                              ("full_like", lambda: ht.full_like(like, 7), 7.0),
                              ("empty_like", lambda: ht.empty_like(like), None)]:
        a, a_ms, a_peak = timed_call(make)
        ok = a.shape == (n, f) and a.split == 0 and a.dtype is ht.float32 and (
            value is None or all(torch.equal(s, torch.full_like(s, value)) for s in a.shards))
        print(f"[e2e] runtime {name} ({n},{f}) f32 split 0: {a_ms:.4f} ms, peak {a_peak / 1e9:.3f} GB, "
              f"{'bitwise torch.full' if value is not None else 'shape and split'} {ok} on {card}")
        check(ok and a_peak <= n * f * 4 * 1.001, f"runtime: {name} differs or held more than itself")
        del a
    del like
    torch.cuda.empty_cache()

    # (e) every new name on the card and the CPU
    calls = runtime_card_vs_cpu(ht, dev, card_device)
    print(f"[e2e] runtime core: {calls} calls of its names on MeshComm({mesh.size}) equal on card and cpu")
    return out


# ------------------------------------------- linear algebra and classifiers
# (a) KNN at the served benchmark's shape (benchmarks/cb/config.py:211-212,
# benchmarks/cb/quantize.py:157-170); (b) GaussianNB at the Lloyd shape
# (config.py:159-162); (c) svd (config.py:152-153); (d) det and inv at
# 2048^2; (e) convolve, pad modes and tiles
KNN_N, KNN_F, KNN_K, KNN_REQS = 65_536, 64, 5, 128
KNN_PEAK_GATE = 1.1 * 4 * KNN_N * KNN_N  # the distance matrix + 10%
GNB_K = 8
GNB_PEAK_GATE = 4.0 * ROWS * GNB_K * 64  # one (n, c, f) f32 buffer
SVD_SHAPES = [((1_000_000, 128), 0), ((2048, 2048), None)]
DET_N = 2048
CONV_N, CONV_K = 100_000_000, 1025
PAD_WIDTH = (1000, 2500)
PAD_MODES = ("reflect", "symmetric", "edge", "wrap", "linear_ramp")
TILE_N = 2048


def knn_reference(q: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, k: int):
    """Plain float64 k-NN on the card (the host would take minutes at 65536^2):
    the majority of the k nearest binary labels, and whether the k-th and
    (k+1)-th squared distances differ by more than K1's bound
    1e-5 (|q|^2 + |y|^2)."""
    x64 = x.double()
    x2 = (x64 * x64).sum(1)
    out, clear = [], []
    for lo in range(0, q.shape[0], 2048):
        qb = q[lo : lo + 2048].double()
        q2 = (qb * qb).sum(1)
        d = q2[:, None] + x2[None, :] - 2.0 * (qb @ x64.T)
        v, i = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
        votes = labels[i[:, :k]].sum(1)
        out.append((2 * votes > k).to(labels.dtype))
        bound = 1e-5 * (q2 + torch.maximum(x2[i[:, k - 1]], x2[i[:, k]]))
        clear.append((v[:, k] - v[:, k - 1]) > bound)
        del d
    return torch.cat(out), torch.cat(clear)


def kernel_count(fn) -> int:
    """CUDA kernels (and copies) ``fn`` launches, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def host_syncs(fn) -> list:
    """Calls in ``fn`` that wait for the card (reads of a tensor value by
    the host and the like), from torch.cuda's sync debug mode: the
    ``file:line`` of each."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature ...") is not a sync
    return [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]


def knn_paths(ht, k1, seed: int, dev, card: str, mesh) -> dict:
    """(a) KNeighborsClassifier(5) fitted on 65536 x 64 f32 at split 0 over
    MeshComm(4): one predict of 65536 fresh split-0 queries (a K1 launch a
    position against the gathered corpus, then the top-k and the vote), and
    the benchmark's 128 served requests of 1-8 replicated rows (column-split
    distances, candidates merged)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    X = torch.randn(KNN_N, KNN_F, generator=gen, device=dev)
    labels = (X[:, 0] > 0).to(torch.int32)
    Q = torch.randn(KNN_N, KNN_F, generator=gen, device=dev)
    n_pos = mesh.size
    # K1 at the shapes this path gives it, against its plain version
    rows = KNN_N // n_pos
    for name, a in (("knn batch block", Q[:rows]), ("knn request", Q[:8])):
        b = X if a.shape[0] == rows else X[:rows]
        abs_err, rel = compare_cdist(k1, a, b, True)
        print(f"[check] cdist {name} {tuple(a.shape)}x{tuple(b.shape)} sqrt=True: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel:.3e}")
        check(rel <= TOL, f"cdist {name}: relative error {rel:.3e} > {TOL}")
    t_k = time_ms(lambda: k1.cdist(Q[:rows], X, sqrt=True), reps=10)
    t_p = time_ms(lambda: k1.reference_cdist(Q[:rows], X, sqrt=True), reps=3)
    t_l = time_ms(lambda: torch.cdist(Q[:rows], X), reps=3)
    nbytes = 4.0 * (rows * KNN_F + KNN_N * KNN_F + rows * KNN_N)
    flops = 2.0 * rows * KNN_N * KNN_F + 2.0 * (rows + KNN_N) * KNN_F + 4.0 * rows * KNN_N
    b_ms, b_by = bound(nbytes, flops)
    print(f"[time] cdist knn block ({rows},{KNN_F})x({KNN_N},{KNN_F}) sqrt: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
          f"library_ms={t_l:.4f} (torch.cdist) bound_ms={b_ms:.4f} ({b_by}) on {card}")
    out = dict(ms_knn=t_k, plain_ms_knn=t_p, library_ms_knn=t_l, bound_ms_knn=b_ms, bound_by_knn=b_by)
    torch.cuda.empty_cache()

    x_ht = ht.array(X, split=0, comm=mesh, copy=False)
    model = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(x_ht, ht.array(labels, split=0, comm=mesh, copy=False))
    q_ht = ht.array(Q, split=0, comm=mesh, copy=False)
    model.predict(ht.array(Q[:4096], split=0, comm=mesh, copy=False))  # warm-up
    k1.launches = 0
    pred, ms, peak = timed_call(lambda: model.predict(q_ht))
    launches = k1.launches
    got = pred.larray
    again = model.predict(q_ht).larray
    rows_t = trace("knn batch predict", lambda: model.predict(q_ht), 1)
    kinds = {"K1": 0.0, "top-k": 0.0, "vote and rest": 0.0}
    for us, _, name in rows_t:
        kind = ("K1" if "cdist" in name else "top-k" if any(t in name.lower() for t in ("topk", "sort", "radix", "select"))
                else "vote and rest")
        kinds[kind] += us / 1e3
    print("[trace] knn batch predict by kind: " + ", ".join(f"{k} {v:.4f} ms" for k, v in kinds.items()))
    want, clear = knn_reference(Q, X, labels, KNN_K)
    agree = bool(torch.equal(got[clear], want[clear]))
    share = float(clear.float().mean())
    print(f"[e2e] knn predict of ({KNN_N},{KNN_F}) split 0 against ({KNN_N},{KNN_F}) over MeshComm({n_pos}), k={KNN_K}: "
          f"{ms:.4f} ms, cdist launches {launches} (expected {n_pos}), peak above corpus and queries "
          f"{peak / 1e9:.3f} GB (gate {KNN_PEAK_GATE / 1e9:.2f}), labels equal the f64 top-{KNN_K} vote on the "
          f"{share:.5f} of queries with a clear 5th/6th gap {agree}, rerun bitwise {torch.equal(got, again)} on {card}")
    check(launches == n_pos, f"knn: cdist launches {launches} != {n_pos}")
    check(peak <= KNN_PEAK_GATE, "knn: predict held more than the distance matrix + 10%")
    check(agree and share > 0.99 and torch.equal(got, again), "knn: batch labels differ from the f64 vote")
    out.update(batch_ms=ms, batch_peak=peak, k1=launches, trace=kinds)
    del pred, got, again, want, clear
    torch.cuda.empty_cache()

    # the served requests: 1-8 replicated rows each (the benchmark's mix)
    rng = np.random.default_rng(seed + 15)
    sizes = [int(r) for r in rng.integers(1, 9, size=KNN_REQS)]
    reqs = [torch.randn(r, KNN_F, generator=gen, device=dev) for r in sizes]
    model.predict(ht.array(reqs[0], comm=mesh, copy=False))
    times, per_req, answers = [], [], []
    for r in reqs:
        k1.launches = 0
        res, t_ms, _ = timed_call(lambda: model.predict(ht.array(r, comm=mesh, copy=False)))
        times.append(t_ms)
        per_req.append(k1.launches)
        answers.append(res.larray)
    want, clear = knn_reference(torch.cat(reqs), X, labels, KNN_K)
    got = torch.cat(answers)
    agree = bool(torch.equal(got[clear], want[clear]))
    med, p99 = float(np.median(times)), float(np.percentile(times, 99))
    print(f"[e2e] knn served: {KNN_REQS} requests of 1-8 replicated rows ({sum(sizes)} rows): median {med:.4f} ms, "
          f"p99 {p99:.4f} ms per request, cdist launches per request {sorted(set(per_req))} (expected [{n_pos}]), "
          f"labels equal the f64 vote on {float(clear.float().mean()):.4f} of rows with a clear gap {agree} on {card}")
    check(set(per_req) == {n_pos} and agree, "knn: served labels or launches differ")
    out.update(served_median_ms=med, served_p99_ms=p99, k1=out["k1"] + sum(per_req))

    # small input on the card and on the CPU
    xs, ys, qs = X[:4096], labels[:4096], Q[:512]
    a = ht.classification.KNeighborsClassifier(KNN_K).fit(ht.array(xs, split=0, comm=mesh), ht.array(ys, split=0, comm=mesh))
    b = ht.classification.KNeighborsClassifier(KNN_K).fit(ht.array(xs.cpu(), split=0, comm=mesh, device="cpu"),
                                                          ht.array(ys.cpu(), split=0, comm=mesh, device="cpu"))
    _, clear_s = knn_reference(qs, xs, ys, KNN_K)
    k1.launches = 0
    la = a.predict(ht.array(qs, split=0, comm=mesh)).larray.cpu()
    small_launches = k1.launches  # a comparison: not counted with the path's launches
    lb = b.predict(ht.array(qs.cpu(), split=0, comm=mesh, device="cpu")).larray
    same = bool(torch.equal(la[clear_s.cpu()], lb[clear_s.cpu()]))
    print(f"[e2e] knn small (4096 x 64, 512 queries) card vs cpu: labels equal where the gap is clear {same}, "
          f"cdist launches on the card {small_launches} (expected {n_pos})")
    check(same and small_launches == n_pos, "knn: card and CPU differ, or the card's predict missed K1")
    del X, Q, x_ht, q_ht, model, reqs
    torch.cuda.empty_cache()
    return out


def gnb_paths(ht, seed: int, dev, card: str, mesh) -> dict:
    """(b) GaussianNB on phase 5's eight blobs, 2e7 x 64 f32 at split 0 over
    MeshComm(4): fit, predict and predict_proba with their peaks; the fitted
    moments against the generating ones; four partial fits against one
    fit; a 1e4-row subset on the card and on the CPU."""
    x, centres, labels = make_blobs(ROWS, 64, GNB_K, seed, dev, return_labels=True)
    x_ht = ht.array(x, split=0, comm=mesh, copy=False)
    y_ht = ht.array(labels, split=0, comm=mesh, copy=False)
    warm = ht.array(x[:65536], split=0, comm=mesh, copy=False)
    ht.naive_bayes.GaussianNB().fit(warm, ht.array(labels[:65536], split=0, comm=mesh, copy=False)).predict_proba(warm)
    model = ht.naive_bayes.GaussianNB()
    _, fit_ms, fit_peak = timed_call(lambda: model.fit(x_ht, y_ht))
    pred, first_ms, pred_peak = timed_call(lambda: model.predict(x_ht))
    pred, pred_ms, _ = timed_call(lambda: model.predict(x_ht))
    proba, proba_ms, proba_peak = timed_call(lambda: model.predict_proba(x_ht))
    theta_err = float((model.theta_.larray - centres).abs().max())
    var_err = float((model.var_.larray - 1).abs().max())
    wrong = int((pred.larray != labels).sum())
    rows_ok = bool(torch.allclose(proba.larray.sum(1), torch.ones(1, device=dev), atol=1e-5))
    print(f"[e2e] gaussiannb ({ROWS},64) f32, {GNB_K} classes, split 0 over MeshComm({mesh.size}): fit {fit_ms:.4f} ms "
          f"(peak above the input {fit_peak / 1e9:.3f} GB), predict {pred_ms:.4f} ms (first call {first_ms:.4f}; "
          f"{pred_peak / 1e9:.3f} GB), "
          f"predict_proba {proba_ms:.4f} ms ({proba_peak / 1e9:.3f} GB; gate {GNB_PEAK_GATE / 1e9:.2f}), |theta - centres| "
          f"{theta_err:.4f}, |var - 1| {var_err:.4f} (tolerance 0.05), labels off the generating ones {wrong}, "
          f"probabilities sum to 1 {rows_ok}, epsilon_ {model.epsilon_:.6g} on {card}")
    check(theta_err <= 0.05 and var_err <= 0.05, "gaussiannb: moments off the generating ones")
    check(max(fit_peak, pred_peak, proba_peak) < GNB_PEAK_GATE, "gaussiannb: a call held an (n, c, f) buffer")
    check(wrong == 0 and rows_ok, "gaussiannb: labels off the generating blobs")
    del pred, proba
    inc = ht.naive_bayes.GaussianNB()
    step = ROWS // 4
    for lo in range(0, ROWS, step):
        inc.partial_fit(ht.array(x[lo : lo + step], split=0, comm=mesh, copy=False),
                        ht.array(labels[lo : lo + step], split=0, comm=mesh, copy=False), classes=np.arange(GNB_K))
    th = float(((inc.theta_.larray - model.theta_.larray).abs() / model.theta_.larray.abs().clamp_min(1e-30)).max())
    va = float(((inc.var_.larray - model.var_.larray).abs() / model.var_.larray).max())
    print(f"[e2e] gaussiannb partial_fit over 4 row batches vs fit: theta max relative {th:.3e} (tolerance 1e-4), "
          f"var {va:.3e} (tolerance 1e-3)")
    check(th <= 1e-4 and va <= 1e-3, "gaussiannb: partial fits differ from one fit")
    again = model.predict(x_ht).larray
    check(torch.equal(again, labels), "gaussiannb: predict rerun differs")
    # a 1e4-row subset on the card and on the CPU
    xs, ys = x[:10_000], labels[:10_000]
    a = ht.naive_bayes.GaussianNB().fit(ht.array(xs, split=0, comm=mesh), ht.array(ys, split=0, comm=mesh))
    b = ht.naive_bayes.GaussianNB().fit(ht.array(xs.cpu(), split=0, comm=mesh, device="cpu"),
                                        ht.array(ys.cpu(), split=0, comm=mesh, device="cpu"))
    la = a.predict_log_proba(ht.array(xs, split=0, comm=mesh)).larray.cpu()
    lb = b.predict_log_proba(ht.array(xs.cpu(), split=0, comm=mesh, device="cpu")).larray
    err = float(((la - lb).abs() / (lb.abs() + 1.0)).max())
    print(f"[e2e] gaussiannb 1e4-row subset card vs cpu: predict_log_proba max |d|/(|lp|+1) {err:.3e} (tolerance 1e-5)")
    check(err <= 1e-5, "gaussiannb: card and CPU differ")
    out = dict(fit_ms=fit_ms, predict_ms=pred_ms, proba_ms=proba_ms, peak=max(fit_peak, pred_peak, proba_peak))
    return out, x


def svd_paths(ht, seed: int, dev, card: str, mesh) -> dict:
    """(c) svd of 1e6 x 128 f32 at split 0 over MeshComm(4) (TSQR) and of
    2048^2 replicated; reconstruction, orthogonality and S against the
    f64 singular values."""
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    out = {}
    for (m, n), split in SVD_SHAPES:
        A = torch.randn(m, n, generator=gen, device=dev)
        a_ht = ht.array(A, split=split, comm=mesh, copy=False)
        ht.linalg.svd(a_ht)  # warm-up
        (U, S, V), ms, peak = timed_call(lambda: ht.linalg.svd(a_ht))
        u, s, v = U.larray, S.larray, V.larray
        rec = float(torch.linalg.norm(((u * s) @ v.T - A).double()) / torch.linalg.norm(A.double()))
        orth = float((u.double().T @ u.double() - torch.eye(n, dtype=torch.float64, device=dev)).abs().max())
        r64 = torch.linalg.qr(A.double(), mode="r")[1] if m > n else A.double()
        s64 = torch.linalg.svdvals(r64)
        s_err = float((s.double() - s64).abs().max() / s64[0])
        route = "TSQR" if split == 0 else "torch.linalg.svd"
        print(f"[e2e] svd ({m},{n}) f32 split {split} over MeshComm({mesh.size}) ({route}): {ms:.4f} ms, peak "
              f"{peak / 1e9:.3f} GB, |USV^T - A|/|A| {rec:.3e} (tolerance 1e-5), max|U^T U - I| {orth:.3e} "
              f"(tolerance 1e-4), max|S - S64|/S64_0 {s_err:.3e} (tolerance 1e-5), U split {U.split} on {card}")
        check(rec <= 1e-5 and orth <= 1e-4 and s_err <= 1e-5 and U.split == split, f"svd ({m},{n}) off")
        out[f"{m}x{n}"] = ms
        if split is None:
            # the cost of factoring float32 in float64: cuSOLVER's float32 gesvd
            f32_svd = lambda: torch.linalg.svd(A, full_matrices=False, driver="gesvd")  # noqa: E731
            f32_svd()  # warm-up
            (_, s32, _), ms32, _ = timed_call(f32_svd)
            err32 = float((s32.double() - s64).abs().max() / s64[0])
            print(f"[e2e] svd ({m},{n}) f32 by cuSOLVER's gesvd in f32: {ms32:.4f} ms, max|S - S64|/S64_0 {err32:.3e} "
                  f"(the port factors in f64: {ms:.4f} ms, {s_err:.3e}) on {card}")
            out[f"{m}x{n}_gesvd_f32"] = ms32
        del A, a_ht, U, S, V, u, s, v, r64
        torch.cuda.empty_cache()
    small = torch.randn(512, 16, generator=gen, device=dev)
    sa = ht.linalg.svd(ht.array(small, split=0, comm=mesh), compute_uv=False).larray.cpu()
    sb = ht.linalg.svd(ht.array(small.cpu(), split=0, comm=mesh, device="cpu"), compute_uv=False).larray
    check(bool(torch.allclose(sa, sb, rtol=1e-5)), "svd: card and CPU differ")
    return out


def det_inv_paths(ht, seed: int, dev, card: str, mesh) -> dict:
    """(d) det and inv of A = I + 0.1 G / sqrt(n), n = 2048, at split 0 and
    1 over MeshComm(4) (the elimination over the rows) and replicated
    (LU): ms, kernels and host syncs per call, the peak above A."""
    n = DET_N
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    A = torch.eye(n, device=dev) + 0.1 * torch.randn(n, n, generator=gen, device=dev) / n**0.5
    sign, logabs = torch.linalg.slogdet(A.double())
    det64 = float(sign * torch.exp(logabs))
    a_bytes = 4 * n * n
    check(len(host_syncs(lambda: float(A[0, 0]))) == 1, "host_syncs misses a host read")
    out = {}
    for split in (0, 1, None):
        a_ht = ht.array(A, split=split, comm=mesh, copy=False)
        ht.linalg.det(a_ht)  # warm-up
        d, d_ms, d_peak = timed_call(lambda: ht.linalg.det(a_ht))
        d_syncs = host_syncs(lambda: ht.linalg.det(a_ht))
        d_kernels = kernel_count(lambda: ht.linalg.det(a_ht))
        inv, i_ms, i_peak = timed_call(lambda: ht.linalg.inv(a_ht))
        i_syncs = host_syncs(lambda: ht.linalg.inv(a_ht))
        i_kernels = kernel_count(lambda: ht.linalg.inv(a_ht))
        det_err = abs(float(d.item()) - det64) / abs(det64)
        resid = float((A.double() @ inv.larray.double() - torch.eye(n, dtype=torch.float64, device=dev)).abs().max())
        rerun = torch.equal(inv.larray, ht.linalg.inv(a_ht).larray) and float(d.item()) == float(ht.linalg.det(a_ht).item())
        route = "elimination" if split is not None else "LU"
        d_reads, i_reads = len(d_syncs), len(i_syncs)
        print(f"[e2e] det/inv ({n},{n}) f32 split {split} over MeshComm({mesh.size}) ({route}): det {d_ms:.4f} ms, "
              f"{d_kernels} kernels and {d_reads} host syncs a call, peak above A {d_peak / 1e6:.3f} MB, relative error "
              f"against the f64 slogdet {det_err:.3e} (tolerance 1e-3; det {float(d.item()):.6e}); inv {i_ms:.4f} ms, "
              f"{i_kernels} kernels and {i_reads} host syncs a call, peak above A {i_peak / 1e6:.3f} MB (A "
              f"{a_bytes / 1e6:.3f} MB), max|A inv(A) - I| {resid:.3e} (tolerance 1e-3), inv split {inv.split}, reruns "
              f"bitwise {rerun} on {card}")
        if d_syncs or i_syncs:
            print(f"[e2e] det/inv split {split} host syncs at: det {d_syncs}, inv {i_syncs}")
        check(det_err <= 1e-3 and resid <= 1e-3 and inv.split == split, f"det/inv split {split} off")
        if split is not None:
            # [A | I] by rows, plus per-column temporaries of a few rows
            check(i_peak <= 2 * a_bytes + 64 * 1024, f"inv split {split} held more than [A | I]")
            check(rerun, f"det/inv split {split} reruns differ")
            check(d_reads == 0 and i_reads == 0, f"det/inv split {split}: the elimination waited on the host")
        out[f"det_ms_{split}"], out[f"inv_ms_{split}"] = d_ms, i_ms
        del a_ht, inv
        torch.cuda.empty_cache()
    small = A[:96, :96].contiguous()
    for split in (0, 1):
        a = ht.linalg.inv(ht.array(small, split=split, comm=mesh)).larray.cpu()
        b = ht.linalg.inv(ht.array(small.cpu(), split=split, comm=mesh, device="cpu")).larray
        check(float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), "inv: card and CPU differ")
    return out


def signal_paths(ht, x, seed: int, dev, card: str, mesh) -> dict:
    """(e) convolve of 1e8 f32 at split 0 over MeshComm(4) with a 1025-tap
    filter in the three modes against an f64 FFT; pad along the split axis
    of the 2e7 x 64 blobs in five modes against np.pad's index rule on the
    global copy; SplitTiles and SquareDiagTiles of 2048^2 at split 0."""
    signal_mod = importlib.import_module("heat_tpu_torch.core.signal")
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    a = torch.randn(CONV_N, generator=gen, device=dev)
    v = torch.randn(CONV_K, generator=gen, device=dev)
    a_ht = ht.array(a, split=0, comm=mesh, copy=False)
    size = 1 << (CONV_N + CONV_K - 1 - 1).bit_length()
    full64 = torch.fft.irfft(torch.fft.rfft(a.double(), size) * torch.fft.rfft(v.double(), size), size)[: CONV_N + CONV_K - 1]
    tol = 1e-5 * float(v.abs().sum()) * float(a.abs().max())
    out = {}
    for mode, lo in (("full", 0), ("same", (CONV_K - 1) // 2), ("valid", CONV_K - 1)):
        ht.convolve(a_ht, v, mode=mode)  # warm-up
        c, ms, peak = timed_call(lambda: ht.convolve(a_ht, v, mode=mode))
        halo = signal_mod.last_halo_bytes
        ref = full64[lo : lo + c.shape[0]]
        err = float((c.larray.double() - ref).abs().max())
        same = torch.equal(c.larray, ht.convolve(a_ht, v, mode=mode).larray)
        print(f"[e2e] convolve ({CONV_N},) f32 * ({CONV_K},) {mode} split 0 over MeshComm({mesh.size}): {ms:.4f} ms, "
              f"halo bytes {halo}, peak {peak / 1e9:.3f} GB, max|d| against the f64 FFT {err:.3e} (gate {tol:.3e}), "
              f"output shards {[s.shape[0] for s in c.shards]}, rerun bitwise {same} on {card}")
        check(err <= tol and same, f"convolve {mode} off")
        out[f"convolve_{mode}_ms"] = ms
        del c, ref
    del full64, a, a_ht
    torch.cuda.empty_cache()
    small, vs = torch.randn(10_001, generator=gen, device=dev), torch.randn(33, generator=gen, device=dev)
    ca = ht.convolve(ht.array(small, split=0, comm=mesh), vs, mode="same").larray.cpu()
    cb = ht.convolve(ht.array(small.cpu(), split=0, comm=mesh, device="cpu"), vs.cpu(), mode="same").larray
    check(float((ca - cb).abs().max()) <= 1e-5 * float(vs.abs().sum() * small.abs().max()), "convolve: card and CPU differ")

    # pad along the split axis of the 2e7 x 64 blobs
    x_ht = ht.array(x, split=0, comm=mesh, copy=False)
    n = x.shape[0]
    b, e = PAD_WIDTH
    i = torch.arange(-b, n + e, device=dev)
    index = {
        "edge": i.clamp(0, n - 1),
        "wrap": i % n,
        "reflect": torch.where(i % (2 * n - 2) < n, i % (2 * n - 2), 2 * n - 2 - i % (2 * n - 2)),
        "symmetric": torch.where(i % (2 * n) < n, i % (2 * n), 2 * n - 1 - i % (2 * n)),
    }
    for mode in PAD_MODES:
        p, ms, peak = timed_call(lambda: ht.pad(x_ht, (PAD_WIDTH, (0, 0)), mode=mode))
        note = ""
        if mode == "linear_ramp":
            # jnp.linspace(0, edge, num, endpoint=False) as XLA computes it:
            # 0 (1 - s) + edge s with s = i (1/num) in f32 (np.pad's float64
            # rule is up to 2 f32 ulps away from it)
            def ramp(edge, num, dt):
                s = (torch.arange(num, device=dev, dtype=dt) * (torch.ones((), dtype=dt, device=dev) / num))[:, None]
                return torch.zeros((), dtype=dt, device=dev) * (1 - s) + edge.to(dt) * s

            ramps = [ramp(x[:1], b, torch.float32), ramp(x[-1:], e, torch.float32).flip(0)]
            ok = same_shards(p, torch.cat([ramps[0], x, ramps[1]]), mesh)
            r64 = torch.cat([ramp(x[:1], b, torch.float64), ramp(x[-1:], e, torch.float64).flip(0)])
            got = torch.cat([p.larray[:b], p.larray[b + n :]])
            ulps = float(((got.double() - r64).abs() / (torch.finfo(torch.float32).eps * r64.abs()).clamp_min(1e-45)).max())
            note = f" (and {ulps:.2f} ulps from np.pad's float64 rule, gate 2)"
            ok = ok and ulps <= 2.0
            del ramps, r64, got
        else:
            ok = same_shards(p, x.index_select(0, index[mode]), mesh)
        print(f"[e2e] pad ({n},64) f32 split 0 by {PAD_WIDTH} rows, {mode}: {ms:.4f} ms, peak {peak / 1e9:.3f} GB, "
              f"bitwise {'jnp.pad' if mode == 'linear_ramp' else 'np.pad'}'s rule on the global copy {ok}{note} on {card}")
        check(ok, f"pad {mode} differs from the rule")
        out[f"pad_{mode}_ms"] = ms
        del p
        torch.cuda.empty_cache()
    sp = torch.randn(13, 5, generator=gen, device=dev)
    for mode in PAD_MODES + ("mean", "median", "maximum", "constant"):
        pa = ht.pad(ht.array(sp, split=0, comm=mesh), ((3, 20), (1, 2)), mode=mode).larray.cpu()
        pb = ht.pad(ht.array(sp.cpu(), split=0, comm=mesh, device="cpu"), ((3, 20), (1, 2)), mode=mode).larray
        check(bool(torch.allclose(pa, pb, rtol=1e-6, atol=1e-6)), f"pad {mode}: card and CPU differ")

    # tiles of 2048^2 at split 0
    t = torch.randn(TILE_N, TILE_N, generator=gen, device=dev)
    t_ht = ht.array(t, split=0, comm=mesh, copy=False)
    st = ht.SplitTiles(t_ht)
    ok = all(torch.equal(st[r], t[st.tile_ranges(r)]) for r in range(mesh.size))
    dt = ht.SquareDiagTiles(t_ht, tiles_per_proc=2)
    for i_ in range(dt.tile_rows):
        for j_ in range(dt.tile_columns):
            r0, r1, c0, c1 = dt.get_start_stop((i_, j_))
            ok = ok and torch.equal(dt[i_, j_], t[r0:r1, c0:c1])
    print(f"[e2e] tiles of ({TILE_N},{TILE_N}) split 0 over MeshComm({mesh.size}): SplitTiles {mesh.size} and "
          f"SquareDiagTiles {dt.tile_rows}x{dt.tile_columns} tiles each equal to the global slice {ok}")
    check(ok, "tiles differ from the global slices")
    return out


def linalg_classifier_paths(ht, k1, seed: int, dev, card: str) -> dict:
    """The linear algebra and classifiers phase: (a) KNN through K1, (b)
    GaussianNB, (c) svd, (d) det and inv, (e) convolve, pad and tiles.
    Returns the K1 launches of (a) and the numbers PERF.md reads."""
    mesh = ht.MeshComm(TRANSPORT_MESH)
    out = {"knn": knn_paths(ht, k1, seed, dev, card, mesh)}
    out["gnb"], x = gnb_paths(ht, seed, dev, card, mesh)
    out["svd"] = svd_paths(ht, seed, dev, card, mesh)
    out["det_inv"] = det_inv_paths(ht, seed, dev, card, mesh)
    out["signal"] = signal_paths(ht, x, seed, dev, card, mesh)
    del x
    torch.cuda.empty_cache()
    print(f"[e2e] linear algebra and classifiers: {json.dumps(out)}")
    return out


def gb_per_s(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def io_paths(ht, k1, k6, k7, seed: int, dev, card: str) -> dict:
    """The I/O phase: (a) ``save_npy`` of the 2e7 x 64 f32 blobs split over
    MeshComm(4); (b) ``load_npy(split=0)`` over MeshComm(1) and MeshComm(4),
    bitwise, its rate beside numpy's read of the same slabs alone and a
    pinned host-to-card copy of one slab, the host's peak (tracemalloc) and
    the card's above the loaded array; (c) KMeans through K1 on the loaded
    array, with the Lloyd phase's gates; (d) ``load_hdf5_packed`` in bf16
    and KMeans through K1 with the north star's blob gate; (e) a split-1
    load, then ``resplit(0)``, bitwise; (f) CSV at 1e6 x 64 (the native
    parser against numpy's, bitwise) and NetCDF at 8e6 x 64; (g)
    ``knn_graph`` on the Spectral cell's data, the new DCSR members on the
    card, and ``larray @ x`` (cuSPARSE) against K6's ``sparse.matmul``.
    The files live in a temporary directory removed at the end, whatever
    happens.  Returns the launches of K1, K6 and K7."""
    import os
    import shutil
    import tempfile
    import tracemalloc

    from heat_tpu_torch.core import io as io_mod
    from heat_tpu_torch.core import stream as stream_mod

    t_phase = time.perf_counter()
    mesh = ht.MeshComm(TRANSPORT_MESH)
    n, f, k = IO_ROWS, IO_F, IO_K
    data, centres, truth = make_blobs(n, f, k, seed + 16, dev, return_labels=True)
    x = ht.array(data, split=0, comm=mesh, copy=False)
    nbytes = data.numel() * data.element_size()
    out = {}
    tmp = tempfile.mkdtemp(prefix="heat_io_")
    try:
        path = os.path.join(tmp, "x.npy")
        # (a) save, one position's shard at a time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ht.save_npy(x, path)
        out["save_s"] = time.perf_counter() - t0
        check(os.path.getsize(path) >= nbytes, "save_npy wrote a short file")
        print(f"[e2e] io save_npy ({n},{f}) f32 split 0 over MeshComm({mesh.size}): {out['save_s']:.3f} s, "
              f"{gb_per_s(nbytes, out['save_s']):.4f} GB/s on {card}")

        # (b) loads: timed, then again under tracemalloc for the host's peak
        loaded = {}
        for m in (1, mesh.size):
            comm = ht.MeshComm(m)
            slab = -(-n // m) * f * 4
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            y = ht.load_npy(path, split=0, comm=comm)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            card_above = torch.cuda.max_memory_allocated() - base - nbytes
            same = y.split == 0 and y.dtype is ht.float32 and same_shards(y, data, comm)
            del y
            tracemalloc.start()
            y = ht.load_npy(path, split=0, comm=comm)
            torch.cuda.synchronize()
            host_peak = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()
            print(f"[e2e] io load_npy split 0 over MeshComm({m}): {load_s:.3f} s, {gb_per_s(nbytes, load_s):.4f} GB/s, "
                  f"every shard bitwise {same}, host peak {host_peak / 1e9:.4f} GB (a slab {slab / 1e9:.4f} GB + "
                  f"{IO_HOST_MARGIN >> 20} MiB allowed), card peak above the loaded array {card_above / 1e9:.4f} GB on {card}")
            check(same, f"load_npy over MeshComm({m}) differs from the saved array")
            check(host_peak <= slab + IO_HOST_MARGIN, f"load_npy over MeshComm({m}): host peak {host_peak} > a slab")
            out[f"load_s_mesh{m}"], out[f"load_gbs_mesh{m}"] = load_s, gb_per_s(nbytes, load_s)
            out[f"host_peak_gb_mesh{m}"], out[f"card_above_gb_mesh{m}"] = host_peak / 1e9, card_above / 1e9
            loaded[m] = y
        del loaded[1]
        # the two ceilings at MeshComm(4)'s slabs: numpy's read of the slabs
        # alone, and a pinned host-to-card copy of one slab
        mm = np.load(path, mmap_mode="r")
        t0 = time.perf_counter()
        for r in range(mesh.size):
            lo, lshape, _ = mesh.chunk((n, f), 0, rank=r)
            part = stream_mod.read_rows(mm, lo, lo + lshape[0], copy=True)
        read_s = time.perf_counter() - t0
        del mm
        pinned = torch.from_numpy(part).pin_memory()
        dst = torch.empty_like(pinned, device=dev)
        h2d_ms = time_ms(lambda: dst.copy_(pinned, non_blocking=True), reps=3, warmup=1)
        slab_bytes = pinned.numel() * 4
        out["numpy_read_gbs"] = gb_per_s(nbytes, read_s)
        out["pinned_h2d_gbs"] = slab_bytes / (h2d_ms / 1e3) / 1e9
        print(f"[e2e] io ceilings at MeshComm({mesh.size})'s slabs: numpy's read alone {read_s:.3f} s, "
              f"{out['numpy_read_gbs']:.4f} GB/s; a pinned host-to-card copy of one {slab_bytes / 1e9:.2f} GB slab "
              f"{h2d_ms:.2f} ms, {out['pinned_h2d_gbs']:.4f} GB/s; the load at MeshComm({mesh.size}) "
              f"{out[f'load_gbs_mesh{mesh.size}']:.4f} GB/s (the file in the page cache) on {card}")
        del part, pinned, dst

        # (c) KMeans through K1 on the loaded array
        y = loaded.pop(mesh.size)
        k1.launches = 0
        t0 = time.perf_counter()
        model = ht.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=IO_ITERS, tol=-1, random_state=seed).fit(y)
        labels = model.predict(y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        dense_k1 = k1.launches
        expected = mesh.size * (k + IO_ITERS + 2)  # kmeans++, Lloyd, labels_, predict, each position
        fitted = model.cluster_centers_.larray.float()
        dist = torch.cdist(fitted, centres)
        match = dist.argmin(dim=1)
        centre_err = float(dist.min(dim=1).values.max())
        pred = labels.larray.reshape(-1)
        d2 = k1.reference_cdist(data, fitted, sqrt=False)
        top2 = d2.topk(2, dim=1, largest=False)
        scale = (data * data).sum(1) + (fitted * fitted).sum(1).max()
        clear = top2.values[:, 1] - top2.values[:, 0] > 2 * TOL * scale
        disagree = int(((pred != top2.indices[:, 0]) & clear).sum())
        print(f"[e2e] io KMeans(k={k}, kmeans++, {IO_ITERS} iterations) on the loaded array over MeshComm({mesh.size}): "
              f"fit + predict {fit_s:.3f} s, cdist launches {dense_k1} (expected {expected}), centre error "
              f"{centre_err:.4e} (tolerance 0.05), {disagree} labels disagree with the plain version over "
              f"{int(clear.sum())} rows with a clear margin on {card}")
        check(dense_k1 == expected, f"io KMeans: cdist launches {dense_k1} != {expected}")
        check(sorted(match.tolist()) == list(range(k)) and centre_err <= 0.05, "io KMeans: centres off the blobs")
        check(disagree == 0, f"io KMeans: {disagree} labels disagree with the plain version")
        del y, model, labels, fitted, pred, d2, top2, scale, clear
        torch.cuda.empty_cache()

        # (d) the packed bf16 load and KMeans through K1 on 16-bit input
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        packed = ht.cluster.load_hdf5_packed(path, "x", dtype=ht.bfloat16, comm=mesh)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
        packed_above = torch.cuda.max_memory_allocated() - base - nbytes // 2
        check(packed.dtype is ht.bfloat16 and packed.shape == (n, f) and packed.x2.shape == (n // 2, 2 * f),
              f"load_hdf5_packed gave {packed}")
        blocks = packed.sample_blocks()
        starts = np.cumsum([0] + [b.shape[0] for b in blocks])
        rounded = starts[-1] == n and all(torch.equal(b, data[lo : lo + b.shape[0]].bfloat16())
                                          for b, lo in zip(blocks, starts.tolist()))
        print(f"[e2e] io load_hdf5_packed bf16 over MeshComm({mesh.size}): {packed_s:.3f} s, "
              f"{gb_per_s(nbytes, packed_s):.4f} GB/s of the file, samples the f32 values rounded {rounded}, card peak "
              f"above the packed array {packed_above / 1e9:.4f} GB on {card}")
        check(rounded, "load_hdf5_packed: the samples are not the file's values rounded to bf16")
        k1.launches = 0
        model = ht.cluster.KMeans(n_clusters=k, init="kmeans++", max_iter=IO_ITERS, tol=-1.0, random_state=seed).fit(packed)
        packed_k1 = k1.launches
        # kmeans++ on the first 2^18 samples (position 0's), then Lloyd and
        # labels_ on each position
        expected16 = k + mesh.size * (IO_ITERS + 1)
        print(f"[e2e] io KMeans on the packed bf16 load: cdist launches {packed_k1} (expected {expected16})")
        check(packed_k1 == expected16, f"io packed KMeans: cdist launches {packed_k1} != {expected16}")
        bf16_blob_gate(k1, model, blocks, centres, truth, f"io packed bf16 load {(n, f)}")
        out["packed_s"] = packed_s
        del packed, blocks, model
        torch.cuda.empty_cache()

        # (e) a split-1 load, then resplit(0)
        k7.launches = 0
        t0 = time.perf_counter()
        y1 = ht.load_npy(path, split=1, comm=mesh)
        torch.cuda.synchronize()
        load1_s = time.perf_counter() - t0
        same1 = y1.split == 1 and same_shards(y1, data, mesh)
        t0 = time.perf_counter()
        y0 = y1.resplit(0)
        torch.cuda.synchronize()
        resplit_ms = 1e3 * (time.perf_counter() - t0)
        resplit_k7 = k7.launches
        same0 = y0.split == 0 and same_shards(y0, data, mesh)
        print(f"[e2e] io load_npy split 1 over MeshComm({mesh.size}): {load1_s:.3f} s, bitwise {same1}; resplit(0) "
              f"{resplit_ms:.2f} ms, bitwise equal to the split-0 load {same0}, repack launches {resplit_k7} (a resplit "
              f"between two split axes joins views of the shards, transport.tiled_resplit) on {card}")
        check(same1 and same0, "io: the split-1 load or its resplit differs")
        check(resplit_k7 == 0, f"io: resplit launched repack {resplit_k7} times")
        out.update(load1_s=load1_s, resplit_ms=resplit_ms)
        del y1, y0
        torch.cuda.empty_cache()

        # (f) CSV: the native parser against numpy's, bitwise; NetCDF
        csv = os.path.join(tmp, "x.csv")
        xc = ht.array(data[:IO_CSV_ROWS], split=0, comm=mesh, copy=False)
        t0 = time.perf_counter()
        ht.save_csv(xc, csv)
        csv_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zc = ht.load_csv(csv, split=0, comm=mesh)
        torch.cuda.synchronize()
        csv_load_s = time.perf_counter() - t0
        same_c = same_shards(zc, data[:IO_CSV_ROWS], mesh)
        bounds, rows = ht.native.csv_row_bounds(csv, 0, mesh.size)
        t0 = time.perf_counter()
        py = [io_mod._csv_parse_byte_range(csv, bounds[r], bounds[r + 1], ",", np.dtype(np.float32), "utf-8", False)
              for r in range(mesh.size)]
        py_s = time.perf_counter() - t0
        same_py = rows == IO_CSV_ROWS and all(
            np.array_equal(p.view(np.uint32), s.cpu().numpy().view(np.uint32)) for p, s in zip(py, zc.shards))
        print(f"[e2e] io CSV ({IO_CSV_ROWS},{f}) over MeshComm({mesh.size}): save_csv {csv_save_s:.3f} s, load_csv "
              f"(native parser) {csv_load_s:.3f} s, bitwise equal to the saved f32 values {same_c}; numpy's parser "
              f"{py_s:.3f} s, bitwise equal to the native one {same_py} on {card}")
        check(same_c and same_py, "io: CSV values differ between the routes or from the saved ones")
        out.update(csv_save_s=csv_save_s, csv_load_s=csv_load_s, csv_numpy_s=py_s)
        del zc, py, xc
        os.remove(csv)
        nc = os.path.join(tmp, "x.nc")
        xn = ht.array(data[:IO_NC_ROWS], split=0, comm=mesh, copy=False)
        t0 = time.perf_counter()
        ht.save_netcdf(xn, nc, "x")
        nc_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zn = ht.load_netcdf(nc, "x", split=0, comm=mesh)
        torch.cuda.synchronize()
        nc_load_s = time.perf_counter() - t0
        same_n = same_shards(zn, data[:IO_NC_ROWS], mesh)
        nc_bytes = IO_NC_ROWS * f * 4
        print(f"[e2e] io NetCDF ({IO_NC_ROWS},{f}) f32 (scipy's classic format) over MeshComm({mesh.size}): save "
              f"{nc_save_s:.3f} s, load {nc_load_s:.3f} s ({gb_per_s(nc_bytes, nc_load_s):.4f} GB/s), bitwise {same_n} "
              f"on {card}")
        check(same_n, "io: the NetCDF load differs from the saved array")
        out.update(nc_save_s=nc_save_s, nc_load_s=nc_load_s)
        del zn, xn
    finally:
        shutil.rmtree(tmp)
    del x, data, centres, truth
    torch.cuda.empty_cache()

    # (g) the DCSR members on the card, and larray @ x against K6
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    blobs, _ = two_blobs(KNNG_N, KNNG_F, gen, dev)
    a = ht.sparse.knn_graph(ht.array(blobs, split=0, comm=mesh), KNNG_K, sigma=0.5**0.5)
    d, i, p = a.data, a.indices, a.indptr
    triples = a._shards
    gathered = (torch.equal(d, torch.cat([t[0] for t in triples])) and torch.equal(i, torch.cat([t[1] for t in triples]))
                and p.dtype == torch.int32 and i.dtype == torch.int32 and tuple(p.shape) == (KNNG_N + 1,)
                and int(p[-1]) == a.nnz and d.device.type == dev.type and torch.equal(a.gdata, d)
                and torch.equal(a.gindptr, p))
    local = (torch.equal(a.ldata, triples[0][0]) and torch.equal(a.lindices, triples[0][1])
             and torch.equal(a.lindptr, triples[0][2]) and a.lshape == mesh.chunk(a.shape, 0)[1])
    gptr = a.global_indptr
    meta = gptr.split is None and gptr.dtype is ht.int32 and torch.equal(gptr.larray, p) and a.balanced and a.trim() is a
    xv = torch.randn(KNNG_N, 1, generator=gen, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch marks its sparse CSR tensors as beta
        lib = a.larray
        want = lib @ xv
        absum = torch.sparse_csr_tensor(p, i, d.abs(), a.shape) @ xv.abs()
    k6.launches = 0
    y = ht.sparse.matmul(a, ht.array(xv, comm=mesh))
    torch.cuda.synchronize()
    dcsr_k6 = k6.launches
    rel = float(((y.larray - want).abs() / absum.clamp_min(1e-30)).max())
    print(f"[e2e] io DCSR members of knn_graph ({KNNG_N},{KNNG_F}) k={KNNG_K} over MeshComm({mesh.size}), nnz {a.nnz}: "
          f"gathered triple on the card {gathered}, the position's triple {local}, global_indptr/balanced/trim {meta}; "
          f"larray @ x (cuSPARSE) against sparse.matmul (K6): max |dy| / sum|vals x| {rel:.3e} (tolerance {TOL_SPMV:g}), "
          f"spmv launches {dcsr_k6} (expected {mesh.size}) on {card}")
    check(gathered and local and meta, "io: the DCSR members differ from the triples")
    check(rel <= TOL_SPMV, f"io: larray @ x differs from sparse.matmul by {rel:.3e}")
    check(dcsr_k6 == mesh.size, f"io: spmv launches {dcsr_k6} != {mesh.size}")
    del a, lib, blobs, d, i, p, y, want, absum
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out.update(k1=dense_k1 + packed_k1, k6=dcsr_k6, k7=resplit_k7)
    print(f"[e2e] io phase {out['wall_s']:.1f} s wall: {json.dumps(out)}")
    return out


# ---------------------------------------------------------- training and random
# TransformerLM training at the LM config's full width: DataParallel with
# adam(1e-3), 5 steps over the 8 x 2048 tokens; step 1's loss and gradients
# against the same step with the plain attention on the card:
# |Δloss| <= TOL_TRAIN * loss and max|Δgrad| <= TOL_TRAIN * max|grad| (f32;
# the two attentions sum in other orders)
TRAIN_STEPS = 5
TOL_TRAIN = 1e-4
# ResNet-50 DP training (BASELINE.md:30): 224 x 224 x 3 NHWC, batch 128,
# sgd(0.1, momentum=0.9), f32 with TF32 off; a ResNet-18 step at batch 8 and
# 64 x 64 against the port's CPU step: |Δloss| <= TOL_RESNET * loss and
# max|Δparam| <= TOL_RESNET (cuDNN's and the CPU's convolutions sum in
# other orders)
RESNET_BATCH, RESNET_HW = 128, 224
TOL_RESNET = 1e-4
# DASO over 2 x 2 slices on the tutorial's MLP widths (784 -> 128 -> 64 -> 10)
DASO_BATCH, DASO_IN, DASO_STEPS = 256, 784, 7
# random: T1 across 2^32 (a 2^21-element window), the draws at the Lloyd
# shape (T1's uniform, normal and randint held to the plain version over all
# 1.28e9 counters), randperm(1e8, split=0) on the Feistel route over
# MeshComm(4), and a 16-bit draw past the 2 GiB f32 chunk limit (9e6 x 64
# bf16: 2.30 GB of f32, two row blocks)
RANDOM_WINDOW = 1 << 21
RANDOM_PERM = 100_000_000
CHUNK_ROWS = 9_000_000
# T1's f32 normals against its plain version on the card: within 2 ulp
# (the plain version emulates the kernel's fused multiply-adds through f64);
# the card's normals against the CPU's within 4 ulp (the two log1p differ;
# the CPU tests' bound against heat_tpu)
NORMAL_ULPS = 2
CARD_CPU_ULPS = 4


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in units of the spacing at the larger magnitude."""
    a64, b64 = a.double(), b.double()
    big = torch.maximum(a.abs(), b.abs())
    spacing = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big).double()
    return float(((a64 - b64).abs() / spacing).max())


def lm_step_parts(model, tokens, targets, ht, k3, tmod, plain: bool):
    """Step 1 without its update: the loss and every parameter's gradient,
    with K3 or with the plain attention in the forward."""
    from heat_tpu_torch.nn.data_parallel import _default_loss

    orig = tmod.flash_attention
    if plain:
        tmod.flash_attention = k3.reference_flash_attention
    try:
        model.zero_grad(set_to_none=True)
        loss = _default_loss(model(tokens), targets)
        loss.backward()
    finally:
        tmod.flash_attention = orig
    grads = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def training_paths(ht, k3, seed: int, dev, card: str) -> dict:
    """Data-parallel training on the card over ``MeshComm(4)``: the
    TransformerLM (K3 in every forward) with adam, ResNet-50 with SGD (no
    Pallas kernel on its path), a ResNet-18 step against the CPU, and DASO
    over 2 x 2 slices.  Returns K3's launches in the TransformerLM steps."""
    tmod = importlib.import_module("heat_tpu_torch.models.transformer")
    mesh = ht.MeshComm(4)
    out = {}
    # ---- TransformerLM
    model = ht.models.transformer_from_flax(flax_layout_params(seed, **LM), device="gpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    tokens = torch.randint(0, LM["vocab_size"], (LM_BATCH, LM["max_seq_len"]), generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    loss_k, grads_k = lm_step_parts(model, tokens, targets, ht, k3, tmod, plain=False)
    loss_p, grads_p = lm_step_parts(model, tokens, targets, ht, k3, tmod, plain=True)
    gscale = max(float(g.abs().max()) for g in grads_p)
    gerr = max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p))
    print(f"[train] TransformerLM step 1 against the plain attention: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(|Δ| {abs(loss_k - loss_p):.3e}, tolerance {TOL_TRAIN:g} * loss), max|Δgrad| {gerr:.3e} "
          f"(tolerance {TOL_TRAIN:g} * {gscale:.4e}) on {card}")
    check(abs(loss_k - loss_p) <= TOL_TRAIN * loss_p, "TransformerLM step 1: loss differs from the plain attention's")
    check(gerr <= TOL_TRAIN * gscale, "TransformerLM step 1: gradients differ from the plain attention's")
    del grads_k, grads_p
    dp = ht.nn.DataParallel(model, comm=mesh, optimizer=ht.optim.DataParallelOptimizer(ht.optim.adam(1e-3)))
    dp.init(seed, tokens)
    tok_d = ht.array(tokens, split=0, comm=mesh)
    tgt_d = ht.array(targets, split=0, comm=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(dp.train_step(tok_d, tgt_d))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k3.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    n_tok = tokens.numel()
    print(f"[train] TransformerLM {LM} DataParallel adam(1e-3) over MeshComm(4), {TRAIN_STEPS} steps of "
          f"{LM_BATCH}x{LM['max_seq_len']} tokens: losses {[round(v, 6) for v in losses]}, K3 launches {launches} "
          f"(expected {LM['num_layers'] * TRAIN_STEPS}), {1e3 * wall / TRAIN_STEPS:.4f} ms/step (first included), "
          f"peak {peak_gb:.3f} GB on {card}")
    check(launches == LM["num_layers"] * TRAIN_STEPS, f"training K3 launches {launches} != {LM['num_layers'] * TRAIN_STEPS}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], "TransformerLM training loss is not finite and falling")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dp.train_step(tok_d, tgt_d)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / reps
    print(f"[train] TransformerLM {step_ms:.4f} ms/step, {n_tok / step_ms * 1e3:.4e} tokens/s (steady) on {card}")
    rows = trace("TransformerLM train step", lambda: dp.train_step(tok_d, tgt_d), 1)
    busy = sum(r[0] for r in rows) / 1e3
    k3_ms = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2]) / 1e3
    gemm_ms = sum(r[0] for r in rows if "gemm" in r[2].lower()) / 1e3
    # the recomputed backward, alone: one layer's plain attention forward and
    # backward at the model's shape, times the layers
    bh, s_, d_ = LM_BATCH * LM["num_heads"], LM["max_seq_len"], LM["head_dim"]
    q, k, v = (torch.randn(bh, s_, d_, generator=gen, device=dev, requires_grad=True) for _ in range(3))
    g = torch.randn(bh, s_, d_, generator=gen, device=dev)
    bwd_ms = LM["num_layers"] * time_ms(lambda: k3._Flash.backward(
        type("ctx", (), {"saved_tensors": (q, k, v), "causal": True, "scale": d_**-0.5})(), g), reps=3, warmup=1)
    print(f"[train] TransformerLM step by kind: busy {busy:.4f} ms, K3 forward {k3_ms:.4f} ms, GEMM kernels "
          f"{gemm_ms:.4f} ms (the forward's, the backward's and the recomputed attention's products), the "
          f"recomputed attention backward timed alone {bwd_ms:.4f} ms ({LM['num_layers']} x ({bh},{s_},{d_})) on {card}")
    del q, k, v, g, dp, model, tok_d, tgt_d
    torch.cuda.empty_cache()
    out.update(lm_launches=launches, lm_step_ms=step_ms, lm_tokens_s=n_tok / step_ms * 1e3, lm_peak_gb=peak_gb)

    # ---- ResNet-50, f32, TF32 off
    gen_c = torch.Generator(device=dev).manual_seed(seed + 18)
    net = ht.models.ResNet50(num_classes=1000, device="gpu", generator=gen_c)
    images = torch.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3, generator=gen_c, device=dev)
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen_c, device=dev)
    rp = ht.nn.DataParallel(net, comm=mesh, optimizer=ht.optim.DataParallelOptimizer(ht.optim.sgd(0.1, momentum=0.9)))
    rp.init(seed, images)
    img_d, lab_d = ht.array(images, split=0, comm=mesh), ht.array(labels, split=0, comm=mesh)
    rp.train_step(img_d, lab_d)  # cuDNN's first call picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3.launches = 0
    t0 = time.perf_counter()
    rlosses = [rp.train_step(img_d, lab_d) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    r_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    r_peak = torch.cuda.max_memory_allocated() / 1e9
    rlosses = [float(v) for v in rlosses]
    stats_ok = all(bool(torch.isfinite(b).all()) for n_, b in net.named_buffers())
    print(f"[train] ResNet-50 DataParallel sgd(0.1, momentum=0.9) f32 (TF32 off) over MeshComm(4), batch "
          f"{RESNET_BATCH} at {RESNET_HW}x{RESNET_HW}x3: {r_ms:.4f} ms/step, {RESNET_BATCH / r_ms * 1e3:.2f} images/s, "
          f"peak {r_peak:.3f} GB, losses {[round(v, 5) for v in rlosses]}, BN running statistics finite {stats_ok}; "
          f"no Pallas kernel is on this path (K3 launches {k3.launches}) on {card}")
    check(stats_ok and all(math.isfinite(v) for v in rlosses), "ResNet-50: non-finite loss or BN statistics")
    check(k3.launches == 0, "ResNet-50 launched K3")
    trace("ResNet-50 train step", lambda: rp.train_step(img_d, lab_d), 1)
    del rp, net, images, labels, img_d, lab_d
    torch.cuda.empty_cache()
    out.update(resnet_ms=r_ms, resnet_images_s=RESNET_BATCH / r_ms * 1e3, resnet_peak_gb=r_peak)

    # ---- a ResNet-18 step on the card against the CPU
    cpu_net = ht.models.ResNet18(num_classes=10, device="cpu", generator=torch.Generator().manual_seed(seed))
    card_net = ht.models.ResNet18(num_classes=10, device="gpu")
    card_net.load_state_dict(cpu_net.state_dict())
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(8, 64, 64, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, 8))
    steps = []
    for net_, x_, y_ in ((card_net, xs.to(dev), ys.to(dev)), (cpu_net, xs, ys)):
        w = ht.nn.DataParallel(net_, optimizer=ht.optim.DataParallelOptimizer(ht.optim.sgd(0.1, momentum=0.9)))
        w.init(seed, x_)
        steps.append(float(w.train_step(x_, y_)))
    perr = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(card_net.state_dict().values(), cpu_net.state_dict().values()))
    print(f"[train] ResNet-18 one step at batch 8, 64x64: loss card {steps[0]:.6f} cpu {steps[1]:.6f}, "
          f"max|Δ| over parameters and BN statistics {perr:.3e} (tolerance {TOL_RESNET:g}) on {card}")
    check(abs(steps[0] - steps[1]) <= TOL_RESNET * steps[1] and perr <= TOL_RESNET, "ResNet-18 step differs between card and CPU")

    # ---- DASO over 2 x 2 slices
    daso = ht.optim.DASO(ht.optim.DataParallelOptimizer(ht.optim.sgd(0.1)), mesh=(2, 2), comm=mesh,
                         total_epochs=10, warmup_epochs=0, cooldown_epochs=0)
    mlp = ht.models.MLP((128, 64, 10), in_features=DASO_IN, device="gpu", generator=torch.Generator(device=dev).manual_seed(seed))
    dm = ht.nn.DataParallelMultiGPU(mlp, comm=mesh, optimizer=daso).init(seed, torch.zeros(1, DASO_IN, device=dev))
    xb = torch.randn(DASO_BATCH, DASO_IN, generator=gen, device=dev)
    yb = torch.randint(0, 10, (DASO_BATCH,), generator=gen, device=dev)
    daso.global_skip, daso.batches_seen = 3, 1
    pattern = []
    t0 = time.perf_counter()
    for step in range(2, 2 + DASO_STEPS):
        dm.train_step(xb, yb)
        w0, w1 = (r.layers[0].kernel for r in dm.replicas)
        agree = bool(torch.equal(w0, w1))
        pattern.append(agree)
        check(agree == (step % 3 == 0), f"DASO step {step}: slices agree {agree}, sync expected {step % 3 == 0}")
    torch.cuda.synchronize()
    print(f"[train] DASO 2 x 2 slices, MLP {DASO_IN}->128->64->10, batch {DASO_BATCH}, global_skip 3: slices agree "
          f"after steps {[s for s, a in zip(range(2, 2 + DASO_STEPS), pattern) if a]} and differ between, "
          f"{1e3 * (time.perf_counter() - t0) / DASO_STEPS:.3f} ms/step on {card}")
    del dm, mlp, xb, yb
    torch.cuda.empty_cache()
    return out


def random_paths(ht, t1, seed: int, dev, card: str) -> dict:
    """Random numbers on the Threefry streams: T1 against its plain version
    across 2^32, the draws at the Lloyd shape timed against T1's bound,
    randperm(1e8, split=0) on the Feistel route, and a chunked 16-bit draw.
    Returns T1's numbers and its launches on the path."""
    rmod = importlib.import_module("heat_tpu_torch.core.random")
    out = {}
    # ---- T1 against the plain version across 2^32
    key = t1.fold_in((0, seed & 0xFFFFFFFF), 12345)
    start = 2**32 - RANDOM_WINDOW // 2
    equal = True
    for kind, dtype, bounds in (("bits32", None, None), ("bits64", None, None), ("uniform", torch.float32, None),
                                ("uniform", torch.float64, None), ("uniform", torch.bfloat16, None),
                                ("uniform", torch.float16, None), ("randint", torch.int32, (-5, 1000)),
                                ("randint", torch.int64, (-(2**63), 2**63 - 1)), ("randint", torch.int8, (-128, 128))):
        got = t1.threefry(key, RANDOM_WINDOW, start=start, kind=kind, dtype=dtype, bounds=bounds, device=dev)
        want = t1.reference_threefry(key, RANDOM_WINDOW, start=start, kind=kind, dtype=dtype, bounds=bounds, device=dev)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        equal = equal and same
        print(f"[random] T1 {kind} {dtype}{'' if bounds is None else f' in {bounds}'} counters [2^32 - "
              f"{RANDOM_WINDOW // 2}, 2^32 + {RANDOM_WINDOW // 2}): bitwise equal to the plain version {same} on {card}")
    check(equal, "T1 differs from its plain version across 2^32")
    nerr = {}
    for dtype in (torch.float32, torch.float64):
        got = t1.threefry(key, RANDOM_WINDOW, start=start, kind="normal", dtype=dtype, device=dev)
        want = t1.reference_threefry(key, RANDOM_WINDOW, start=start, kind="normal", dtype=dtype, device=dev)
        nerr[dtype] = ulps(got, want)
        print(f"[random] T1 normal {dtype} across 2^32: max {nerr[dtype]:.1f} ulp from the plain version "
              f"(tolerance {NORMAL_ULPS}), bitwise equal share {float((got == want).double().mean()):.6f} on {card}")
        check(nerr[dtype] <= NORMAL_ULPS, f"T1 normal {dtype} off its plain version by {nerr[dtype]} ulp")
    out["max_abs_err"] = float((t1.threefry(key, RANDOM_WINDOW, start=start, kind="uniform", device=dev)
                                - t1.reference_threefry(key, RANDOM_WINDOW, start=start, kind="uniform", device=dev)).abs().max())
    del got, want

    # ---- the draws at the Lloyd shape through the entry points
    n = ROWS * 64
    mesh = ht.MeshComm(4)
    ht.random.seed(seed)
    torch.cuda.synchronize()
    t1.launches = 0
    calls = {}
    moment_tol = max(1e-3, 6 / math.sqrt(n))  # some 6 standard errors, 1e-3 at the full size
    for name, fn in (("rand", lambda: ht.random.rand(ROWS, 64, split=0, comm=mesh)),
                     ("randn", lambda: ht.random.randn(ROWS, 64, split=0, comm=mesh)),
                     ("randint", lambda: ht.random.randint(0, 1000, (ROWS, 64), split=0, comm=mesh))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = fn()
        torch.cuda.synchronize()
        calls[name] = 1e3 * (time.perf_counter() - t0)
        v = a.larray
        check(tuple(a.shape) == (ROWS, 64) and a.split == 0, f"{name}: bad shape or split")
        if name == "rand":
            check(float(v.min()) >= 0 and float(v.max()) < 1 and abs(float(v.mean()) - 0.5) < moment_tol, "rand: bad values")
        elif name == "randn":
            check(abs(float(v.mean())) < moment_tol and abs(float(v.std()) - 1) < moment_tol, "randn: bad moments")
        else:
            check(int(v.min()) == 0 and int(v.max()) == 999, "randint: bad bounds")
        del a, v
        torch.cuda.empty_cache()
    path_launches = t1.launches
    check(path_launches == 3, f"T1 launches {path_launches} != 3 (rand, randn, randint: 1 each)")
    # the same draws at a small size on the card and on the CPU
    ht.random.seed(seed + 1)
    a = ht.random.randn(1000, 7, split=0, comm=mesh).larray.cpu()
    ht.random.seed(seed + 1)
    b = ht.random.randn(1000, 7, split=0, comm=mesh, device="cpu").larray
    ht.random.seed(seed + 1)
    c = ht.random.randint(-50, 50, (999,), split=0, comm=mesh).larray.cpu()
    ht.random.seed(seed + 1)
    d = ht.random.randint(-50, 50, (999,), split=0, comm=mesh, device="cpu").larray
    wide = []
    for d_ in ("gpu", "cpu"):
        ht.random.seed(seed + 1)
        wide.append(ht.random.randint(-(2**62), 2**62, (999,), dtype=ht.int64, split=0, comm=mesh, device=d_).larray.cpu())
    small_ulps = ulps(a, b)
    same_int = torch.equal(c, d) and torch.equal(*wide)
    print(f"[random] randn (1000, 7) card vs cpu: {small_ulps:.1f} ulp (tolerance {CARD_CPU_ULPS}); randint (999,) "
          f"int32 and int64 card vs cpu equal {same_int} on {card}")
    check(small_ulps <= CARD_CPU_ULPS and same_int, "random draws differ between card and CPU")
    # T1 alone at the Lloyd shape: f32 uniform, normal and int32 randint,
    # each held to its plain version over the whole range, chunk by chunk
    # (a whole-size int64 plain draw exceeds the card); times of the kernel,
    # the plain version and torch.rand
    step = 1 << 27
    buf = torch.empty(n, device=dev)
    ibuf = torch.empty(n, dtype=torch.int32, device=dev)
    draws = (("uniform", buf, None), ("normal", buf, None), ("randint", ibuf, (0, 1000)))
    whole = {}
    for kind, dst, bounds in draws:
        t1.threefry(key, n, kind=kind, dtype=dst.dtype, bounds=bounds, device=dev, out=dst)
        worst = 0.0
        for o in range(0, n, step):
            want = t1.reference_threefry(key, min(step, n - o), start=o, kind=kind, dtype=dst.dtype, bounds=bounds,
                                         device=dev)
            got = dst[o:o + want.numel()]
            worst = max(worst, ulps(got, want) if kind == "normal" else float(not torch.equal(got, want)))
            del want
        whole[kind] = worst
        tol = NORMAL_ULPS if kind == "normal" else 0
        print(f"[random] T1 {kind} {dst.dtype} over all {n} counters of ({ROWS}, 64): "
              + (f"max {worst:.1f} ulp from the plain version (tolerance {tol})" if kind == "normal"
                 else f"bitwise equal to the plain version {worst == 0}") + f" on {card}")
        check(worst <= tol, f"T1 {kind} at ({ROWS}, 64) differs from its plain version")
    ms = time_ms(lambda: t1.threefry(key, n, kind="uniform", device=dev, out=buf), reps=5)
    ms_normal = time_ms(lambda: t1.threefry(key, n, kind="normal", device=dev, out=buf), reps=5)
    ms_randint = time_ms(lambda: t1.threefry(key, n, kind="randint", dtype=torch.int32, bounds=(0, 1000), device=dev,
                                             out=ibuf), reps=5)
    plain_ms = time_ms(lambda: [buf[o:o + step].copy_(t1.reference_threefry(key, min(step, n - o), start=o, kind="uniform",
                                                                              device=dev)) for o in range(0, n, step)],
                       reps=1, warmup=0)
    rand_ms = time_ms(lambda: torch.rand(n, device=dev, out=buf), reps=5)
    ms_2 = time_ms(lambda: t1.threefry(key, n, kind="uniform", device=dev, out=buf), reps=5)
    bound_ms = 4 * n / HBM_BYTES_PER_S * 1e3
    print(f"[time] threefry uniform f32 ({ROWS}, 64): kernel_ms={ms:.4f} (again {ms_2:.4f}; normal {ms_normal:.4f}; "
          f"randint int32 {ms_randint:.4f}) plain_ms={plain_ms:.4f} torch.rand (Philox, not the same function) "
          f"{rand_ms:.4f} bound_ms={bound_ms:.4f} (bytes: {4 * n / 1e9:.2f} GB written, each draw) on {card}")
    print(f"[e2e] random at ({ROWS}, 64) over MeshComm(4): " + ", ".join(f"{k} {v:.3f} ms" for k, v in calls.items())
          + f" (first calls), T1 launches {path_launches} on {card}")
    del buf, ibuf, draws, dst, got
    torch.cuda.empty_cache()
    out.update(ms=ms, ms_normal=ms_normal, ms_randint=ms_randint, plain_ms=plain_ms, torch_rand_ms=rand_ms,
               bound_ms=bound_ms, calls=calls, launches=path_launches, normal_ulps_whole=whole["normal"])

    # ---- randperm(1e8, split=0) on the Feistel route
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    perm = ht.random.randperm(RANDOM_PERM, split=0, comm=mesh)
    torch.cuda.synchronize()
    perm_ms = 1e3 * (time.perf_counter() - t0)
    perm_peak = torch.cuda.max_memory_allocated() / 1e9
    p = perm.larray
    is_perm = torch.equal(torch.sort(p).values, torch.arange(RANDOM_PERM, dtype=torch.int32, device=dev))
    # the Feistel keys of a few indices recomputed on the host in python ints
    ht.random.seed(seed + 2)
    state = ht.random.get_state()
    q = ht.random.randperm(5000, split=0, comm=mesh).larray.cpu()
    ht.random.set_state(state)
    q_cpu = ht.random.randperm(5000, split=0, comm=mesh, device="cpu").larray
    print(f"[random] randperm({RANDOM_PERM}, split=0) over MeshComm(4), Feistel route: {perm_ms:.3f} ms, peak "
          f"{perm_peak:.3f} GB, a permutation {is_perm}; randperm(5000) card equals cpu {torch.equal(q, q_cpu)} on {card}")
    check(is_perm and torch.equal(q, q_cpu), "randperm on the Feistel route")
    del perm, p
    torch.cuda.empty_cache()
    out["perm_ms"] = perm_ms

    # ---- a 16-bit draw past the chunk limit, sampled positions against the plain version
    for name, kind in (("rand", "uniform"), ("randn", "normal")):
        ht.random.seed(seed + 3)
        draw_key = rmod._next_key()
        ht.random.seed(seed + 3)
        x = getattr(ht.random, name)(CHUNK_ROWS, 64, dtype=ht.bfloat16, split=0, comm=mesh).larray
        f32_bytes = CHUNK_ROWS * 64 * 4
        n_chunks = -(-f32_bytes // rmod._CHUNK_F32_BYTES)
        rows = -(-CHUNK_ROWS // n_chunks)
        worst, checked = 0.0, 0
        for blk in range(n_chunks):
            lo = blk * rows
            hi = min(lo + rows, CHUNK_ROWS)
            for o in (0, (hi - lo) * 64 - 4096):
                want = t1.reference_threefry(t1.fold_in(draw_key, blk), 4096, start=o, kind=kind, dtype=torch.bfloat16,
                                             device=dev)
                got = x[lo:hi].reshape(-1)[o:o + 4096]
                worst = max(worst, float((got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max()))
                checked += 4096
        print(f"[random] {name} ({CHUNK_ROWS}, 64) bf16 in {n_chunks} row blocks of {rows}: {checked} sampled "
              f"positions, max {worst:.0f} bf16 ulp from the plain version (tolerance {0 if kind == 'uniform' else 1}) "
              f"on {card}")
        check(worst <= (0 if kind == "uniform" else 1), f"chunked {name} bf16 differs from the plain version")
        del x
        torch.cuda.empty_cache()
    return out


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
    from heat_tpu_torch.ops import threefry as t1
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
            "heat_attention": k3, "heat_matmul": k2, "heat_repack": k7, "heat_threefry": t1}
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
    k1_abs_16 = check_cdist16(k1, gen, dev)

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
    k5_abs, k5_rerun = 0.0, True
    xt_l = torch.randn(LASSO_N + 1, LASSO_M, generator=gen, device=dev)
    y_l = torch.randn(LASSO_M, generator=gen, device=dev)
    xt_r = torch.randn(37, 9_999, generator=gen, device=dev)
    y_r = torch.randn(9_999, generator=gen, device=dev)
    for name, xt_, y_, nonzero in [("5e5x1001", xt_l, y_l, False), ("5e5x1001", xt_l, y_l, True),
                                   ("ragged 9999x37", xt_r, y_r, False), ("ragged 9999x37", xt_r, y_r, True)]:
        th = 0.1 * torch.randn(xt_.shape[0], generator=gen, device=dev) if nonzero else torch.zeros(xt_.shape[0], device=dev)
        got = k5.sweep(xt_, y_, th, 1e-4)
        again = k5.sweep(xt_, y_, th, 1e-4)
        want = k5.reference_sweep(xt_, y_, th, 1e-4)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "non-finite lasso_sweep output")
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        rerun = torch.equal(got, again)
        k5_rerun = k5_rerun and rerun
        print(f"[check] lasso_sweep {name} theta0={'nonzero' if nonzero else 'zero'}: max_abs_err={err:.3e} "
              f"max|theta|={scale:.3e} nonzero coords {int((want != 0).sum())}/{want.numel()}, rerun bitwise equal {rerun}")
        check(err <= TOL_LASSO * scale, f"lasso_sweep {name}: error {err:.3e} > {TOL_LASSO} * {scale:.3e}")
        check(rerun, f"lasso_sweep {name}: reruns differ")
        k5_abs = max(k5_abs, err)
    del xt_r, y_r

    # K6 at the SpMV cell (k = 1 and 4), the Spectral cell's k-NN
    # Laplacian, a ragged matrix (empty rows, one row of 1000 entries,
    # columns out of order), integer-valued data (bitwise, also against the
    # JAX package's ELL product), bitwise reruns at the cell, and the
    # panels' edges
    k6_abs = 0.0
    sp_vals, sp_cols, sp_ptr = random_csr(SPMV_N, SPMV_N, SPMV_DENSITY, gen, dev)
    sp_nnz = sp_vals.numel()
    sp_w = k6.ell_width(int((sp_ptr[1:] - sp_ptr[:-1]).max()))
    sp_t = k6.csr_panels(sp_vals, sp_cols, sp_ptr, SPMV_N)
    sp_x = torch.randn(SPMV_N, SPMV_K, generator=gen, device=dev)
    k6_cases = [("spmv cell k=1", sp_t, sp_x[:, 0]), ("spmv cell k=4", sp_t, sp_x)]
    blobs, _ = two_blobs(KNNG_N, KNNG_F, gen, dev)
    lap = ht.graph.laplacian_sparse(ht.sparse.knn_graph(ht.array(blobs, split=0), KNNG_K, sigma=0.5**0.5))
    lap_t = spmm_mod._panels(lap)[0]
    lap_p = lap._shards[0][2]
    lap_w = k6.ell_width(int((lap_p[1:] - lap_p[:-1]).max()))
    lap_x = torch.sin(torch.arange(1, KNNG_N + 1, dtype=torch.float32, device=dev))
    k6_cases.append(("knn laplacian", lap_t, lap_x))
    rg_rows = 100_003
    rg_cnt = torch.randint(0, 17, (rg_rows,), generator=gen, device=dev)
    rg_cnt[::7] = 0
    rg_cnt[rg_rows // 2] = 1000
    rg_ptr = torch.zeros(rg_rows + 1, dtype=torch.int64, device=dev)
    rg_ptr[1:] = torch.cumsum(rg_cnt, 0)
    rg_nnz = int(rg_ptr[-1])
    rg_t = k6.csr_panels(torch.randn(rg_nnz, generator=gen, device=dev),
                         torch.randint(0, 50_000, (rg_nnz,), generator=gen, device=dev, dtype=torch.int32), rg_ptr, 50_000)
    k6_cases.append(("ragged", rg_t, torch.randn(50_000, 3, generator=gen, device=dev)))
    for name, t_, x_ in k6_cases:
        got, abs_err, rel = compare_spmv(k6, t_, x_)
        print(f"[check] spmv {name} ({t_.rows} rows, nnz {t_.nnz}) x {tuple(x_.shape)}: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel:.3e} (|dy| / sum|vals x|)")
        check(rel <= TOL_SPMV, f"spmv {name}: relative error {rel:.3e} > {TOL_SPMV}")
        k6_abs = max(k6_abs, abs_err)
        if name.startswith("spmv cell") or name == "knn laplacian":
            same = torch.equal(got, k6.spmv(t_, x_))
            print(f"[check] spmv {name}: a rerun is bitwise equal {same}")
            check(same, f"spmv {name}: a rerun differs")
    int_d = torch.randint(1, 8, (sp_nnz,), generator=gen, device=dev).float()
    int_x = torch.randint(-4, 5, (SPMV_N, SPMV_K), generator=gen, device=dev).float()
    y_int = k6.spmv(k6.csr_panels(int_d, sp_cols, sp_ptr, SPMV_N), int_x)
    same = torch.equal(y_int, k6.reference_spmv_ell(*k6.ell_pack(int_d, sp_cols, sp_ptr, sp_w), int_x))
    print(f"[check] spmv integer-valued spmv cell k={SPMV_K}: bitwise equal to the plain ELL product {same}")
    check(same, "spmv on integer-valued data is not bitwise equal to its plain version")
    n_geo = check_spmv_geometries(k6, gen, dev)
    print(f"[check] spmv panel edges: {n_geo} geometries within {TOL_SPMV:g} of plain, reruns bitwise "
          f"(x over 3/10 panels at k = 1, 2, 4, 5, x and the CSR one element off 16 bytes; rows in one panel, empty rows; "
          f"a row over all 70001 columns; sparse rows, one run a row, x from memory)")
    del rg_t, int_d, int_x, y_int, k6_cases, blobs
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
    k1_16 = time_cdist16(k1, gen, dev, card)

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
    th1 = 0.1 * torch.randn(LASSO_N + 1, generator=gen, device=dev)
    k5_ms = time_ms(lambda: k5.sweep(xt_l, y_l, th0, 0.01), reps=10)
    k5_ms_nonzero = time_ms(lambda: k5.sweep(xt_l, y_l, th1, 0.01), reps=10)
    k5_plain_ms = time_ms(lambda: k5.reference_sweep(xt_l, y_l, th0, 0.01), reps=2, warmup=1)
    k5_ms_2 = time_ms(lambda: k5.sweep(xt_l, y_l, th0, 0.01), reps=10)
    k5_ms_nonzero_2 = time_ms(lambda: k5.sweep(xt_l, y_l, th1, 0.01), reps=10)
    k5_bound_ms, k5_bound_by = lasso_sweep_bound_ms(LASSO_M, LASSO_N + 1)
    k5_bound_sweep_ms, _ = lasso_sweep_bound_ms(LASSO_M, LASSO_N + 1, reads_of_x=1)
    print(
        f"[time] lasso_sweep ({LASSO_M},{LASSO_N + 1}): kernel_ms={k5_ms:.4f} (again {k5_ms_2:.4f}) from theta = 0, "
        f"{k5_ms_nonzero:.4f} (again {k5_ms_nonzero_2:.4f}) from a non-zero theta, the r0 GEMV included; "
        f"plain_ms={k5_plain_ms:.4f} library_ms=null (no library call computes a coordinate-descent sweep) "
        f"bound_ms={k5_bound_ms:.4f} ({k5_bound_by}; X read twice, by the r0 GEMV and the sweep; the sweep's "
        f"alone, one read: {k5_bound_sweep_ms:.4f}) on {card}"
    )
    del xt_l, y_l
    torch.cuda.empty_cache()

    # K6 at the SpMV cell and at the k-NN Laplacian; the library call is
    # cuSPARSE's CSR product.  The Laplacian's call is shorter than its
    # host work, so its device time (profiler) stands beside its event time
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch marks its sparse CSR tensors as beta
        sp_torch = torch.sparse_csr_tensor(sp_ptr, sp_cols.to(torch.int64), sp_vals, (SPMV_N, SPMV_N))
        ld_, li_, lp_ = lap._shards[0]
        lap_torch = torch.sparse_csr_tensor(lp_.to(torch.int64), li_.to(torch.int64), ld_.to(torch.float32),
                                            (KNNG_N, KNNG_N))
    k6_times = {}
    timed = [(k, sp_t, sp_x[:, :k].contiguous(), sp_torch, sp_w) for k in (1, SPMV_K)]
    timed.append(("laplacian", lap_t, lap_x[:, None], lap_torch, lap_w))
    for key, t_, xk, csr, w_ in timed:
        k, n_, nnz = xk.shape[1], t_.rows, t_.nnz
        t_k = time_ms(lambda: k6.spmv(t_, xk), reps=50, warmup=5)
        t_p = time_ms(lambda: k6.reference_spmv(t_, xk), reps=5)
        t_l = time_ms(lambda: csr @ xk, reps=50, warmup=5)
        t_k2 = time_ms(lambda: k6.spmv(t_, xk), reps=50, warmup=5)
        d_k = device_ms(lambda: k6.spmv(t_, xk), reps=20)
        d_l = device_ms(lambda: csr @ xk, reps=20)
        b_ms, b_by = spmv_bound_ms(nnz, n_, n_, k)
        k6_times[key] = (t_k, t_p, t_l, b_ms, b_by, d_k, d_l)
        print(f"[time] spmv ({n_}^2, nnz {nnz}) k={k}: kernel_ms={t_k:.4f} (again {t_k2:.4f}; "
              f"device {d_k:.4f}) plain_ms={t_p:.4f} library_ms={t_l:.4f} (device {d_l:.4f}; torch.sparse_csr_tensor @ x, "
              f"cuSPARSE) bound_ms={b_ms:.4f} ({b_by}); {spmv_traffic(k6, t_, k, w_)} on {card}")
    del sp_torch, lap_torch, sp_t, lap, lap_t, timed
    torch.cuda.empty_cache()

    # K3 and K2: against their plain versions, then timed
    k3_abs, k3_abs_16 = check_attention(k3, gen, dev)
    k2_abs, k2_abs_16 = check_matmul(k2, gen, dev)
    kernel_trace(k3, k2, gen, dev)
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

    # the bf16 north star, its blob gates and small bf16 fits
    ns = northstar_paths(ht, k1, km_mod, args.seed, dev, card)

    # the repo's cluster benchmark (KMeans, KMedians, KMedoids on spherical
    # data), KMedians/KMedoids at the Lloyd shape, and the op surface on the
    # card against the CPU
    cb = cluster_benchmark_paths(ht, k1, args.seed, dev, card)

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
    # as a user's would; K6's repacking is built on the card at first use
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
        want = k6.reference_spmv(spmm_mod._panels(a_sp)[0], xv.larray)
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

    vn = v0.larray / torch.linalg.vector_norm(v0.larray)
    _, pa, pb = solver_mod._lanczos_loop(
        spmm_mod._panels(lap), vn, KNNG_LANCZOS, lambda ops, v: torch.cat([k6.reference_spmv(t, v) for t in ops])
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
    del data, x_ht, spec, graph, lap, V, T, emb, degree, xs_, sq
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

    # the runtime core: the data pipeline through K1, assignments through K7
    rt = runtime_core_paths(ht, k1, k7, args.seed, dev, card)

    # linear algebra and classifiers: KNN through K1, GaussianNB, svd,
    # det/inv, convolve, pad and tiles
    la = linalg_classifier_paths(ht, k1, args.seed, dev, card)

    # I/O: files to the card and back, KMeans on what was loaded, DCSR members
    io = io_paths(ht, k1, k6, k7, args.seed, dev, card)

    # training: TransformerLM through K3, ResNet-50, a ResNet-18 step
    # against the CPU, DASO over 2 x 2 slices
    trn = training_paths(ht, k3, args.seed, dev, card)

    # random numbers on the Threefry streams through T1
    rnd = random_paths(ht, t1, args.seed, dev, card)

    # ---------------------------------------------------------- 6. summary
    kernels = [
        {
            "name": "cdist",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/cdist.cu",
            "replaces": "heat_tpu/ops/cdist.py:32",
            "launches": launches + ns["launches"] + cb["launches"] + rt["k1"] + la["knn"]["k1"] + io["k1"],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "at": f"({ROWS}, 64) x (8, 64) f32",
            "launches_f32_kmeans": launches,
            "launches_northstar": ns["launches"],
            "launches_cluster_benchmark": cb["launches"],
            "launches_runtime_core": rt["k1"],
            "launches_linalg_classifiers": la["knn"]["k1"],
            "launches_io": io["k1"],
            **{key: la["knn"][key] for key in ("ms_knn", "plain_ms_knn", "library_ms_knn", "bound_ms_knn", "bound_by_knn")},
            "at_knn": f"({KNN_N // TRANSPORT_MESH}, {KNN_F}) x ({KNN_N}, {KNN_F}) f32 sqrt, a position's block of the KNN batch",
            "max_abs_err_d3": cb["max_abs_err"],
            **{key: cb[key] for key in ("ms_d3", "plain_ms_d3", "library_ms_d3", "bound_ms_d3", "bound_by_d3")},
            "at_d3": f"({4 * CLUSTER_N}, 3) x ({CLUSTER_K}, 3) f32, the cluster benchmark's spherical data",
            "max_abs_err_16": k1_abs_16,
            **{f"{key}_bf16": k1_16[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "at_bf16": f"({NS_ROWS}, {NS_F}) x ({NS_K}, {NS_F}) bf16; library torch.cdist(x,y).square() on bf16, bf16 out",
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
            "ms_nonzero_theta": k5_ms_nonzero,
            "bound_ms_sweep_alone": k5_bound_sweep_ms,
            "bitwise_rerun": k5_rerun,
        },
        {
            "name": "spmv",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/spmv.cu",
            "replaces": "heat_tpu/ops/spmv.py:117",
            "launches": matmul_launches + spectral_launches + io["k6"],
            "launches_io": io["k6"],
            "max_abs_err": k6_abs,
            "ms": k6_times[1][0],
            "plain_ms": k6_times[1][1],
            "bound_ms": k6_times[1][3],
            "bound_by": k6_times[1][4],
            "library_ms": k6_times[1][2],
            "at": f"({SPMV_N}^2, density {SPMV_DENSITY}) k=1",
            **{f"{key}_k{SPMV_K}": k6_times[SPMV_K][i]
               for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))},
            **{f"{key}_laplacian": k6_times["laplacian"][i]
               for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                                        "device_library_ms"))},
            "at_laplacian": f"the knn Laplacian ({KNNG_N} rows, k={KNNG_K}), k=1",
        },
        {
            "name": "attention",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/attention.cu",
            "replaces": "heat_tpu/ops/attention.py:37",
            "launches": lm["attention"] + trn["lm_launches"],
            "launches_forward_and_ulysses": lm["attention"],
            "launches_training": trn["lm_launches"],
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
            **{f"{key}_f32_causal": att_times[(ATTN_BH, ATTN_S, ATTN_D, "float32", True)][i]
               for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms"))},
            "at_f32_causal": f"({ATTN_BH}, {ATTN_S}, {ATTN_D}) f32 causal",
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
            "launches": tr["launches"] + rt["k7"] + io["k7"],
            "launches_transport": tr["launches"],
            "launches_runtime_core": rt["k7"],
            "launches_io": io["k7"],
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
            "ms_misaligned": k7_times[(REPACK_OUT, "misaligned")][0],
            "library_ms_misaligned": k7_times[(REPACK_OUT, "misaligned")][1],
            "ms_misaligned_2p4GB": k7_times[(REPACK_BIG_OUT, "misaligned")][0],
            "library_ms_misaligned_2p4GB": k7_times[(REPACK_BIG_OUT, "misaligned")][1],
            "misaligned_call": "source one f32 element off 16-byte alignment; library buf[1:].clone()",
        },
        {
            "name": "threefry",
            "route": "cuda",
            "source": "heat_tpu_torch/csrc/threefry.cu",
            "replaces": "none: no Pallas counterpart (jax.random's Threefry-2x32 under heat_tpu/core/random.py:91)",
            "launches": rnd["launches"],
            "max_abs_err": rnd["max_abs_err"],
            "ms": rnd["ms"],
            "plain_ms": rnd["plain_ms"],
            "bound_ms": rnd["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no PyTorch call computes Threefry-2x32; torch.rand (Philox) beside it as torch_rand_ms",
            "torch_rand_ms": rnd["torch_rand_ms"],
            "ms_normal": rnd["ms_normal"],
            "ms_randint": rnd["ms_randint"],
            "at": f"({ROWS}, 64) f32 uniform, 5.12 GB written; randint int32 in [0, 1000), the same bytes",
        },
    ]
    print(f"[summary] training: TransformerLM {trn['lm_step_ms']:.4f} ms/step ({trn['lm_tokens_s']:.4e} tokens/s, "
          f"peak {trn['lm_peak_gb']:.3f} GB), ResNet-50 {trn['resnet_ms']:.4f} ms/step ({trn['resnet_images_s']:.2f} "
          f"images/s, peak {trn['resnet_peak_gb']:.3f} GB); random: randperm(1e8) {rnd['perm_ms']:.3f} ms on {card}")
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
