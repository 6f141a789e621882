"""Build, check and time variants of K6, the ELL SpMV kernel, on one CUDA card.

    PYTHONPATH=. python3 scripts/probe_k6.py [--only NAME ...]

Two families of variants, each a text patch of a source built with the
package's nvcc flags into ``heat_tpu_torch/_build/probe/`` (all builds at
once; each kernel's ptxas report is printed):
- ``old*``: the first K6 design (below as ``_OLD``: TPR threads a row,
  16-byte loads of every slot, pads included, x gathered through L2):
  ``old`` as it was; ``old-const-x`` with x's gathers replaced by a
  constant (the slab stream alone); ``old-coalesced`` with each slot's
  column replaced by a row-local consecutive id (the same bytes, coalesced
  gathers); ``old-skip-pads`` reading no quad past a row's length;
  ``old-skip-batched`` that and four quads a lane loaded before their
  gathers.  They are called through their own entry with the row lengths.
- ``panels*``: ``csrc/spmv.cu`` as it stands (the entries repacked by
  column panel; x staged in shared-memory panels, or gathered from memory
  from memory, one run a row, where the rows are too sparse for panels)
  and variants of it, swapped into the wrapper (``k6._fn``; a variant's
  third field overrides the wrapper's geometry: ``tpr`` scales the
  threads a row, other keys set module constants; ``STAGE_RUN`` 0 stages
  every matrix, infinity none).
Each variant runs in its own process: checked against the plain version
(within 1e-5 of Σ|vals·x| per row, integer-valued data and reruns
bitwise; the panels also at multi-panel, odd, misaligned and one-dense-row
geometries), then timed with CUDA events in turns with cuSPARSE
(``torch.sparse_csr_tensor @ x``: library, kernel, kernel, library), and by
the profiler's device time (a small call's event time is its host's), at
the SpMV cell (131072^2, density 0.002, k = 1 and 4) and at the Spectral
cell's k-NN Laplacian (65536 x 16 two blobs, k = 6).  ``ncu`` does not
run on the card's machine, so sector counts are not read.  A machine
without a card exits with 2.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from heat_tpu_torch.ops import _build  # noqa: E402

# the first K6 kernel, with the row lengths as an extra argument
_OLD = r'''
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int TPR, int KC>
__global__ void __launch_bounds__(kThreads)
spmv_ell_f32_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y, int rows, int width,
                    int k, const int* __restrict__ lens) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  const int c0 = blockIdx.y * KC;
  const bool live_row = row < rows;
  float acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = 0.f;
  if (live_row) {
    const float4* vrow = reinterpret_cast<const float4*>(vals + row * width);
    const int4* crow = reinterpret_cast<const int4*>(cols + row * width);
    const int quads = width / 4;
    for (int q = lane; q < quads; q += TPR) {
      const float4 v = __ldg(vrow + q);
      const int4 j = __ldg(crow + q);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int jj[4] = {j.x, j.y, j.z, j.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (jj[s] < 0) continue;
        const float* xr = x + static_cast<long long>(jj[s]) * k + c0;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c0 + c < k) acc[c] = fmaf(vv[s], __ldg(xr + c), acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (live_row && lane == 0) {
    float* yr = y + row * k + c0;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c0 + c < k) yr[c] = acc[c];
    }
  }
}

template <int TPR, int KC>
cudaError_t launch(const float* vals, const int* cols, const float* x, float* y, int rows,
                   int width, int k, cudaStream_t stream, const int* lens) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, (k + KC - 1) / KC);
  spmv_ell_f32_kernel<TPR, KC><<<grid, kThreads, 0, stream>>>(vals, cols, x, y, rows, width, k, lens);
  return cudaGetLastError();
}

template <int TPR>
cudaError_t launch_k(const float* vals, const int* cols, const float* x, float* y, int rows,
                     int width, int k, cudaStream_t stream, const int* lens) {
  if (k == 1) return launch<TPR, 1>(vals, cols, x, y, rows, width, k, stream, lens);
  return launch<TPR, 4>(vals, cols, x, y, rows, width, k, stream, lens);
}

}  // namespace

extern "C" int heat_spmv_old(const float* vals, const int* cols, const float* x, float* y,
                             int rows, int width, int k, void* stream, const int* lens) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 32) return static_cast<int>(launch_k<8>(vals, cols, x, y, rows, width, k, s, lens));
  if (width <= 64) return static_cast<int>(launch_k<16>(vals, cols, x, y, rows, width, k, s, lens));
  return static_cast<int>(launch_k<32>(vals, cols, x, y, rows, width, k, s, lens));
}
'''

_OLD_LOOP = '''    for (int q = lane; q < quads; q += TPR) {
      const float4 v = __ldg(vrow + q);
      const int4 j = __ldg(crow + q);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int jj[4] = {j.x, j.y, j.z, j.w};
'''
_BATCHED_LOOP = '''    for (int q0 = lane; q0 < quads; q0 += 4 * TPR) {
      float4 vb[4];
      int4 jb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u * TPR < quads) {
          vb[u] = __ldg(vrow + q0 + u * TPR);
          jb[u] = __ldg(crow + q0 + u * TPR);
        } else {
          vb[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          jb[u] = make_int4(-1, -1, -1, -1);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
      const float vv[4] = {vb[u].x, vb[u].y, vb[u].z, vb[u].w};
      const int jj[4] = {jb[u].x, jb[u].y, jb[u].z, jb[u].w};
'''
_SKIP = ("const int quads = width / 4;", "const int quads = (lens[row] + 3) / 4;")

_TPR1_ASSERT = ("static_assert(TPR == 2 ||", "static_assert(TPR == 1 || TPR == 2 ||")
_TPR1_CASE = ("    case 2: return launch<2, KC, kStaged>",
              "    case 1: return launch<1, KC, kStaged>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);\n"
              "    case 2: return launch<2, KC, kStaged>")

# (source, patches, wrapper overrides)
VARIANTS = {
    "old": ("old", [], {}),
    "old-const-x": ("old", [("__ldg(xr + c)", "1.0f")], {}),
    "old-coalesced": ("old", [("x + static_cast<long long>(jj[s]) * k + c0;",
                               "x + static_cast<long long>((row + 4 * q + s) & 65535) * k + c0;")], {}),
    "old-skip-pads": ("old", [_SKIP], {}),
    "old-skip-batched": ("old", [_SKIP, (_OLD_LOOP, _BATCHED_LOOP),
                                 ("          if (c0 + c < k) acc[c] = fmaf(vv[s], __ldg(xr + c), acc[c]);\n"
                                  "        }\n      }\n    }\n",
                                  "          if (c0 + c < k) acc[c] = fmaf(vv[s], __ldg(xr + c), acc[c]);\n"
                                  "        }\n      }\n      }\n    }\n")], {}),
    "panels": ("new", [], {}),
    "panels-unroll1": ("new", [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")], {"UNROLL": 1}),
    "panels-unroll4": ("new", [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")], {"UNROLL": 4}),
    "panels-tpr-half": ("new", [], {"tpr": 0.5}),
    "panels-tpr-double": ("new", [], {"tpr": 2}),
    "panels-tpr1": ("new", [_TPR1_ASSERT, _TPR1_CASE], {"tpr": 0.25}),
    "panels-tpr1-unroll4": ("new", [_TPR1_ASSERT, _TPR1_CASE, ("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
                            {"tpr": 0.25, "UNROLL": 4}),
    "panels-sub3072": ("new", [("constexpr int kSubCols = 6144;", "constexpr int kSubCols = 3072;")],
                       {"PANEL_COLS": 3072}),
    "panels-ldg": ("new", [("v[u] = __ldcs(reinterpret_cast<const float4*>(pvals) + q0 + u * TPR);\n"
                            "              jq[u] = __ldcs(reinterpret_cast<const int4*>(pcols) + q0 + u * TPR);",
                            "v[u] = __ldg(reinterpret_cast<const float4*>(pvals) + q0 + u * TPR);\n"
                            "              jq[u] = __ldg(reinterpret_cast<const int4*>(pcols) + q0 + u * TPR);")], {}),
    # diagnostics, timed only (their results are wrong by design): no panel
    # copies, no gathers from shared memory
    "diag-no-copy": ("new", [("hopper::mbar_arrive_expect_tx(&bar[q & 1], bulk);\n    if (bulk) hopper::bulk_load(dst, src, bulk, &bar[q & 1]);",
                              "hopper::mbar_arrive_expect_tx(&bar[q & 1], 0);")], {}),
    "diag-no-gather": ("new", [("part[0] = fmaf(vv[e], kStaged ? xs[cc[e] - c0] : __ldg(xs + cc[e]), part[0]);",
                                "part[0] = fmaf(vv[e], __int_as_float(cc[e]), part[0]);"),
                               ("const float4 xv = kStaged ? *xq : __ldg(xq);",
                                "const float4 xv = make_float4(__int_as_float(cc[e]), 1.f, 2.f, 3.f);")], {}),
    # the two repackings forced at every shape, and the staged one with
    # the fewest tiles (1024 rows each: fewer CTAs copy x)
    "panels-staged": ("new", [], {"STAGE_RUN": 0}),
    "panels-direct": ("new", [], {"STAGE_RUN": float("inf")}),
    "panels-staged-tiles-min": ("new", [], {"STAGE_RUN": 0, "MIN_TILE_ROWS": 1024}),
}
OUT = _build.BUILD_DIR / "probe"
SPMV_N, SPMV_DENSITY = 131_072, 0.002
KNNG_N, KNNG_F, KNNG_K = 65_536, 16, 6


def build(name: str):
    """Builds one variant; returns (ok, seconds, report lines)."""
    kind, patches, _ = VARIANTS[name]
    d = OUT / f"spmv-{name}"
    d.mkdir(parents=True, exist_ok=True)
    src = _OLD if kind == "old" else (_build.CSRC / "spmv.cu").read_text()
    for old, new in patches:
        if old not in src:
            return False, 0.0, [f"patch target not found: {old!r}"]
        src = src.replace(old, new)
    (d / "spmv.cu").write_text(src)
    if kind == "new":
        (d / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "spmv.cu")],
                          capture_output=True, text=True)
    lines, entry = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "spmv" in line else None
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry[-60:]}: {line.strip()}")
    if proc.returncode != 0:
        lines = (proc.stdout + proc.stderr).splitlines()[-40:]
    return proc.returncode == 0, time.perf_counter() - t0, lines


def time_ms(fn, reps: int) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time a call, from torch.profiler: the CUDA-typed events of
    ``reps`` calls (a small kernel's CUDA-event time is its host's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / reps


def random_csr(nrows: int, ncols: int, density: float, gen, dev):
    """Distinct uniformly random positions, U[0, 1) values (chip_smoke.py's)."""
    target = int(round(density * nrows * ncols))
    lin = torch.unique(torch.randint(0, nrows * ncols, (target,), generator=gen, device=dev))
    indptr = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(lin // ncols, minlength=nrows), 0)
    return torch.rand(lin.numel(), generator=gen, device=dev), (lin % ncols).to(torch.int32), indptr


def cells(gen, dev):
    """(name, CSR triple, ELL slabs, panels, x, csr tensor) at the SpMV cell
    k = 1, 4 and the k-NN Laplacian."""
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import spmv as k6

    def one(name, d, i, p, ncols, x):
        triple = (d.to(torch.float32), i.to(torch.int32), p.to(torch.int64))
        slabs = k6.ell_pack(*triple, k6.ell_width(int((p[1:] - p[:-1]).max())))
        csr = torch.sparse_csr_tensor(triple[2], triple[1].to(torch.int64), triple[0], (p.numel() - 1, ncols))
        return name, triple, slabs, k6.csr_panels(*triple, ncols), x, csr

    sv, sc, sp = random_csr(SPMV_N, SPMV_N, SPMV_DENSITY, gen, dev)
    x = torch.randn(SPMV_N, 4, generator=gen, device=dev)
    out = [one("cell k=1", sv, sc, sp, SPMV_N, x[:, 0].contiguous()), one("cell k=4", sv, sc, sp, SPMV_N, x)]
    blobs = 0.3 * torch.randn(KNNG_N, KNNG_F, generator=gen, device=dev)
    blobs[KNNG_N // 2 :] += 3.0
    lap = ht.graph.laplacian_sparse(ht.sparse.knn_graph(ht.array(blobs, split=0), KNNG_K, sigma=0.5**0.5))
    xl = torch.sin(torch.arange(1, KNNG_N + 1, dtype=torch.float32, device=dev))
    out.append(one("knn laplacian k=1", *lap._shards[0], KNNG_N, xl))
    return out


def rel_err(k6, got, panels, x) -> float:
    want = k6.reference_spmv(panels, x)
    scale = k6.reference_spmv(panels._replace(vals=panels.vals.abs()), x.abs())
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


def run(name: str) -> int:
    import warnings

    from heat_tpu_torch.ops import spmv as k6

    warnings.simplefilter("ignore")
    kind, _, over = VARIANTS[name]
    lib = ctypes.CDLL(str(OUT / f"spmv-{name}" / "lib.so"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bad = 0
    if kind == "old":
        fn = lib.heat_spmv_old
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int

        lens_of = {}

        def call(slabs, t, x):
            v, c = slabs
            x2 = x[:, None] if x.ndim == 1 else x
            y = torch.empty(v.shape[0], x2.shape[1], device=dev)
            if c.data_ptr() not in lens_of:
                lens_of[c.data_ptr()] = (c >= 0).sum(1, dtype=torch.int32)
            lens = lens_of[c.data_ptr()]
            err = fn(v.data_ptr(), c.data_ptr(), x2.data_ptr(), y.data_ptr(), v.shape[0], v.shape[1], x2.shape[1],
                     torch.cuda.current_stream().cuda_stream, lens.data_ptr())
            assert err == 0, err
            return y[:, 0] if x.ndim == 1 else y
    else:
        fn = lib.heat_spmv_panels_f32
        fn.argtypes = k6._ARGTYPES
        fn.restype = ctypes.c_int
        k6._fn = fn
        for key, val in over.items():
            if key != "tpr":
                setattr(k6, key, val)
        if "tpr" in over:
            base = k6.plan
            floor = 1 if over["tpr"] < 0.5 else 2
            k6.plan = lambda *a: base(*a)._replace(tpr=min(16, max(floor, int(base(*a).tpr * over["tpr"]))))

        def call(slabs, t, x):
            return k6.spmv(t, x)

    data = cells(gen, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cname, _, _, t, x, _ in data:
        geo = k6.plan(t.rows, t.ncols, t.nnz, 1 if x.ndim == 1 else x.shape[1], sms, t.staged)
        print(f"[{name}] plan {cname}: staged {t.staged}, {geo}", flush=True)
    exact = name not in ("old-const-x", "old-coalesced") and not name.startswith("diag")
    for cname, _, sl, t, x, _ in data:
        if not exact:
            continue
        got = call(sl, t, x)
        again = call(sl, t, x)
        torch.cuda.synchronize()
        err = rel_err(k6, got, t, x)
        same = torch.equal(got, again)
        ok = err <= 1e-5 and same
        bad += not ok
        print(f"[{name}] check {cname}: max_rel_err {err:.3e} (tolerance 1e-5), bitwise rerun {same}", flush=True)
    if exact:
        _, (d, i, p), _, t, x, _ = data[1]
        idata = torch.randint(1, 8, d.shape, generator=gen, device=dev).float()
        islabs = k6.ell_pack(idata, i, p, k6.ell_width(int((p[1:] - p[:-1]).max())))
        ix = torch.randint(-4, 5, x.shape, generator=gen, device=dev).float()
        same = torch.equal(call(islabs, k6.csr_panels(idata, i, p, x.shape[0]), ix), k6.reference_spmv_ell(*islabs, ix))
        bad += not same
        print(f"[{name}] check integer-valued cell k=4: bitwise equal to plain {same}", flush=True)
    if kind == "new" and exact:
        bad += check_geometries(name, k6, gen, dev)
    for cname, _, sl, t, x, csr in data:
        xk, v, nnz = x, sl[0], t.nnz
        t_l1 = time_ms(lambda: csr @ (xk if xk.ndim == 2 else xk[:, None]), 50)
        t_k1 = time_ms(lambda: call(sl, t, xk), 50)
        t_k2 = time_ms(lambda: call(sl, t, xk), 50)
        t_l2 = time_ms(lambda: csr @ (xk if xk.ndim == 2 else xk[:, None]), 50)
        d_k = device_ms(lambda: call(sl, t, xk), 20)
        d_l = device_ms(lambda: csr @ (xk if xk.ndim == 2 else xk[:, None]), 20)
        k = 1 if x.ndim == 1 else x.shape[1]
        live = 8.0 * nnz
        bound = 1e3 * (live + 4.0 * x.shape[0] * k + 4.0 * v.shape[0] * k) / 3.35e12
        print(f"[{name}] time {cname} slabs {tuple(v.shape)} nnz {nnz} (pad share {1 - nnz / v.numel():.4f}): "
              f"kernel_ms {t_k1:.4f} {t_k2:.4f}, library_ms {t_l1:.4f} {t_l2:.4f} (cuSPARSE), bound_ms {bound:.4f}, "
              f"kernel/bound {min(t_k1, t_k2) / bound:.3f}, kernel/library {min(t_k1, t_k2) / min(t_l1, t_l2):.3f}; "
              f"device time (profiler) kernel {d_k:.4f} library {d_l:.4f} on {card}", flush=True)
    return bad


def check_geometries(name, k6, gen, dev) -> int:
    """The panels' edges: several panels at k = 1, 2, 4, 5, 9; rows in one
    panel; empty rows and runs; a row over every column; sparse rows over
    10 panels; a row count off the tile; x with an odd column count and
    one element off 16 bytes; the CSR arrays one element off 16 bytes."""
    bad = 0

    def one(what, sv, sc, sp, ncols, k, x_off=0, csr_off=0):
        nonlocal bad
        if csr_off:
            sv, sc = (torch.cat([a.new_zeros(csr_off), a])[csr_off:] for a in (sv, sc))
        t = k6.csr_panels(sv, sc, sp, ncols)
        shape = (ncols,) if k is None else (ncols, k)
        xb = torch.randn(ncols * (k or 1) + x_off, generator=gen, device=dev)
        x = xb[x_off:].view(shape)
        got = k6.spmv(t, x)
        again = k6.spmv(t, x)
        torch.cuda.synchronize()
        err = rel_err(k6, got, t, x)
        ok = err <= 1e-5 and torch.equal(got, again)
        bad += not ok
        if not ok:
            print(f"[{name}] MISMATCH {what} k={k}: max_rel_err {err:.3e}", flush=True)
        return ok

    n_ok = 0
    for k in (None, 1, 2, 4, 5, 9):
        sv, sc, sp = random_csr(3001, 60_001, 0.01, gen, dev)  # 3 panels at k = 1, 10 at k = 4
        n_ok += one("multi-panel 3001 x 60001", sv, sc, sp, 60_001, k)
        n_ok += one("multi-panel, x one element off", sv, sc, sp, 60_001, k, x_off=1)
        n_ok += one("multi-panel, CSR one element off", sv, sc, sp, 60_001, k, csr_off=1)
        # every row's entries in the sixth panel, a third of the rows empty
        sv, sc, sp = random_csr(2050, 6144, 0.02, gen, dev)
        keep = (torch.arange(2050, device=dev) % 3 != 0).repeat_interleave((sp[1:] - sp[:-1]))
        sp2 = torch.zeros_like(sp)
        sp2[1:] = torch.cumsum(torch.bincount(torch.repeat_interleave(torch.arange(2050, device=dev),
                                                                       sp[1:] - sp[:-1])[keep], minlength=2050), 0)
        n_ok += one("one panel's columns, empty rows", sv[keep], sc[keep] + 30_720, sp2, 50_000, k)
        # one row over every column among near-empty rows
        rows, ncols = 7, 70_001
        cnt = torch.tensor([0, 3, ncols, 1, 0, 2, 5], device=dev)
        sp = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
        sp[1:] = torch.cumsum(cnt, 0)
        sc = torch.cat([torch.sort(torch.randperm(ncols, generator=gen, device=dev)[: int(n)]).values for n in cnt])
        n_ok += one("one row over every column", torch.randn(int(sp[-1]), generator=gen, device=dev),
                    sc.to(torch.int32), sp, ncols, k)
        sv, sc, sp = random_csr(20_000, 60_001, 0.0002, gen, dev)
        n_ok += one("sparse rows, one run a row", sv, sc, sp, 60_001, k)
    print(f"[{name}] check geometries: {n_ok} of {n_ok + bad} equal within 1e-5, reruns bitwise", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k6: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] == "--run":  # one variant, in its own process
        return 1 if run(sys.argv[2]) else 0
    args = sys.argv[1:]
    only = set(args[args.index("--only") + 1 :]) if "--only" in args else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[identity] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    jobs = [name for name in VARIANTS if only is None or name in only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    failed = 0
    for name, (ok, secs, lines) in zip(jobs, built):
        print(f"[build] {name}: ok={ok} {secs:.1f} s")
        for line in lines:
            print(f"[build]   {line}")
        failed += not ok
    for name, (ok, _, _) in zip(jobs, built):
        if not ok:
            continue
        try:
            rc = subprocess.run([sys.executable, __file__, "--run", name], timeout=300).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"[run] {name}: exit {rc} on {card}", flush=True)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
