"""Build, check and time variants of K7 (``csrc/repack.cu``) and K5
(``csrc/lasso_sweep.cu``) on one CUDA card.

    PYTHONPATH=. python3 scripts/probe_k7_k5.py [repack] [lasso] [--only NAME ...]

Each variant is a text patch of the kernel's source (``base`` is the
source as it stands), built with the package's nvcc flags into
``heat_tpu_torch/_build/probe/``, all builds at once; each kernel's ptxas
report is printed.  Each variant then runs in its own process with its
library swapped into the wrapper (``k7._fn``, ``k5._fn``):
- K7: bitwise against the plain version at every (source, destination)
  alignment pair for int8 and f32, 1-33 byte segments, eight segments of
  mixed alignment in one launch, and 2.4 GB aligned and one f32 element
  off; then CUDA-event times at 80 MB and 2.4 GB, aligned and one f32
  element off, against ``clone()`` in turns: library, kernel, kernel,
  library.
- K5: the sweep against the plain version within 1e-5·max|θ| at
  5e5 x 1001 and at n around the block width, from θ = 0 and from a
  non-zero θ, and a bitwise rerun; then CUDA-event times of ``sweep``
  (the wrapper's r0 GEMV included) at 5e5 x 1001 from both θ, twice each.
A machine without a card exits with 2.
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

# K7: a TMA bulk copy (global -> shared -> global, one thread a block) for
# segments whose source and destination are both 16-byte aligned
_BULK = '''
__device__ __forceinline__ void bulk_words(const uint4* sa, uint4* d, long long w0, long long w1) {
  __shared__ __align__(128) uint4 buf[kChunkWords];
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x != 0) return;
  const unsigned bytes = static_cast<unsigned>((w1 - w0) * 16);
  const unsigned sbuf = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned sbar = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sbar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sbar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(sbuf), "l"(sa + w0), "r"(bytes), "r"(sbar) : "memory");
  for (;;) {
    unsigned done;
    asm volatile("{\\n.reg .pred p;\\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\\nselp.u32 %0, 1, 0, p;\\n}\\n"
                 : "=r"(done) : "r"(sbar) : "memory");
    if (done) break;
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(d + w0), "r"(sbuf), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) repack_kernel('''

# K5: the next block's columns prefetched into L2 at the start of each pass
_PREFETCH = '''__device__ __forceinline__ void prefetch_columns(const float* x, int cols, long long m, long long rows) {
  if (rows <= 0) return;
  const long long lines = (rows * 4 + 127) / 128 + 1;
  for (long long t = threadIdx.x; t < cols * lines; t += kThreads) {
    const long long k = t / lines;
    const char* first = reinterpret_cast<const char*>(x + k * m);
    const char* last = reinterpret_cast<const char*>(x + k * m + rows - 1);
    const char* a = reinterpret_cast<const char*>(reinterpret_cast<unsigned long long>(first) & ~127ull) +
                    128 * (t - k * lines);
    if (a <= last) asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
  }
}

'''

# K5: two barriers a block: CTA c adds value c's partials (one warp, one load
# a lane in turn) and publishes the sum, then every CTA reads the sums (the
# work area's tail holds them)
_PUBLISH = '''    {
      float* pub = work + 2 * kValues * 1024 + (step & 1) * kValues;
      for (unsigned int v = blockIdx.x; v < kValues; v += nb) {
        float s = 0.f;
        if (warp == 0) {
          for (unsigned int c = lane; c < nb; c += 32) s += __ldcg(part + v * nb + c);
          for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
          if (lane == 0) pub[v] = s;
        }
      }
      grid_barrier(arrived, nb * ++barriers);
      if (threadIdx.x < kValues) tot[threadIdx.x] = __ldcg(pub + threadIdx.x);
    }
'''

# K5: %globaltimer at five points of each block step, in CTA 0's thread 0
_TIMED = [
    ("__global__ void __launch_bounds__(kThreads)\nsweep_kernel",
     "__device__ unsigned long long k5_clock[4096 * 5];\n__device__ __forceinline__ void stamp(int step, int p) {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0 && step < 4096) k5_clock[step * 5 + p] = t;\n}\n\n"
     "__global__ void __launch_bounds__(kThreads)\nsweep_kernel"),
    ("    float th[kB];\n", "    stamp(step, 0);\n    float th[kB];\n"),
    ("    // the CTA's sums, in a fixed order\n", "    stamp(step, 1);\n    // the CTA's sums, in a fixed order\n"),
    ("    grid_barrier(arrived, nb * ++barriers);\n", "    stamp(step, 2);\n    grid_barrier(arrived, nb * ++barriers);\n"
     "    stamp(step, 3);\n"),
    ("    for (int k = 0; k < kB; ++k) dprev[k] = d_s[k];\n  }\n",
     "    for (int k = 0; k < kB; ++k) dprev[k] = d_s[k];\n    stamp(step, 4);\n  }\n"),
    ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int heat_k5_clock(unsigned long long* host, int count) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, k5_clock, count * sizeof(unsigned long long)));\n}\n"),
]

VARIANTS = {
    "repack": {
        "base": [],
        "plain-hints": [("return __ldcs(p);", "return *p;"), ("__stcs(p, v);", "*p = v;")],
        "ldg-stcs": [("return __ldcs(p);", "return __ldg(p);")],
        "no-allocate": [("return __ldcs(p);", 'uint4 v; asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];" '
                         ': "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p)); return v;')],
        "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
        "unroll8": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 8;")],
        "tiles4": [("constexpr int kTiles = 1;", "constexpr int kTiles = 4;")],
        "bulk-aligned": [
            ("\n__global__ void __launch_bounds__(kThreads) repack_kernel(", _BULK),
            ("copy_words<0, false>(sa, d, w0, w1, 0u);", "bulk_words(sa, d, w0, w1);"),
        ],
    },
    "lasso": {
        "base": [],
        "prefetch-l2": [
            ("// mode 2: X_B and r in shared memory", _PREFETCH + "// mode 2: X_B and r in shared memory"),
            ("    float th[kB];\n", "    if (j0 + kB < n) prefetch_columns(xc + static_cast<long long>(kB) * m, "
             "n - j0 - kB < kB ? n - j0 - kB : kB, m, rows);\n    float th[kB];\n"),
        ],
        "prefetch-late": [
            ("// mode 2: X_B and r in shared memory", _PREFETCH + "// mode 2: X_B and r in shared memory"),
            ("    grid_barrier(arrived, nb * ++barriers);\n", "    if (j0 + kB < n) prefetch_columns(xc + static_cast<long long>(kB) * m, "
             "n - j0 - kB < kB ? n - j0 - kB : kB, m, rows);\n    grid_barrier(arrived, nb * ++barriers);\n"),
        ],
        "publish": [("    sum_partials(part, nb, warp, lane, tot);\n", _PUBLISH)],
        "rows1": [("constexpr int kRowUnroll = 2;", "constexpr int kRowUnroll = 1;")],
        "rows4": [("constexpr int kRowUnroll = 2;", "constexpr int kRowUnroll = 4;")],
        "threads256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
        "b4": [("constexpr int kB = 8;", "constexpr int kB = 4;")],
        "b16": [("constexpr int kB = 8;", "constexpr int kB = 16;"), ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                ("constexpr int kRowUnroll = 2;", "constexpr int kRowUnroll = 1;")],
        "b12-t384": [("constexpr int kB = 8;", "constexpr int kB = 12;"), ("constexpr int kThreads = 512;", "constexpr int kThreads = 384;"),
                     ("constexpr int kRowUnroll = 2;", "constexpr int kRowUnroll = 1;")],
        "b12-rows1": [("constexpr int kB = 8;", "constexpr int kB = 12;"), ("constexpr int kRowUnroll = 2;", "constexpr int kRowUnroll = 1;")],
        "b6": [("constexpr int kB = 8;", "constexpr int kB = 6;")],
        "timed": _TIMED,
    },
}
VARIANTS["lasso"]["prefetch-late-timed"] = VARIANTS["lasso"]["prefetch-late"] + _TIMED
SOURCE = {"repack": "repack.cu", "lasso": "lasso_sweep.cu"}
ENTRY = {"repack": "repack_kernel", "lasso": "sweep_kernel"}
OUT = _build.BUILD_DIR / "probe"


def build(kernel: str, name: str):
    """Builds one variant; returns (ok, seconds, report lines)."""
    d = OUT / f"{kernel}-{name}"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / SOURCE[kernel]).read_text()
    for old, new in VARIANTS[kernel][name]:
        if old not in src:
            return False, 0.0, [f"patch target not found: {old!r}"]
        src = src.replace(old, new)
    (d / SOURCE[kernel]).write_text(src)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE[kernel])],
                          capture_output=True, text=True)
    lines, entry = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if ENTRY[kernel] in line else None
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry[-50:]}: {line.strip()}")
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


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def run_repack(tag: str, lib: ctypes.CDLL) -> int:
    from heat_tpu_torch.ops import repack as k7

    fn = lib.heat_repack_segments
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i64p, i64p, i64p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k7._fn = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0

    def same(segs, what):
        nonlocal bad
        total = sum(n for _, _, n in segs)
        got, again = k7.repack_segments(segs, (total,)), k7.repack_segments(segs, (total,))
        want = k7.reference_repack_segments(segs, (total,))
        torch.cuda.synchronize()
        ok = torch.equal(_bytes(got), _bytes(want)) and torch.equal(_bytes(got), _bytes(again))
        if not ok:
            bad += 1
            print(f"[{tag}] MISMATCH {what}", flush=True)
        return ok

    # every (source mod 16, destination mod 16) pair: int8 by bytes, f32 by 4
    a8 = torch.randint(-128, 127, (200_000,), generator=gen, device=dev, dtype=torch.int8)
    a32 = torch.randn(50_000, generator=gen, device=dev)
    pairs = 0
    for so in range(16):
        for do in range(16):
            for n in (1, 15, 16, 17, 33, 1000, 99_999):
                pairs += same([(a8, 100, do), (a8, so, n)] if do else [(a8, so, n)], f"int8 src {so} dst {do} n {n}")
    for so in range(4):
        for do in range(4):
            for n in (1, 5, 4099, 40_000):
                pairs += same([(a32, 100, do), (a32, so, n)] if do else [(a32, so, n)], f"f32 src {so} dst {do} n {n}")
    for n in range(1, 34):
        pairs += same([(a8, 3, 5), (a8, 7 + n, n), (a8, 100, 20)], f"int8 short {n}")
    segs = [(a8, o, n) for o, n in zip((1, 5, 16, 9, 3, 30, 2, 11), (1, 17, 50_001, 33, 2, 4096, 70_000, 15))]
    pairs += same(segs, "8 mixed segments")
    print(f"[{tag}] {pairs} small cases bitwise equal (of {pairs + bad})", flush=True)
    del a8, a32
    big = torch.randn(600_000_001, generator=gen, device=dev)
    for off in (0, 1):
        ok = same([(big, off, 600_000_000)], f"2.4 GB offset {off}")
        print(f"[{tag}] 2.4 GB f32 from element offset {off}: bitwise equal {ok}", flush=True)
    torch.cuda.empty_cache()
    for total, reps in ((20_000_000, 50), (600_000_000, 10)):
        buf = big[: total + 1]
        for off in (0, 1):
            src = buf[off : off + total]
            t_l1 = time_ms(lambda: src.clone(), reps)
            t_k1 = time_ms(lambda: k7.repack_segments([(buf, off, total)], (total,)), reps)
            t_k2 = time_ms(lambda: k7.repack_segments([(buf, off, total)], (total,)), reps)
            t_l2 = time_ms(lambda: src.clone(), reps)
            t_k, t_l = min(t_k1, t_k2), min(t_l1, t_l2)
            print(f"[{tag}] time {4 * total / 1e9:.2f} GB f32 offset {off}: kernel_ms {t_k1:.4f} {t_k2:.4f} "
                  f"({8 * total / t_k / 1e9:.3f} TB/s), library_ms {t_l1:.4f} {t_l2:.4f} (clone), "
                  f"ratio {t_k / t_l:.3f}", flush=True)
    return bad


def run_lasso(tag: str, lib: ctypes.CDLL) -> int:
    from heat_tpu_torch.ops import lasso_sweep as k5

    fn = lib.heat_lasso_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k5._fn = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    cases = [(500_000, 1001), (9_999, 37), (100, 3), (1, 2), (50, 7), (20_000, 8), (20_000, 9), (20_000, 15),
             (20_000, 16), (20_000, 17), (20_000, 33), (1_000_000, 5), (7_000_000, 5)]
    for m, n in cases:
        xt = torch.randn(n, m, generator=gen, device=dev)
        y = torch.randn(m, generator=gen, device=dev)
        for nonzero in (False, True):
            th = 0.1 * torch.randn(n, generator=gen, device=dev) if nonzero else torch.zeros(n, device=dev)
            got, again = k5.sweep(xt, y, th, 1e-4), k5.sweep(xt, y, th, 1e-4)
            want = k5.reference_sweep(xt, y, th, 1e-4)
            torch.cuda.synchronize()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            ok = err <= 1e-5 * max(scale, 1e-3) and torch.equal(got, again)
            bad += not ok
            print(f"[{tag}] ({m},{n}) theta0={'nonzero' if nonzero else 'zero'}: max_abs_err {err:.3e} "
                  f"(tolerance {1e-5 * max(scale, 1e-3):.3e}), bitwise rerun {torch.equal(got, again)}", flush=True)
        del xt, y
    xt = torch.randn(1001, 500_000, generator=gen, device=dev)
    y = torch.randn(500_000, generator=gen, device=dev)
    for nonzero in (False, True):
        th = 0.1 * torch.randn(1001, generator=gen, device=dev) if nonzero else torch.zeros(1001, device=dev)
        t1 = time_ms(lambda: k5.sweep(xt, y, th, 0.01), 10)
        t2 = time_ms(lambda: k5.sweep(xt, y, th, 0.01), 10)
        g = time_ms(lambda: torch.matmul(th, xt), 10)
        print(f"[{tag}] time (500000,1001) theta0={'nonzero' if nonzero else 'zero'}: sweep_ms {t1:.4f} {t2:.4f} "
              f"(the r0 GEMV alone {g:.4f})", flush=True)
    if hasattr(lib, "heat_k5_clock"):
        # one sweep's block steps split by phase, CTA 0's clock
        k5.sweep(xt, y, th, 0.01)
        torch.cuda.synchronize()
        steps = (1001 + 7) // 8
        clock = (ctypes.c_ulonglong * (5 * steps))()
        lib.heat_k5_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.heat_k5_clock.restype = ctypes.c_int
        check = lib.heat_k5_clock(ctypes.addressof(clock), 5 * steps)
        t = torch.tensor(list(clock), dtype=torch.float64).reshape(steps, 5)
        names = ("pass", "reduce + partial write", "grid barrier", "partials sum + solve")
        parts = [float((t[:, p + 1] - t[:, p]).mean()) / 1e3 for p in range(4)]
        whole = float(t[-1, 4] - t[0, 0]) / 1e6
        print(f"[{tag}] phases (cudaMemcpyFromSymbol {check}), us a block step: "
              + ", ".join(f"{nme} {v:.3f}" for nme, v in zip(names, parts)) + f"; {steps} steps in {whole:.4f} ms", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k7_k5: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) == 4 and sys.argv[1] == "--run":  # one variant, in its own process
        kernel, name = sys.argv[2], sys.argv[3]
        lib = ctypes.CDLL(str(OUT / f"{kernel}-{name}" / "lib.so"))
        run = run_repack if kernel == "repack" else run_lasso
        return 1 if run(f"{kernel} {name}", lib) else 0
    args = sys.argv[1:]
    only = set(args[args.index("--only") + 1 :]) if "--only" in args else None
    kernels = [k for k in args if k in VARIANTS] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[identity] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    jobs = [(k, name) for k in kernels for name in VARIANTS[k] if only is None or name in only]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(*job), jobs))
    failed = 0
    for (kernel, name), (ok, secs, lines) in zip(jobs, built):
        print(f"[build] {kernel} {name}: ok={ok} {secs:.1f} s")
        for line in lines:
            print(f"[build]   {line}")
        failed += not ok
    for (kernel, name), (ok, _, _) in zip(jobs, built):
        if not ok:
            continue
        try:
            rc = subprocess.run([sys.executable, __file__, "--run", kernel, name], timeout=300).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"[run] {kernel} {name}: exit {rc} on {card}", flush=True)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
