"""Build, check and time variants of K1's 16-bit kernel (``cdist16_kernel``
in ``heat_tpu_torch/csrc/cdist.cu``) on one CUDA card.

    PYTHONPATH=. python3 scripts/probe_k1.py [--only NAME ...]

Each variant is a text patch of ``cdist.cu`` (``base`` is the source as it
stands), built with the package's nvcc flags into
``heat_tpu_torch/_build/probe/``, all builds at once; the ptxas report of
each 16-bit instantiation on the north star's path (bf16 x bf16, 16-byte
loads, the tall 256 x 8 tile) is printed.  Each variant then runs in its
own process with its 16-bit entry point swapped into the wrapper: every
check case against the plain version (|Δd2| within 1e-5·(|x|²+|y|²)),
bitwise against ``base`` and against a rerun, then CUDA-event times at
the north star's (1e8, 64) x (8, 64) bf16 in turns with ``base``: base,
variant, variant, base.  A machine without a card exits with 2.
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

# the first design of the 16-bit kernel: the tall tile's row norms in a loop
# of their own and y read one padded shared-memory element at a time (the
# source fuses the norm into the product loop and reads y as float4)
_LOOP = '''#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TYN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * TXN];'''
_LOOP_LDS = '''#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TYN];
      // the tall tile (a row a thread) sums its row's norm here, and reads
      // y's values as float4 from unpadded rows: fewer shared-memory
      // instructions, the same sums in the same order
      if (TXN == 1 && TM == 1) xnorm = fmaf(a[0], a[0], xnorm);
      if (YP == BN) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(&ys[k][j]);
          b[j] = q.x; b[j + 1] = q.y; b[j + 2] = q.z; b[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * TXN];
      }'''
PADDED = [(new, old) for old, new in [
    ("  __shared__ float ys[BK][BN + 1];\n  __shared__ float xn_s[BM];\n  __shared__ float yn_s[BN];\n\n"
     "  const int tid = threadIdx.x;\n  const int tx = tid % TXN;",
     "  constexpr int YP = (TXN == 1 && TN % 4 == 0) ? BN : BN + 1;\n  __shared__ __align__(16) float ys[BK][YP];\n"
     "  __shared__ float xn_s[BM];\n  __shared__ float yn_s[BN];\n\n"
     "  const int tid = threadIdx.x;\n  const int tx = tid % TXN;"),
    ("    if (tid < BM) {\n#pragma unroll\n      for (int c = 0; c < BK; ++c) xnorm = fmaf(xs[c][tid], xs[c][tid], xnorm);\n"
     "    }\n    if (tid < BN) {\n#pragma unroll\n      for (int c = 0; c < BK; ++c) ynorm = fmaf(ys[c][tid], ys[c][tid], ynorm);\n"
     "    }\n\n#pragma unroll\n    for (int k = 0; k < BK; ++k) {\n      float a[TM], b[TN];\n" + _LOOP,
     "    if (!(TXN == 1 && TM == 1) && tid < BM) {\n#pragma unroll\n"
     "      for (int c = 0; c < BK; ++c) xnorm = fmaf(xs[c][tid], xs[c][tid], xnorm);\n"
     "    }\n    if (tid < BN) {\n#pragma unroll\n      for (int c = 0; c < BK; ++c) ynorm = fmaf(ys[c][tid], ys[c][tid], ynorm);\n"
     "    }\n\n#pragma unroll\n    for (int k = 0; k < BK; ++k) {\n      float a[TM], b[TN];\n" + _LOOP_LDS),
]]
OCC = [("__launch_bounds__((BM / TM) * (BN / TN))\ncdist16_kernel",
        "__launch_bounds__((BM / TM) * (BN / TN), (BN / TN == 1 ? 6 : 1))\ncdist16_kernel")]
LDCS = [("raw[u] = __ldg(reinterpret_cast<const WX*>", "raw[u] = __ldcs(reinterpret_cast<const WX*>")]
VARIANTS = {
    "base": [],
    "padded-ys": PADDED,
    "occ6": OCC,
    "ldcs": LDCS,
}
OUT = _build.BUILD_DIR / "probe"
MAIN = "cdist16_kernelINS_4BF16ES1_Li8ELi256ELi8ELi32ELi1ELi8E"
NS_ROWS, NS_F, NS_K = 100_000_000, 64, 8


def build(name: str):
    """Builds one variant; returns (ok, seconds, report lines)."""
    d = OUT / f"cdist-{name}"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "cdist.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            return False, 0.0, [f"patch target not found: {old[:80]!r}"]
        src = src.replace(old, new)
    (d / "cdist.cu").write_text(src)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "cdist.cu")],
                          capture_output=True, text=True)
    lines, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            keep = MAIN in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(f"bf16 x bf16, 16-byte loads, 256 x 8 tile: {line.strip()}")
    if proc.returncode != 0:
        lines = (proc.stdout + proc.stderr).splitlines()[-40:]
    return proc.returncode == 0, time.perf_counter() - t0, lines


def entry(path: Path):
    fn = ctypes.CDLL(str(path)).heat_cdist_16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rows(m: int, d: int, dtype, gen, dev, offset: int = 0) -> torch.Tensor:
    """Normal rows of a 16-bit type drawn in f32 chunks; the base
    ``offset`` elements past an aligned buffer."""
    buf = torch.empty(m * d + offset, dtype=dtype, device=dev)
    out = buf[offset:].view(m, d)
    for lo in range(0, m, 1 << 24):
        out[lo : lo + (1 << 24)] = torch.randn(min(1 << 24, m - lo), d, generator=gen, device=dev)
    return out


def run(name: str) -> int:
    from heat_tpu_torch.ops import cdist as k1

    k1._kernel()
    base = entry(OUT / "cdist-base" / "lib.so")
    variant = entry(OUT / f"cdist-{name}" / "lib.so")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    cases = [(20_000_000, 8, 64, 0), (1_000_000, 1, 64, 0), (1003, 257, 67, 0), (777, 300, 20, 0),
             (1001, 8, 65, 0), (130, 9, 16, 0), (5, 3, 1, 0), (1_000_003, 8, 64, 1), (1_000_003, 8, 20, 3)]
    for xt, yt in [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                   (torch.float16, torch.float16), (torch.float16, torch.float32)]:
        for m, n, d, off in cases:
            x = rows(m, d, xt, gen, dev, off)
            y = torch.randn(n, d, generator=gen, device=dev).to(yt)
            k1._fn16 = variant
            got, again = k1.cdist(x, y, sqrt=False), k1.cdist(x, y, sqrt=False)
            k1._fn16 = base
            ref = k1.cdist(x, y, sqrt=False)
            rel = 0.0
            for lo in range(0, m, 1 << 22):
                xs = x[lo : lo + (1 << 22)]
                want = k1.reference_cdist(xs, y, sqrt=False)
                scale = (xs.float() ** 2).sum(1)[:, None] + (y.float() ** 2).sum(1)[None, :]
                rel = max(rel, float(((got[lo : lo + (1 << 22)] - want).abs() / scale).max()))
            torch.cuda.synchronize()
            ok = rel <= 1e-5 and torch.equal(got, again)
            bad += not ok
            print(f"[{name}] {str(xt)[6:]} x {str(yt)[6:]} ({m},{d})x({n},{d}) base+{off}: max_rel_err {rel:.3e}, "
                  f"bitwise rerun {torch.equal(got, again)}, bitwise equal to base {torch.equal(got, ref)}", flush=True)
            del x, y, got, again, ref
    x = rows(NS_ROWS, NS_F, torch.bfloat16, gen, dev)
    y = torch.randn(NS_K, NS_F, generator=gen, device=dev).bfloat16()

    def with_fn(fn):
        def call():
            k1._fn16 = fn
            k1.cdist(x, y, sqrt=False)
        return call

    t_b1 = time_ms(with_fn(base), 20)
    t_v1 = time_ms(with_fn(variant), 20)
    t_v2 = time_ms(with_fn(variant), 20)
    t_b2 = time_ms(with_fn(base), 20)
    bound = 1e3 * (2.0 * NS_ROWS * NS_F + 2.0 * NS_K * NS_F + 4.0 * NS_ROWS * NS_K) / 3.35e12
    t_v = min(t_v1, t_v2)
    print(f"[{name}] time ({NS_ROWS},{NS_F})x({NS_K},{NS_F}) bf16: kernel_ms {t_v1:.4f} {t_v2:.4f}, base_ms "
          f"{t_b1:.4f} {t_b2:.4f}, bound_ms {bound:.4f}, kernel/bound {t_v / bound:.3f}", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1: no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--run":  # one variant, in its own process
        return 1 if run(sys.argv[2]) else 0
    names = sys.argv[sys.argv.index("--only") + 1:] if "--only" in sys.argv else list(VARIANTS)
    names = ["base"] + [n for n in names if n != "base"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[identity] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    failed = 0
    for name, (ok, secs, lines) in zip(names, built):
        print(f"[build] {name}: ok={ok} {secs:.1f} s")
        for line in lines:
            print(f"[build]   {line}")
        failed += not ok
    for name, (ok, _, _) in zip(names, built):
        if not ok:
            continue
        try:
            rc = subprocess.run([sys.executable, __file__, "--run", name], timeout=600).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"[run] {name}: exit {rc} on {card}", flush=True)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
