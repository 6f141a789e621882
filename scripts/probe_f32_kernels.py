"""Build, check and time variants of the f32 kernels of K2 (``mm_kernel``)
and K3 (``flash_fwd_kernel``) on one CUDA card.

    PYTHONPATH=. python3 scripts/probe_f32_kernels.py [matmul] [attention]

Each variant is a text patch of ``heat_tpu_torch/csrc/matmul.cu`` or
``attention.cu`` (``base`` is the source as it stands), built with the
package's nvcc flags into ``heat_tpu_torch/_build/probe/``, all builds at
once; the ptxas report of each f32 kernel is printed.  Each variant then
runs in its own process with its library swapped into the wrapper: every
check case against the plain version (f32 |Δ| within 1e-5·max(|a|·|b|)
for K2 and 1e-5 for K3, and a bitwise rerun), then CUDA-event times
against the library call (``torch.matmul`` with TF32 off,
``F.scaled_dot_product_attention``) in turns: library, kernel, kernel,
library.  A machine without a card exits with 2.
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

VARIANTS = {
    "matmul": {
        "base": [],
        "bk16-s4": [("BK = 32, STAGES = 3", "BK = 16, STAGES = 4")],
        "bk16-s3": [("BK = 32, STAGES = 3", "BK = 16, STAGES = 3")],
        "group8": [("NT = 256, GROUP_M = 16;", "NT = 256, GROUP_M = 8;")],
        "a-float2": [
            ("kq += 4)", "kq += 2)"),
            ("float av[8][4];", "float av[8][2];"),
            ("float4*>(av[i]) = *reinterpret_cast<const float4*>", "float2*>(av[i]) = *reinterpret_cast<const float2*>"),
            ("kk < 4; ++kk", "kk < 2; ++kk"),
        ],
    },
    "attention": {
        "base": [],
        "d64-2-blocks": [("DMAX == 64 ? 3", "DMAX == 64 ? 2")],
        "full-unroll": [
            ("#pragma unroll 4\n    for (int c = 0", "#pragma unroll\n    for (int c = 0"),
            ("#pragma unroll 4\n    for (int j = 0; j < BK", "#pragma unroll\n    for (int j = 0; j < BK"),
        ],
    },
}
SOURCE = {"matmul": "matmul.cu", "attention": "attention.cu"}
ENTRY = {"matmul": "mm_kernel", "attention": "flash_fwd_kernel"}
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
    (d / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE[kernel])],
                          capture_output=True, text=True)
    lines, entry = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            # keep the f32 kernels, whose mangled names carry ENTRY followed by "I"
            entry = line.split("'")[1] if f"{ENTRY[kernel]}I" in line else None
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


def operand(shape, gen, dev, offset: bool) -> torch.Tensor:
    """A contiguous normal tensor, its base 4 bytes past 16 when ``offset``."""
    n = 1
    for s in shape:
        n *= s
    return torch.randn(n + int(offset), generator=gen, device=dev)[int(offset):].view(shape)


def run_matmul(tag: str, lib: ctypes.CDLL) -> int:
    from heat_tpu_torch.ops import matmul as k2

    fn = lib.heat_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k2._fn = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for m, k, n, off in [(8192, 8192, 8192, False), (1000, 777, 1333, False), (1000, 777, 1333, True),
                         (513, 1024, 260, False), (513, 1024, 260, True), (130, 4100, 96, False),
                         (2048, 2048, 2048, False), (1, 1, 1, False), (129, 0, 5, False), (300, 4104, 520, True)]:
        a, b = operand((m, k), gen, dev, off), operand((k, n), gen, dev, off)
        got, again, want = k2.matmul(a, b), k2.matmul(a, b), k2.reference_matmul(a, b)
        torch.cuda.synchronize()
        tol = 1e-5 * max(float((a.abs() @ b.abs()).max()) if k else 0.0, 1.0)
        err = float((got - want).abs().max())
        ok = err <= tol and torch.equal(got, again)
        bad += not ok
        print(f"[{tag}] ({m},{k})x({k},{n}) offset={off}: max_abs_err {err:.3e} (tolerance {tol:.3e}), "
              f"bitwise rerun {torch.equal(got, again)}", flush=True)
    for m, k, n in [(8192, 8192, 8192), (4096, 4096, 4096)]:
        a, b = torch.randn(m, k, generator=gen, device=dev), torch.randn(k, n, generator=gen, device=dev)
        reps = 5 if m == 8192 else 20
        t_l1 = time_ms(lambda: torch.matmul(a, b), reps)
        t_k1, t_k2 = time_ms(lambda: k2.matmul(a, b), reps), time_ms(lambda: k2.matmul(a, b), reps)
        t_l2 = time_ms(lambda: torch.matmul(a, b), reps)
        t_k, t_l = min(t_k1, t_k2), min(t_l1, t_l2)
        print(f"[{tag}] time ({m},{k})x({k},{n}) f32: kernel_ms {t_k1:.4f} {t_k2:.4f} ({2 * m * n * k / t_k / 1e9:.1f} "
              f"TFLOP/s), library_ms {t_l1:.4f} {t_l2:.4f} (torch.matmul, tf32 off), ratio {t_k / t_l:.3f}", flush=True)
    return bad


def run_attention(tag: str, lib: ctypes.CDLL) -> int:
    import torch.nn.functional as F

    from heat_tpu_torch.ops import attention as k3

    fn = lib.heat_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k3._fn = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(64, 2048, 2048, 64, True, False), (16, 4096, 4096, 128, True, False), (16, 4096, 4096, 128, False, False),
             (2, 1000, 1337, 24, True, False), (2, 77, 77, 256, True, False), (1, 1, 1, 1, True, False),
             (2, 65, 0, 8, False, False), (3, 37, 50, 64, True, False), (3, 50, 37, 64, True, False),
             (2, 333, 517, 128, True, True)]
    cases += [(2, 300, 517, d, c, False) for d in (1, 20, 24, 100, 200, 256) for c in (True, False)]
    bad = 0
    for bh, sq, sk, d, causal, off in cases:
        q, k, v = (operand((bh, n, d), gen, dev, off) for n in (sq, sk, sk))
        got = k3.flash_attention(q, k, v, causal=causal)
        again = k3.flash_attention(q, k, v, causal=causal)
        want = k3.reference_flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = err <= 1e-5 and torch.equal(got, again)
        bad += not ok
        print(f"[{tag}] ({bh},{sq},{sk},{d}) causal={causal} offset={off}: max_abs_err {err:.3e} (tolerance 1e-5), "
              f"bitwise rerun {torch.equal(got, again)}", flush=True)
    for bh, s, d, causal in [(64, 2048, 64, True), (16, 4096, 128, True), (16, 4096, 128, False)]:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev) for _ in range(3))
        q4, k4, v4 = q[None], k[None], v[None]
        t_l1 = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), 10)
        t_k1 = time_ms(lambda: k3.flash_attention(q, k, v, causal=causal), 10)
        t_k2 = time_ms(lambda: k3.flash_attention(q, k, v, causal=causal), 10)
        t_l2 = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), 10)
        t_k, t_l = min(t_k1, t_k2), min(t_l1, t_l2)
        pairs = s * (s + 1) // 2 if causal else s * s
        print(f"[{tag}] time ({bh},{s},{d}) f32 causal={causal}: kernel_ms {t_k1:.4f} {t_k2:.4f} "
              f"({4 * bh * pairs * d / t_k / 1e9:.1f} TFLOP/s), library_ms {t_l1:.4f} {t_l2:.4f} "
              f"(F.scaled_dot_product_attention), ratio {t_k / t_l:.3f}", flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_f32_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) == 4 and sys.argv[1] == "--run":  # one variant, in its own process
        kernel, name = sys.argv[2], sys.argv[3]
        lib = ctypes.CDLL(str(OUT / f"{kernel}-{name}" / "lib.so"))
        run = run_matmul if kernel == "matmul" else run_attention
        return 1 if run(f"{kernel} {name}", lib) else 0
    kernels = [k for k in sys.argv[1:] if k in VARIANTS] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[identity] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    jobs = [(k, name) for k in kernels for name in VARIANTS[k]]
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
            rc = subprocess.run([sys.executable, __file__, "--run", kernel, name], timeout=600).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"[run] {kernel} {name}: exit {rc} on {card}", flush=True)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
