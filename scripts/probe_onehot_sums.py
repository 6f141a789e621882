"""Accuracy and time of the Lloyd step's f32 one-hot sums of bf16 rows on
one CUDA card: onehotᵀ·x, (8, 64), over 1e6 and 1e8 rows of x ~ N(3, 1)
bf16 with random labels, against the same sums in f64.

    python3 scripts/probe_onehot_sums.py

Candidates: one cuBLAS product with an f32 output
(``torch.mm(..., out_dtype=torch.float32)``), the same with
``allow_bf16_reduced_precision_reduction`` off, one batched product of
4096- or 65536-row slices with f32 outputs summed in f32 (what
``cluster/kmeans.py::_onehot_sums`` does, at 4096), and 4M-row blocks
widened to f32 for an f32 product.  Prints each one's error relative to
max|sum| and its CUDA-event time.  A machine without a card exits with 2.
"""

import sys

import torch


def t_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_onehot_sums: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.__version__, torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
    g = torch.Generator(device=dev).manual_seed(0)
    for n in (1_000_003, 100_000_000):
        xs = torch.empty(n, 64, dtype=torch.bfloat16, device=dev)
        for lo in range(0, n, 1 << 24):
            xs[lo:lo + (1 << 24)] = torch.randn(min(1 << 24, n - lo), 64, generator=g, device=dev) + 3.0
        lab = torch.randint(0, 8, (n,), generator=g, device=dev)
        onehot = (lab[:, None] == torch.arange(8, device=dev)[None, :]).to(torch.bfloat16)
        want = torch.zeros(8, 64, dtype=torch.float64, device=dev)
        for lo in range(0, n, 1 << 22):
            want += onehot[lo:lo + (1 << 22)].T.double() @ xs[lo:lo + (1 << 22)].double()
        scale = float(want.abs().max())

        def mm_flag():
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            try:
                return torch.mm(onehot.T, xs, out_dtype=torch.float32)
            finally:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True

        def bmm_chunks(c=4096):
            b = n // c
            head = torch.bmm(onehot[: b * c].view(b, c, 8).transpose(1, 2), xs[: b * c].view(b, c, 64),
                             out_dtype=torch.float32).sum(0)
            return head + torch.mm(onehot[b * c:].T.float(), xs[b * c:].float())

        def widen(rows=1 << 22):
            acc = torch.zeros(8, 64, device=dev)
            for lo in range(0, n, rows):
                acc += onehot[lo:lo + rows].T.float() @ xs[lo:lo + rows].float()
            return acc

        cands = {
            "mm_out_f32": lambda: torch.mm(onehot.T, xs, out_dtype=torch.float32),
            "mm_out_f32_noreduced": mm_flag,
            "bmm_4096": bmm_chunks,
            "bmm_65536": lambda: bmm_chunks(65536),
            "widen_4M": widen,
        }
        for name, fn in cands.items():
            got = fn()
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max()) / scale
            print(f"n={n} {name}: rel err {err:.3e}, {t_ms(fn):.4f} ms", flush=True)
        del xs, onehot, lab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
