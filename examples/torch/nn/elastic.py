"""Fault-tolerant training with elastic restart on the PyTorch/CUDA port
(counterpart of examples/nn/elastic.py).

Trains a small MLP regression under the ``run_elastic`` supervisor:
checkpoints are written every few steps, faults are injected mid-run (a NaN
loss and a crash), and training recovers from the latest checkpoint instead
of dying.  Re-running the script with the same ``--ckpt-dir`` resumes where
the previous run stopped.

    python examples/torch/nn/elastic.py [--steps N] [--ckpt-dir DIR] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

import heat_tpu_torch as ht
from heat_tpu_torch.utils import Checkpointer, FaultInjector, StallDetector, run_elastic


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch elastic training example")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--ckpt-dir", type=str,
                        default=os.path.join(tempfile.gettempdir(), "heat_tpu_torch_elastic_ckpt"))
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--inject", action="store_true", default=True,
                        help="inject a NaN loss at step 17 and a crash at step 23")
    parser.add_argument("--no-inject", dest="inject", action="store_false")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    dev = ht.get_device().torch_device

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((256, 16)), dtype=torch.float32, device=dev)
    W_true = torch.as_tensor(rng.standard_normal((16, 1)), dtype=torch.float32, device=dev)
    Y = X @ W_true + 0.01 * torch.as_tensor(rng.standard_normal((256, 1)), dtype=torch.float32, device=dev)
    model = ht.models.MLP(features=(64, 1), in_features=16, device=ht.get_device(),
                          generator=torch.Generator(device=dev).manual_seed(0))
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8

    def loss_of(params):
        return torch.mean((torch.func.functional_call(model, params, (X,)) - Y) ** 2)

    def train_step(state):
        """One Adam step on the flat state {p/…, m/…, v/…, t} (optax's
        update, as the JAX example's)."""
        params = {n[2:]: t.detach().requires_grad_(True) for n, t in state.items() if n.startswith("p/")}
        loss = loss_of(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        t = state["t"] + 1
        new = {"t": t}
        for (name, p), g in zip(params.items(), grads):
            m = b1 * state["m/" + name] + (1 - b1) * g
            v = b2 * state["v/" + name] + (1 - b2) * g * g
            mhat, vhat = m / (1 - b1 ** t), v / (1 - b2 ** t)
            new["p/" + name] = (p - lr * mhat / (vhat.sqrt() + eps)).detach()
            new["m/" + name], new["v/" + name] = m, v
        return new, loss.detach()

    faults = FaultInjector()
    if args.inject:
        faults.nan_at(17).raise_at(23)

    def step_fn(state, step):
        state, loss = train_step(state)
        return state, {"loss": faults.fire(step, loss)}

    init = {"t": torch.zeros((), device=dev)}
    for name, p in model.named_parameters():
        init["p/" + name] = p.detach().clone()
        init["m/" + name], init["v/" + name] = torch.zeros_like(p), torch.zeros_like(p)
    watchdog = StallDetector(timeout=120.0, on_stall=lambda quiet: print(f"!! no step completed for {quiet:.0f}s")).start()
    t0 = time.perf_counter()
    try:
        state, report = run_elastic(
            step_fn, init, lambda step: step, n_steps=args.steps,
            checkpointer=Checkpointer(args.ckpt_dir, max_to_keep=2), checkpoint_every=args.checkpoint_every,
            on_event=lambda event: print(f"  [elastic] {event}"), on_step=lambda step, metrics: watchdog.beat(),
        )
    finally:
        watchdog.stop()
    final_loss = float(train_step(state)[1])
    print(f"{report.steps_run} steps ({report.restarts} restarts, {len(report.skipped_steps)} skipped) in "
          f"{time.perf_counter() - t0:.1f}s; final loss {final_loss:.5f}")
    assert np.isfinite(final_loss)
    return report, final_loss


if __name__ == "__main__":
    main()
