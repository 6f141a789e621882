"""Mixture-of-experts language-model training on the PyTorch/CUDA port
(counterpart of examples/nn/moe_lm.py).

Trains the decoder-only ``TransformerLM`` (its attention through the
hand-written flash-attention kernel on the card) with a mixture-of-experts
FFN on a synthetic token stream; the Switch load-balancing losses the MoE
layers record are added to the objective.  Over a mesh of several
positions (``ht.use_comm(ht.MeshComm(n))``) the experts and tokens are
sharded over it and dispatched by two all-to-alls; across processes each
process trains on its rows with the experts local.

    python examples/torch/nn/moe_lm.py [--steps N] [--experts E] [--top-k K] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import heat_tpu_torch as ht
from heat_tpu_torch.nn.data_parallel import _default_loss


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch MoE LM example")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--experts", type=int, default=8)
    parser.add_argument("--top-k", type=int, default=2)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--force-cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device("cpu" if args.force_cpu else args.device)
    rank, _ = ht.parallel.init_distributed()
    dev = ht.get_device().torch_device

    comm = ht.get_comm()
    ep_mesh = comm if comm.size > 1 and not comm.is_process_comm else None
    if ep_mesh is not None and args.experts % ep_mesh.size:
        args.experts = max(ep_mesh.size, args.experts - args.experts % ep_mesh.size)
    if rank == 0:
        print(f"device: {dev}, positions: {comm.size}, experts: {args.experts}, expert-parallel: {ep_mesh is not None}")
    model = ht.models.TransformerLM(
        vocab_size=args.vocab, num_layers=args.layers, num_heads=4, head_dim=32, max_seq_len=args.seq_len,
        moe_experts=args.experts, moe_k=args.top_k, ep_mesh=ep_mesh, device=ht.get_device(),
        generator=torch.Generator(device=dev).manual_seed(0),
    )

    # a patterned token stream the LM can learn, staged on the device once
    rng = np.random.default_rng(0)
    base = rng.integers(0, args.vocab, args.seq_len + 1)
    pool = 16
    offs = rng.integers(0, args.vocab, (pool, args.batch_size, 1))
    toks = torch.as_tensor((base[None, None, :] + offs) % args.vocab, device=dev)

    def batch_fn(step):
        b = toks[step % pool]
        return b[:, :-1], b[:, 1:]

    n_params = sum(p.numel() for p in model.parameters())
    if rank == 0:
        print(f"parameters: {n_params / 1e6:.2f}M")
    dp = ht.nn.DataParallel(
        model, comm=comm, optimizer=ht.optim.DataParallelOptimizer(ht.optim.adamw(args.lr)),
        loss_fn=lambda logits, y: _default_loss(logits, y) + args.aux_weight * sum(model.moe_aux_losses()),
    )
    dp.init(0, batch_fn(0)[0])

    t0 = time.perf_counter()
    nll = None
    for step in range(args.steps):
        x, y = batch_fn(step)
        nll = dp.train_step(ht.array(x, split=0), ht.array(y, split=0))
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:4d}  loss {float(nll):.4f}")
    wall = time.perf_counter() - t0
    n_tok = args.steps * args.batch_size * args.seq_len
    if rank == 0:
        print(f"{args.steps} steps in {wall:.1f}s: {n_tok / wall:.0f} tokens/s")
    assert np.isfinite(float(nll))
    return float(nll)


if __name__ == "__main__":
    main()
