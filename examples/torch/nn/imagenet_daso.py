"""Hierarchical delayed-sync (DASO) training on the PyTorch/CUDA port
(counterpart of examples/nn/imagenet_daso.py).

The two-tier layout is a :func:`heat_tpu_torch.parallel.hybrid_mesh`: a
"dcn" axis across slices and an "ici" axis inside one.  Each slice trains
its own copy of the model on its rows of every batch, and DASO averages the
slices once a skip window.  In one process the slices share the card;
started across processes (``python -m torch.distributed.run
--nproc_per_node N examples/torch/nn/imagenet_daso.py``) each process is one
slice and the average is an all-reduce over the dcn group.  The batches are
synthetic ImageNet-shaped ones.

    python examples/torch/nn/imagenet_daso.py [--slices 2] [--epochs 4] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import heat_tpu_torch as ht


def build_two_tier_mesh(n_slices: int, per_slice: int = 1):
    """The (dcn, ici) mesh of ``n_slices`` slices and the comm along ici."""
    mesh = ht.parallel.hybrid_mesh({"ici": per_slice}, {"dcn": n_slices})
    return mesh, ht.MeshComm(mesh, split_axis="ici")


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch DASO example")
    parser.add_argument("--slices", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--classes", type=int, default=10)
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    rank, size = ht.parallel.init_distributed()
    if size > 1 and args.slices != size:
        print(f"{size} processes: one slice each")
        args.slices = size
    dev = ht.get_device().torch_device

    mesh, comm = build_two_tier_mesh(args.slices)
    daso = ht.optim.DASO(
        ht.optim.DataParallelOptimizer(ht.optim.sgd(0.05, momentum=0.9)),
        mesh=mesh, comm=comm, total_epochs=args.epochs, warmup_epochs=1, cooldown_epochs=1,
    )
    net = ht.models.ResNet18(num_classes=args.classes, device=ht.get_device(),
                             generator=torch.Generator(device=dev).manual_seed(0))
    model = ht.nn.DataParallelMultiGPU(net, comm=comm, optimizer=daso)
    rng = np.random.default_rng(0)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    model.init(0, rng.standard_normal((8,) + shape[1:]).astype(np.float32))

    history = []
    for epoch in range(args.epochs):
        t0, losses = time.perf_counter(), []
        for _ in range(8):  # synthetic "batches per epoch"
            X = rng.standard_normal(shape).astype(np.float32)
            y = rng.integers(0, args.classes, args.batch_size)
            losses.append(model.train_step(ht.array(X), ht.array(y)))
        mean_loss = float(sum(float(v) for v in losses) / len(losses))
        daso.next_epoch(mean_loss)
        history.append(mean_loss)
        if rank == 0:
            print(f"epoch {epoch}: loss {mean_loss:.4f}  global_skip {daso.global_skip}  "
                  f"({time.perf_counter() - t0:.1f}s, {daso.n_slices} slices)")
    return history


if __name__ == "__main__":
    main()
