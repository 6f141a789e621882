"""Data-parallel ResNet-50 training on the PyTorch/CUDA port
(counterpart of examples/nn/imagenet.py).

ImageNet itself is not bundled: by default the example runs on synthetic
ImageNet-shaped batches; ``--data`` names an HDF5 file (``images`` and
``labels`` datasets) streamed by the out-of-core loader.  Across processes
(``python -m torch.distributed.run --nproc_per_node N
examples/torch/nn/imagenet.py``) each process steps on its rows and the
gradients are all-reduced once a step, BatchNorm over every process's rows.

    python examples/torch/nn/imagenet.py [--epochs 2] [--batch-size 128] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import heat_tpu_torch as ht


def synthetic_batches(batch_size, image_size, classes, steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        X = rng.standard_normal((batch_size, image_size, image_size, 3), dtype=np.float32)
        y = rng.integers(0, classes, batch_size)
        yield X, y


def hdf5_batches(path, batch_size):
    """(images, labels) slabs of an HDF5 file from the out-of-core loader."""
    from heat_tpu_torch.utils.data import PartialH5Dataset

    yield from PartialH5Dataset(path, dataset_names=["images", "labels"], initial_load=batch_size)


def hdf5_rows(path):
    import h5py

    with h5py.File(path, "r") as f:
        return f["images"].shape[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch ImageNet example")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--steps-per-epoch", type=int, default=16)
    parser.add_argument("--image-size", type=int, default=176)
    parser.add_argument("--classes", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--data", type=str, default=None, help="HDF5 shard path")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    rank, _ = ht.parallel.init_distributed()
    dev = ht.get_device().torch_device

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # the reference steps StepLR every 30 epochs: the schedule counts steps
    steps_per_epoch = -(-hdf5_rows(args.data) // args.batch_size) if args.data else args.steps_per_epoch
    schedule = ht.optim.lr_scheduler.StepLR(args.lr, step_size=30 * steps_per_epoch, gamma=0.1)
    net = ht.models.ResNet50(num_classes=args.classes, dtype=dtype, device=ht.get_device(),
                             generator=torch.Generator(device=dev).manual_seed(0))
    model = ht.nn.DataParallel(
        net, optimizer=ht.optim.DataParallelOptimizer(ht.optim.sgd(schedule, momentum=0.9, nesterov=True)))
    model.init(0, np.zeros((8, args.image_size, args.image_size, 3), np.float32))

    losses = []
    for epoch in range(args.epochs):
        batches = (hdf5_batches(args.data, args.batch_size) if args.data else
                   synthetic_batches(args.batch_size, args.image_size, args.classes, args.steps_per_epoch, seed=epoch))
        t0, losses, n_images = time.perf_counter(), [], 0
        for X, y in batches:
            if not isinstance(X, ht.DNDarray):
                X, y = ht.array(X, split=0), ht.array(y, split=0)
            n_images += X.shape[0]
            losses.append(model.train_step(X, y))
        dt = time.perf_counter() - t0
        if not losses:
            print(f"epoch {epoch}: no batches")
            continue
        mean_loss = float(sum(float(v) for v in losses) / len(losses))
        if rank == 0:
            print(f"epoch {epoch}: loss {mean_loss:.4f}  {n_images / dt:.0f} img/s ({len(losses)} steps, {dt:.1f}s)")
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
