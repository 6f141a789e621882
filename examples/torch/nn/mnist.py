"""Data-parallel MNIST training on the PyTorch/CUDA port
(counterpart of examples/nn/mnist.py).

The reference's convnet in torch, trained by ``ht.nn.DataParallel``: on one
process the step runs over the global batch; started by a launcher
(``python -m torch.distributed.run --nproc_per_node N
examples/torch/nn/mnist.py``) each process steps on its rows of every
batch and the gradients are all-reduced once a step.

    python examples/torch/nn/mnist.py [--epochs N] [--batch-size B] [--data DIR] [--device cpu]

Without ``--data`` pointing at the MNIST IDX files, a deterministic
synthetic MNIST-shaped dataset is used (nothing is downloaded).  The card
is the default device; ``--device cpu`` runs on the CPU.
"""

import argparse
import time

import torch
from torch import nn

import heat_tpu_torch as ht
from heat_tpu_torch.utils.data import DataLoader, MNISTDataset


class Net(nn.Module):
    """The reference's convnet (examples/nn/mnist.py:23) over NHWC input."""

    def __init__(self):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(1, 32, 3), nn.Conv2d(32, 64, 3)
        self.fc1, self.fc2 = nn.Linear(12 * 12 * 64, 128), nn.Linear(128, 10)

    def forward(self, x):
        x = torch.relu(self.conv1(x.permute(0, 3, 1, 2)))
        x = torch.max_pool2d(torch.relu(self.conv2(x)), 2)
        x = torch.relu(self.fc1(x.flatten(1)))
        return torch.log_softmax(self.fc2(x), dim=-1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch MNIST example")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--data", type=str, default="./mnist-data")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    rank, size = ht.parallel.init_distributed()
    dev = ht.get_device().torch_device

    # replicated in every process: each batch is cut by the chunk rule below
    train_set = MNISTDataset(args.data, train=True, download=True, split=None)
    test_set = MNISTDataset(args.data, train=False, download=True, test_set=True)
    torch.manual_seed(0)
    model = ht.nn.DataParallel(
        Net().to(dev),
        optimizer=ht.optim.DataParallelOptimizer(ht.optim.adam(args.lr)),
        loss_fn=lambda logp, y: -logp.gather(1, y[:, None].long()).mean(),
    )
    model.init(0, train_set.htdata.larray[: args.batch_size, ..., None] / 255.0)

    for epoch in range(args.epochs):
        loader = DataLoader(train_set, batch_size=args.batch_size, shuffle=True)
        t0, losses = time.perf_counter(), []
        for images, labels in loader:
            x = ht.array(images.to(dev, torch.float32)[..., None] / 255.0, split=0)
            y = ht.array(labels.to(dev), split=0)
            losses.append(model.train_step(x, y))
        dt = time.perf_counter() - t0
        if rank == 0:
            print(f"epoch {epoch}: mean loss {float(sum(losses)) / len(losses):.4f} ({len(losses)} steps, {dt:.1f}s)")

    with torch.no_grad():
        pred = model(test_set.htdata.larray.to(dev, torch.float32)[..., None] / 255.0).argmax(dim=1)
    truth = test_set.httargets.larray.to(pred.device)
    accuracy = float((pred == truth).float().mean())
    if rank == 0:
        print(f"test accuracy: {accuracy:.4f} ({size} process(es))")
    return accuracy


if __name__ == "__main__":
    main()
