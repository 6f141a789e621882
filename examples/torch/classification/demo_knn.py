"""k-nearest-neighbours demo with cross-validation on the bundled iris data,
on the PyTorch/CUDA port (counterpart of examples/classification/demo_knn.py).

The predictions' distances run through the hand-written distance kernel on
the card.  The data is the bundled ``iris.csv`` (the JAX script reads
``iris.h5``; the same 150 rows).

    python examples/torch/classification/demo_knn.py [--device cpu]
"""

import argparse
import random

import heat_tpu_torch as ht
from heat_tpu_torch import datasets
from heat_tpu_torch.classification import KNeighborsClassifier


def calculate_accuracy(new_y, verification_y):
    """Fraction of properly labelled samples (reference: demo_knn.py:28)."""
    if new_y.gshape != verification_y.gshape:
        raise ValueError(f"Expecting results of same length, got {new_y.gshape}, {verification_y.gshape}")
    count = ht.sum(ht.where(new_y == verification_y, 1, 0))
    return count / new_y.gshape[0]


def create_fold(dataset_x, dataset_y, size, seed=None):
    """Hold out a random contiguous fold of ``size`` samples; return
    (train_x, train_y, test_x, test_y)."""
    if seed is not None:
        random.seed(seed)
    n = dataset_x.shape[0]
    start = random.randint(0, n - size - 1)
    stop = start + size
    fold_x, fold_y = dataset_x[start:stop], dataset_y[start:stop]
    rest_x = ht.concatenate((dataset_x[:start], dataset_x[stop:]), axis=0)
    rest_y = ht.concatenate((dataset_y[:start], dataset_y[stop:]), axis=0)
    return rest_x, rest_y, fold_x, fold_y


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch KNN demo")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    X = ht.load_csv(f"{datasets.path}/iris.csv", sep=";", split=0)
    Y = ht.array([0] * 50 + [1] * 50 + [2] * 50, split=0)
    accuracies = []
    for i in range(5):
        train_x, train_y, test_x, test_y = create_fold(X, Y, size=30, seed=i)
        knn = KNeighborsClassifier(n_neighbors=5)
        knn.fit(train_x, train_y)
        pred = knn.predict(test_x)
        acc = float(calculate_accuracy(pred, test_y).numpy())
        accuracies.append(acc)
        print(f"fold {i}: accuracy = {acc:.3f}")
    print(f"mean accuracy over {len(accuracies)} folds: {sum(accuracies) / len(accuracies):.3f}")
    return accuracies


if __name__ == "__main__":
    main()
