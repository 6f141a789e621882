"""LASSO path demo on the bundled diabetes dataset, on the PyTorch/CUDA
port (counterpart of examples/lasso/demo.py).

Computes the coordinate-descent LASSO path over a log-spaced range of
regularization strengths (each sweep one launch of the hand-written sweep
kernel on the card) and prints (or, with matplotlib, plots) the paths.  The
data is the bundled ``diabetes.csv``, the text copy of ``diabetes.h5``.

    python examples/torch/lasso/demo.py [--device cpu]
"""

import argparse

import numpy as np

import heat_tpu_torch as ht
from heat_tpu_torch import datasets
from heat_tpu_torch.regression import Lasso


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch Lasso demo")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    parser.add_argument("--plot", action="store_true", help="plot the paths with matplotlib")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    data = ht.load_csv(f"{datasets.path}/diabetes.csv", sep=";", split=0)
    X, y = data[:, :11], data[:, 11]
    # normalize features (the reference does the same ahead of fit)
    X = X / ht.sqrt(ht.mean(X**2, axis=0))
    estimator = Lasso(max_iter=100)
    lamda = np.logspace(0, 4, 10) / 10
    theta_list = []
    for la in lamda:
        estimator.lam = float(la)
        estimator.fit(X, y)
        theta_list.append(estimator.theta.numpy().flatten())
    theta_lasso = np.stack(theta_list).T[1:, :]
    print("lambda grid:", np.round(lamda, 3))
    print("coefficient paths (features x lambdas):")
    print(np.round(theta_lasso, 4))
    if args.plot:
        from matplotlib import pyplot as plt

        for row in theta_lasso:
            plt.plot(lamda, row)
        plt.xscale("log")
        plt.xlabel("lambda")
        plt.ylabel("coefficient")
        plt.title("Lasso paths - heat_tpu_torch implementation")
        plt.show()
    return theta_lasso


if __name__ == "__main__":
    main()
