"""Regenerate the bundled sample datasets (deterministic; a copy of the
JAX package's generator, writing into this package's directory).

The reference ships Fisher-iris and the scikit-learn diabetes regression
set (heat/datasets/: iris.csv, iris.h5, iris.nc, iris_X_train.csv, ...,
diabetes.h5).  Both are public-domain/BSD sample data redistributed by
scikit-learn; the files hold their real values under the reference's file
names, shapes, separators and dataset/variable keys.

- ``iris.csv``: the 150x4 Fisher measurements, ';'-separated, 1 decimal.
- ``iris_X_{train,test}.csv`` / ``iris_y_{train,test}.csv``: a fixed
  stratified 75/75 split (the reference's row counts).
- ``iris_y_pred_proba.csv``: GaussianNB class probabilities for the test
  rows.
- ``diabetes.h5``: 'x' = (442, 11) intercept column + 10 standardized
  features, 'y' = (442,) response; ``diabetes.csv`` the same 442 rows as
  text, x's 11 columns then y, ';'-separated (the port's examples read it
  where h5py is missing).

sklearn's ``load_iris`` differs from the reference's own ``iris.csv`` in 2
rows (the known UCI-vs-Fisher discrepancy, rows 34 and 37), and
``diabetes.h5`` 'x' by up to ~1.2e-5 (a normalization variant): the files
are value-equivalent sample data, not byte copies of the reference's.

Run ``python -m heat_tpu_torch.datasets._generate`` to rewrite the files
(it needs scikit-learn).
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    from sklearn.datasets import load_diabetes, load_iris
    from sklearn.model_selection import train_test_split
    from sklearn.naive_bayes import GaussianNB

    iris = load_iris()
    X = np.asarray(iris.data, dtype=np.float64)
    y = np.asarray(iris.target, dtype=np.int64)

    # iris.csv: ';'-separated, 1 decimal, no header (reference schema)
    np.savetxt(os.path.join(HERE, "iris.csv"), X, delimiter=";", fmt="%.1f")
    np.savetxt(os.path.join(HERE, "iris_labels.csv"), y, fmt="%d")

    # fixed stratified 75/75 split (reference row counts)
    Xtr, Xte, ytr, yte = train_test_split(
        X, y, test_size=75, train_size=75, stratify=y, random_state=42
    )
    np.savetxt(os.path.join(HERE, "iris_X_train.csv"), Xtr, delimiter=";", fmt="%.1f")
    np.savetxt(os.path.join(HERE, "iris_X_test.csv"), Xte, delimiter=";", fmt="%.1f")
    np.savetxt(os.path.join(HERE, "iris_y_train.csv"), ytr, fmt="%d")
    np.savetxt(os.path.join(HERE, "iris_y_test.csv"), yte, fmt="%d")
    # class-probability table for the test rows: a fitted GaussianNB, the
    # model family behind the reference's fixture
    proba = GaussianNB().fit(Xtr, ytr).predict_proba(Xte)
    np.savetxt(
        os.path.join(HERE, "iris_y_pred_proba.csv"), proba,
        delimiter=";", fmt="%.18e",
    )

    try:
        import h5py

        with h5py.File(os.path.join(HERE, "iris.h5"), "w") as f:
            f.create_dataset("data", data=X)

        dia = load_diabetes()
        Xd = np.concatenate(
            [np.ones((dia.data.shape[0], 1)), np.asarray(dia.data, np.float64)],
            axis=1,
        )
        yd = np.asarray(dia.target, dtype=np.float64)
        with h5py.File(os.path.join(HERE, "diabetes.h5"), "w") as f:
            f.create_dataset("x", data=Xd)
            f.create_dataset("y", data=yd)
    except ImportError:
        pass
    # diabetes.h5's x and y as text, for machines without h5py
    dia = load_diabetes()
    Xd = np.concatenate([np.ones((dia.data.shape[0], 1)), np.asarray(dia.data, np.float64)], axis=1)
    np.savetxt(os.path.join(HERE, "diabetes.csv"), np.concatenate([Xd, np.asarray(dia.target, np.float64)[:, None]], 1),
               delimiter=";", fmt="%.18e")

    try:
        from scipy.io import netcdf_file

        with netcdf_file(os.path.join(HERE, "iris.nc"), "w") as f:
            f.createDimension("rows", X.shape[0])
            f.createDimension("cols", X.shape[1])
            v = f.createVariable("data", "d", ("rows", "cols"))
            v[:] = X
    except ImportError:
        pass


if __name__ == "__main__":
    main()
