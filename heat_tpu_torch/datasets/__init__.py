"""Bundled sample datasets (counterpart of heat_tpu/datasets/): the Fisher
iris and scikit-learn diabetes data in the reference's file schema
(``iris.csv``, ``iris.h5``, ``iris.nc``, the ``iris_*.csv`` splits,
``diabetes.h5``, and ``diabetes.csv``, its text copy); ``_generate.py``
rewrites them.  ``path`` is this
package's directory."""

import os

path = os.path.dirname(os.path.abspath(__file__))

__all__ = ["path"]
