"""Synthetic spherical cluster data (counterpart of
heat_tpu/utils/data/spherical.py), the data of the repo's cluster benchmark
(benchmarks/cb/cluster.py)."""

from __future__ import annotations

from ...core import manipulations, random, trigonometrics, types

__all__ = ["create_spherical_dataset"]


def create_spherical_dataset(
    num_samples_cluster: int,
    radius: float = 1.0,
    offset: float = 4.0,
    dtype=types.float32,
    random_state: int = 1,
):
    """Four spherical clusters in 3-D along the space diagonal, centred at
    ±offset·(1,1,1) and ±2·offset·(1,1,1): 4·``num_samples_cluster`` rows
    at every mesh size, split 0 (heat_tpu/utils/data/spherical.py:12).
    Each cluster is the same n points of a ball of ``radius``, drawn as
    (r, θ, φ) from ``random.rand``, shifted."""
    random.seed(random_state)
    n = int(num_samples_cluster)
    r = random.rand(n, split=0) * radius
    theta = random.rand(n, split=0) * 3.1415
    phi = random.rand(n, split=0) * 2 * 3.1415

    x = (r * trigonometrics.sin(theta) * trigonometrics.cos(phi)).astype(dtype, copy=False)
    y = (r * trigonometrics.sin(theta) * trigonometrics.sin(phi)).astype(dtype, copy=False)
    z = (r * trigonometrics.cos(theta)).astype(dtype, copy=False)

    cluster1 = manipulations.stack((x + offset, y + offset, z + offset), axis=1)
    cluster2 = manipulations.stack((x + 2 * offset, y + 2 * offset, z + 2 * offset), axis=1)
    cluster3 = manipulations.stack((x - offset, y - offset, z - offset), axis=1)
    cluster4 = manipulations.stack((x - 2 * offset, y - 2 * offset, z - 2 * offset), axis=1)

    data = manipulations.concatenate((cluster1, cluster2, cluster3, cluster4), axis=0)
    return manipulations.resplit(data, 0)
