"""k-clustering demo on the PyTorch/CUDA port (counterpart of
examples/cluster/demo_kclustering.py).

Fits KMeans, KMedians and KMedoids on four spherical clusters placed along
the space diagonal and prints the recovered centres against the truth; the
distances of KMeans (and of the ++ seedings) run through the hand-written
distance kernel on the card.

    python examples/torch/cluster/demo_kclustering.py [--device cpu]
"""

import argparse

import heat_tpu_torch as ht
from heat_tpu_torch.utils.data import create_spherical_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description="heat_tpu_torch k-clustering demo")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args(argv)
    ht.use_device(args.device)
    seed = 1
    positions = ht.get_comm().size
    reference = ht.array([[-8, -8, -8], [-4, -4, -4], [4, 4, 4], [8, 8, 8]], dtype=ht.float32)
    fitted = {}
    for n, radius, offset, dtype, scale in (
        (20 * positions, 1.0, 4.0, ht.float32, 1),
        (100 * positions, 1.0, 4.0, ht.float32, 1),
        (20 * positions, 10.0, 40.0, ht.int32, 10),
    ):
        data = create_spherical_dataset(num_samples_cluster=n, radius=radius, offset=offset, dtype=dtype,
                                        random_state=seed)
        clusterer = {
            "kmeans": ht.cluster.KMeans(n_clusters=4, init="kmeans++"),
            "kmedians": ht.cluster.KMedians(n_clusters=4, init="kmedians++"),
            "kmedoids": ht.cluster.KMedoids(n_clusters=4, init="kmedoids++"),
        }
        print(f"4 spherical clusters with radius {radius}, each {n} samples (dtype = {dtype.__name__})")
        for name, c in clusterer.items():
            c.fit(data)
            fitted[(name, n, radius)] = c.cluster_centers_.numpy()
            print(f"### Fitting with {name} ###\nOriginal sphere centers = {reference * scale}\n"
                  f"Fitted cluster centers = {c.cluster_centers_}")
    return fitted


if __name__ == "__main__":
    main()
