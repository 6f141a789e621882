"""Dataset and DataLoader over DNDarrays (counterpart of
heat_tpu/utils/data/datatools.py).

The reference wraps each rank's shard as a torch dataset and shuffles at the
end of an epoch by exchanging permuted samples between ranks.  Under the
single controller the arrays are global: an epoch shuffle takes every
array's rows in one shared random order (split 0 through the transport
engine's take, as ``random.shuffle_rows``), and a batch is a slice of the
global arrays.  The order is heat_tpu's for one seed: ``shuffle_rows``
when every array is split 0, else one ``randperm``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Union

import torch

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["Dataset", "DataLoader", "dataset_shuffle", "dataset_ishuffle", "dataset_irecv"]


class Dataset:
    """One or more DNDarrays that share the sample axis (axis 0).

    ``transforms`` is one callable per array, applied to its item;
    ``transform`` receives the whole item tuple instead (not both).
    ``ishuffle`` names the non-blocking epoch shuffle (the same call here);
    ``test_set`` turns shuffling off."""

    def __init__(self, array: DNDarray, *arrays: DNDarray, transform=None, transforms=None, ishuffle: bool = False, test_set: bool = False):
        self.arrays = (array,) + arrays
        n = array.shape[0]
        if any(a.shape[0] != n for a in self.arrays[1:]):
            raise ValueError("all arrays must share the sample dimension")
        if transform is not None and transforms is not None:
            raise ValueError("pass either transform (tuple-level) or transforms (per-array), not both")
        if transforms is not None and not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        if transforms is not None:
            transforms = list(transforms) + [None] * (len(self.arrays) - len(transforms))
        self.transforms = transforms
        self.transform = transform
        self.ishuffle = ishuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, index):
        items = tuple(a.larray[index] for a in self.arrays)
        if self.transforms is not None:
            items = tuple(t(item) if t is not None else item for t, item in zip(self.transforms, items))
            return items[0] if len(items) == 1 else items
        if self.transform is not None:
            return self.transform(*items)
        return items[0] if len(items) == 1 else items

    def shuffle(self) -> None:
        """Every array's rows in one shared random order; a test set stays
        as it is."""
        if self.test_set:
            return
        if self.arrays and all(a.split == 0 for a in self.arrays):
            self.arrays = tuple(ht_random.shuffle_rows(list(self.arrays)))
            return
        perm = ht_random.randperm(len(self), device=self.arrays[0].device).larray
        self.arrays = tuple(ht_random._shuffled(a, perm) for a in self.arrays)

    def Shuffle(self) -> None:
        """The reference's name of the blocking epoch shuffle."""
        self.shuffle()

    def Ishuffle(self) -> None:
        """The reference's name of the non-blocking epoch shuffle; the same
        call under torch's asynchronous launches."""
        self.shuffle()


class DataLoader:
    """Batches of a :class:`Dataset` (or of one DNDarray), shuffled anew
    every epoch with ``shuffle=True``; a ``PartialH5Dataset`` yields its
    streamed slabs.  The torch DataLoader's worker and pinning knobs are
    kept for the signature's sake; ``collate_fn`` is applied."""

    def __init__(
        self,
        dataset: Union[Dataset, DNDarray],
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        collate_fn=None,
        pin_memory: bool = False,
        timeout: float = 0,
        worker_init_fn=None,
    ):
        from .partial_dataset import PartialH5Dataset

        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        self._streaming = isinstance(dataset, PartialH5Dataset)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.pin_memory = pin_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn

    def __len__(self) -> int:
        n = len(self.dataset)
        if self._streaming:
            return -(-n // self.dataset.slab_rows)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if self._streaming:
            for batch in iter(self.dataset):
                yield self.collate_fn(batch) if self.collate_fn is not None else batch
            return
        if self.shuffle:
            self.dataset.shuffle()
        n = len(self.dataset)
        for i in range(len(self)):
            batch = self.dataset[i * self.batch_size : min((i + 1) * self.batch_size, n)]
            yield self.collate_fn(batch) if self.collate_fn is not None else batch


def dataset_shuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """The epoch shuffle of ``dataset``, in place."""
    dataset.shuffle()


def dataset_ishuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """The non-blocking epoch shuffle: the same call under torch's
    asynchronous launches; :func:`dataset_irecv` waits for it."""
    dataset.shuffle()


def dataset_irecv(dataset: Dataset) -> None:
    """Wait until the shuffled arrays are written (their cards
    synchronised)."""
    for dev in {s.device for a in dataset.arrays for s in a.shards if s.is_cuda}:
        torch.cuda.synchronize(dev)
