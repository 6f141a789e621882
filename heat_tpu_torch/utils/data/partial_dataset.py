"""Streaming HDF5 datasets (counterpart of
heat_tpu/utils/data/partial_dataset.py).

:class:`PartialH5Dataset` names an HDF5 file too large to load at once;
iterating it (:class:`PartialH5DataLoaderIter`) starts one reader thread per
named dataset, which reads slabs of rows through ``stream.open_source`` into
a bounded queue, and the consumer places each slab on the mesh split along
its rows while the readers fetch the next.  A reader's error reaches the
consumer; ``close`` (at the end, on leaving a ``with`` block, or when
collected) stops and joins the readers and closes their files.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

from ...core import factories, memtrack, stream

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter", "queue_thread"]


def queue_thread(q: "queue.Queue") -> None:
    """Work loop of a daemon thread: runs each ``callable`` or ``(callable,
    *args)`` item of ``q``; a ``None`` item ends it."""
    while True:
        items = q.get()
        if items is None:
            q.task_done()
            return
        if isinstance(items, tuple):
            items[0](*items[1:])
        else:
            items()
        q.task_done()


class _Reader(threading.Thread):
    """Reads rows [0, rows) of ``src`` in slabs of ``slab_rows`` into the
    bounded queue ``q``, then ``None``; on an error it stores it in
    ``error`` and puts ``None``.  ``halt`` stops it between slabs."""

    def __init__(self, src: stream.ChunkSource, q: "queue.Queue", slab_rows: int, rows: int, halt: threading.Event):
        super().__init__(daemon=True, name="heat-tpu-torch-h5-reader")
        self._src, self._q, self._slab_rows, self._rows, self._halt = src, q, slab_rows, rows, halt
        self.error: Optional[BaseException] = None

    def _put(self, item) -> None:
        while not self._halt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def run(self) -> None:
        try:
            lo = 0
            while lo < self._rows and not self._halt.is_set():
                hi = min(lo + self._slab_rows, self._rows)
                self._put((lo, self._src.read(lo, hi)))
                lo = hi
        except Exception as err:  # handed to the consumer, which raises it
            self.error = err
        finally:
            self._put(None)


class PartialH5Dataset:
    """An HDF5 file streamed in slabs.

    Parameters
    ----------
    file : str
        Path of the HDF5 file.
    comm : MeshComm, optional
        The positions each slab is split over.
    dataset_names : list of str
        The datasets streamed side by side (e.g. ``["data", "labels"]``).
    transforms : callable, optional
        Applied to each slab tuple.
    initial_load : int
        Rows of a slab.
    load_length : int
        Slabs the queue holds ahead of the consumer.
    use_gpu, validate_set
        The reference's flags, kept for the signature's sake.
    """

    def __init__(
        self,
        file: str,
        comm=None,
        dataset_names: Optional[List[str]] = None,
        transforms=None,
        use_gpu: bool = True,
        validate_set: bool = False,
        initial_load: int = 7000,
        load_length: int = 2,
    ):
        self.file = file
        self.comm = comm
        self.dataset_names = dataset_names or ["data"]
        self.transforms = transforms
        self.slab_rows = int(initial_load)
        self.prefetch_depth = int(load_length)
        with stream.open_source(file, dataset=self.dataset_names[0]) as src:
            self.total_size = int(src.shape[0])

    def __len__(self) -> int:
        return self.total_size

    def __iter__(self) -> "PartialH5DataLoaderIter":
        return PartialH5DataLoaderIter(self)

    def Shuffle(self) -> None:
        """Slabs come in the file's order; shuffling happens downstream."""

    def Ishuffle(self) -> None:
        """See :meth:`Shuffle`."""

    def thread_replace_converted_batches(self) -> None:
        """The reference's hand-over between its reader and converter
        threads; the queue of :class:`PartialH5DataLoaderIter` does it."""


class PartialH5DataLoaderIter:
    """The slabs of a :class:`PartialH5Dataset` (or of a loader whose
    ``dataset`` is one), as tuples of split DNDarrays, one per named
    dataset (a single array for one name)."""

    def __init__(self, loader):
        dataset = getattr(loader, "dataset", loader)
        self.dataset = dataset
        self._closed = False
        self._halt = threading.Event()
        self._sources: List[stream.ChunkSource] = []
        self._queues: List["queue.Queue"] = []
        self._readers: List[_Reader] = []
        try:
            for name in dataset.dataset_names:
                src = stream.open_source(dataset.file, dataset=name)
                self._sources.append(src)
                q: "queue.Queue" = queue.Queue(maxsize=dataset.prefetch_depth)
                self._queues.append(q)
                self._readers.append(_Reader(src, q, dataset.slab_rows, dataset.total_size, self._halt))
        except (OSError, KeyError, ValueError) as err:
            self.close()
            raise RuntimeError(f"cannot open streamed datasets in {dataset.file!r}") from err
        for r in self._readers:
            r.start()

    def close(self) -> None:
        """Stop and join the readers and close the files; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._halt.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for r in self._readers:
            if r.is_alive():
                r.join(timeout=5.0)
        for src in self._sources:
            src.close()

    def __del__(self):
        if hasattr(self, "_closed"):
            self.close()

    def __enter__(self) -> "PartialH5DataLoaderIter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        items = [q.get() for q in self._queues]
        if any(item is None for item in items):
            errors = [r.error for r in self._readers if r.error is not None]
            self.close()
            if errors:
                raise RuntimeError(f"background reader failed for {self.dataset.file!r}") from errors[0]
            raise StopIteration
        out = tuple(factories.array(host, split=0, comm=self.dataset.comm) for _, host in items)
        for x in out:
            memtrack.tag_shards(x.shards, "staging")
        if self.dataset.transforms is not None:
            out = self.dataset.transforms(*out)
        return out[0] if len(out) == 1 else out
