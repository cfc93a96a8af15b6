"""Batch iterator with threaded prefetch (the host side of the input pipe), a
copy of ``lc2is_tpu/data/loader.py``.

The reference uses a bare single-process DataLoader with no workers
(``evaluate.py:62``).  Here item loading runs in a thread pool and a small
ready-queue of collated batches hides decoding behind the step on the card.
The shuffle is seeded by ``seed + epoch``, so the order repeats the JAX
package's.  Unlike the JAX copy, an exception while loading a batch is raised
in the consumer, not taken for the end of the epoch.

Under a mesh of more than one rank each global batch is split by rows: the
order, the batch size and ``len`` stay the global ones, and each rank loads
and collates only its own contiguous rows of each batch (all of them where
the batch does not divide by the world size), tagged with those rows
(``core/mesh.py::tag_rows``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

import numpy as np

from lc2is_tpu_torch.core.mesh import Mesh, batch_rows, tag_rows


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 0,
        prefetch: int = 2,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.mesh = mesh if mesh is not None and mesh.data > 1 else None
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """The epoch the next iteration runs (its shuffle and the dataset's
        augmentation stream), as a resumed run needs."""
        self._epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)  # advance the per-item aug stream
        self._epoch += 1
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers <= 0:
            for b in batches:
                yield self._collate(b, [self.dataset[int(i)] for i in self._own(b)])
            return

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(lambda i: self.dataset[int(i)], self._own(b)))
                    q.put(self._collate(b, items))
            except Exception as e:  # raised again in the consumer
                q.put(_Failure(e))
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, _Failure):
                    raise item.error
                yield item
        finally:
            stop.set()
            try:  # a producer blocked on a full queue gets to see ``stop``
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False)


    def _own(self, b: np.ndarray) -> np.ndarray:
        """This rank's indices of global batch ``b``."""
        if self.mesh is None:
            return b
        r = batch_rows(self.mesh, len(b))
        return b[r.start:r.stop]

    def _collate(self, b: np.ndarray, items):
        batch = self.collate_fn(items)
        return batch if self.mesh is None else tag_rows(batch, batch_rows(self.mesh, len(b)))


class _Failure:
    """An exception of the producer thread, on its way to the consumer."""

    def __init__(self, error: Exception):
        self.error = error
