"""Host-side batch loader with a background prefetch thread (port of
``raw2logit_tpu/data/loader.py``).

The ISP runs on the device inside the train step, so the loader only
assembles (raw, label) numpy batches, from an indexable dataset or a
tile store (``data/tilestore.py``), and overlaps the next batch's
assembly with the current step on one thread. Batches stay on the host;
the train loop moves them to the device. The JAX loader's ``mesh``
argument, which places a batch sharded over the devices, has no
counterpart: the port is data-parallel with one process per rank
(``parallel/``), each taking its rows of a global batch.
"""

import queue
import threading

import numpy as np

from raw2logit_tpu_torch import tracing


class ArrayDataset:
    """Indexable (img, label) view over a pair of stacked arrays."""

    def __init__(self, X, Y):
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        if len(self.X) != len(self.Y):
            raise ValueError(f"X/Y length mismatch: "
                             f"{len(self.X)} != {len(self.Y)}")

    def __len__(self):
        return len(self.X)

    def __getitem__(self, i):
        return self.X[i], self.Y[i]


def make_dataloader(dataset, batch_size, shuffle=True, **kw):
    """A Loader over an ``(X, Y)`` array pair, (N, H, W[, C]) as given.
    The ragged last batch is kept unless ``drop_last=True`` (Loader alone
    ties its default to ``shuffle``); other keyword arguments (seed,
    prefetch) pass through to Loader."""
    X, Y = dataset
    kw.setdefault("drop_last", False)
    return Loader(ArrayDataset(X, Y), batch_size, shuffle=shuffle, **kw)


class Loader:
    """Iterate (images, labels) numpy batches over a dataset.

    Args:
        dataset: indexable (img, label) source, or a tile store (anything
            with a ``gather(indices)`` method, a ``Subset`` of a store
            among them), read a batch at a time.
        batch_size: items per batch.
        shuffle: reshuffle each epoch, in the order
            ``np.random.default_rng((seed, epoch)).permutation``.
        drop_last: drop the trailing partial batch; defaults to
            ``shuffle`` (training keeps one batch shape, evaluation keeps
            every item).
        seed: seed of the shuffle.
        prefetch: assemble the next batch on a background thread.

    The consumer's wait for each batch (with ``prefetch`` the wait on the
    worker, else the batch's assembly) runs inside the span
    ``r2l.loader.wait``.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=None,
                 seed=0, prefetch=True):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self):
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self.seed, self._epoch)).permutation(n)

    def _assemble(self, indices):
        if hasattr(self.dataset, "gather"):
            # the store's threaded gather; the store serialises it against
            # its close (TileStore._lock)
            return self.dataset.gather(indices)
        items = [self.dataset[int(i)] for i in indices]
        xs = np.stack([np.asarray(x, np.float32) for x, _ in items])
        ys = np.asarray([y for _, y in items])
        return xs, ys

    def _batches(self):
        order = self._order()
        self._epoch += 1
        n = len(order)
        stop = (n - n % self.batch_size) if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self):
        if not self.prefetch:
            for idx in self._batches():
                with tracing.span("r2l.loader.wait"):
                    batch = self._assemble(idx)
                yield batch
            return
        yield from self._prefetch()

    def _prefetch(self):
        """One batch of lookahead on a background thread, cancelled when
        the consumer stops early (break or exception)."""
        q = queue.Queue(maxsize=2)
        cancel = threading.Event()

        def worker():
            try:
                for idx in self._batches():
                    if cancel.is_set():
                        return
                    q.put(self._assemble(idx))
            except BaseException as e:  # surfaced in the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            for _ in range(len(self)):  # the worker puts as many batches
                with tracing.span("r2l.loader.wait"):
                    item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancel.set()
            # drain, so that a worker blocked in put() wakes and sees cancel
            while not q.empty():
                q.get_nowait()
