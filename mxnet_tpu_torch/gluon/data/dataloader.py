"""DataLoader with multiprocess workers.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference:
python/mxnet/gluon/data/dataloader.py:26-112): ``default_batchify_fn``,
the process pool (fork by default, ``MXNET_WORKER_START_METHOD``) and
the thread pool, ``_MultiWorkerIter``, ``last_batch``, ``prefetch`` and
``pin_memory``.

Workers run ONLY host-side numpy code (dataset indexing, decode,
augment, batchify): the port's default context is ``gpu(0)``, and a
forked worker must never touch CUDA. Datasets therefore hold host
arrays (``ArrayDataset`` copies NDArrays to the host at construction);
a worker handed a tensor that is not on the host raises a clear error
back to the consumer instead of touching the device, and workers set
``torch.set_num_threads(1)`` (the parent's OpenMP pool does not survive
fork). Batches cross the process boundary as numpy arrays and are
placed once, in the consumer:

* ``pin_memory=True``: staged through pinned (page-locked) host memory
  and copied with ``non_blocking=True`` onto the current GPU context
  (``gpu(0)`` when the current context is the host); without a card the
  constructor raises — it never quietly gives host tensors;
* ``pin_memory=False``: placed on the current context, as the JAX
  package does.

Worker exceptions are captured and re-raised at ``next()``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import traceback
import weakref

import numpy as np
import torch

from ...context import current_context, gpu
from ...ndarray.ndarray import NDArray, array as _nd_array
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference dataloader.py:
    default_batchify_fn). Output stays numpy until placement; NDArray
    samples stack on their context."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data_.detach() for d in data]),
                       ctx=data[0].context)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return data


# Workers return numpy (picklable, no device handles); one function
# serves both sides — kept as a distinct name for reference parity.
default_mp_batchify_fn = default_batchify_fn


def _check_host(tree):
    """Raise if `tree` holds an array that is not on the host: a worker
    must not touch the card (reading the tensor's device does not)."""
    if isinstance(tree, (list, tuple)):
        for t in tree:
            _check_host(t)
        return
    device = None
    if isinstance(tree, NDArray):
        device = tree.data_.device
    elif isinstance(tree, torch.Tensor):
        device = tree.device
    if device is not None and device.type != "cpu":
        raise RuntimeError(
            "a DataLoader sample holds a tensor on %s: datasets feed "
            "worker processes that must not touch the card; keep samples "
            "as host arrays (ArrayDataset copies NDArrays to the host)"
            % device)


class _WorkerError:
    """Pickled traceback from a worker (re-raised in the consumer)."""

    def __init__(self, exc):
        self.exc_type = type(exc).__name__
        self.msg = str(exc)
        self.tb = traceback.format_exc()

    def reraise(self):
        raise RuntimeError(
            "DataLoader worker raised %s: %s\n--- worker traceback ---\n%s"
            % (self.exc_type, self.msg, self.tb))


_worker_dataset = None


def _terminate_pool(pool):
    try:
        pool.terminate()
        pool.join()
    except Exception:
        pass


def _worker_initializer(dataset, is_child_process):
    # The dataset is sent once at pool startup, not per batch.
    global _worker_dataset
    _worker_dataset = dataset
    if is_child_process:
        # A worker never uses the card: hide it from anything the worker
        # might initialize, and keep torch's host pool to one thread
        # (the parent's OpenMP threads do not survive fork).
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        torch.set_num_threads(1)


def _worker_fn(samples, batchify_fn, dataset=None):
    """`dataset` is passed explicitly by thread pools (several loaders
    share one process); process-pool workers use the per-process global
    installed by the initializer, and check that nothing they touch
    lives on the card."""
    try:
        in_process = dataset is not None
        ds = dataset if in_process else _worker_dataset
        items = [ds[i] for i in samples]
        if not in_process:
            _check_host(items)
        batch = batchify_fn(items)
        if not in_process:
            _check_host(batch)
        return _as_numpy(batch)
    except Exception as e:  # captured, not fatal to the pool
        return _WorkerError(e)


def _as_numpy(batch):
    if isinstance(batch, NDArray):
        return batch.asnumpy()
    if isinstance(batch, torch.Tensor):
        return batch.detach().cpu().numpy()
    if isinstance(batch, (list, tuple)):
        return [_as_numpy(b) for b in batch]
    return batch


def _to_ndarray(batch, pin_ctx=None):
    """NDArrays from host numpy batches: through pinned memory and a
    non-blocking copy onto `pin_ctx`, or on the current context."""
    if isinstance(batch, np.ndarray):
        if pin_ctx is None:
            return _nd_array(batch)
        staged = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        return NDArray(staged.to(pin_ctx.torch_device, non_blocking=True),
                       ctx=pin_ctx)
    if isinstance(batch, (list, tuple)):
        return [_to_ndarray(b, pin_ctx) for b in batch]
    return batch


class _MultiWorkerIter:
    """Async iterator over a worker pool with bounded prefetch
    (reference dataloader.py:_MultiWorkerIter)."""

    def __init__(self, pool, batchify_fn, batch_sampler, prefetch,
                 pin_ctx=None, dataset=None):
        self._pool = pool
        self._batchify_fn = batchify_fn
        self._pin_ctx = pin_ctx
        self._dataset = dataset          # non-None only for thread pools
        self._iter = iter(batch_sampler)
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        for _ in range(prefetch):
            self._push_next()

    def _push_next(self):
        r = next(self._iter, None)
        if r is None:
            return
        async_ret = self._pool.apply_async(
            _worker_fn, (r, self._batchify_fn, self._dataset))
        self._data_buffer[self._sent_idx] = async_ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            assert not self._data_buffer, \
                "Data buffer should be empty at this moment"
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx)
        self._rcvd_idx += 1
        batch = ret.get()
        if isinstance(batch, _WorkerError):
            batch = batch.reraise()
        return _to_ndarray(batch, self._pin_ctx)

    def __iter__(self):
        return self


class DataLoader:
    """Mini-batch loader over a Dataset (reference dataloader.py:
    DataLoader).

    Parameters follow the reference: dataset, batch_size, shuffle,
    sampler, last_batch, batch_sampler, batchify_fn, num_workers,
    pin_memory, prefetch, thread_pool. ``close()`` (or the context
    manager) terminates the worker pool.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=False):
        self._dataset = dataset
        self._pin_ctx = None
        if pin_memory:
            ctx = current_context()
            self._pin_ctx = ctx if ctx.device_type == "gpu" else gpu(0)
            self._pin_ctx.torch_device   # raises without a card
        self._thread_pool = thread_pool
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pool = None
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool

                self._pool = ThreadPool(
                    self._num_workers,
                    initializer=_worker_initializer,
                    initargs=(dataset, False))
            else:
                # Fork by default (fast; workers run only numpy by
                # contract); MXNET_WORKER_START_METHOD=forkserver|spawn
                # trades startup cost for a thread-clean child (the
                # dataset must then be picklable).
                from ... import env as _env

                method = _env.get("MXNET_WORKER_START_METHOD")
                self._pool = mp.get_context(method).Pool(
                    self._num_workers,
                    initializer=_worker_initializer,
                    initargs=(dataset, True))
            # finalize() runs at gc or atexit, before interpreter
            # teardown, so the pool shuts down while multiprocessing's
            # internals are still alive.
            self._finalizer = weakref.finalize(self, _terminate_pool,
                                               self._pool)

    def __iter__(self):
        if self._num_workers == 0:
            def same_process_iter():
                for batch in self._batch_sampler:
                    items = [self._dataset[idx] for idx in batch]
                    yield _to_ndarray(_as_numpy(self._batchify_fn(items)),
                                      self._pin_ctx)
            return same_process_iter()
        return _MultiWorkerIter(self._pool, self._batchify_fn,
                                self._batch_sampler, self._prefetch,
                                self._pin_ctx,
                                dataset=self._dataset
                                if self._thread_pool else None)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Terminate and join the worker pool (idempotent)."""
        if self._pool is not None:
            self._finalizer()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
