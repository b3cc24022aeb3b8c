"""Data iterators.

Counterpart of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``ResizeIter``, ``PrefetchingIter`` (with its error relay
and bounded ``close()``, :179-360), ``NDArrayIter``, ``CSVIter``,
``MNISTIter`` and the ``ImageRecordIter`` factory (:657). Reference:
python/mxnet/io.py and the C++ iterators of src/io/.

Batches are NDArrays on the iterator's context (``ctx``, default the
current context, ``gpu(0)``). A ``PrefetchingIter`` given a GPU context
moves each batch its producer threads pull through pinned staging
buffers and a side-stream copy (``data.prefetch.PinnedStager``), so
the copy overlaps the consumer's step; ``ImageRecordIter`` builds its
iterator on the host and delivers through that path. Shuffles draw from
explicit generators. ``LibSVMIter`` builds CSR batches in the JAX
package; sparse arrays are ROADMAP Queue 1 item 11, so it raises.
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import time as _time
from collections import namedtuple

import numpy as np

from .context import current_context
from .ndarray.ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "LibSVMIter", "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/type/layout of one data stream (reference io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference io.py:DataBatch :177)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "data must be a list"
        if label is not None:
            assert isinstance(label, (list, tuple)), "label must be a list"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base iterator (reference io.py:DataIter :231)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch, optionally
    resetting the inner iterator on internal EOF (reference
    io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetcher over one or more iterators
    (reference io.py:PrefetchingIter; C++ analogue iter_prefetcher.h's
    dmlc::ThreadedIter producer).

    Worker-thread errors are captured and re-raised in the consumer's
    ``next()`` — a decode exception must surface in the training loop,
    not kill the producer and strand ``next()`` on an event forever.
    The error consumes the whole ROUND across every sub-iterator; with
    ``n_iter > 1`` the streams stay aligned afterwards only if the
    failing sub-iterator consumed its underlying record before raising
    (the decode-failure shape) — a sub-iterator that raises WITHOUT
    advancing re-produces the same batch while its peers have moved on.
    Shutdown is explicit: ``close()`` (idempotent, bounded join) or the
    context-manager protocol; ``__del__`` remains a best-effort net.

    ``ctx``: None delivers the sub-iterators' batches as they come; a
    GPU context stages each batch in pinned memory in the producer
    thread and copies it on a side stream (raises without a card); a
    CPU context delivers host NDArrays.
    """

    def __init__(self, iters, rename_data=None, rename_label=None,
                 ctx=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.ctx = ctx
        self._stagers = self._make_stagers(ctx)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self.next_error = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self._place(i, self.iters[i].next())
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as exc:  # relayed to the consumer
                    self.next_batch[i] = None
                    self.next_error[i] = exc
                if not self.started:
                    # close() landed while we produced: exit without
                    # clear() — clearing here would clobber close()'s
                    # set() and park this thread on wait() forever.
                    break
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _make_stagers(self, ctx):
        """One PinnedStager per sub-iterator on a GPU context, else
        None (batches pass through)."""
        if ctx is None or ctx.device_type != "gpu":
            return None
        from .data.prefetch import PinnedStager

        return [PinnedStager(ctx, slots=3) for _ in range(self.n_iter)]

    def _place(self, i, batch):
        """Producer side: start the batch's copy to the card."""
        if self._stagers is None:
            return batch
        return batch, self._stagers[i]((batch.data, batch.label or []))

    def _delivered(self, item):
        """Consumer side: the sub-iterator's batch on ``ctx``."""
        if self._stagers is None:
            return item
        from .data.prefetch import deliver

        batch, placed = item
        data, label = deliver(placed)
        return DataBatch([NDArray(t, ctx=self.ctx) for t in data],
                         [NDArray(t, ctx=self.ctx) for t in label],
                         batch.pad, batch.index)

    def close(self, timeout=1.0):
        """Stop and join the producer threads (idempotent).

        The stop event is RE-set in a loop: a worker that was mid-
        produce when we flipped ``started`` clears ``data_taken`` on
        its way back to ``wait()``, clobbering a one-shot ``set()`` and
        blocking forever — so keep setting until the thread exits (or
        the bounded timeout passes; workers are daemons)."""
        if not self.started:
            return
        self.started = False
        for e in self.data_taken:      # every worker gets the signal up
            e.set()                    # front, whatever the join order
        deadline = _time.monotonic() + timeout
        for thread, e in zip(self.prefetch_threads, self.data_taken):
            while thread.is_alive() and _time.monotonic() < deadline:
                e.set()
                thread.join(timeout=0.05)
        for e in self.data_taken:      # re-signal any worker whose own
            e.set()                    # clear() raced the loop above

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        if not self.started:
            raise RuntimeError("PrefetchingIter is closed")
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        # A captured worker error dies with the epoch it happened in.
        self.next_error = [None for _ in range(self.n_iter)]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if not self.started:
            # No workers left to refill the slots: a stale parked batch
            # followed by an unfillable wait() would hang the loop.
            raise StopIteration
        for e in self.data_ready:
            e.wait()
        pending = [exc for exc in self.next_error if exc is not None]
        if pending:
            # The whole ROUND is consumed by the error: clear every
            # error slot and recycle every iterator — the sub-iterators
            # advance in lockstep, so a stale parked batch (or a stale
            # second error raised a batch late) would pair stream i's
            # batch k+1 with peer batch k forever after.
            self.next_error = [None for _ in range(self.n_iter)]
            for j in range(self.n_iter):
                self.data_ready[j].clear()
                self.data_taken[j].set()
            raise pending[0]
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "iterators (of different length) all end together"
            return False
        batches = [self._delivered(b) for b in self.next_batch]
        for batch in batches:
            assert batch.pad == batches[0].pad, \
                "all iterators must have the same padding"
        self.current_batch = DataBatch(
            sum([batch.data for batch in batches], []),
            sum([batch.label for batch in batches], []),
            batches[0].pad,
            batches[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, numpy/NDArray) pairs
    (reference io.py:_init_data). Arrays stay on the host."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, (NDArray,)):
            out[k] = v
        else:
            try:
                v = np.asarray(v)
                # float64 lands as float32, as mx.nd.array would make it.
                out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
            except Exception:
                raise TypeError("Invalid type '%s' for %s" % (type(v), k))
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle and last-batch
    handling 'pad'/'discard'/'roll_over' (reference io.py:NDArrayIter :546).

    ``rng`` (a ``numpy.random.RandomState``) draws the shuffle; by
    default one seeded from ``mx.random.seed``. Batches are NDArrays on
    ``ctx`` (default: the current context)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None, rng=None):
        super().__init__(batch_size)
        self.ctx = ctx if ctx is not None else current_context()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            if rng is None:
                from . import random as _random

                rng = np.random.RandomState(_random.host_seed())
            rng.shuffle(self.idx)
            self.data = [(k, v.asnumpy()[self.idx] if isinstance(v, NDArray)
                          else v[self.idx]) for k, v in self.data]
            self.label = [(k, v.asnumpy()[self.idx] if isinstance(v, NDArray)
                           else v[self.idx]) for k, v in self.label]
        # Keep numpy on host; device transfer happens per-batch.
        self.data = [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
                     for k, v in self.data]
        self.label = [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
                      for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.idx = self.idx[:new_n]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if (self.last_batch_handle == "roll_over" and
                self.cursor > self.num_data):
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [_nd_array(x[1][self.cursor:self.cursor + self.batch_size],
                              ctx=self.ctx) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [_nd_array(np.concatenate([x[1][self.cursor:], x[1][:pad]],
                                         axis=0), ctx=self.ctx)
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad" and
                self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0


class CSVIter(DataIter):
    """Stream batches from CSV files (reference: src/io/iter_csv.cc,
    exposed as mx.io.CSVIter). Values load once into memory per pass."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype=np.float32, ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + self.data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            label = label.reshape((-1,) + self.label_shape)
        else:
            label = np.zeros((data.shape[0],) + self.label_shape, dtype=dtype)
        self._inner = NDArrayIter(
            data={"data": data}, label={"softmax_label": label},
            batch_size=batch_size,
            last_batch_handle="roll_over" if round_batch else "pad", ctx=ctx)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _read_idx_ubyte(path):
    """Read an (optionally gzipped) IDX file (MNIST format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                 13: np.float32, 14: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=dtype)
        return data.reshape(dims)


class MNISTIter(DataIter):
    """MNIST IDX-format iterator (reference: src/io/iter_mnist.cc;
    same parameter names: image/label/batch_size/shuffle/flat/seed)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, ctx=None, **kwargs):
        super().__init__(batch_size)
        for p in (image, label):
            if not os.path.exists(p) and not os.path.exists(p + ".gz"):
                raise IOError("MNIST file %s not found" % p)
        image = image if os.path.exists(image) else image + ".gz"
        label = label if os.path.exists(label) else label + ".gz"
        images = _read_idx_ubyte(image).astype(np.float32) / 255.0
        labels = _read_idx_ubyte(label).astype(np.float32)
        # Data-parallel sharding across workers (iter_mnist.cc
        # num_parts) — equal-size wrap-tail shards: every part gets
        # exactly ceil(N/num_parts) samples (the tail wraps to the
        # head instead of being silently dropped), so every record is
        # reachable and all ranks run the same step count per epoch.
        if num_parts > 1:
            from .data.sharding import shard_slice

            images = shard_slice(images, num_parts, part_index)
            labels = shard_slice(labels, num_parts, part_index)
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(images.shape[0])
            images, labels = images[order], labels[order]
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        self._inner = NDArrayIter(images, labels, batch_size=batch_size,
                                  last_batch_handle="discard", ctx=ctx)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """LibSVM-format sparse iterator (reference: src/io/iter_libsvm.cc).
    Its batches are CSR arrays, and sparse arrays are not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LibSVMIter builds CSR batches; sparse arrays are ROADMAP "
            "Queue 1 item 11")


def ImageRecordIter(**kwargs):
    """Factory matching the reference's registered C++ ImageRecordIter
    (src/io/iter_image_recordio_2.cc). Implemented over the image module's
    python/native pipeline; ``ctx`` (default the current context) is
    where batches are delivered."""
    from .image import ImageRecordIterImpl

    return ImageRecordIterImpl(**kwargs)
