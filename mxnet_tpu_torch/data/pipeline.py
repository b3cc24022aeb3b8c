"""The streaming input pipeline: sharded read → parallel decode →
async device prefetch, with a checkpointable cursor at every seam.

Counterpart of ``mxnet_tpu/data/pipeline.py``: ``ImageRecordDecoder``,
``DataPipeline`` (with ``state_dict``/``load_state_dict``, the
delivered-batch watermark) and ``stall_fraction`` over the port's
``data::wait``/``data::decode``/``data::put`` and ``train_step::*``
spans. What differs is the placement: ``place=True`` on a GPU context
(the default, ``gpu(0)``) stages each batch in pinned memory and copies
it on a side CUDA stream (``prefetch.PinnedStager``), and raises at
construction without a card; on a CPU context batches become host
NDArrays. Augmenters draw from a generator the decoder owns
(``seed``), not from the global ``random``.

This is the framework form of what the reference builds in C++ as
``PrefetcherIter(BatchLoader(ImageRecordIOParser2))`` and what
`examples/train_resnet_trainstep.py` previously hand-assembled from
``preprocess_threads`` + ``PrefetchingIter``:

    dataset = data.RecordDataset(["train-0.rec", "train-1.rec"])
    pipe = data.DataPipeline(dataset,
                             decode_fn=data.ImageRecordDecoder((3, 48, 48),
                                                               rand_crop=True),
                             batch_size=32, shuffle=True, seed=7)
    for batch in pipe:          # batch.data / batch.label are on the card
        loss = step(batch.data[0], batch.label[0])

Design points (tf.data / Grain lineage, SURVEY L6):

* **Per-rank determinism.** The per-epoch sample order is a pure
  function of ``(seed, epoch)``; each rank walks its equal-size
  wrap-tail shard (``sharding.shard_indices``), so all ranks run the
  same number of steps and the union of shards covers every record.
* **Overlap.** Record read + JPEG decode + augment run on a
  ``DecodePool`` thread team; assembled batches move device-ward on a
  ``DevicePrefetcher`` thread. While the accelerator runs step N, the
  host decodes N+1 and DMAs N+2.
* **Checkpointable.** ``state_dict()`` captures the *delivered-batch
  watermark* — epoch plus samples handed to the training loop — never
  the read-ahead frontier. In-flight decoded-but-undelivered work is
  deliberately dropped on restore and recomputed deterministically, so
  resume replays the exact remaining sample sequence
  (``tests/test_data_pipeline.py`` proves the 2-rank stream is
  bit-identical through a SIGKILL). Note the guarantee is *sample
  order*: stochastic augmenters draw from their own RNG streams and are
  not replayed bitwise.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import io as mxio
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..telemetry import healthplane as _hp
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from .decode import DecodePool
from .prefetch import DevicePrefetcher, PinnedStager, deliver
from .reader import RecordDataset
from .sharding import shard_indices, num_padded

__all__ = ["DataPipeline", "ImageRecordDecoder", "stall_fraction"]

_decode_seconds = _tm.REGISTRY.histogram(
    "mx_data_decode_seconds", "Per-sample decode+augment wall time")
_samples_total = _tm.REGISTRY.counter(
    "mx_data_samples_total", "Samples delivered by the input pipeline")


class ImageRecordDecoder:
    """Decode one packed image record (recordio.pack_img framing) to
    ``(label, CHW float32)`` through the image module's augmenter
    pipeline — the per-sample body the decode pool runs. Thread-safe:
    augmenters are shared but stateless per call (RandomOrderAug
    shuffles a local view). The random augmenters draw from one
    generator the decoder owns, seeded with ``seed`` (default: from
    ``mx.random.seed``); under a decode team the draw order follows the
    threads, so only a single-threaded run replays it."""

    def __init__(self, data_shape, label_width=1, aug_list=None, seed=None,
                 **aug_kwargs):
        from ..image import image as _img

        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.auglist = aug_list if aug_list is not None \
            else _img.CreateAugmenter(self.data_shape, **aug_kwargs)
        self.rng = _img.AugRandom(seed)
        _img.bind_rng(self.auglist, self.rng)

    def __call__(self, record):
        from .. import recordio
        from ..image import image as _img

        header, payload = recordio.unpack(record)
        img = _img._imdecode_np(payload)
        for aug in self.auglist:
            img = aug(img)
        arr = np.asarray(img, dtype=np.float32).transpose(2, 0, 1)
        label = np.asarray(header.label, dtype=np.float32)
        if self.label_width == 1:
            label = label.ravel()[:1].reshape(())
        else:
            label = label.reshape(self.label_width)
        return label, arr


def _host_place(batch):
    """Host placement (a CPU context): torch tensors over the batch's
    numpy arrays, no copy."""
    batch = dict(batch)
    batch["data"] = torch.from_numpy(batch["data"])
    batch["label"] = torch.from_numpy(batch["label"])
    return batch


class DataPipeline:
    """Streaming, sharded, checkpointable batch source.

    Parameters
    ----------
    dataset : RecordDataset, or one/many ``.rec`` paths to wrap.
    decode_fn : callable(record bytes) -> (label, sample ndarray) —
        e.g. :class:`ImageRecordDecoder`.
    batch_size : per-rank batch size (each rank's pipeline produces its
        own local batch; with N ranks the global batch is N * this).
    shuffle / seed : per-epoch deterministic shuffle (identical on
        every rank — the shard partition depends on it).
    num_shards / shard_index : default from ``parallel.dist``: one shard
        per process, this process taking its rank's; overridable.
    decode_threads : decode-pool size (0/1 = decode inline).
    ordered : decode delivery mode (see DecodePool; unordered delivery
        is faster under skew but drops the resume guarantee).
    prefetch : device-prefetch queue depth (0 disables the prefetch
        thread entirely; 2 = double buffering).
    place : False -> host numpy batches; True (default) -> NDArrays on
        ``ctx``: on a GPU context through pinned staging and a side-stream
        copy (raises without a card), on a CPU context as host tensors;
        callable -> custom placement (returns the batch dict with
        ``data``/``label`` as torch tensors, or a ``prefetch.Placed``).
    ctx : the context ``place=True`` places on (default: the current
        context, ``gpu(0)``).
    autoscale : False (default) -> fixed decode_threads; True or a
        kwargs dict -> a :class:`~mxnet_tpu_torch.data.autoscale.\
DecodeAutoscaler` resizes the decode pool off the data-wait share of
        step time (hysteresis thresholds / bounds in the dict;
        ``MXNET_DATA_MAX_WORKERS`` caps growth), ticked once per
        delivered batch.

    Epoch geometry: every epoch delivers exactly
    ``batches_per_epoch = ceil(samples_per_shard / batch_size)``
    batches on every rank; the final batch wraps back to the head of
    this epoch's shard order (``DataBatch.pad`` counts the wrapped
    duplicates), so SPMD ranks never diverge in step count.
    """

    def __init__(self, dataset, decode_fn, batch_size, shuffle=True,
                 seed=0, num_shards=None, shard_index=None,
                 decode_threads=4, ordered=True, prefetch=2, place=True,
                 autoscale=False, ctx=None):
        from .sharding import resolve_shards

        if not isinstance(dataset, RecordDataset):
            dataset = RecordDataset(dataset)
        self.dataset = dataset
        self.decode_fn = decode_fn
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.num_shards, self.shard_index = resolve_shards(num_shards,
                                                           shard_index)
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError("shard_index %d out of range for %d shards"
                             % (self.shard_index, self.num_shards))
        self.decode_threads = int(decode_threads)
        self.ordered = bool(ordered)
        self.prefetch = int(prefetch)
        self.ctx = ctx if ctx is not None else current_context()
        if place is True:
            place = (PinnedStager(self.ctx, slots=max(1, self.prefetch) + 1)
                     if self.ctx.device_type == "gpu" else _host_place)
        self._place = place if callable(place) else None
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._autoscale = autoscale
        self._autoscaler = None
        self._pool = None
        self._prefetcher = None
        self._batches = None
        # Delivered-batch watermark, committed in ONE attribute store
        # (the TrainStep._ckpt_view discipline) so a preemption signal
        # handler snapshotting mid-next() sees a consistent position.
        self._ckpt_view = (0, 0)          # (epoch, delivered samples)
        # The batch most recently handed to the training loop — the
        # in-flight batch when a step hangs or a loss goes non-finite;
        # read by debug_state() for flight-recorder bundles.
        self._last_batch = None
        self._closed = False
        # Readiness slot for /readyz: claimed when the stages spin up,
        # flipped ready once the first batch reaches the training loop
        # ("pipeline primed"), released on close().
        self._hp_component = None
        self._hp_ready = False

    # -- geometry -------------------------------------------------------------

    @property
    def samples_per_shard(self):
        return num_padded(len(self.dataset), self.num_shards) \
            // self.num_shards

    @property
    def batches_per_epoch(self):
        return -(-self.samples_per_shard // self.batch_size)

    @property
    def samples_per_epoch(self):
        """Delivered samples per epoch (incl. batch-tail wrap pad)."""
        return self.batches_per_epoch * self.batch_size

    @property
    def epoch(self):
        return self._ckpt_view[0]

    @property
    def provide_data(self):
        return None     # shapes are decode_fn-defined; DataBatch carries them

    # -- the stages -----------------------------------------------------------

    def _epoch_positions(self, epoch, cursor):
        """(epoch, pos, sample_id) for ONE epoch from ``cursor``; pos
        runs over the padded epoch [0, samples_per_epoch) and wraps ids
        past samples_per_shard to the head of the order."""
        per = self.samples_per_shard
        order = shard_indices(len(self.dataset), self.num_shards,
                              self.shard_index, epoch=epoch,
                              seed=self.seed, shuffle=self.shuffle)
        for pos in range(cursor, self.samples_per_epoch):
            yield epoch, pos, int(order[pos % per])

    def _positions(self, epoch, cursor):
        """Infinite epoch-after-epoch position walk (ordered mode: the
        decode window streams straight across epoch boundaries)."""
        while True:
            yield from self._epoch_positions(epoch, cursor)
            epoch += 1
            cursor = 0

    def _decode_one(self, item):
        epoch, pos, sid = item
        t0 = time.perf_counter()
        record = self.dataset.read(sid)
        label, arr = self.decode_fn(record)
        t1 = time.perf_counter()
        _trace.complete("data::decode", t0, t1, sample=sid)
        _decode_seconds.observe(t1 - t0)
        return epoch, pos, sid, label, arr

    def _samples(self, epoch, cursor):
        """Decoded-sample stream in delivery order. Ordered mode
        streams one infinite position walk through the pool (the decode
        window overlaps epoch boundaries); unordered mode pools one
        epoch at a time so completion-order reordering can never leak a
        sample across an epoch boundary."""
        if self.decode_threads >= 2:
            self._pool = DecodePool(self._decode_one,
                                    num_threads=self.decode_threads,
                                    ordered=self.ordered)
            if self.ordered:
                yield from self._pool.run(self._positions(epoch, cursor))
                return
            while True:
                yield from self._pool.run(
                    self._epoch_positions(epoch, cursor))
                epoch += 1
                cursor = 0
        else:
            yield from map(self._decode_one,
                           self._positions(epoch, cursor))

    def _assemble(self, samples, epoch, cursor):
        """Group the decoded stream into host batch dicts. The
        watermark (epoch, end_pos) counts DELIVERED samples — identical
        to position order in ordered mode (the exact-replay resume
        contract). Under unordered delivery the delivered SET is not
        the first end_pos positions, so a resume is approximate: the
        re-walk covers the remaining count, but within the interrupted
        epoch up to one in-flight window of samples may repeat or be
        skipped — geometry validation pins ``ordered`` so the two modes
        can never silently exchange checkpoints."""
        per = self.samples_per_shard
        bs = self.batch_size
        padded = self.samples_per_epoch
        while True:
            chunk = []
            for sample in samples:
                chunk.append(sample)
                if len(chunk) == bs:
                    break
            if len(chunk) < bs:
                return
            if chunk[0][0] != epoch:     # first batch of the next epoch
                epoch, cursor = chunk[0][0], 0
            assert all(c[0] == epoch for c in chunk), \
                "batch spans epochs (padded epoch must be batch-aligned)"
            cursor += bs
            assert cursor <= padded
            yield {
                "epoch": epoch,
                "end_pos": cursor,
                "ids": np.array([c[2] for c in chunk], dtype=np.int64),
                "label": np.stack([c[3] for c in chunk]),
                "data": np.stack([c[4] for c in chunk]),
                "pad": max(0, min(bs, cursor - per)),
            }

    def _ensure_running(self):
        if self._closed:
            raise RuntimeError("DataPipeline is closed")
        if self._batches is not None:
            return
        if self._hp_component is None:
            self._hp_component = _hp.unique_component("data_pipeline")
        self._hp_ready = False
        _hp.set_ready(self._hp_component, False)
        epoch, cursor = self._ckpt_view
        batches = self._assemble(self._samples(epoch, cursor),
                                 epoch, cursor)
        if self.prefetch >= 1:
            self._prefetcher = DevicePrefetcher(batches,
                                                depth=self.prefetch,
                                                place=self._place)
            self._batches = self._prefetcher
        else:
            self._batches = ((self._place(b) if self._place else b)
                             for b in batches)

    def _teardown(self):
        """Stop all worker stages; the watermark survives so the next
        _ensure_running resumes exactly there."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        if self._pool is not None:
            self._pool.close()
            self._pool = None
        self._autoscaler = None     # the pool it resized is gone
        self._batches = None

    # -- iteration ------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_running()
        if self._prefetcher is None:
            # No prefetch thread: account the blocking pull as wait all
            # the same so the stall metric stays meaningful.
            from .prefetch import data_wait_seconds

            t0 = time.perf_counter()
            batch = deliver(next(self._batches))
            t1 = time.perf_counter()
            _trace.complete("data::wait", t0, t1)   # stall_fraction input
            data_wait_seconds.observe(t1 - t0)
        else:
            batch = next(self._batches)
        if self._place is None:
            # place=False contract: raw host numpy, zero device work.
            wrap = lambda a: a                        # noqa: E731
        else:
            wrap = (lambda a: a if isinstance(a, NDArray)      # noqa: E731
                    else NDArray(a))
        out = mxio.DataBatch(data=[wrap(batch["data"])],
                             label=[wrap(batch["label"])],
                             pad=batch["pad"], index=batch["ids"])
        # Commit the delivered watermark AFTER the batch exists — one
        # bytecode, signal-safe (see TrainStep._ckpt_view).
        end = batch["end_pos"]
        self._last_batch = {"epoch": batch["epoch"], "end_pos": end,
                            "ids": batch["ids"]}
        self._ckpt_view = ((batch["epoch"] + 1, 0)
                           if end >= self.samples_per_epoch
                           else (batch["epoch"], end))
        _samples_total.inc(self.batch_size)
        if not self._hp_ready:      # first delivered batch: primed
            self._hp_ready = True
            _hp.set_ready(self._hp_component)
        if self._autoscale and self._pool is not None:
            if self._autoscaler is None:
                from .autoscale import DecodeAutoscaler

                kwargs = self._autoscale \
                    if isinstance(self._autoscale, dict) else {}
                self._autoscaler = DecodeAutoscaler(self._pool, **kwargs)
            self._autoscaler.tick()
        return out

    next = __next__

    def reset(self):
        """Restart the CURRENT epoch from its beginning (DataIter
        protocol; checkpoint resume wants load_state_dict instead)."""
        self._teardown()
        self._ckpt_view = (self._ckpt_view[0], 0)

    def close(self):
        """Shut down worker stages (idempotent; context manager)."""
        self._teardown()
        self._closed = True
        if self._hp_component is not None:
            _hp.clear_ready(self._hp_component)
            self._hp_component = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._teardown()
        except Exception:
            pass

    # -- checkpoint -----------------------------------------------------------

    def state_dict(self):
        """The delivered-batch watermark plus the geometry that makes
        it meaningful. Everything is a small scalar/string — it rides
        inside any CheckpointManager.save state tree."""
        epoch, cursor = self._ckpt_view
        return {
            "kind": "data_pipeline",
            "epoch": epoch,
            "cursor": cursor,
            "seed": self.seed,
            "shuffle": int(self.shuffle),
            "num_shards": self.num_shards,
            "shard_index": self.shard_index,
            "batch_size": self.batch_size,
            "ordered": int(self.ordered),
            "fingerprint": repr(self.dataset.fingerprint()),
        }

    def debug_state(self):
        """Forensics view (flight-recorder bundles): the delivered-batch
        watermark plus the sample ids of the batch most recently handed
        to the training loop — the batch in flight when a step hangs or
        a loss goes non-finite, i.e. the one to replay."""
        last = self._last_batch
        return {
            "watermark": self.state_dict(),
            "last_batch": None if last is None else {
                "epoch": int(last["epoch"]),
                "end_pos": int(last["end_pos"]),
                "ids": [int(i) for i in last["ids"]],
            },
        }

    def load_state_dict(self, state):
        """Seek to a :meth:`state_dict` watermark. The pipeline's
        geometry (shards, seed, batch size, dataset) must match the
        checkpoint — a silent mismatch would replay the wrong sample
        sequence, so every field is validated loudly."""
        from .reader import validate_geometry

        expected = [("num_shards", self.num_shards),
                    ("shard_index", self.shard_index),
                    ("seed", self.seed),
                    ("shuffle", int(self.shuffle)),
                    ("batch_size", self.batch_size)]
        if "ordered" in state:
            expected.append(("ordered", int(self.ordered)))
        validate_geometry(state, expected, self.dataset, "pipeline",
                          kind="data_pipeline")
        epoch, cursor = int(state["epoch"]), int(state["cursor"])
        if cursor % self.batch_size or \
                not 0 <= cursor < self.samples_per_epoch:
            raise ValueError("invalid cursor %d (batch %d, epoch of %d)"
                             % (cursor, self.batch_size,
                                self.samples_per_epoch))
        self._teardown()
        self._ckpt_view = (epoch, cursor)
        self._closed = False


def stall_fraction(events=None):
    """Input-stall fraction of the training loop, derived from the
    trace spans the subsystems already emit: time spent blocked on data
    (``data::wait`` + ``train_step::data_put``) over total loop wall
    time (``data::wait`` + ``train_step::step``; the data_put span is
    inside the step span, so the denominator is not double-counted).
    Pass a chrome-trace event list (e.g.
    ``trace.chrome_trace()["traceEvents"]``) or None to read the live
    rings. Returns a float in [0, 1]; 0.0 when nothing is traced."""
    if events is None:
        events = _trace.chrome_trace()["traceEvents"]
    wait = put = step = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        name, dur = e.get("name"), float(e.get("dur", 0.0))
        if name == "data::wait":
            wait += dur
        elif name == "train_step::data_put":
            put += dur
        elif name == "train_step::step":
            step += dur
    denom = wait + step
    if denom <= 0.0:
        return 0.0
    return min(1.0, (wait + put) / denom)
