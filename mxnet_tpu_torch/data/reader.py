"""Sharded streaming reader over RecordIO files.

Counterpart of ``mxnet_tpu/data/reader.py``: ``RecordDataset``,
``ShardedRecordStream`` and ``validate_geometry``, unchanged.

The storage half of the input pipeline (reference: the chunked RecordIO
scanner inside iter_image_recordio_2.cc): one or many ``.rec`` files
presented as a single flat, random-access sample space, plus a stream
that walks a rank's deterministic shard of each epoch.

``RecordDataset`` builds the global record index once (``.idx`` sidecar
when present, else the native C++ scanner, else a pure-python frame
scan) and serves stateless ``read(i)`` calls that are safe from any
thread — the decode pool reads records concurrently with no shared file
cursor. ``ShardedRecordStream`` layers the per-rank, per-epoch order
from :mod:`.sharding` on top and carries the checkpointable cursor
(epoch, position, seed) that makes resume replay the exact remaining
sample sequence.
"""
from __future__ import annotations

import bisect
import os
import struct
import threading

import numpy as np

from ..recordio import (_kMagic, _decode_lrec, native_reads_enabled,
                        read_logical_record)

__all__ = ["RecordDataset", "ShardedRecordStream", "validate_geometry"]


def validate_geometry(state, expected, dataset, what, kind=None):
    """Shared resume-safety validation for checkpointed cursors: the
    state's ``kind`` tag, every ``(key, live value)`` pair, and the
    dataset fingerprint must all match — a silent mismatch would replay
    the wrong sample sequence (stream and pipeline cursors don't even
    share units), so everything fails loudly."""
    if kind is not None and state.get("kind", kind) != kind:
        raise ValueError(
            "%s cannot restore a %r checkpoint (want kind=%r) — the "
            "cursors of different pipeline stages are not interchangeable"
            % (what, state.get("kind"), kind))
    for key, have in expected:
        got = int(state[key])
        if got != int(have):
            raise ValueError(
                "%s %s mismatch: checkpoint has %s, %s has %s"
                % (what, key, got, what, have))
    fp = state.get("fingerprint")
    if fp is not None and str(fp) != repr(dataset.fingerprint()):
        raise ValueError(
            "dataset changed since checkpoint (%s vs %s) — resume "
            "would replay wrong sample ids"
            % (fp, repr(dataset.fingerprint())))


def _python_index(path):
    """Byte offsets of every logical record — pure-python fallback scan
    (same framing walk as src/recordio_core.cc's rio_index)."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        start = None
        while pos + 8 <= size:
            magic, lrec = struct.unpack("<II", f.read(8))
            if magic != _kMagic:
                raise IOError("Invalid RecordIO magic in %s @%d"
                              % (path, pos))
            cflag, length = _decode_lrec(lrec)
            if cflag in (0, 1):           # whole record or first chunk
                start = pos
            if cflag in (0, 3) and start is not None:
                offsets.append(start)
                start = None
            pad = (4 - length % 4) % 4
            pos += 8 + length + pad
            f.seek(pos)
    return offsets


def _read_at(f, offset, uri="<stream>"):
    """One logical record at ``offset`` — the python read path behind
    RecordDataset.read (frame walk shared with recordio.MXRecordIO)."""
    f.seek(offset)
    record = read_logical_record(f, uri)
    if record is None:
        raise IOError("Truncated record in %s @%d" % (uri, offset))
    return record


class RecordDataset:
    """One or many ``.rec(+.idx)`` files as a flat random-access sample
    space: ``len()`` records, ``read(i) -> bytes``.

    ``idx_paths`` defaults to each rec's ``.idx`` sibling when it
    exists. Reads are stateless and thread-safe: the native core opens
    per-call, the python path keeps one handle per (thread, file).

    A ``tools/rec_shard.py`` manifest opens directly: pass its
    ``...-manifest.json`` path (alone) and the shard set it describes
    becomes the sample space, with each shard's record count verified
    against the manifest (a re-packed shard fails loudly instead of
    silently serving a different sample space). See
    :meth:`from_manifest` for the explicit spelling.
    """

    def __init__(self, rec_paths, idx_paths=None, manifest_counts=None):
        if isinstance(rec_paths, (str, os.PathLike)):
            rec_paths = [rec_paths]
        rec_paths = [os.fspath(p) for p in rec_paths]
        if len(rec_paths) == 1 and rec_paths[0].endswith(".json"):
            if idx_paths is not None:
                raise ValueError(
                    "a manifest already names its shards' .idx files — "
                    "don't pass idx_paths with a manifest")
            rec_paths, idx_paths, manifest_counts = \
                self._resolve_manifest(rec_paths[0])
        self.rec_paths = rec_paths
        if not self.rec_paths:
            raise ValueError("no .rec files given")
        if idx_paths is None:
            idx_paths = [os.path.splitext(p)[0] + ".idx"
                         for p in self.rec_paths]
        elif isinstance(idx_paths, (str, os.PathLike)):
            idx_paths = [idx_paths]
        if len(idx_paths) != len(self.rec_paths):
            # zip() would silently truncate — dropping .rec files from
            # the sample space is a data-loss bug, not a default.
            raise ValueError(
                "idx_paths (%d) must match rec_paths (%d) one-to-one"
                % (len(idx_paths), len(self.rec_paths)))
        self._offsets = []                # per file, record byte offsets
        for rec, idx in zip(self.rec_paths, idx_paths):
            self._offsets.append(self._index_one(rec, idx))
        counts = [len(o) for o in self._offsets]
        if manifest_counts is not None:
            # Manifest fingerprint check: the shard set on disk must BE
            # the split the manifest describes — per-shard record
            # counts are the cheap invariant a re-pack cannot preserve
            # by accident.
            for rec, have, want in zip(self.rec_paths, counts,
                                       manifest_counts):
                if have != int(want):
                    raise ValueError(
                        "manifest mismatch for %s: indexed %d records, "
                        "manifest says %d — the shard set changed since "
                        "the split (re-run tools/rec_shard.py)"
                        % (rec, have, want))
        self._cum = np.cumsum([0] + counts).tolist()
        self._tls = threading.local()
        if len(self) == 0:
            raise ValueError("no records in %s" % self.rec_paths)

    @classmethod
    def from_manifest(cls, manifest_path):
        """Open the shard set a ``tools/rec_shard.py`` manifest
        describes (paths resolved relative to the manifest file) with
        per-shard record counts verified."""
        return cls([os.fspath(manifest_path)])

    @staticmethod
    def _resolve_manifest(manifest_path):
        """(rec_paths, idx_paths, counts) from a rec_shard manifest."""
        import json

        with open(manifest_path) as f:
            manifest = json.load(f)
        shards = manifest.get("shards")
        if not isinstance(shards, list) or not shards:
            raise ValueError(
                "%s is not a rec_shard manifest (no 'shards' list)"
                % manifest_path)
        base = os.path.dirname(os.path.abspath(manifest_path))
        recs, idxs, counts = [], [], []
        for shard in shards:
            recs.append(os.path.join(base, shard["rec"]))
            idxs.append(os.path.join(base, shard["idx"])
                        if shard.get("idx") else None)
            counts.append(int(shard["records"]))
        return recs, idxs, counts

    @staticmethod
    def _index_one(rec, idx):
        if idx and os.path.exists(idx):
            offsets = []
            with open(idx) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        offsets.append(int(line.split("\t")[1]))
            # idx files list insertion order == file order for the
            # writers in this tree, but sort anyway: the global sample
            # id must be stable regardless of key order.
            offsets = sorted(offsets)
            RecordDataset._check_idx_covers(rec, offsets)
            return offsets
        if native_reads_enabled():   # env hatch first; probe cached
            from .. import recordio_native

            return recordio_native.native_index(rec)
        return _python_index(rec)

    @staticmethod
    def _check_idx_covers(rec, offsets):
        """Reject a stale/truncated ``.idx`` sidecar: a writer killed
        mid-pack flushes the .rec further than its buffered index, and
        silently serving only the indexed prefix would shrink the
        sample space (and bake the wrong count into fingerprint(), so
        resume validation could never catch it)."""
        size = os.path.getsize(rec)
        if not offsets:
            if size:
                raise IOError("empty .idx for non-empty %s" % rec)
            return
        with open(rec, "rb") as f:
            f.seek(offsets[-1])
            if read_logical_record(f, rec) is None:
                raise IOError(
                    "stale .idx for %s: offset %d points past the data"
                    % (rec, offsets[-1]))
            end = f.tell()
        if end != size:
            raise IOError(
                "stale/truncated .idx for %s: records continue past the "
                "last indexed one (%d != %d bytes) — rebuild with "
                "tools/rec2idx.py" % (rec, end, size))

    def __len__(self):
        return self._cum[-1]

    @property
    def num_records(self):
        return self._cum[-1]

    def fingerprint(self):
        """Identity of the sample space for checkpoint validation:
        (basename, record count, file bytes) per file. Byte size makes
        a re-packed same-name same-count file (different shuffle or
        content) fail loudly instead of silently replaying wrong
        samples."""
        return [[os.path.basename(p), len(o), os.path.getsize(p)]
                for p, o in zip(self.rec_paths, self._offsets)]

    def locate(self, i):
        """Global sample id -> (rec_path, byte offset)."""
        n = len(self)
        if not 0 <= i < n:
            raise IndexError("record %d out of range (%d records)" % (i, n))
        k = bisect.bisect_right(self._cum, i) - 1
        return self.rec_paths[k], self._offsets[k][i - self._cum[k]]

    def _handle(self, path):
        handles = getattr(self._tls, "handles", None)
        if handles is None:
            handles = self._tls.handles = {}
        f = handles.get(path)
        if f is None or f.closed:
            f = handles[path] = open(path, "rb")
        return f

    # Explicit test override: None = defer to the shared recordio gate
    # (which re-reads the MXNET_USE_NATIVE_RECORDIO hatch per call).
    _native_ok = None

    def _native_reads(self):
        if RecordDataset._native_ok is not None:
            return RecordDataset._native_ok
        return native_reads_enabled()

    def read(self, i):
        """Record ``i`` as bytes. Stateless; callable from any thread
        concurrently (the decode pool's contract)."""
        path, offset = self.locate(i)
        if self._native_reads():
            from .. import recordio_native

            data, _ = recordio_native.native_read_at(path, offset)
            return data
        return _read_at(self._handle(path), offset, path)


class ShardedRecordStream:
    """This rank's deterministic walk of the dataset, epoch after epoch.

    ``next_raw()`` yields ``(epoch, sample_id, bytes)`` forever — epoch
    boundaries advance internally, recomputing the per-epoch shard order
    from ``(seed, epoch)`` via :func:`sharding.shard_indices`. Shards
    are equal-size wrap-tail (see that module), so every rank's stream
    has identical length per epoch and SPMD ranks never diverge in step
    count.

    The cursor (``epoch``, ``cursor``) is the checkpointable state;
    ``state_dict``/``load_state_dict`` round-trip it along with the
    shard geometry and a dataset fingerprint so resume replays the
    exact remaining sequence or fails loudly on a mismatched dataset.
    """

    def __init__(self, dataset, num_shards=None, shard_index=None,
                 seed=0, shuffle=True, epoch=0):
        from .sharding import resolve_shards

        self.dataset = dataset
        self.num_shards, self.shard_index = resolve_shards(num_shards,
                                                           shard_index)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.epoch = int(epoch)
        self.cursor = 0                  # next position within the shard
        self._order = None               # lazy per-epoch shard order

    @property
    def samples_per_shard(self):
        from .sharding import num_padded

        return num_padded(len(self.dataset), self.num_shards) \
            // self.num_shards

    def _epoch_order(self):
        if self._order is None:
            from .sharding import shard_indices

            self._order = shard_indices(
                len(self.dataset), self.num_shards, self.shard_index,
                epoch=self.epoch, seed=self.seed, shuffle=self.shuffle)
        return self._order

    def peek_id(self, ahead=0):
        """Sample id ``ahead`` positions past the cursor without
        advancing — epoch boundaries are honored, so a peek past the
        end of this shard's epoch reads the NEXT epoch's (reshuffled)
        order, exactly what next_raw will deliver."""
        from .sharding import shard_indices

        per = self.samples_per_shard
        pos = self.cursor + ahead
        epoch = self.epoch + pos // per
        if epoch == self.epoch:
            return int(self._epoch_order()[pos])
        order = shard_indices(len(self.dataset), self.num_shards,
                              self.shard_index, epoch=epoch,
                              seed=self.seed, shuffle=self.shuffle)
        return int(order[pos % per])

    def next_raw(self):
        """Advance: returns ``(epoch, sample_id, record bytes)``."""
        order = self._epoch_order()
        sid = int(order[self.cursor])
        epoch = self.epoch
        self.cursor += 1
        if self.cursor >= len(order):
            self.epoch += 1
            self.cursor = 0
            self._order = None
        return epoch, sid, self.dataset.read(sid)

    def seek(self, epoch, cursor):
        """Jump to an absolute (epoch, in-shard position)."""
        per = self.samples_per_shard
        if not 0 <= cursor < per:
            raise ValueError("cursor %d out of range (shard size %d)"
                             % (cursor, per))
        self.epoch = int(epoch)
        self.cursor = int(cursor)
        self._order = None

    def state_dict(self):
        return {"kind": "record_stream",
                "epoch": self.epoch,
                "cursor": self.cursor,
                "seed": self.seed,
                "shuffle": int(self.shuffle),
                "num_shards": self.num_shards,
                "shard_index": self.shard_index,
                "fingerprint": repr(self.dataset.fingerprint())}

    def load_state_dict(self, state):
        validate_geometry(state,
                          (("num_shards", self.num_shards),
                           ("shard_index", self.shard_index),
                           ("seed", self.seed),
                           ("shuffle", int(self.shuffle))),
                          self.dataset, "stream", kind="record_stream")
        self.seek(int(state["epoch"]), int(state["cursor"]))
