"""CheckpointManager — fault-tolerant async checkpointing with atomic
commit.

Counterpart of ``mxnet_tpu/checkpoint/manager.py``. The reference's
durability story (model.py:save_checkpoint → one blocking ``nd.save``)
has two production gaps on preemptible fleets: a crash mid-save can
leave a truncated-but-loadable ``.params``, and every save stalls the
training step for the full serialize+write. This manager closes both:

* **Atomic commit.** A checkpoint is a *directory* ``step-<N>/`` holding
  one raw shard file per writing process plus a ``manifest.json``
  (step, per-array shapes/dtypes/offsets/CRC32s). Everything is first
  written into a ``tmp.*`` staging directory and fsynced; the commit is
  a single ``os.rename`` of the staging dir onto the final name. A kill
  at ANY byte of the save leaves either the previous commit or a
  ``tmp.*`` orphan that ``restore()`` ignores and GC sweeps.
* **Async saves.** ``save(step, state)`` copies every leaf to host
  memory at the step boundary (the only synchronous cost), then a
  background writer thread serializes, commits, and runs retention GC
  off the critical path. ``save(..., sync=True)`` keeps the whole write
  on the calling thread (preemption hooks, tests).
* **Corruption-proof restore.** ``restore()`` walks committed steps
  newest-first, verifying manifest integrity and per-chunk length +
  CRC32; a corrupt or torn checkpoint is skipped with a warning and the
  next older commit is returned. Transient IO errors during writes are
  retried with bounded exponential backoff.
* **Sharded saves.** A state leaf may be a :class:`Shard` — the locally
  held chunks of a globally sharded array. Each process writes only its
  own shard file; process 0 stitches the per-process part-manifests
  into the final manifest and performs the commit rename.

What differs from the JAX package, and why:

* Leaves may be torch tensors and the port's NDArrays. Both are
  mutable — the next step rewrites them in place — so ``save`` copies
  every one of them (and every numpy leaf) before it returns, and the
  writer never holds an alias. A CUDA leaf is copied into pinned host
  memory (torch's caching host allocator) with ``non_blocking`` copies
  and one synchronization per save; a CUDA tensor is never read through
  ``np.asarray``.
* bfloat16 is written and read as raw 16-bit words: a ``uint16`` view
  on the host, the dtype name ``bfloat16`` in the manifest and 2-byte
  payloads, which is what the JAX package writes through ``ml_dtypes``.
  The port has no ``ml_dtypes``; a restored bfloat16 leaf comes back as
  a CPU ``torch.bfloat16`` tensor (every other array leaf as numpy).
* ``process_index``/``process_count`` default from ``parallel.dist``
  when a group is formed, else 0/1, as in the JAX package. A tensor-
  parallel ``TrainStep.state_dict(sharded=True)`` gives each rank's
  block of a split array as a :class:`Shard` chunk, from the ranks that
  hold its first replica only; the others give ``chunks=[]``, and
  process 0 stitches the manifest from whichever processes wrote.

The format is the JAX package's: the ``manifest.json`` keys, ``_FORMAT``
(the string names the format, not the package), the shard file names
and ``sort_keys`` JSON. A directory committed by either package
restores in the other.

Telemetry rides the port's ``telemetry`` registry: counters
``checkpoint::save_seconds``, ``checkpoint::bytes`` (cumulative) and
``checkpoint::pending`` (gauge) show up in ``profiler.dumps()`` and in
``telemetry.render_prometheus()``; snapshot/write/commit phases emit
``checkpoint::*`` trace spans (suppressed in signal-handler mode).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..telemetry import trace as _trace
from ..telemetry import watchdog as _watchdog

__all__ = ["CheckpointManager", "Shard", "CheckpointNotFoundError",
           "CheckpointCorruptError"]

_FORMAT = "mxnet_tpu.checkpoint/1"
_STEP_PREFIX = "step-"
_TMP_PREFIX = "tmp."
_BF16 = "bfloat16"

log = logging.getLogger(__name__)


class CheckpointNotFoundError(FileNotFoundError):
    """No fully committed, uncorrupted checkpoint exists."""


class CheckpointCorruptError(ValueError):
    """A committed checkpoint failed integrity verification."""


# -- fault-injection seams ----------------------------------------------------
# All checkpoint writes/commits go through these module-level hooks so a
# test can fail the first N writes or truncate a file without touching
# real filesystem syscalls elsewhere in the process.

def _open_for_write(path):
    return open(path, "wb")


def _rename(src, dst):
    os.rename(src, dst)


def _fsync_dir(path):
    # Durability of the rename itself; not available on some platforms.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- host copies --------------------------------------------------------------

def _dtype_label(dtype):
    """The manifest's name of a numpy/torch dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return _BF16 if dtype == torch.bfloat16 else \
            str(torch.empty((), dtype=dtype).numpy().dtype)
    if isinstance(dtype, str) and dtype == _BF16:
        return _BF16
    return str(np.dtype(dtype))


def _host_of_cpu_tensor(t):
    """A numpy copy of a CPU tensor; bfloat16 as its uint16 words."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(
            np.uint16).copy(), _BF16
    return t.numpy().copy(), str(t.numpy().dtype)


class _Staging:
    """Device-to-host copies of one snapshot: each CUDA tensor lands in a
    pinned buffer with a ``non_blocking`` copy; :meth:`finish` waits
    once for all of them. The pinned tensors stay referenced by the
    numpy arrays viewing them, so the caching host allocator reuses a
    block only after the writer has dropped the snapshot."""

    def __init__(self):
        self.devices = set()

    def array(self, t):
        t = t.detach()
        if not t.is_cuda:
            return _host_of_cpu_tensor(t)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self.devices.add(t.device)
        if t.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.uint16), _BF16
        return host.numpy(), str(host.numpy().dtype)

    def finish(self):
        for dev in self.devices:
            torch.cuda.current_stream(dev).synchronize()


def _array_of(value, staging):
    """(host numpy, manifest dtype name) of an array-like leaf, always a
    copy."""
    if isinstance(value, torch.Tensor):
        return staging.array(value)
    data = getattr(value, "_data", None)
    if isinstance(data, torch.Tensor):             # the port's NDArray
        return staging.array(data)
    if isinstance(value, np.ndarray):
        # A live host buffer the caller may keep mutating: the writer
        # must serialize THIS step's bytes, and the CRC is computed at
        # write time from the same object.
        return value.copy(), str(value.dtype)
    arr = np.array(value)
    return arr, str(arr.dtype)


class Shard:
    """The locally held pieces of a globally sharded array.

    ``chunks`` is a list of ``(index, data)`` where ``index`` is a tuple
    of ``(start, stop)`` per dimension into the global array and
    ``data`` is the value of that slice (numpy, torch tensor or NDArray;
    copied here). ``dtype`` is a numpy or torch dtype or the name
    ``"bfloat16"``. A process that holds nothing of the array passes
    ``chunks=[]``; the manifest is stitched from whichever processes do
    hold pieces.
    """

    def __init__(self, shape, dtype, chunks):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = _dtype_label(dtype)
        self.chunks = []
        staging = _Staging()
        for index, data in chunks:
            index = tuple((int(a), int(b)) for a, b in index)
            # Copy (not just make contiguous): the writer serializes
            # asynchronously, and a view of a caller-mutated array would
            # commit torn bytes with a matching CRC.
            data, _ = _array_of(data, staging)
            expect = tuple(b - a for a, b in index)
            if tuple(data.shape) != expect:
                raise ValueError(
                    "Shard chunk shape %s does not match index %s"
                    % (data.shape, index))
            self.chunks.append((index, data))
        staging.finish()

    def __repr__(self):
        return "Shard(shape=%s, dtype=%s, chunks=%d)" % (
            self.shape, self.dtype, len(self.chunks))


def _flatten(state, prefix="", out=None):
    """Nested dict -> flat {'a/b/c': leaf}. Keys must be '/'-free strs."""
    if out is None:
        out = {}
    for key, value in state.items():
        if not isinstance(key, str) or "/" in key:
            raise ValueError(
                "checkpoint state keys must be '/'-free strings, got %r"
                % (key,))
        full = prefix + key
        if isinstance(value, dict):
            _flatten(value, full + "/", out)
        else:
            out[full] = value
    return out


def _unflatten(flat):
    out = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _to_host(value, staging):
    """Snapshot one leaf to (host numpy | Shard, kind, dtype name). Runs
    on the caller's thread at the step boundary — the only synchronous
    cost of an async save."""
    if isinstance(value, Shard):
        return value, "array", value.dtype
    if isinstance(value, (bytes, bytearray)):
        return np.frombuffer(bytes(value), np.uint8).copy(), "bytes", \
            "uint8"
    if isinstance(value, str):
        return np.frombuffer(value.encode("utf-8"), np.uint8).copy(), \
            "str", "uint8"
    if isinstance(value, (bool, np.bool_)):
        return np.asarray(bool(value)), "bool", "bool"
    if isinstance(value, (int, np.integer)):
        return np.asarray(int(value), np.int64), "int", "int64"
    if isinstance(value, (float, np.floating)):
        return np.asarray(float(value), np.float64), "float", "float64"
    arr, dtype = _array_of(value, staging)
    return arr, "array", dtype


def _snapshot(state):
    """{flat key: (host value, kind, dtype name)} of a nested state,
    every device copy complete."""
    staging = _Staging()
    snap = {k: _to_host(v, staging) for k, v in _flatten(state).items()}
    staging.finish()
    return snap


def _from_host(arr, kind):
    if kind == "array":
        return arr
    if kind == "bytes":
        return arr.tobytes()
    if kind == "str":
        return arr.tobytes().decode("utf-8")
    if kind == "bool":
        return bool(arr)
    if kind == "int":
        return int(arr)
    if kind == "float":
        return float(arr)
    raise CheckpointCorruptError("unknown leaf kind %r" % (kind,))


def _dtype(name):
    """The numpy dtype a manifest entry is read in (bfloat16: its uint16
    words)."""
    if name == _BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError:
        # A damaged manifest must read as corrupt (restore falls back to
        # an older commit), not crash the restore walk.
        raise CheckpointCorruptError("unknown dtype %r" % (name,))


def _restored(arr, name):
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


# -- the manager --------------------------------------------------------------

class CheckpointManager:
    """Directory-of-steps checkpoint store with async atomic commits.

    Parameters
    ----------
    directory : str — root; each commit is ``<directory>/step-<N>/``.
    keep_last : int — retention: newest N commits survive GC (0/None
        disables GC entirely).
    keep_every : int or None — additionally keep every commit whose step
        is a multiple of K (archival ladder).
    max_retries : int — transient-IO retry budget per save (exponential
        backoff, base ``retry_backoff`` seconds).
    process_index / process_count : the writer's identity among the
        processes of one save (default: ``parallel.dist``'s rank and
        size when a group is formed, else 0/1; only process 0 stitches
        manifests, commits, and GCs).
    stitch_timeout : float — how long process 0 waits for the other
        processes' part-manifests before declaring the save failed.
    max_pending : int — bound on queued async snapshots (each holds a
        full host copy of the state). When the writer falls behind the
        save cadence, the OLDEST queued snapshot is dropped (latest
        wins) instead of growing host memory without bound.
    fsync : 'commit' (default) | 'full' | 'none' — durability of each
        commit. 'commit' fsyncs only the small manifest + directory so
        the commit marker itself is power-loss durable, while a power
        cut that tears the bulk shard data is caught by restore()'s CRC
        check and falls back to the previous commit. 'full' additionally
        fsyncs shard data; 'none' skips all fsyncs.
    """

    def __init__(self, directory, keep_last=3, keep_every=None,
                 max_retries=3, retry_backoff=0.05,
                 process_index=None, process_count=None,
                 stitch_timeout=60.0, fsync="commit", max_pending=2):
        if process_index is None or process_count is None:
            from ..parallel import dist

            if dist.is_initialized():
                if process_index is None:
                    process_index = dist.rank()
                if process_count is None:
                    process_count = dist.num_processes()
        self.process_index = int(process_index or 0)
        self.process_count = int(process_count or 1)
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.stitch_timeout = float(stitch_timeout)
        if fsync not in ("none", "commit", "full"):
            raise ValueError("fsync must be 'none', 'commit' or 'full', "
                             "got %r" % (fsync,))
        self.fsync = fsync
        self.max_pending = int(max_pending)
        self.dropped_saves = 0
        self.last_error = None
        self.total_bytes = 0
        self.total_save_seconds = 0.0

        self._fs_lock = threading.RLock()
        self._queue = queue.Queue()
        self._thread = None
        self._pending = 0
        # Per-manager watchdog lane (a lane is a single slot; two
        # managers sharing "checkpoint" would mask each other's hangs).
        self._wd_lane = _watchdog.unique_lane("checkpoint")
        self._pending_lock = threading.Lock()
        self._closed = False

        # Counters are process-global telemetry shared by every manager:
        # never pass an initial value here — that would zero cumulative
        # history (and corrupt the pending gauge) each time a second
        # manager is constructed.
        from .. import profiler

        domain = profiler.Domain("checkpoint")
        self._c_seconds = domain.new_counter("save_seconds")
        self._c_bytes = domain.new_counter("bytes")
        self._c_pending = domain.new_counter("pending")
        self._quiet = False     # signal-handler mode: skip lock-taking
        #                         telemetry (see PreemptionHook)

    # -- paths ----------------------------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self.directory, "%s%08d" % (_STEP_PREFIX, step))

    def _tmp_dir(self, step):
        # Multi-process saves share one deterministic staging dir; a
        # single process suffixes its pid so an orphan from a previous
        # incarnation can never collide with a live write.
        if self.process_count > 1:
            return os.path.join(self.directory,
                                "%sstep-%08d" % (_TMP_PREFIX, step))
        return os.path.join(self.directory, "%sstep-%08d.%d"
                            % (_TMP_PREFIX, step, os.getpid()))

    def _shard_name(self, index):
        return "shard-%05d-of-%05d.bin" % (index, self.process_count)

    def _part_name(self, index):
        return "manifest-part-%05d.json" % index

    # -- public API -----------------------------------------------------------

    @property
    def pending(self):
        """Number of queued-or-in-flight async saves."""
        with self._pending_lock:
            return self._pending

    def save(self, step, state, sync=False):
        """Checkpoint `state` (a nested dict of arrays, tensors,
        NDArrays, Shards and small scalars) as `step`. Every leaf is
        copied to host memory NOW; serialization + commit happen on the
        writer thread unless ``sync=True``. Returns immediately in async
        mode."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        step = int(step)
        with self._span("checkpoint::snapshot", step=step):
            snap = _snapshot(state)
        if sync:
            self._write_with_retry(step, snap)
            return
        self._ensure_thread()
        # Backpressure: each queued item is a full host snapshot. If the
        # writer is slower than the save cadence, drop the oldest queued
        # snapshot (the newest state is the one worth keeping) rather
        # than growing host memory one checkpoint per step.
        # Single-process only: a multi-process save is collective, and a
        # process dropping a step its peers kept would stall process 0's
        # stitch for the full timeout.
        while self.max_pending and self.process_count == 1 and \
                self._queue.qsize() >= self.max_pending:
            try:
                dropped_step, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            self._queue.task_done()
            with self._pending_lock:
                self._pending -= 1
            self._bump(self._c_pending, -1)
            self.dropped_saves += 1
            log.warning("checkpoint writer backlogged; dropping queued "
                        "save for step %d (latest wins)", dropped_step)
        with self._pending_lock:
            self._pending += 1
        self._bump(self._c_pending, 1)
        self._queue.put((step, snap))

    def wait(self):
        """Block until every queued async save has committed (or failed;
        see `last_error`)."""
        self._queue.join()

    def drain(self, timeout=None, poll=0.01):
        """Lock-free wait for queued saves: polls the queue's unfinished
        counter without acquiring its mutex, so it is safe from a signal
        handler that may have interrupted a frame holding that mutex
        (queue.join() is not). Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._queue.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)
        return True

    def close(self):
        """Flush pending saves and stop the writer thread."""
        if self._closed:
            return
        self.wait()
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None
        # Release this manager's watchdog lane (see __init__).
        _watchdog.reset(self._wd_lane)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def all_steps(self):
        """Sorted steps with a committed, manifest-bearing directory."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return steps
        for name in names:
            if not name.startswith(_STEP_PREFIX):
                continue
            try:
                step = int(name[len(_STEP_PREFIX):])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(self.directory, name,
                                           "manifest.json")):
                steps.append(step)
        return sorted(steps)

    def latest_step(self):
        """Newest committed step, or None. Commit-level check only; a
        checksum-corrupt commit is detected (and skipped) by restore."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step=None):
        """Return ``(step, state)`` for the newest fully-committed,
        integrity-verified checkpoint (or exactly `step` if given).
        Incomplete or corrupt checkpoints are skipped newest-first;
        raises CheckpointNotFoundError when nothing restorable exists."""
        if step is not None:
            return int(step), self._load(int(step))
        for s in reversed(self.all_steps()):
            try:
                return s, self._load(s)
            except (CheckpointCorruptError, OSError, ValueError,
                    KeyError) as exc:
                log.warning("checkpoint step %d unreadable (%s); trying "
                            "older", s, exc)
        raise CheckpointNotFoundError(
            "no restorable checkpoint under %r" % self.directory)

    # -- writer ---------------------------------------------------------------

    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            name="ckpt-writer", daemon=True)
            self._thread.start()

    def _worker(self):
        # Deprioritize the writer: serialization/CRC/IO should fill idle
        # host cycles, not steal cores from the dispatching thread or the
        # input pipeline (thread-level nice is a Linux-ism; elsewhere
        # this is a no-op and the thread runs at normal priority).
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (AttributeError, OSError):
            pass
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, snap = item
            # Watchdog lane: a commit stuck on dead storage is a
            # `checkpoint_hang`.
            _watchdog.begin(self._wd_lane)
            try:
                self._write_with_retry(step, snap)
            except Exception as exc:  # keep the trainer alive
                self.last_error = exc
                self._warn("async checkpoint save for step %d failed: %s"
                           % (step, exc))
            finally:
                _watchdog.end(self._wd_lane)
                del snap, item      # release the host copy before waiting
                with self._pending_lock:
                    self._pending -= 1
                self._bump(self._c_pending, -1)
                self._queue.task_done()

    def _cleanup_failed(self, step):
        """Undo this process's contribution to a failed write. With
        multiple processes the staging dir is shared — removing the
        whole tree would destroy peers' already-written shards."""
        tmp = self._tmp_dir(step)
        if self.process_count == 1:
            shutil.rmtree(tmp, ignore_errors=True)
            return
        for name in (self._shard_name(self.process_index),
                     self._part_name(self.process_index),
                     self._part_name(self.process_index) + ".wip",
                     "manifest.json"):
            try:
                os.remove(os.path.join(tmp, name))
            except OSError:
                pass

    def _write_with_retry(self, step, snap):
        delay = self.retry_backoff
        for attempt in range(self.max_retries + 1):
            try:
                self._write_once(step, snap)
                return
            except OSError as exc:
                self._cleanup_failed(step)
                if attempt == self.max_retries:
                    self.last_error = exc
                    raise
                self._warn("checkpoint write for step %d failed (%s); "
                           "retry %d/%d in %.2fs" % (step, exc, attempt + 1,
                                                     self.max_retries, delay))
                time.sleep(delay)
                delay *= 2

    def _span(self, name, **args):
        """Trace span, skipped in signal-handler (_quiet) mode — a
        ring's first-use registration takes a lock the interrupted frame
        could hold."""
        if self._quiet:
            return contextlib.nullcontext()
        return _trace.span(name, **args)

    def _write_once(self, step, snap):
        with self._fs_lock, \
                self._span("checkpoint::write", step=step):
            t0 = time.perf_counter()
            final = self._step_dir(step)
            replace_torn = False
            if os.path.isfile(os.path.join(final, "manifest.json")):
                # Same step already committed (e.g. a preempt save raced
                # an async one) — skip only if that commit looks intact
                # (manifest + sizes, no full read: this runs inside the
                # preemption grace window). Bit-rot within a correct
                # length is still caught by restore()'s per-chunk CRC.
                if self._commit_intact(step):
                    return
                replace_torn = True
            tmp = self._tmp_dir(step)
            os.makedirs(tmp, exist_ok=True)
            written = self._write_shard(tmp, snap)
            if self.process_index != 0:
                # Non-primary processes contribute their shard + part
                # manifest; process 0 owns stitch/commit/GC.
                self._account(t0, written)
                return
            entries = self._stitch_parts(tmp, step)
            manifest = {"format": _FORMAT, "step": step,
                        "process_count": self.process_count,
                        "shards": [self._shard_name(i)
                                   for i in range(self.process_count)],
                        "arrays": entries}
            blob = json.dumps(manifest, sort_keys=True).encode("utf-8")
            f = _open_for_write(os.path.join(tmp, "manifest.json"))
            try:
                f.write(blob)
                if self.fsync != "none":
                    f.flush()
                    os.fsync(f.fileno())
            finally:
                f.close()
            if replace_torn:
                # The fresh replacement is fully staged; only now drop
                # the broken commit.
                shutil.rmtree(final, ignore_errors=True)
            with self._span("checkpoint::commit", step=step):
                try:
                    _rename(tmp, final)
                except OSError:
                    if os.path.isfile(os.path.join(final,
                                                   "manifest.json")):
                        # lost a race
                        shutil.rmtree(tmp, ignore_errors=True)
                    else:
                        raise
                if self.fsync != "none":
                    _fsync_dir(self.directory)
            self._account(t0, written + len(blob))
            self._gc()

    def _write_shard(self, tmp, snap):
        """This process's raw chunk file + part manifest. Replicated
        (non-Shard) leaves are written by process 0 only; Shard leaves
        contribute whatever chunks this process holds."""
        entries = {}
        offset = 0
        nbytes_total = 0
        shard_path = os.path.join(tmp, self._shard_name(self.process_index))
        f = _open_for_write(shard_path)
        try:
            for key in sorted(snap):
                value, kind, dtype = snap[key]
                if isinstance(value, Shard):
                    chunks = list(value.chunks)
                    shape = value.shape
                elif self.process_index == 0:
                    chunks = [(None, value)]
                    shape = value.shape
                else:
                    continue
                entry = {"shape": list(shape), "dtype": dtype,
                         "kind": kind, "chunks": []}
                for index, data in chunks:
                    # Zero-copy write: a flat byte view of the host
                    # snapshot, not a tobytes() duplicate.
                    raw = memoryview(np.ascontiguousarray(data)).cast("B")
                    f.write(raw)
                    entry["chunks"].append({
                        "shard": self.process_index, "offset": offset,
                        "nbytes": len(raw), "crc32": zlib.crc32(raw),
                        "index": None if index is None
                        else [list(p) for p in index]})
                    offset += len(raw)
                    nbytes_total += len(raw)
                if entry["chunks"] or isinstance(value, Shard):
                    entries[key] = entry
            if self.fsync == "full":
                f.flush()
                os.fsync(f.fileno())
        finally:
            f.close()
        part = json.dumps({"arrays": entries},
                          sort_keys=True).encode("utf-8")
        # Publish the part manifest atomically (write + rename): process
        # 0 polls for these by name, and must never observe a part file
        # that exists but has no bytes yet.
        part_path = os.path.join(tmp, self._part_name(self.process_index))
        pf = _open_for_write(part_path + ".wip")
        try:
            pf.write(part)
            if self.fsync != "none":
                pf.flush()
                os.fsync(pf.fileno())
        finally:
            pf.close()
        _rename(part_path + ".wip", part_path)
        return nbytes_total

    def _stitch_parts(self, tmp, step):
        """Process 0: merge every process's part manifest (waiting up to
        stitch_timeout for stragglers) into one arrays table."""
        deadline = time.monotonic() + self.stitch_timeout
        paths = [os.path.join(tmp, self._part_name(i))
                 for i in range(self.process_count)]
        while True:
            missing = [p for p in paths if not os.path.isfile(p)]
            if not missing:
                break
            if time.monotonic() > deadline:
                raise OSError(
                    "step %d: timed out waiting for checkpoint shards %s"
                    % (step, [os.path.basename(p) for p in missing]))
            time.sleep(0.01)
        merged = {}
        for path in paths:
            try:
                with open(path, "rb") as f:
                    part = json.loads(f.read().decode("utf-8"))
            except (OSError, ValueError) as exc:
                # Parts are rename-published so this should not happen;
                # surface it as a retryable IO failure either way.
                raise OSError("step %d: unreadable checkpoint part %s "
                              "(%s)" % (step, os.path.basename(path), exc))
            for key, entry in part["arrays"].items():
                if key in merged:
                    merged[key]["chunks"].extend(entry["chunks"])
                else:
                    merged[key] = entry
        for key, entry in merged.items():
            if not entry["chunks"]:
                raise OSError("step %d: no process wrote any chunk of %r"
                              % (step, key))
        return merged

    def _bump(self, counter, delta):
        """Best-effort counter update that NEVER blocks: the registry
        child's lock may be held by the very frame a preemption signal
        interrupted. Under contention (or _quiet) the telemetry tick is
        dropped — the authoritative totals live on the manager."""
        if self._quiet:
            return
        counter._child.inc_try(delta)

    def _warn(self, msg):
        """log.warning, except in signal-handler (_quiet) mode where the
        logging lock may be held by the interrupted frame — there the
        message goes straight to fd 2, which takes no locks."""
        if self._quiet:
            try:
                os.write(2, (msg + "\n").encode())
            except OSError:
                pass
        else:
            log.warning("%s", msg)

    def _account(self, t0, nbytes):
        dt = time.perf_counter() - t0
        self.total_bytes += nbytes
        self.total_save_seconds += dt
        self._bump(self._c_bytes, nbytes)
        self._bump(self._c_seconds, dt)

    def _gc(self):
        """Retention: newest keep_last + every keep_every-th step; sweep
        everything else, plus staging orphans older than the newest
        commit (a crashed writer's leavings)."""
        if not self.keep_last or self.process_index != 0:
            return
        steps = self.all_steps()
        keep = set(steps[-int(self.keep_last):])
        if self.keep_every:
            keep.update(s for s in steps if s % int(self.keep_every) == 0)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        latest = steps[-1] if steps else None
        if latest is None:
            return
        for name in os.listdir(self.directory):
            if not name.startswith(_TMP_PREFIX + "step-"):
                continue
            try:
                s = int(name[len(_TMP_PREFIX) + 5:].split(".")[0])
            except ValueError:
                continue
            if s <= latest:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _commit_intact(self, step):
        """Cheap structural check of a committed step: manifest parses
        and every shard file covers the extents the manifest claims."""
        root = self._step_dir(step)
        try:
            with open(os.path.join(root, "manifest.json"), "rb") as f:
                manifest = json.loads(f.read().decode("utf-8"))
            if manifest.get("format") != _FORMAT:
                return False
            need = {}
            for entry in manifest["arrays"].values():
                _dtype(entry["dtype"])
                for chunk in entry["chunks"]:
                    end = chunk["offset"] + chunk["nbytes"]
                    sid = chunk["shard"]
                    need[sid] = max(need.get(sid, 0), end)
            for sid, end in need.items():
                path = os.path.join(root, manifest["shards"][sid])
                if os.path.getsize(path) < end:
                    return False
            return True
        except Exception:
            return False

    # -- reader ---------------------------------------------------------------

    def _load(self, step):
        root = self._step_dir(step)
        mpath = os.path.join(root, "manifest.json")
        if not os.path.isfile(mpath):
            raise CheckpointNotFoundError(
                "step %d has no committed manifest" % step)
        try:
            with open(mpath, "rb") as f:
                manifest = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError) as exc:
            raise CheckpointCorruptError(
                "step %d: unreadable manifest (%s)" % (step, exc))
        if manifest.get("format") != _FORMAT:
            raise CheckpointCorruptError(
                "step %d: unknown manifest format %r"
                % (step, manifest.get("format")))
        shards = manifest["shards"]
        handles = {}
        try:
            flat = {}
            for key, entry in manifest["arrays"].items():
                arr = self._read_entry(root, shards, handles, step, key,
                                       entry)
                flat[key] = _from_host(_restored(arr, entry["dtype"]),
                                       entry["kind"])
        finally:
            for h in handles.values():
                h.close()
        return _unflatten(flat)

    def _read_entry(self, root, shards, handles, step, key, entry):
        dtype = _dtype(entry["dtype"])
        shape = tuple(entry["shape"])
        out = np.empty(shape, dtype)
        filled = 0
        for chunk in entry["chunks"]:
            sid = chunk["shard"]
            if sid not in handles:
                path = os.path.join(root, shards[sid])
                try:
                    handles[sid] = open(path, "rb")
                except OSError as exc:
                    raise CheckpointCorruptError(
                        "step %d: missing shard %s (%s)"
                        % (step, shards[sid], exc))
            f = handles[sid]
            f.seek(chunk["offset"])
            raw = f.read(chunk["nbytes"])
            if len(raw) != chunk["nbytes"]:
                raise CheckpointCorruptError(
                    "step %d: %r truncated in %s (%d of %d bytes)"
                    % (step, key, shards[sid], len(raw), chunk["nbytes"]))
            if zlib.crc32(raw) != chunk["crc32"]:
                raise CheckpointCorruptError(
                    "step %d: %r checksum mismatch in %s"
                    % (step, key, shards[sid]))
            index = chunk["index"]
            if index is None:
                out = np.frombuffer(raw, dtype).reshape(shape).copy()
                filled = int(np.prod(shape, dtype=np.int64))
            else:
                sl = tuple(slice(a, b) for a, b in index)
                piece = np.frombuffer(raw, dtype).reshape(
                    tuple(b - a for a, b in index))
                out[sl] = piece
                filled += piece.size
        if filled < int(np.prod(shape, dtype=np.int64)):
            raise CheckpointCorruptError(
                "step %d: %r chunks cover %d of %d elements"
                % (step, key, filled,
                   int(np.prod(shape, dtype=np.int64))))
        return out
