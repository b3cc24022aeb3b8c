"""KVStoreDist: the worker side of the multi-process ``dist_*`` kvstores.

Counterpart of ``mxnet_tpu/kvstore_dist.py`` (reference:
src/kvstore/kvstore_dist.h:44-450 — EncodeDefaultKey's big-array split
across servers, PushImpl's local reduce then ZPush, PullImpl, the
compressed push :334-366 — and python/mxnet/kvstore.py: rank,
num_workers, set_optimizer pickling the optimizer to the servers,
_barrier).

A worker reduces its own contexts first (``KVStoreLocal._merge``, on the
first value's device), then sends the merged value as host numpy to the
servers; ``dist_sync`` aggregates every worker's push per key before one
optimizer application on the server, ``dist_async`` updates per push,
and ``dist_device_sync`` is ``dist_sync`` whose local merge stays on the
card. Keys go to servers by crc32 of their repr; a dense key of at least
``MXNET_KVSTORE_BIGARRAY_BOUND`` elements is split contiguously across
every server. A value keeps its dtype across the wire: a float64 key
round-trips as float64.

``push``, ``pull``, ``pull_async`` (a :class:`~.kvstore.PullHandle` from
a puller thread), ``pushpull``, ``set_optimizer`` (the port's optimizer,
pickled), two-bit and one-bit gradient compression with per-subkey
error feedback, ``get_dead_nodes``, ``_barrier``,
``save_optimizer_states``/``load_optimizer_states`` and ``close`` are
the JAX package's. A row-sparse key (``init`` of a
``RowSparseNDArray``) lives whole on one server whatever its size;
a row-sparse push sends its row ids and values (``push_rsp``), which
the server scatter-adds, and ``row_sparse_pull`` fetches only the
requested rows (``pull_rows``).
"""
from __future__ import annotations

import atexit
import contextlib
import os
import pickle
import queue
import threading
import time
import zlib

import numpy as np

from .base import atomic_write
from .kvstore import KVStoreLocal, PullHandle, _key_list, _row_pulls, \
    _val_list, _write_rows
from .ndarray import sparse as _sparse
from .ndarray.ndarray import array as _nd_array
from .kvstore_server import _client
from .telemetry import trace as _trace
from .telemetry import xtrace as _xtrace

__all__ = ["KVStoreDist"]


def _server_of(key, num_servers):
    """Stable key→server assignment (reference EncodeDefaultKey hashes key
    ids across server ranges; crc32 is seed-independent across processes,
    unlike Python's hash)."""
    return zlib.crc32(repr(key).encode()) % num_servers


class KVStoreDist(KVStoreLocal):
    """Multi-process key-value store over parameter servers."""

    def __init__(self, name="dist_sync"):
        name = name.lower()
        assert name in ("dist", "dist_sync", "dist_device_sync", "dist_async")
        super().__init__(device_mode=(name == "dist_device_sync"))
        self._name = name
        self._sync = name != "dist_async"
        self._bigarray_bound = int(os.environ.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND", "1000000"))
        self._num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._num_servers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        self._meta = {}             # key -> (shape, dtype)
        self._compression = None
        self._closed = False

        # Per-SERVER comm locks (created once the addressbook arrives):
        # the request/reply framing is per-connection, so the Trainer's
        # overlap pipeline (pushes from its comm thread, pulls from the
        # async-pull thread) must never interleave messages on ONE
        # connection — but a push to server B has no business waiting
        # on a pull parked at server A. One RLock per server serializes
        # whole exchanges per connection while different servers
        # proceed concurrently; multi-server operations (sharded fetch)
        # take their locks in ascending server order. Reentrant:
        # push → _post → _drain_acks nests on the same server's lock.
        self._comm_locks = []
        self._pull_q = None
        self._pull_thread = None
        # Linearizes pull_async enqueues against close()'s shutdown
        # sentinel: a task is either ahead of the sentinel (processed)
        # or its handle is finished with an error — never parked
        # unfinished behind it.
        self._pull_lifecycle = threading.Lock()

        sched_addr = (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
                      int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")))
        self._sched = _client(sched_addr)
        self._sched_lock = threading.Lock()
        # A restarted worker rejoins under its old rank and skips the
        # startup rendezvous (reference ps::Postoffice::is_recovery,
        # kvstore_dist.h:52-55).
        recover = os.environ.get("DMLC_WORKER_RECOVERY")
        self._sched.send(("register", "worker", None,
                          int(recover) if recover else None))
        reply = self._sched.recv()
        assert reply[0] == "registered"
        self._rank = reply[1]
        book = self._sched.recv()
        assert book[0] == "addressbook"
        self._servers = [_client(addr) for addr in book[1]]
        self._comm_locks = [threading.RLock() for _ in self._servers]
        self._pending_acks = [0] * len(self._servers)
        for conn in self._servers:
            conn.send(("hello", self._sync, self._rank))
        atexit.register(self.close)
        self._start_heartbeat()

    def _start_heartbeat(self):
        """Periodic liveness pings to the scheduler (reference: ps-lite
        heartbeats feeding GetDeadNodes)."""
        import threading

        interval = float(os.environ.get("MXNET_TPU_PS_HEARTBEAT", "5"))

        def beat():
            import time as _t

            while not self._closed:
                _t.sleep(interval)
                if self._closed:
                    return
                try:
                    with self._sched_lock:
                        self._sched.send(("heartbeat",))
                except OSError:
                    return

        threading.Thread(target=beat, daemon=True).start()

    def get_dead_nodes(self, timeout=60):
        """Ranks considered dead: dropped connections or no heartbeat
        within `timeout` seconds (reference kvstore.h GetDeadNodes
        region, kvstore_dist.h:121-123)."""
        with self._sched_lock:
            self._sched.send(("dead_nodes", float(timeout)))
            # mxlint: disable=lock-blocking -- send+recv is one framed
            # exchange; the lock exists precisely so replies can't
            # interleave (ROADMAP "cancellable dist pulls" bounds this)
            reply = self._sched.recv()
        assert reply[0] == "dead_nodes"
        return reply[1]

    # -- identification -------------------------------------------------------

    @property
    def type(self):
        return self._name

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    # -- transport helpers ----------------------------------------------------

    # Push/init acks are pipelined: the server answers them inline and
    # in order, so the worker posts sends without waiting and collects
    # outstanding acks lazily — pushes overlap with compute and with
    # each other across servers (reference overlaps via engine-var async
    # ZPush, kvstore_dist.h:350-371). Value-bearing RPCs (pulls) stay
    # at most one outstanding per connection: sync-mode pulls can be
    # PARKED server-side mid-round and answered out of order, so they
    # must never share the wire with another outstanding value request.

    def _reconnect(self, server_idx):
        """Re-resolve a (possibly restarted) server's address via the
        scheduler and reconnect (reference: recovered nodes re-announce
        through the scheduler; peers reconnect on send failure). Any
        un-collected acks on the dead connection are unknowable — the
        caller retries its own operation; best-effort semantics match
        the reference's recovery story."""
        import time as _t

        deadline = _t.time() + float(os.environ.get(
            "MXNET_PS_RECONNECT_TIMEOUT", "120"))
        while True:
            # Re-query every attempt: the replacement server publishes a
            # NEW address only once it registers, which may lag the old
            # one's death.
            with self._sched_lock:
                self._sched.send(("servers",))
                # mxlint: disable=lock-blocking -- send+recv is one
                # framed exchange on the scheduler channel; interleaved
                # replies would misframe (see class docstring)
                reply = self._sched.recv()
            assert reply[0] == "servers"
            try:
                conn = _client(tuple(reply[1][server_idx]), retry_for=3.0)
                break
            except (ConnectionRefusedError, OSError):
                if _t.time() >= deadline:
                    raise
        self._servers[server_idx] = conn
        self._pending_acks[server_idx] = 0
        conn.send(("hello", self._sync, self._rank))

    # A long push-only phase must not let un-read acks pile up: past
    # this many outstanding on one connection the server's socket buffer
    # could fill with our unread replies, stalling its executor thread
    # (and with it every worker). 64 is far above any real pipelining
    # depth (keys in flight per server within one step).
    _MAX_PENDING_ACKS = 64

    def _post(self, server_idx, msg):
        """Fire-and-collect-later send; reply must be a plain ack."""
        with self._comm_locks[server_idx]:
            if self._pending_acks[server_idx] >= self._MAX_PENDING_ACKS:
                self._drain_acks(server_idx)
            try:
                self._servers[server_idx].send(msg)
            except (OSError, EOFError, BrokenPipeError):
                self._reconnect(server_idx)
                self._servers[server_idx].send(msg)
            self._pending_acks[server_idx] += 1

    def _drain_acks(self, server_idx=None):
        """Collect outstanding acks (surfacing any deferred errors).
        Each server drains under its OWN lock — a slow ack collection
        on one connection never parks traffic to the others."""
        idxs = [server_idx] if server_idx is not None \
            else range(len(self._servers))
        for i in idxs:
            with self._comm_locks[i]:
                conn = self._servers[i]
                while self._pending_acks[i]:
                    try:
                        # mxlint: disable=lock-blocking -- ack drain
                        # holds THIS server's comm lock so no other
                        # thread can send mid-drain and misframe this
                        # connection's stream; other servers' traffic
                        # proceeds under their own locks
                        reply = conn.recv()
                    except (OSError, EOFError):
                        # Server died with acks in flight; reconnect and
                        # move on — the retried ops re-post on the new
                        # connection.
                        self._reconnect(i)
                        break
                    self._pending_acks[i] -= 1
                    if reply[0] == "error":
                        raise RuntimeError("kvstore server %d: %s"
                                           % (i, reply[1]))

    def _call(self, server_idx, msg, ctx_out=None):
        """Blocking RPC for value-bearing requests; retries once through
        a reconnect if the server went away mid-exchange. ``ctx_out``
        (a list) collects the reply's trailing wire trace context, when
        the server sent one (pull replies carry the context of the sync
        round that produced the value)."""
        with self._comm_locks[server_idx]:
            self._drain_acks(server_idx)
            for attempt in (0, 1):
                conn = self._servers[server_idx]
                try:
                    conn.send(msg)
                    # mxlint: disable=lock-blocking -- the value RPC's
                    # send+recv must be one atomic exchange (replies
                    # carry no request ids); ROADMAP "cancellable dist
                    # pulls" tracks bounding a dead-peer park here
                    reply = conn.recv()
                    break
                except (OSError, EOFError, BrokenPipeError):
                    if attempt:
                        raise
                    self._reconnect(server_idx)
            if reply[0] == "error":
                raise RuntimeError("kvstore server %d: %s"
                                   % (server_idx, reply[1]))
            if ctx_out is not None and len(reply) > 2:
                ctx_out.append(reply[2])
            return reply[1] if len(reply) > 1 else None

    def _shards(self, key, shape, stype="default"):
        """Yield (server_idx, subkey, flat_slice) shards for a key.

        Dense arrays of ``size >= MXNET_KVSTORE_BIGARRAY_BOUND`` are
        sliced contiguously across *all* servers (reference kvstore_dist.h
        EncodeDefaultKey); smaller keys live whole on one hashed server.
        A row-sparse key is never sliced, whatever its size: the server
        needs whole rows to scatter-add and to answer ``pull_rows``.
        """
        size = int(np.prod(shape)) if shape else 1
        if (stype == "row_sparse" or size < self._bigarray_bound
                or self._num_servers == 1):
            return [(_server_of(key, self._num_servers), key, None)]
        bounds = np.linspace(0, size, self._num_servers + 1).astype(np.int64)
        return [(i, (key, i), slice(int(bounds[i]), int(bounds[i + 1])))
                for i in range(self._num_servers)
                if bounds[i + 1] > bounds[i]]

    # -- core API -------------------------------------------------------------

    def contains(self, key):
        return key in self._meta

    def discard(self, key):
        """Drop a key worker-side (`_meta`) AND server-side (rank 0
        sends `delete` per shard) — the Trainer retires a generation of
        coalesced gradient buckets through this when the param-set
        signature drifts; without the server delete each drift would
        leak a bucket-sized value per server for process lifetime."""
        meta = self._meta.pop(key, None)
        if meta is None:
            return
        shape, _, stype = meta
        shards = self._shards(key, shape, stype)
        if self._compression is not None:
            # Error-feedback residuals are WORKER-local, one per shard
            # subkey — every rank must drop its own or each retired
            # generation leaks bucket-sized float buffers here too.
            for _, subkey, _ in shards:
                self._compression._residual.pop(subkey, None)
        if self._rank == 0:
            for sidx, subkey, _ in shards:
                self._call(sidx, ("delete", subkey, _xtrace.inject()))
        self._barrier()

    def init(self, key, value):
        """Rank 0 seeds the servers; everyone records shape metadata and a
        barrier makes the value visible before any worker proceeds
        (reference: only rank 0's init reaches servers, kvstore.py:init)."""
        keys, single = _key_list(key)
        vals = _val_list(value, len(keys), single)
        for k, vlist in zip(keys, vals):
            v = vlist[0]
            arr = v.asnumpy()       # a row-sparse value densifies
            stype = v.stype
            self._meta[k] = (arr.shape, arr.dtype, stype)
            if self._rank == 0:
                flat = arr.reshape(-1)
                for sidx, subkey, sl in self._shards(k, arr.shape, stype):
                    part = arr if sl is None else flat[sl]
                    self._call(sidx, ("init", subkey, part,
                                      _xtrace.inject()))
        self._barrier()

    def push(self, key, value, priority=0):
        keys, single = _key_list(key)
        vals = _val_list(value, len(keys), single)
        for k, vlist in zip(keys, vals):
            assert k in self._meta, "key %r was not initialized" % (k,)
            if isinstance(vlist[0], _sparse.RowSparseNDArray):
                self._push_row_sparse(k, vlist)
                continue
            # Local reduce first, on the first value's device (host copy
            # only for the single merged value) — reference comm_->Reduce.
            merged = self._merge(vlist)
            arr = merged.asnumpy()
            flat = arr.reshape(-1)
            for sidx, subkey, sl in self._shards(k, arr.shape,
                                                 self._meta[k][2]):
                part = arr if sl is None else flat[sl]
                if self._compression is not None:
                    packed, meta = self._compression.compress(subkey, part)
                    self._post(sidx, ("push_compressed", subkey,
                                      packed.cpu().numpy(), meta,
                                      _xtrace.inject()))
                else:
                    self._post(sidx, ("push", subkey, part,
                                      _xtrace.inject()))

    def _push_row_sparse(self, k, vlist):
        """Send the row ids and values of every local row-sparse value,
        concatenated: the server scatter-adds them, so duplicates sum,
        as the reference's row-sparse reduce does."""
        idx = np.concatenate([v.indices.asnumpy().astype(np.int64)
                              for v in vlist])
        val = np.concatenate([v.data.asnumpy() for v in vlist])
        sidx, subkey, _ = self._shards(k, self._meta[k][0], "row_sparse")[0]
        self._post(sidx, ("push_rsp", subkey, idx, val, _xtrace.inject()))

    def _fetch(self, k):
        shape, dtype, stype = self._meta[k]
        shards = self._shards(k, shape, stype)
        t0 = time.perf_counter()
        ctx_out = []
        if len(shards) == 1 and shards[0][2] is None:
            value = np.asarray(self._call(
                shards[0][0], ("pull", shards[0][1], _xtrace.inject()),
                ctx_out=ctx_out)).reshape(shape)
        else:
            # Multi-server fetch: hold every involved server's lock for
            # the whole issue-all-then-collect exchange. Ascending
            # server order is the fixed acquisition order repo-wide —
            # any two threads taking multiple comm locks take them in
            # the same sequence, so sharded fetches never deadlock
            # against each other or against single-server RPCs.
            with contextlib.ExitStack() as stack:
                for sidx in sorted({s[0] for s in shards}):
                    stack.enter_context(self._comm_locks[sidx])
                value = self._fetch_sharded(k, shape, dtype, shards,
                                            ctx_out)
        self._pull_span(k, t0, ctx_out)
        return value

    def _pull_span(self, k, t0, ctx_out):
        """Record the pull as a trace slice. A reply carrying a FOREIGN
        sampled round context (the peer whose push the server folded
        first) is stamped as ``link_trace_id`` so trace_merge joins
        this slice into that trace's cross-rank flow."""
        args = {"key": str(k)}
        rctx = next((c for c in map(_xtrace.extract, ctx_out)
                     if c is not None), None)
        own = _xtrace.current()
        if rctx is not None and rctx.sampled and \
                (own is None or own.trace_id != rctx.trace_id):
            args["link_trace_id"] = rctx.trace_id
        _trace.complete("kvstore::pull", t0, time.perf_counter(), **args)

    def _fetch_sharded(self, k, shape, dtype, shards, ctx_out=None):
        # Big-array shards live one-per-server (contiguous slicing across
        # all servers): issue every shard pull first, then collect — the
        # servers serve and transfer concurrently instead of one
        # round-trip at a time.
        assert len({s[0] for s in shards}) == len(shards), \
            "sharding invariant broken: multiple shards on one server"
        issued = []
        for sidx, subkey, sl in shards:
            self._drain_acks(sidx)
            try:
                self._servers[sidx].send(("pull", subkey,
                                          _xtrace.inject()))
                issued.append((sidx, subkey, sl, True))
            except (OSError, EOFError, BrokenPipeError):
                issued.append((sidx, subkey, sl, False))
        out = np.empty(int(np.prod(shape)), dtype=dtype)
        retry = []
        errors = []
        # Consume EVERY in-flight reply before surfacing any error: an
        # early raise would leave the other connections' pull replies
        # unconsumed and permanently desync their request/reply framing.
        for sidx, subkey, sl, sent in issued:
            if sent:
                try:
                    reply = self._servers[sidx].recv()
                except (OSError, EOFError):
                    retry.append((sidx, subkey, sl))
                    continue
                if reply[0] == "error":
                    errors.append((sidx, reply[1]))
                else:
                    out[sl] = reply[1]
                    if ctx_out is not None and len(reply) > 2:
                        ctx_out.append(reply[2])
            else:
                retry.append((sidx, subkey, sl))
        if errors:
            raise RuntimeError("; ".join(
                "kvstore server %d: %s" % (s, e) for s, e in errors))
        for sidx, subkey, sl in retry:
            # dead server: _call reconnects via the scheduler and retries
            out[sl] = self._call(sidx, ("pull", subkey, _xtrace.inject()),
                                 ctx_out=ctx_out)
        return out.reshape(shape)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        assert out is not None, "pull requires out="
        keys, single = _key_list(key)
        outs = _val_list(out, len(keys), single)
        for k, olist in zip(keys, outs):
            value = self._fetch(k)
            for o in olist:
                o[:] = value

    def _ensure_pull_thread(self):
        if self._pull_thread is None:
            self._pull_q = queue.Queue()

            def loop():
                while True:
                    task = self._pull_q.get()
                    if task is None:
                        # Shutdown: nothing can be enqueued past the
                        # sentinel (pull_lifecycle lock), but drain
                        # defensively so no handle ever hangs.
                        while True:
                            try:
                                handle = self._pull_q.get_nowait()[0]
                            except queue.Empty:
                                return
                            handle._finish(
                                RuntimeError("kvstore is closed"))
                    handle, args, ctx = task
                    t0 = time.perf_counter()
                    try:
                        # The submitter's trace context rides the task:
                        # the wire pull this thread performs belongs to
                        # the step that asked for it, not the thread.
                        with _xtrace.activate(ctx):
                            self.pull(*args)
                    except BaseException as exc:   # noqa: BLE001 relayed
                        handle._finish(exc, time.perf_counter() - t0)
                        continue
                    handle._finish(None, time.perf_counter() - t0)

            self._pull_thread = threading.Thread(
                target=loop, name="mx-kvstore-pull", daemon=True)
            self._pull_thread.start()

    def pull_async(self, key, out=None, priority=0, ignore_sparse=True):
        """Real async pull: the wire round-trip (which a sync-mode
        server may PARK until every worker pushed the key) runs on a
        dedicated puller thread, so the CALLER is free — the Trainer's
        main thread keeps unflattening/dispatching fused applies while
        the pull is in flight. Cross-SERVER wire overlap is real: comm
        locks are per server, so this pull proceeds while pushes target
        other servers. On any ONE connection the lock still serializes
        whole exchanges — replies carry no request ids, so framing
        safety requires it."""
        handle = PullHandle()
        with self._pull_lifecycle:
            if self._closed:
                # The puller loop exited (or will, at the sentinel):
                # complete the handle with an error now instead of
                # letting a waiter hang on an unprocessed task.
                handle._finish(RuntimeError("kvstore is closed"))
                return handle
            self._ensure_pull_thread()
            self._pull_q.put((handle, (key, out, priority,
                                       ignore_sparse),
                              _xtrace.current()))
        return handle

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows over the wire (reference
        PullRowSparse, kvstore.h:209); `out` as in
        :meth:`KVStoreLocal.row_sparse_pull`."""
        for k, o, r in _row_pulls(key, out, row_ids):
            shape, _, stype = self._meta[k]
            sidx, subkey, _ = self._shards(k, shape, stype)[0]
            r_np = r.asnumpy().astype(np.int64)
            vals = self._call(
                sidx, ("pull_rows", subkey, r_np, _xtrace.inject()))
            _write_rows(o, _nd_array(vals, ctx=o.context, dtype=o.dtype),
                        _nd_array(r_np, ctx=o.context, dtype="int64"), shape)

    # -- optimizer / compression ----------------------------------------------

    def set_optimizer(self, optimizer):
        """Pickle the optimizer to every server (reference kvstore.py:
        set_optimizer → _send_command_to_servers(0, optstr) from rank 0).
        `param_dict` holds live Parameter objects and does not cross the
        wire — per-param lr/wd multipliers don't survive serialization,
        the same caveat the reference's optstr path has."""
        self._optimizer = optimizer
        if self._rank == 0:
            param_dict = optimizer.param_dict
            optimizer.param_dict = {}
            try:
                blob = pickle.dumps(optimizer)
            finally:
                optimizer.param_dict = param_dict
            for sidx in range(len(self._servers)):
                self._call(sidx, ("set_optimizer", blob, _xtrace.inject()))
        self._barrier()

    def server_profiler_command(self, sub, arg=None):
        """Drive every server's profiler over the command channel
        (reference KVStoreServerProfilerCommand,
        kvstore_dist_server.h:211-217). Returns the per-server replies
        — for ``"dumps"`` that is each server's aggregate span table."""
        return [self._call(s, ("profiler", sub, arg, _xtrace.inject()))
                for s in range(len(self._servers))]

    def server_stats(self):
        """Each server's cumulative update work: ``[{"apply_seconds":
        s, "applies": n}, ...]``, one dict per server."""
        return [self._call(s, ("stats", _xtrace.inject()))
                for s in range(len(self._servers))]

    # -- pod telemetry channel (telemetry.aggregate rides this) ---------------
    # Same transport discipline as server_profiler_command: a command on
    # the existing worker->server wire. Snapshots all land on server 0
    # (they are KB-scale; key-sharding them would buy nothing), stamped
    # with the SERVER's receive time so rank-0 staleness ages never
    # depend on worker clock agreement.

    def telemetry_push(self, blob):
        """Publish this rank's serialized telemetry snapshot
        (pipelined ack — rides the push fast path, no round-trip)."""
        self._post(0, ("telemetry_push", self._rank, blob, _xtrace.inject()))

    def telemetry_pull(self):
        """Fetch every rank's last snapshot: ``{rank: (age_seconds,
        blob)}`` with ages measured on the server's clock."""
        return self._call(0, ("telemetry_pull", _xtrace.inject()))

    # -- pod forensics channel (telemetry.healthplane rides this) -------------
    # Flight-recorder bundles and pod-snapshot requests cross the same
    # worker->server wire: bundles are pushed fire-and-forget (they are
    # tens of KB and already committed locally — losing one to a dying
    # server loses nothing a local disk doesn't still hold), pulls and
    # request operations are blocking RPCs.

    def diag_push(self, name, blob):
        """Publish one committed diagnostic bundle (file name + bytes)
        for rank 0 to collect (pipelined ack, push fast path)."""
        self._post(0, ("diag_push", self._rank, name, blob,
                          _xtrace.inject()))

    def diag_pull(self):
        """Drain every rank's pushed bundles:
        ``{rank: [(name, blob), ...]}`` — each bundle hands off exactly
        once (rank 0's collector commits them to its directory)."""
        return self._call(0, ("diag_pull", _xtrace.inject()))

    def diag_request(self, kind, msg=""):
        """Post a pod-snapshot request (rank 0's fan-out trigger);
        returns the new request sequence number every rank's collector
        will observe."""
        return self._call(0, ("diag_request", kind, msg, _xtrace.inject()))

    def diag_request_check(self):
        """Read the current pod-snapshot request slot:
        ``(seq, kind, msg)`` (seq 0 = never requested)."""
        return self._call(0, ("diag_request_check", _xtrace.inject()))

    # -- pod compile-cache channel (compile.distribute rides this) ------------
    # Persistent-compile-cache entries cross the same worker->server
    # wire (server 0, the telemetry/diag convention): rank 0 publishes
    # executables it compiled fire-and-forget; a rank that misses
    # locally probes + pulls instead of compiling. Entries are NOT
    # drained on pull — they serve every later elastic joiner — and the
    # server bounds its buffer by total bytes, dropping oldest.

    def cc_push(self, key, meta, blob):
        """Publish one compile-cache entry (pipelined ack, push fast
        path)."""
        self._post(0, ("cc_push", key, meta, blob,
                          _xtrace.inject()))

    def cc_probe(self, keys=None):
        """Which of ``keys`` the pod rendezvous currently holds;
        ``None`` enumerates EVERY held key (one round-trip for a
        joiner's whole-store prefetch)."""
        return self._call(0, ("cc_probe",
                              None if keys is None else list(keys),
                              _xtrace.inject()))

    def cc_pull(self, key):
        """Fetch one entry: ``(meta, blob)`` or None."""
        return self._call(0, ("cc_pull", key, _xtrace.inject()))

    def set_gradient_compression(self, compression_params):
        from .gradient_compression import GradientCompression

        self._compression_params = dict(compression_params)
        self._compression = GradientCompression(compression_params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Gather per-server updater states (the optimizer state lives on
        the servers in dist mode — reference kvstore.py notes exactly
        this for update_on_kvstore)."""
        blobs = [self._call(s, ("get_states", _xtrace.inject()))
                 for s in range(len(self._servers))]
        # Durable artifact (resume loads it): commit atomically so a
        # crash mid-dump can't leave a torn pickle that unpickles as
        # garbage at restore.
        with atomic_write(fname) as f:
            f.write(pickle.dumps(blobs))

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            blobs = pickle.load(f)
        if self._rank == 0:
            for sidx, blob in enumerate(blobs):
                if blob:
                    self._call(sidx, ("set_states", blob, _xtrace.inject()))
        self._barrier()

    # -- coordination ---------------------------------------------------------

    def _barrier(self):
        """Block until all workers arrive (reference kvstore.py:_barrier →
        MXKVStoreBarrier over the ps-lite scheduler). Holds the scheduler
        channel for the duration — heartbeats pause, which is fine: the
        scheduler counts the barrier message itself as liveness."""
        # In-flight pushes must be PROCESSED before we report arrival:
        # a peer may pull right after the barrier.
        self._drain_acks()
        with self._sched_lock:
            self._sched.send(("barrier",))
            # mxlint: disable=lock-blocking -- a barrier blocks by
            # definition; holding the sched channel for the duration is
            # the documented design (heartbeats pause, the barrier
            # message itself counts as liveness)
            reply = self._sched.recv()
        if reply[0] != "barrier_done":
            raise RuntimeError(
                "kvstore barrier failed (a worker died or timed out): %r"
                % (reply,))

    barrier = _barrier

    def close(self):
        if self._closed:
            return
        with self._pull_lifecycle:
            self._closed = True
            if self._pull_q is not None:
                self._pull_q.put(None)
        if self._pull_thread is not None and \
                self._pull_thread is not threading.current_thread():
            # The puller has touched torch: let it finish before the
            # interpreter tears down (a daemon thread still unwinding
            # at exit aborts the process: "terminate called without an
            # active exception").
            self._pull_thread.join(timeout=60)
        try:
            # surface any deferred push errors before tearing down
            self._drain_acks()
        except (OSError, EOFError, RuntimeError):
            pass
        try:
            with self._sched_lock:
                self._sched.send(("finalize",))
                self._sched.close()
        except OSError:
            pass
        for conn in self._servers:
            try:
                conn.close()
            except OSError:
                pass
