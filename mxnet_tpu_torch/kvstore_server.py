"""KVStore server and scheduler roles: the parameter-server side of the
``dist_*`` kvstores.

Counterpart of ``mxnet_tpu/kvstore_server.py`` (reference:
src/kvstore/kvstore_dist_server.h:155-400 — sync-mode aggregation,
optimizer-on-server ``ApplyUpdates`` :325-348, pull responses deferred
until the sync round's update lands, the command channel for
set_optimizer — python/mxnet/kvstore_server.py, whose
``_init_kvstore_server_module`` makes ``import mxnet`` in a
``DMLC_ROLE=server``/``scheduler`` process run the server loop and never
return, and ps-lite's scheduler rendezvous: registration, address book,
barriers, heartbeats).

Kept from the JAX package: the wire (length-prefixed pickled messages
over ``multiprocessing.connection``), the single executor thread with
the pulls parked mid sync-round and answered after the update, sync and
async semantics, restart recovery from per-key snapshots, heartbeats and
the barrier, and the blob channels (telemetry, diag, compile cache).

The import-lock note, which the design depends on: ps-lite receives
requests on I/O threads but executes every handler on the server's one
executor thread (kvstore_dist_server.h:188 ``exec_``). Here one reader
thread per connection only enqueues; the main thread, the only one that
runs optimizer math, drains the queue. That is what makes running
inside ``import mxnet_tpu_torch`` safe: the main thread still holds the
package's import lock, and it is the only thread that triggers lazy
imports (module locks are reentrant for their owner; any other thread
importing from the package would deadlock against the import that never
finishes).

The port's server applies the optimizer with the port's
``optimizer``/``Updater`` on CPU tensors (``ctx=cpu()``): a server or
scheduler process never initialises CUDA
(``torch.cuda.is_initialized()`` stays False there). A pushed value
keeps its dtype on the wire and in the stored value, so a float64 key
stays float64. A row-sparse push (``push_rsp``: row ids and their
values) is scatter-added into a zero gradient of the stored shape, so
duplicate ids sum, in the pushed dtype. The
remote profiler commands drive this process's ``profiler``, which in a
server or scheduler traces the CPU only and so never initialises CUDA.

Roles and env contract (set by ``parallel/launch.py``):

- ``DMLC_ROLE``: ``worker`` / ``server`` / ``scheduler``
- ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``: scheduler address
- ``DMLC_NUM_WORKER`` / ``DMLC_NUM_SERVER``: group sizes
"""
from __future__ import annotations

import os
import pickle
import queue
import sys
import threading
import time

import numpy as np

from .base import atomic_write

__all__ = ["KVStoreServer", "Scheduler", "_init_kvstore_server_module"]

_AUTHKEY = os.environ.get("MXNET_TPU_PS_AUTHKEY", "mxnet_tpu_kvstore").encode()
_WAIT_TIMEOUT = float(os.environ.get("MXNET_TPU_PS_TIMEOUT", "300"))
_DEBUG = bool(int(os.environ.get("MXNET_KVSTORE_DEBUG", "0")))


def _dbg(*args):
    """Verbose PS tracing (reference MXNET_ENGINE_INFO-style env knob)."""
    if _DEBUG:
        print("[kvstore %s/%d]" % (os.environ.get("DMLC_ROLE", "?"),
                                   os.getpid()), *args,
              file=sys.stderr, flush=True)


def _listener(host, port=0):
    from multiprocessing.connection import Listener

    # backlog must cover the whole node group connecting at once (ps-lite's
    # Van listens with a deep backlog for the same reason).
    return Listener((host, port), family="AF_INET", backlog=128,
                    authkey=_AUTHKEY)


def _client(addr, retry_for=30.0):
    """Connect with retry — roles race at startup (workers/servers may dial
    the scheduler before its socket is up, like ps-lite's connect loop)."""
    from multiprocessing.connection import Client

    deadline = time.time() + retry_for
    while True:
        try:
            return Client(tuple(addr), family="AF_INET", authkey=_AUTHKEY)
        except (ConnectionRefusedError, OSError):
            if time.time() >= deadline:
                raise
            time.sleep(0.1)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Rendezvous + barrier service (ps-lite scheduler role).

    Every node (server or worker) connects once and keeps the connection:
    servers receive the final ``shutdown`` over it; workers use it for
    ``barrier`` rounds. Ranks are assigned in registration order (the
    reference's ps-lite assigns node ids on Van registration the same
    way). Scheduler threads touch only stdlib state — no package imports.
    """

    def __init__(self, num_workers, num_servers, host=None, port=None):
        self.num_workers = num_workers
        self.num_servers = num_servers
        host = host or os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(port if port is not None
                   else os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
        self._listener = _listener(host, port)
        self._lock = threading.Lock()
        self._servers = {}          # server_id -> (host, port)
        self._next_worker = 0
        self._next_server = 0
        self._all_registered = threading.Event()
        self._barrier = threading.Barrier(num_workers) if num_workers else None
        self._finalized = 0
        self._done = threading.Event()
        # Liveness (reference: ps-lite heartbeats -> GetDeadNodes,
        # kvstore_dist.h:121-123): last-contact time per worker rank,
        # plus ranks whose connection dropped without finalize.
        self._last_seen = {}
        self._dead = set()
        self._gone = False          # a worker finalized or dropped

    def run(self):
        """Serve until every worker has finalized, then shut servers down.
        The accept loop keeps running after rendezvous so restarted
        workers can re-register (reference is_recovery rejoin,
        kvstore_dist.h:52-55)."""
        def accept_loop():
            while not self._done.is_set():
                try:
                    conn = self._listener.accept()
                except OSError:
                    return
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=accept_loop, daemon=True).start()
        self._done.wait(_WAIT_TIMEOUT * 4)
        self._listener.close()

    def _serve_conn(self, conn):
        msg = conn.recv()
        assert msg[0] == "register", msg
        role = msg[1]
        recover = msg[3] if len(msg) > 3 else None
        with self._lock:
            if role == "server":
                if recover is not None:
                    # Restarted server rejoining under its old rank: its
                    # new address replaces the dead one; workers refresh
                    # via the "servers" command when their connection
                    # drops (reference ps::Postoffice::is_recovery,
                    # kvstore_dist.h:52-55 — server side).
                    node_id = int(recover)
                else:
                    node_id = self._next_server
                    self._next_server += 1
                self._servers[node_id] = msg[2]
            elif recover is not None:
                # Restarted worker rejoining under its old rank: clear
                # its dead mark and un-break the barrier so subsequent
                # collective rounds can complete.
                node_id = int(recover)
                self._dead.discard(node_id)
                self._last_seen[node_id] = time.time()
                self._gone = False
                if self._barrier is not None:
                    self._barrier.reset()
            else:
                node_id = self._next_worker
                self._next_worker += 1
                self._last_seen[node_id] = time.time()
            if (self._next_worker == self.num_workers
                    and self._next_server == self.num_servers):
                self._all_registered.set()
        conn.send(("registered", node_id))
        if not self._all_registered.wait(_WAIT_TIMEOUT):
            conn.close()
            raise RuntimeError("scheduler: rendezvous timed out")
        book = [self._servers[i] for i in sorted(self._servers)]
        conn.send(("addressbook", book))
        if role == "server":
            # Server connections are write-only from here; hold until all
            # workers finalize, then deliver shutdown.
            self._done.wait(_WAIT_TIMEOUT * 4)
            try:
                conn.send(("shutdown",))
                conn.close()
            except OSError:
                pass
            return
        # Worker command loop.
        crashed = False
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                # Dropped without finalize: record the death so peers'
                # get_dead_nodes() sees it (reference GetDeadNodes).
                crashed = True
                msg = ("finalize",)
            with self._lock:
                self._last_seen[node_id] = time.time()
                if crashed:
                    self._dead.add(node_id)
            if msg[0] == "heartbeat":
                continue
            if msg[0] == "servers":
                # Current server addressbook — lets a worker re-resolve
                # a restarted server's new address.
                with self._lock:
                    book = [self._servers[i] for i in sorted(self._servers)]
                conn.send(("servers", book))
                continue
            if msg[0] == "dead_nodes":
                timeout = float(msg[1])
                now = time.time()
                with self._lock:
                    dead = sorted(self._dead | {
                        r for r, t in self._last_seen.items()
                        if now - t > timeout})
                conn.send(("dead_nodes", dead))
                continue
            if msg[0] == "barrier":
                if self._gone:
                    try:
                        conn.send(("barrier_failed",))
                    except OSError:
                        pass
                    continue
                try:
                    self._barrier.wait(_WAIT_TIMEOUT)
                    conn.send(("barrier_done",))
                except threading.BrokenBarrierError:
                    # A worker died or timed out: fail the barrier loudly
                    # on every survivor instead of hanging the cluster.
                    try:
                        conn.send(("barrier_failed",))
                    except OSError:
                        pass
            elif msg[0] == "finalize":
                with self._lock:
                    self._finalized += 1
                    if self._finalized == self.num_workers:
                        self._done.set()
                    elif self._barrier is not None:
                        # This worker is gone: a barrier a peer waits in
                        # can never complete — break it so the peer gets
                        # barrier_failed, not a silent hang — and every
                        # later barrier fails at once. A round that just
                        # completed is left alone: its threads are still
                        # draining, and an abort now would fail a peer
                        # that already passed it.
                        self._gone = True
                        if self._barrier.n_waiting:
                            self._barrier.abort()
                try:
                    conn.close()
                except OSError:
                    pass
                return


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _KeyState:
    __slots__ = ("stored", "pending_pulls", "queues", "round_ctx",
                 "applied_ctx")

    def __init__(self, value):
        self.stored = value                     # np.ndarray
        self.pending_pulls = []                 # [(conn, rows or None)]
        # Per-worker push queues: a sync round folds exactly ONE push
        # from every worker, so a worker pipelining its next push before
        # the round closes (fire-and-forget sends) can never close a
        # round early or mix gradients across rounds.
        self.queues = {}                        # conn id -> [grad, ...]
        # xtrace propagation: the OPEN round adopts the first push's
        # wire trace context; once applied it becomes the value's
        # context, echoed on pull replies so pullers can link their
        # slice into the round's cross-rank flow.
        self.round_ctx = None                   # wire ctx, open round
        self.applied_ctx = None                 # wire ctx, last apply

    def in_open_round(self, conn_id):
        """True when this worker has a push not yet folded into an
        applied round."""
        return bool(self.queues.get(conn_id))


class KVStoreServer:
    """One key-sharded parameter server (reference KVStoreDistServer).

    Sync mode (``dist_sync``/``dist_device_sync``): pushes for a key
    accumulate until all ``num_workers`` have contributed, then the
    updater (optimizer, if one was sent via ``set_optimizer``) is applied
    once to the aggregate — pulls issued mid-round are parked and
    answered after the update, which is how the reference defers pull
    responses until `ApplyUpdates` (kvstore_dist_server.h:325-348). Async
    mode (``dist_async``): the updater runs on every push immediately, no
    barrier (kvstore_dist_server.h:348 region).
    """

    def __init__(self, scheduler_addr=None, num_workers=None, host=None):
        self.scheduler_addr = scheduler_addr or (
            os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")))
        self.num_workers = int(num_workers if num_workers is not None
                               else os.environ.get("DMLC_NUM_WORKER", "1"))
        self.host = host or os.environ.get("DMLC_NODE_HOST", "127.0.0.1")
        self._keys = {}
        self._conn_rank = {}        # conn id -> worker rank (from hello)
        self._telemetry = {}        # worker rank -> (recv_time, blob)
        # Diag-bundle rendezvous (telemetry.healthplane.DiagCollector):
        # per-rank pushed bundles awaiting rank 0's pull, bounded so a
        # dead collector cannot make the server hoard bundles; plus the
        # pod-snapshot request slot workers poll.
        self._diag = {}             # worker rank -> [(name, blob), ...]
        self._diag_bound = int(os.environ.get(
            "MXNET_PS_DIAG_BUFFER", "16"))
        self._diag_request = (0, None, None)    # (seq, kind, msg)
        # Compile-cache rendezvous (the JAX package's compile.distribute):
        # key -> (meta, blob), insertion-ordered so the byte bound drops
        # the OLDEST entries (the executables a joiner still wants are
        # the newest ladder's). Entries are never drained on pull —
        # unlike diag bundles they serve every later elastic joiner.
        self._cc = {}
        self._cc_bytes = 0
        self._cc_bound = int(os.environ.get(
            "MXNET_PS_CC_BUFFER_MB", "256")) * (1 << 20)
        self._updater = None
        self._apply_seconds = 0.0   # the "stats" command reads these
        self._applies = 0
        self._opt_blob = None       # pickled optimizer for snapshots
        self._sync_mode = True
        self._trace_writer = None   # set by run() when MXNET_TRACE_DIR
        self._queue = queue.Queue()
        self.server_id = None
        # Snapshot-backed recovery (reference is_recovery for servers,
        # kvstore_dist.h:52-55): with MXNET_PS_SNAPSHOT_DIR set, shard
        # state is persisted after every applied update, and a process
        # restarted with DMLC_SERVER_RECOVERY=<rank> restores it and
        # rejoins under its old rank. Without the dir, recovery still
        # rejoins but starts empty (workers must re-init).
        self._snapshot_dir = os.environ.get("MXNET_PS_SNAPSHOT_DIR")
        self._snap_every = max(1, int(os.environ.get(
            "MXNET_PS_SNAPSHOT_EVERY", "1")))
        self._snap_counter = 0

    # -- snapshot/recovery ----------------------------------------------------
    # Per-key value files keep each applied update O(that key's size);
    # the meta file (optimizer blob + updater states, O(model)) is
    # throttled by MXNET_PS_SNAPSHOT_EVERY applies — at scale, restored
    # optimizer state may be a few steps stale (best-effort, like the
    # reference's recovery story), while stored values are exact.

    def _base_path(self):
        return os.path.join(self._snapshot_dir,
                            "server_%d" % self.server_id)

    def _key_path(self, key):
        import hashlib

        h = hashlib.md5(repr(key).encode()).hexdigest()[:16]
        return "%s.key_%s.pkl" % (self._base_path(), h)

    @staticmethod
    def _atomic_write(path, blob):
        # base.atomic_write (mkstemp staging + fsync + rename): a fixed
        # ".tmp" suffix here let two servers snapshotting the same key
        # path clobber each other's staging file, and skipping fsync
        # could commit a rename whose bytes die with the page cache.
        with atomic_write(path, "wb") as f:
            f.write(blob)

    def _write_snapshot(self, key=None):
        """Persist one key's stored value (key given) and, on schedule
        or when key is None, the optimizer meta."""
        if self._snapshot_dir is None or self.server_id is None:
            return
        if key is not None:
            self._atomic_write(self._key_path(key), pickle.dumps(
                {"key": key, "stored": self._keys[key].stored}))
            self._snap_counter += 1
            if self._snap_counter % self._snap_every:
                return
        states = (self._updater.get_states(dump_optimizer=False)
                  if self._updater is not None else None)
        self._atomic_write(self._base_path() + ".meta.pkl", pickle.dumps(
            {"opt_blob": self._opt_blob, "updater_states": states}))

    def _load_snapshot(self):
        import glob

        if self._snapshot_dir is None:
            return False
        found = False
        for path in glob.glob(self._base_path() + ".key_*.pkl"):
            with open(path, "rb") as f:
                rec = pickle.load(f)
            self._keys[rec["key"]] = _KeyState(rec["stored"])
            found = True
        meta_path = self._base_path() + ".meta.pkl"
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            self._opt_blob = meta["opt_blob"]
            if self._opt_blob is not None:
                self._updater = self._make_updater(self._opt_blob)
                if meta["updater_states"]:
                    self._updater.set_states(meta["updater_states"])
            found = True
        _dbg("recovered %d keys from snapshot" % len(self._keys))
        return found

    # -- update application (executor thread only) ----------------------------

    @staticmethod
    def _make_updater(blob):
        """The port's Updater over an optimizer pickled by a worker; its
        states live on the host."""
        from . import optimizer as opt
        from .context import cpu

        updater = opt.get_updater(pickle.loads(blob))
        updater.state_ctx = lambda index: cpu()
        return updater

    def _apply(self, key, state, grad_np):
        """Run the optimizer on ``stored`` (reference ApplyUpdates)."""
        if self._updater is None:
            # Default "updater" is assignment of the merged value
            # (kvstore_dist_server.h: CopyFromTo(merged, &stored)).
            state.stored = grad_np.astype(state.stored.dtype, copy=False)
            return
        from . import ndarray as nd
        from .context import cpu

        host = cpu()
        dtype = state.stored.dtype.name
        stored = nd.array(state.stored, ctx=host, dtype=dtype)
        grad = nd.array(grad_np.astype(state.stored.dtype, copy=False),
                        ctx=host, dtype=dtype)
        self._updater(key, grad, stored)
        state.stored = stored.asnumpy()

    # Index of the optional trailing wire trace context per push kind
    # (workers inject it after the value payload; old peers omit it).
    _PUSH_CTX_IDX = {"push": 3, "push_compressed": 4, "push_rsp": 4}

    def _grad_from_msg(self, msg, state):
        from .gradient_compression import GradientCompression

        if msg[0] == "push":
            # The pushed value keeps its dtype (a float64 key stays
            # float64; the JAX package narrows every push to float32).
            return np.asarray(msg[2])
        if msg[0] == "push_compressed":
            return GradientCompression.decompress(msg[2], msg[3]).numpy()
        # push_rsp: (cmd, key, indices, values[, ctx]), scattered into a
        # dense gradient of the stored shape (duplicates sum, the
        # reference's row-sparse merge on the server).
        values = np.asarray(msg[3])
        grad = np.zeros(state.stored.shape, dtype=values.dtype)
        np.add.at(grad, np.asarray(msg[2], dtype=np.int64), values)
        return grad

    def _traced_apply(self, key, state, grad_np, wire_ctx):
        """Run :meth:`_apply` under the round's extracted trace context
        so the server-side apply span joins the pushing step's flow; its
        time adds to the ``stats`` command's ``apply_seconds``."""
        from .telemetry import trace as _ttrace
        from .telemetry import xtrace as _xt

        t0 = time.perf_counter()
        with _xt.activate(_xt.extract(wire_ctx)):
            with _ttrace.span("kvstore::apply", key=str(key)):
                self._apply(key, state, grad_np)
        self._apply_seconds += time.perf_counter() - t0
        self._applies += 1
        state.applied_ctx = wire_ctx

    @staticmethod
    def _send(conn, msg):
        try:
            conn.send(msg)
        except OSError:
            pass

    def _answer_pull(self, conn, state, rows):
        # The reply echoes the applied round's wire trace context — the
        # puller stamps a FOREIGN context as link_trace_id, joining its
        # slice into the pushing step's flow.
        value = state.stored if rows is None else state.stored[rows]
        self._send(conn, ("val", value, state.applied_ctx))

    def _handle(self, conn, msg):
        """Execute one request — runs exclusively on the executor thread
        (reference: handlers run on the server's `exec_`)."""
        cmd = msg[0]
        _dbg("exec", cmd, msg[1] if len(msg) > 1 and cmd != "set_optimizer"
             else "")
        if cmd == "hello":
            self._sync_mode = bool(msg[1])
            # Workers announce their rank: sync rounds key on WORKER
            # identity, not connection identity, so a reconnecting
            # worker resumes its own queue instead of wedging the round
            # open with a stale entry (id() of a dead conn can even be
            # reused by a new one).
            if len(msg) > 2:
                self._conn_rank[id(conn)] = msg[2]
        elif cmd == "init":
            self._keys[msg[1]] = _KeyState(np.asarray(msg[2]))
            self._write_snapshot(msg[1])
            self._send(conn, ("ok",))
        elif cmd == "delete":
            # Retire a key (fused-trainer bucket-generation GC): drop
            # the stored value and its recovery snapshot so the server
            # neither leaks the buffer nor resurrects it on restart.
            self._keys.pop(msg[1], None)
            if self._snapshot_dir is not None and \
                    self.server_id is not None:
                try:
                    os.remove(self._key_path(msg[1]))
                except OSError:
                    pass
            self._send(conn, ("ok",))
        elif cmd in ("push", "push_compressed", "push_rsp"):
            key = msg[1]
            state = self._keys.get(key)
            if state is None:
                self._send(conn, ("error", "key %r not initialized" % (key,)))
                return
            grad = self._grad_from_msg(msg, state)
            ctx_idx = self._PUSH_CTX_IDX[cmd]
            wire_ctx = msg[ctx_idx] if len(msg) > ctx_idx else None
            if not self._sync_mode:
                self._traced_apply(key, state, grad, wire_ctx)
                self._write_snapshot(key)
                self._send(conn, ("ok",))
                return
            # The open round adopts the FIRST context-bearing push: one
            # owner per round keeps the apply span (and the reply echo)
            # a single flow instead of a fan-in of every worker's trace.
            if wire_ctx is not None and state.round_ctx is None:
                state.round_ctx = wire_ctx
            wid = self._conn_rank.get(id(conn), id(conn))
            state.queues.setdefault(wid, []).append(grad)
            # Round complete: one queued push from num_workers distinct
            # connections (count the non-empty queues, so a stale entry
            # from a reconnected worker cannot wedge the round open).
            ready = [q for q in state.queues.values() if q]
            if len(ready) == self.num_workers:
                total = np.zeros(state.stored.shape,
                                 dtype=np.result_type(state.stored.dtype,
                                                      np.float32))
                for q in ready:
                    total += q.pop(0)
                self._traced_apply(key, state, total, state.round_ctx)
                state.round_ctx = None
                self._write_snapshot(key)
                # A parked puller with pushes still queued waits for the
                # round of its last push: answering it now would return
                # a value without its later pushes (the JAX package
                # answers every parked pull here, which loses rounds
                # when a worker pipelines several pushes of one key).
                parked = []
                for (pconn, prows) in state.pending_pulls:
                    if state.in_open_round(
                            self._conn_rank.get(id(pconn), id(pconn))):
                        parked.append((pconn, prows))
                    else:
                        self._answer_pull(pconn, state, prows)
                state.pending_pulls = parked
            self._send(conn, ("ok",))
        elif cmd in ("pull", "pull_rows"):
            key = msg[1]
            state = self._keys.get(key)
            if state is None:
                self._send(conn, ("error", "key %r not initialized" % (key,)))
                return
            rows = np.asarray(msg[2]) if cmd == "pull_rows" else None
            # The serve side of a pull belongs to the REQUESTER's causal
            # chain (a gateway request's backend pull, a trainer fetch):
            # record it under the request's wire context so the flow
            # reaches the server lane even when no apply ran for it.
            ctx_idx = 3 if cmd == "pull_rows" else 2
            req_ctx = msg[ctx_idx] if len(msg) > ctx_idx else None
            from .telemetry import trace as _ttrace
            from .telemetry import xtrace as _xt

            with _xt.activate(_xt.extract(req_ctx)):
                with _ttrace.span("kvstore::serve_pull",
                                  key=str(msg[1])):
                    wid = self._conn_rank.get(id(conn), id(conn))
                    if self._sync_mode and state.in_open_round(wid):
                        # This worker contributed to the OPEN round, so
                        # it expects the value that includes its push:
                        # park until ApplyUpdates flushes it. A puller
                        # that has NOT pushed into the open round wants
                        # the last COMPLETED round — answer immediately
                        # (parking it would deadlock lockstep workers
                        # once pushes are pipelined: a fast worker's
                        # next-step push opens a round the slow worker
                        # can never help close while its own pull is
                        # parked).
                        state.pending_pulls.append((conn, rows))
                    else:
                        self._answer_pull(conn, state, rows)
        elif cmd == "set_optimizer":
            self._opt_blob = msg[1]
            self._updater = self._make_updater(msg[1])
            self._write_snapshot()
            self._send(conn, ("ok",))
        elif cmd == "get_states":
            blob = (self._updater.get_states(dump_optimizer=False)
                    if self._updater else b"")
            self._send(conn, ("val", blob))
        elif cmd == "set_states":
            if self._updater is not None:
                self._updater.set_states(msg[1])
            self._send(conn, ("ok",))
        elif cmd == "stats":
            # This server's cumulative update work: seconds spent in
            # _apply (the optimizer, or the assignment) and its count.
            self._send(conn, ("val", {"apply_seconds": self._apply_seconds,
                                      "applies": self._applies}))
        elif cmd == "telemetry_push":
            # Pod telemetry rendezvous (telemetry.aggregate): each rank
            # publishes its serialized registry snapshot here (server 0
            # by convention — snapshots are small); receive time is
            # stamped on THIS server's monotonic clock, so staleness
            # ages depend neither on worker clock agreement nor on NTP
            # steps of the server's wall clock.
            self._telemetry[msg[1]] = (time.monotonic(), msg[2])
            self._send(conn, ("ok",))
        elif cmd == "telemetry_pull":
            now = time.monotonic()
            self._send(conn, ("val", {rank: (now - t, blob)
                                      for rank, (t, blob)
                                      in self._telemetry.items()}))
        elif cmd == "diag_push":
            # Pod forensics rendezvous (telemetry.healthplane): a rank
            # publishes one committed flight-recorder bundle — (rank,
            # name, blob) — for rank 0 to pull. Server 0 by convention,
            # same as telemetry_push; pipelined ack.
            q = self._diag.setdefault(msg[1], [])
            q.append((msg[2], msg[3]))
            # bound <= 0 keeps nothing (del q[:-0] would keep EVERYTHING
            # — an unbounded hoard, the opposite of the bound's intent).
            q[:] = q[-self._diag_bound:] if self._diag_bound > 0 else []
            self._send(conn, ("ok",))
        elif cmd == "diag_pull":
            # Drain semantics: bundles hand off exactly once — repeated
            # collects are incremental and the buffer never regrows
            # past one round's worth.
            pending, self._diag = self._diag, {}
            self._send(conn, ("val", pending))
        elif cmd == "diag_request":
            # Pod-snapshot fan-out: rank 0 bumps the request slot; every
            # rank's DiagCollector polls diag_request_check and captures
            # a bundle when the sequence advances.
            seq = self._diag_request[0] + 1
            self._diag_request = (seq, msg[1],
                                  msg[2] if len(msg) > 2 else "")
            self._send(conn, ("val", seq))
        elif cmd == "diag_request_check":
            self._send(conn, ("val", self._diag_request))
        elif cmd == "cc_push":
            # Compile-cache rendezvous: (key, meta, blob[, ctx]).
            # Replacing an existing key re-inserts it at the fresh end;
            # the byte bound then retires oldest-first. Pipelined ack.
            key, meta, blob = msg[1], msg[2], msg[3]
            old = self._cc.pop(key, None)
            if old is not None:
                self._cc_bytes -= len(old[1])
            if self._cc_bound > 0 and len(blob) <= self._cc_bound:
                self._cc[key] = (meta, blob)
                self._cc_bytes += len(blob)
                while self._cc_bytes > self._cc_bound and self._cc:
                    oldest = next(iter(self._cc))    # insertion order
                    self._cc_bytes -= len(self._cc.pop(oldest)[1])
            self._send(conn, ("ok",))
        elif cmd == "cc_probe":
            # keys=None enumerates every held key — the one-round
            # whole-buffer listing a joiner's prefetch rides.
            self._send(conn, ("val", list(self._cc)
                              if msg[1] is None else
                              [k for k in msg[1] if k in self._cc]))
        elif cmd == "cc_pull":
            self._send(conn, ("val", self._cc.get(msg[1])))
        elif cmd == "profiler":
            # Remote server profiling (reference
            # KVStoreServerProfilerCommand, include/mxnet/kvstore.h:49,
            # kvstore_dist_server.h:211-217): workers drive THIS
            # server's profiler through the command channel. Beyond
            # parity, "dumps" returns the aggregate table over the wire
            # instead of only writing a server-local file.
            from . import profiler as _prof

            sub = msg[1]
            arg = msg[2] if len(msg) > 2 else None
            if sub == "set_config":
                _prof.set_config(**(arg or {}))
                self._send(conn, ("ok",))
            elif sub == "set_state":
                _prof.set_state(arg)
                self._send(conn, ("ok",))
            elif sub == "pause":
                _prof.pause()
                self._send(conn, ("ok",))
            elif sub == "resume":
                _prof.resume()
                self._send(conn, ("ok",))
            elif sub == "dump":
                _prof.dump()
                self._send(conn, ("ok",))
            elif sub == "dumps":
                self._send(conn, ("val", _prof.dumps()))
            elif sub == "trace_flush":
                # Commit this server's pending trace segments NOW —
                # rank 0 calls this right before trace_merge so the
                # server lane is on disk deterministically instead of
                # only at shutdown (segment age budget is 30s).
                path = None
                if self._trace_writer is not None:
                    path = self._trace_writer.flush()
                self._send(conn, ("val", path))
            else:
                self._send(conn, ("error",
                                  "unknown profiler cmd %r" % (sub,)))
        else:
            self._send(conn, ("error", "unknown command %r" % (cmd,)))

    # -- I/O threads: enqueue only, never import ------------------------------

    def _reader(self, conn, on_close=None):
        """Enqueue every message of `conn`; at its end, enqueue
        `on_close` if given (the scheduler's connection: a scheduler that
        is gone ends the job, as its "shutdown" would)."""
        try:
            while True:
                msg = conn.recv()
                self._queue.put((conn, msg))
        except (EOFError, OSError):
            if on_close is not None:
                self._queue.put((conn, on_close))

    def run(self):
        """Register with the scheduler, then execute requests on this
        thread until the scheduler says shutdown."""
        listener = _listener(self.host, 0)
        addr = listener.address
        sched = _client(self.scheduler_addr)
        recover = os.environ.get("DMLC_SERVER_RECOVERY")
        sched.send(("register", "server", (addr[0], addr[1]),
                    int(recover) if recover else None))
        reply = sched.recv()
        assert reply[0] == "registered"
        self.server_id = reply[1]
        if recover is not None:
            self._load_snapshot()
        book = sched.recv()
        assert book[0] == "addressbook"

        def accept_loop():
            while True:
                try:
                    conn = listener.accept()
                except OSError:
                    return
                threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=accept_loop, daemon=True).start()
        threading.Thread(target=self._reader, args=(sched, ("shutdown",)),
                         daemon=True).start()
        # With MXNET_TRACE_DIR set, the server streams its own spans
        # (kvstore::apply under the round's trace context) as segments
        # in a lane past the worker ranks — the merged timeline then
        # shows the server half of every push→apply→pull flow.
        writer = None
        trace_dir = os.environ.get("MXNET_TRACE_DIR")
        if trace_dir:
            from .telemetry.export import StreamingTraceWriter

            writer = StreamingTraceWriter(
                trace_dir, rank=self.num_workers + (self.server_id or 0))
        # Exposed for the command channel's "trace_flush" (the handler
        # runs on this same executor thread — no locking needed).
        self._trace_writer = writer
        while True:
            conn, msg = self._queue.get()
            if msg[0] == "shutdown":
                break
            try:
                self._handle(conn, msg)
            except Exception as exc:  # surface handler errors to the worker
                _dbg("handler error:", exc)
                self._send(conn, ("error", "%s: %s" % (type(exc).__name__,
                                                       exc)))
            if writer is not None:
                writer.tick()
        if writer is not None:
            writer.close()
        listener.close()


# ---------------------------------------------------------------------------
# role bootstrap
# ---------------------------------------------------------------------------

def _init_kvstore_server_module():
    """Run the blocking server/scheduler loop when this process's role says
    so, then exit — mirroring the reference where ``import mxnet`` in a
    ``DMLC_ROLE=server`` process never returns to the user script
    (python/mxnet/kvstore_server.py:_init_kvstore_server_module).

    Server and scheduler processes never touch a card: every array the
    server makes is on the host, and nothing here initialises CUDA.
    """
    role = os.environ.get("DMLC_ROLE", "").lower()
    if role not in ("server", "scheduler"):
        return
    if role == "scheduler":
        Scheduler(int(os.environ["DMLC_NUM_WORKER"]),
                  int(os.environ["DMLC_NUM_SERVER"])).run()
    else:
        KVStoreServer().run()
    sys.exit(0)
