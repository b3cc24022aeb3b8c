"""KVStore — key-value store for parameter synchronization.

Counterpart of ``mxnet_tpu/kvstore.py:94-342`` (reference:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h,
python/mxnet/kvstore.py), on one process: ``create("local")`` and
``create("device")`` (alias ``"nccl"``).

Semantics as in the JAX package: ``push`` merges (sums) the values given
for a key, then applies the updater to the stored value (default
updater = assign); ``pull`` writes the stored value into the provided
output arrays, on their own devices; ``pushpull`` is the two in one
call. ``set_optimizer`` installs an optimizer as the updater and
``save_optimizer_states``/``load_optimizer_states`` checkpoint its
states (``Updater.get_states``/``set_states``).

Where the stored copy lives: the reference's ``"local"`` merges on a host
copy (CommCPU); the port keeps the stored value on the device of the
value ``init`` was given, for both types, so a store never moves data
to the host on its own. ``dist_*`` types raise: the distributed store is
ROADMAP Queue 1 item 7; row-sparse pulls raise (item 11).
"""
from __future__ import annotations

import time

from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "PullHandle", "create"]


class PullHandle:
    """Completion handle for :meth:`KVStore.pull_async`.

    ``wait()`` blocks until the pull landed in its ``out`` arrays and
    re-raises any transport error there — a caller that never waits
    never observes the error, so always wait before reading the outs.
    ``seconds`` (valid after completion) is the wall time the pull
    spent in the store, which the Trainer's overlap telemetry charges
    as reduce time.
    """

    __slots__ = ("_event", "_error", "seconds", "inline")

    def __init__(self):
        import threading

        self._event = threading.Event()
        self._error = None
        self.seconds = 0.0
        # True when the pull ran synchronously inside pull_async (the
        # base-class/local-store case): its time is already inside the
        # caller's own wall clock, so overlap accounting must not add
        # `seconds` again. Set by capability, never by timing.
        self.inline = False

    def _finish(self, error=None, seconds=0.0):
        self._error = error
        self.seconds = seconds
        self._event.set()

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("pull did not complete within %r s"
                               % (timeout,))
        if self._error is not None:
            raise self._error


def _key_list(key):
    return (key, False) if isinstance(key, (list, tuple)) else ([key], True)


def _val_list(value, n_keys, single):
    """Group `value` per key: each key maps to a list of per-device arrays
    (reference python/mxnet/kvstore.py:_ctype_key_value grouping)."""
    if single:
        if isinstance(value, NDArray):
            return [[value]]
        return [list(value)]
    out = []
    for v in value:
        out.append([v] if isinstance(v, NDArray) else list(v))
    assert len(out) == n_keys
    return out


class KVStore:
    """Base store (reference: python/mxnet/kvstore.py:KVStore)."""

    def __init__(self):
        self._updater = None
        self._optimizer = None
        self._compression_params = None

    # -- identification -------------------------------------------------------

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core API -------------------------------------------------------------

    def init(self, key, value):
        raise NotImplementedError

    def contains(self, key):
        """Whether `key` was initialized in this store (conservative
        default False for stores that don't track membership locally)."""
        return False

    def discard(self, key):
        """Drop `key`'s stored value if present (no-op default)."""

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pull_async(self, key, out=None, priority=0, ignore_sparse=True):
        """Issue a pull and return a :class:`PullHandle` instead of
        blocking. A local store completes it synchronously (its copies
        are already queued on the card asynchronously); errors surface
        on ``handle.wait()``."""
        handle = PullHandle()
        handle.inline = True
        t0 = time.perf_counter()
        try:
            self.pull(key, out=out, priority=priority,
                      ignore_sparse=ignore_sparse)
        except BaseException as exc:      # noqa: BLE001 — relayed
            handle._finish(exc, time.perf_counter() - t0)
            return handle
        handle._finish(None, time.perf_counter() - t0)
        return handle

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(
            "row_sparse_pull needs the sparse NDArray, which the port does "
            "not have yet (ROADMAP Queue 1 item 11)")

    def set_updater(self, updater):
        """Install `updater(key, recv, stored)` applied on push
        (reference kvstore.py:set_updater)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Use an optimizer as the updater (reference
        kvstore.py:set_optimizer); a local store installs it directly."""
        from . import optimizer as opt

        self._optimizer = optimizer
        updater = opt.get_updater(optimizer)
        updater.state_ctx = self._state_ctx
        self.set_updater(updater)

    def _state_ctx(self, key):
        return None

    def set_gradient_compression(self, compression_params):
        """2-bit / 1-bit gradient compression knobs (reference
        gradient_compression.h:37-134). Stored, as in the JAX package,
        whose local stores do not compress either: the codec
        (``gradient_compression.GradientCompression``, with error
        feedback) acts on the dist path, ROADMAP Queue 1 item 7."""
        self._compression_params = dict(compression_params)

    # -- optimizer state checkpointing ---------------------------------------

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "updater is not set"
        from .base import atomic_write

        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "updater is not set"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _barrier(self):
        pass


class KVStoreLocal(KVStore):
    """Single-process store; ``"device"`` and ``"local"`` differ only in
    their name here (see the module docstring)."""

    def __init__(self, device_mode=False):
        super().__init__()
        self._device_mode = device_mode
        self._store = {}

    @property
    def type(self):
        return "device" if self._device_mode else "local"

    def contains(self, key):
        return key in self._store

    def discard(self, key):
        self._store.pop(key, None)

    def _state_ctx(self, key):
        stored = self._store.get(key)
        return stored.context if stored is not None else None

    def init(self, key, value):
        keys, single = _key_list(key)
        vals = _val_list(value, len(keys), single)
        for k, vlist in zip(keys, vals):
            assert k not in self._store, "key %r already initialized" % (k,)
            self._store[k] = vlist[0].copy()

    def _merge(self, vlist):
        """Sum the values pushed for one key, in order, on the first
        value's device."""
        merged = vlist[0]
        for v in vlist[1:]:
            merged = merged + v.as_in_context(merged.context)
        return merged

    def push(self, key, value, priority=0):
        keys, single = _key_list(key)
        vals = _val_list(value, len(keys), single)
        for k, vlist in zip(keys, vals):
            assert k in self._store, "key %r was not initialized" % (k,)
            merged = self._merge(vlist)
            stored = self._store[k]
            if self._updater is not None:
                self._updater(k, merged.as_in_context(stored.context), stored)
            else:
                # Default updater = assign (reference kvstore_local.h).
                m = merged.as_in_context(stored.context)
                # Never alias the caller's array.
                self._store[k] = m.copy() if m is vlist[0] else m

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        assert out is not None, "pull requires out="
        keys, single = _key_list(key)
        outs = _val_list(out, len(keys), single)
        for k, olist in zip(keys, outs):
            stored = self._store[k]
            for o in olist:
                o[:] = stored.as_in_context(o.context)

    def pushpull(self, key, value, out=None, priority=0):
        """push then pull; with ``out=None`` the pulled value lands in
        `value` itself (reference kvstore.py:pushpull)."""
        self.push(key, value, priority=priority)
        self.pull(key, out=value if out is None else out, priority=priority)


def create(name="local"):
    """Create a KVStore (reference: kvstore.py:create). Supported:
    ``local`` (also ``local_update_cpu``, ``local_allreduce_cpu``),
    ``device`` (also ``local_allreduce_device``, ``nccl``). ``dist_*``
    raises NotImplementedError (ROADMAP Queue 1 item 7)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStoreLocal(device_mode=False)
    if name in ("device", "local_allreduce_device", "nccl"):
        return KVStoreLocal(device_mode=True)
    if name.startswith("dist"):
        raise NotImplementedError(
            "kvstore %r: the distributed store (kvstore_dist, the server "
            "and the multi-process reduce) is ROADMAP Queue 1 item 7; the "
            "port has the single-process 'local' and 'device' stores"
            % name)
    raise ValueError("unknown kvstore type %r" % name)
