"""mxnet_tpu_torch.compile.distribute — compile-cache entries shared
over the kvstore command channel.

Counterpart of ``mxnet_tpu/compile/distribute.py``. Three commands ride
the worker->server wire of ``kvstore_dist.py`` (server 0 is the
rendezvous), and the same three the in-process
``telemetry.aggregate.LocalBus``:

``cc_push(key, meta, blob)``
    Publish one cache entry (pipelined ack). The server keeps a bounded
    drop-oldest buffer of entries by total bytes
    (``MXNET_PS_CC_BUFFER_MB``).
``cc_probe(keys)``
    Which of ``keys`` the server holds; ``None`` lists every held key
    in one round-trip.
``cc_pull(key)``
    Fetch one entry: ``(meta, blob)`` or None. Entries are not drained:
    they serve every later joiner.

By default only rank 0 publishes (``publishes``) and every rank pulls
on a local miss (``pulls``). Entries above ``MXNET_PS_CC_ENTRY_MB`` are
never pushed.
"""
from __future__ import annotations

from .. import env as _env
from .. import log as _log
from ..telemetry import metrics as _tm
from . import _errors_total

__all__ = ["CacheDistributor", "entry_bound_bytes"]

_pushed_total = _tm.REGISTRY.counter(
    "mx_compile_cache_pushed_total",
    "Compile-cache entries published to the pod over the kvstore")
_pulled_total = _tm.REGISTRY.counter(
    "mx_compile_cache_pulled_total",
    "Compile-cache entries fetched from the pod over the kvstore")
_prefetched_total = _tm.REGISTRY.counter(
    "mx_compile_cache_prefetched_total",
    "Compile-cache entries bulk-warmed into the local store at attach")

_logger = _log.get_logger("mxnet_tpu_torch.compile")


def entry_bound_bytes():
    """Largest entry the distributor ships (``MXNET_PS_CC_ENTRY_MB``)."""
    return int(_env.get("MXNET_PS_CC_ENTRY_MB")) * (1 << 20)


class CacheDistributor:
    """Pod transport for compile-cache entries.

    Parameters
    ----------
    kv : transport exposing ``rank`` and the ``cc_push``/``cc_pull``/
        ``cc_probe`` commands (``KVStoreDist`` or a LocalBus endpoint).
    publishes : whether this rank publishes entries it compiles
        (default: rank 0 only).
    pulls : whether this rank consults the pod on a local miss
        (default: every rank — a probe is one small round-trip against
        a multi-second compile).
    max_entry_bytes : per-entry publish bound (default
        ``MXNET_PS_CC_ENTRY_MB``).
    """

    def __init__(self, kv, publishes=None, pulls=True,
                 max_entry_bytes=None):
        self._kv = kv
        self.rank = int(getattr(kv, "rank", 0))
        self.publishes = (self.rank == 0) if publishes is None \
            else bool(publishes)
        self.pulls = bool(pulls)
        self.max_entry_bytes = entry_bound_bytes() \
            if max_entry_bytes is None else int(max_entry_bytes)

    def publish(self, key, meta, payload):
        """Push one entry to the pod rendezvous. Oversized entries are
        skipped (warned, not raised). Returns True when shipped."""
        if len(payload) > self.max_entry_bytes:
            _log.warn_rate_limited(
                _logger, "cc_dist_big:%d" % id(self), 300.0,
                "compile-cache entry %s is %d bytes (> %d bound) — not "
                "distributed; peers compile it locally", key,
                len(payload), self.max_entry_bytes)
            return False
        self._kv.cc_push(key, meta, payload)
        _pushed_total.inc()
        return True

    def probe(self, keys=None):
        """Subset of ``keys`` the pod currently holds; ``None``
        enumerates EVERY held key in one round-trip."""
        return self._kv.cc_probe(None if keys is None else list(keys))

    def prefetch(self, store):
        """Bulk-warm ``store`` from the pod: ONE ``cc_probe(None)``
        round enumerates every entry the rendezvous holds, then each
        key absent from the local disk store is pulled and committed —
        a joiner warms its whole store before its first build instead
        of paying a probe round-trip per miss. Best-effort: transport
        or commit failures degrade to the ordinary miss-by-miss path.
        Returns the number of entries committed."""
        if store is None or not self.pulls:
            return 0
        try:
            held = self.probe(None)
        except Exception as exc:    # a transport's failure is not the build's
            _errors_total.labels(site="prefetch", kind="distribute").inc()
            _log.warn_rate_limited(
                _logger, "cc_prefetch:%d" % id(self), 60.0,
                "compile-cache prefetch probe failed (falling back to "
                "miss-by-miss pulls): %s", exc)
            return 0
        have = set(store.keys())
        committed = 0
        for key in held:
            if key in have:
                continue
            try:
                rec = self._kv.cc_pull(key)
            except Exception as exc:    # as above
                _errors_total.labels(site="prefetch",
                                     kind="distribute").inc()
                _log.warn_rate_limited(
                    _logger, "cc_prefetch:%d" % id(self), 60.0,
                    "compile-cache prefetch pull failed after %d "
                    "entries (remainder falls back to miss-by-miss "
                    "pulls): %s", committed, exc)
                break
            if rec is None:
                continue                # raced a buffer eviction
            meta, payload = rec
            try:
                store.put(key, payload, meta)
            except OSError as exc:
                # Disk trouble hits every later put too: stop.
                _errors_total.labels(site="prefetch", kind="io").inc()
                _log.warn_rate_limited(
                    _logger, "cc_prefetch:%d" % id(self), 60.0,
                    "compile-cache prefetch commit failed after %d "
                    "entries (store stays partially warm): %s",
                    committed, exc)
                break
            committed += 1
            _prefetched_total.inc()
        if committed:
            _logger.info("compile-cache prefetch warmed %d entr%s from "
                         "the pod rendezvous", committed,
                         "y" if committed == 1 else "ies")
        return committed

    def fetch(self, key):
        """``(meta, payload)`` from the pod, or None. One probe first so
        the common cold-pod miss costs a tiny round-trip, not a blob
        transfer attempt."""
        if not self._kv.cc_probe([key]):
            return None
        rec = self._kv.cc_pull(key)
        if rec is None:
            return None                 # raced a buffer eviction
        _pulled_total.inc()
        meta, payload = rec
        return meta, payload
