"""mxnet_tpu_torch.compile — the persistent compile cache, shared between
ranks over the kvstore.

Counterpart of ``mxnet_tpu/compile/__init__.py``. The JAX package stores
XLA executables; PyTorch runs eagerly and has none. What the port does
compile, at first use in every process, are its kernels, and both of its
compile steps go through this cache:

* site ``nvcc``: ``_native.build`` asks the store, and then a peer, for
  a library missing from ``_native.BUILD`` before it starts ``nvcc``; a
  library it builds is committed with nvcc's log (``_native.build_log``
  returns the same ptxas report after a hit). The key is the library's
  content hash: its source, every ``csrc/*.cuh``, the flags and nvcc's
  ``--version`` line. Beside it, at site ``nvcc_toolkit``, the version
  line keyed by the rest: a machine without nvcc reads it there to find
  the library built from the same sources.
* site ``nvrtc``: ``_nvrtc.compile_program`` asks the store, and then a
  peer, on a miss of its per-process dict before it runs NVRTC; a fresh
  program is committed as its cubin, lowered names and log. The key is
  the source, the options, the name expressions, NVRTC's version and the
  card's compute capability.

A miss compiles, counted on ``mx_compile_cache_misses_total{site}``; a
hit on ``mx_compile_cache_hits_total{site,source}`` (``local``: this
process's directory, ``remote``: a peer's entry pulled over the
kvstore); a store or peer failure on ``mx_compile_cache_errors_total
{site,kind}`` and in the log, and the step compiles as if the cache were
off. A kernel that fails to build or launch still raises: an entry only
ever replaces a compile of the same sources, flags and toolkit.

Distribution (:mod:`.distribute`): with a kvstore attached
(:func:`attach_kvstore`), rank 0 publishes every entry it commits over
the ``cc_push``/``cc_pull``/``cc_probe`` commands, and a rank that
misses locally pulls the entry instead of compiling.

:func:`maybe_cached_jit` and :class:`CachedFunction` keep the JAX
package's seam: the port's eager functions have no executable to store,
so a :class:`CachedFunction` counts the signatures it meets (as
``CachedOp.num_traces``) and writes no entry.

Enable with ``MXNET_COMPILE_CACHE=<dir>`` (``MXNET_COMPILE_CACHE_MB``
bounds it) or :func:`configure`. Off (the default), every site compiles
as before.
"""
from __future__ import annotations

import json
import threading
import time

from .store import CompileCacheStore, make_key, entry_name, ENTRY_FORMAT
from ..telemetry import memstats as _ms
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from .. import log as _log

__all__ = ["CachedFunction", "CompileCacheStore", "cached_compile",
           "maybe_cached_jit", "configure", "reset", "enabled",
           "active_store", "attach_kvstore", "set_distributor",
           "shared_filesystem", "backend_fingerprint", "make_key",
           "entry_name", "ENTRY_FORMAT", "fetch", "commit"]

_hits_total = _tm.REGISTRY.counter(
    "mx_compile_cache_hits_total",
    "Compile-cache hits (a kernel library or cubin loaded instead of "
    "compiled); source=local is this process's disk, source=remote a "
    "peer's entry pulled over the kvstore", labels=("site", "source"))
_misses_total = _tm.REGISTRY.counter(
    "mx_compile_cache_misses_total",
    "Compile-cache misses (a real nvcc or NVRTC compile was paid)",
    labels=("site",))
_errors_total = _tm.REGISTRY.counter(
    "mx_compile_cache_errors_total",
    "Cache failures, each followed by a plain compile: kind=corrupt "
    "(an entry's payload failed to unpack), io (commit failed), "
    "distribute (peer fetch, publish or prefetch failed)",
    labels=("site", "kind"))
_load_seconds = _tm.REGISTRY.histogram(
    "mx_compile_cache_load_seconds",
    "Wall time to read a cached entry (the cost a hit pays instead of "
    "mx_compile_seconds)", labels=("site",))

_logger = _log.get_logger("mxnet_tpu_torch.compile")

# -- process-wide configuration ------------------------------------------------

_lock = threading.Lock()
_store = None
_distributor = None
_configured = False        # configure()/env decision made


def _default_max_bytes():
    from .. import env as _env

    return int(_env.get("MXNET_COMPILE_CACHE_MB")) * (1 << 20)


def configure(directory, max_bytes=None):
    """Enable the cache at ``directory`` for this process (overrides the
    ``MXNET_COMPILE_CACHE`` env decision). ``max_bytes=None`` uses the
    ``MXNET_COMPILE_CACHE_MB`` budget. Returns the active store."""
    global _store, _configured
    with _lock:
        _store = CompileCacheStore(
            directory,
            _default_max_bytes() if max_bytes is None else max_bytes)
        _configured = True
        return _store


def reset():
    """Disable the cache and forget the env decision and the distributor
    (a later call re-reads the environment)."""
    global _store, _distributor, _configured
    with _lock:
        _store = None
        _distributor = None
        _configured = False


def active_store():
    """The live :class:`CompileCacheStore`, or None when disabled. The
    first call reads ``MXNET_COMPILE_CACHE`` unless :func:`configure`
    already decided."""
    global _store, _configured
    with _lock:
        if not _configured:
            _configured = True
            from .. import env as _env

            directory = _env.get("MXNET_COMPILE_CACHE")
            if directory:
                _store = CompileCacheStore(directory, _default_max_bytes())
        return _store


def enabled():
    return active_store() is not None


def set_distributor(distributor):
    """Install (or clear, with None) the transport consulted on local
    misses and fed on local compiles."""
    global _distributor
    with _lock:
        _distributor = distributor
    return distributor


def shared_filesystem():
    """``MXNET_COMPILE_CACHE_SHARED=1``: every rank's
    ``MXNET_COMPILE_CACHE`` is one shared directory. Entries commit
    through tmp + fsync + rename, so concurrent ranks see a whole entry
    or none; the kvstore channel would only duplicate bytes, and
    :func:`attach_kvstore` is a no-op."""
    from .. import env as _env

    return bool(_env.get("MXNET_COMPILE_CACHE_SHARED"))


def attach_kvstore(kv, prefetch=True):
    """Wire a :class:`.distribute.CacheDistributor` over a kvstore-shaped
    transport (``KVStoreDist`` or a LocalBus endpoint). A no-op returning
    None when the cache is off or in shared-filesystem mode.

    With ``prefetch`` (the default) one ``cc_probe(None)`` round lists
    every entry the rendezvous holds, and the ones missing from this
    rank's store are pulled and committed at once, before the first
    build."""
    if not enabled() or shared_filesystem():
        return None
    from .distribute import CacheDistributor

    dist = set_distributor(CacheDistributor(kv))
    if prefetch:
        dist.prefetch(active_store())
    return dist


def _active_distributor():
    with _lock:
        return _distributor


# -- key ingredients -----------------------------------------------------------

_backend_fp = None


def backend_fingerprint():
    """What this process's stack is: platform, the card's name,
    capability and count, the world size, torch's and its CUDA's
    versions, NVRTC's, nvcc's ``--version`` line and the driver's (None
    where the machine has no such part). Every entry's meta records it.
    Each site's key takes the fields that change its output: nvcc's
    version line (in the library's hash) at ``nvcc``, NVRTC's version
    and the capability at ``nvrtc``. The card's name, its count and the
    world size change no generated code, so another card of the same
    architecture, or a rank of a larger job, hits the same entry."""
    global _backend_fp
    if _backend_fp is None:
        import torch

        from .. import _native, _nvrtc
        from ..parallel import dist as _dist

        card = torch.cuda.is_available()
        _backend_fp = {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0) if card else None,
            "capability": list(torch.cuda.get_device_capability(0))
            if card else None,
            "num_devices": torch.cuda.device_count(),
            "world_size": _dist.num_processes(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvrtc": _optional(_nvrtc.nvrtc_version),
            "nvcc": _optional(_native.nvcc_version),
            "driver": _optional(_nvrtc.driver_version),
        }
    return _backend_fp


def _optional(version):
    """`version()`, or None on a machine without that part of the
    toolkit."""
    try:
        return version()
    except (OSError, RuntimeError):
        return None


# -- the payload of an entry ---------------------------------------------------

def _pack(fields, blob):
    """One JSON line of `fields`, then the binary `blob`."""
    return json.dumps(fields, sort_keys=True).encode("utf-8") + b"\n" + blob


def _unpack(payload):
    """``(fields, blob)`` of :func:`_pack`; ValueError when `payload` is
    not one."""
    head, sep, blob = payload.partition(b"\n")
    fields = json.loads(head.decode("utf-8")) if sep else None
    if not isinstance(fields, dict):
        raise ValueError("not a compile-cache payload of the port")
    return fields, blob


# -- the sites' calls ----------------------------------------------------------

def fetch(site, key):
    """``(fields, blob)`` of entry `key` from the active store, else from
    a peer (committed to the store first, so the next start needs no
    peer), else None: a miss, counted, after which the caller compiles
    and calls :func:`commit`. None without counting when the cache is
    off."""
    store = active_store()
    if store is None:
        return None
    t0 = time.perf_counter()
    source = "local"
    with _trace.span("compile_cache::load", site=site):
        rec = store.get(key)
        if rec is None:
            source = "remote"
            rec = _fetch_remote(site, store, key)
    if rec is not None:
        try:
            fields, blob = _unpack(rec[1])
        except ValueError as exc:
            _errors_total.labels(site=site, kind="corrupt").inc()
            _logger.warning("compile-cache entry %s at site %s does not "
                            "unpack (compiling): %s", key, site, exc)
            store._quarantine(store.path_for(key))
        else:
            _load_seconds.labels(site=site).observe(
                time.perf_counter() - t0)
            _hits_total.labels(site=site, source=source).inc()
            return fields, blob
    _misses_total.labels(site=site).inc()
    return None


def _fetch_remote(site, store, key):
    """A local miss: ask the pod, and commit what it sends."""
    distributor = _active_distributor()
    if distributor is None or not distributor.pulls:
        return None
    try:
        rec = distributor.fetch(key)
    except Exception as exc:    # a transport's failure is not the build's
        _errors_total.labels(site=site, kind="distribute").inc()
        _logger.warning("peer compile-cache fetch failed at site %s "
                        "(compiling locally): %s", site, exc)
        return None
    if rec is None:
        return None
    meta, payload = rec
    try:
        store.put(key, payload, meta)
    except OSError as exc:
        _errors_total.labels(site=site, kind="io").inc()
        _logger.warning("compile cache commit failed at site %s (the "
                        "pulled entry stays in memory): %s", site, exc)
    return meta, payload


def commit(site, key, fields, blob, compile_seconds, meta=None):
    """Commit one freshly compiled entry at `site` (its `fields` and
    binary `blob`), and publish it when this rank publishes. Observed as
    ``mx_compile_seconds{site}`` (an entry that records no compile has
    `compile_seconds` None). A no-op apart from that when the cache is
    off; a failure is counted and logged, never raised: the compiled
    kernel is already in hand."""
    if compile_seconds is not None:
        _ms.observe_compile(site, compile_seconds)
    store = active_store()
    if store is None:
        return
    payload = _pack(fields, blob)
    meta = dict(meta or {}, site=site, backend=backend_fingerprint(),
                created=time.time(), payload_bytes=len(payload))
    if compile_seconds is not None:
        meta["compile_seconds"] = round(compile_seconds, 3)
    try:
        store.put(key, payload, meta)
    except OSError as exc:
        _errors_total.labels(site=site, kind="io").inc()
        _logger.warning("compile cache commit failed at site %s (it "
                        "compiles again next start): %s", site, exc)
        return
    distributor = _active_distributor()
    if distributor is not None and distributor.publishes:
        try:
            distributor.publish(key, meta, payload)
        except Exception as exc:    # a transport's failure is not the build's
            _errors_total.labels(site=site, kind="distribute").inc()
            _logger.warning("compile cache publish failed at site %s "
                            "(peers compile it themselves): %s", site, exc)


# -- the JAX package's jit seam ------------------------------------------------

def _signature(args):
    """Hashable shape/dtype signature of a call: tensors (and NDArrays)
    by shape and dtype, Python scalars by type, containers by their
    items, anything else by repr."""
    if isinstance(args, (list, tuple)):
        return (type(args).__name__,) + tuple(_signature(a) for a in args)
    if isinstance(args, dict):
        return ("dict",) + tuple((k, _signature(args[k]))
                                 for k in sorted(args, key=repr))
    shape = getattr(args, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(args, "dtype", "?")))
    if isinstance(args, (bool, int, float, complex)):
        return ("py", type(args).__name__)
    return ("py", repr(args))


class CachedFunction:
    """The JAX package's cached jit, in the port: `fn` runs eagerly on
    every call, and the signatures it meets are counted
    (:attr:`num_traces`, as ``CachedOp.num_traces``). Nothing is
    compiled, loaded or written."""

    def __init__(self, fn, site):
        self._fn = fn
        self.site = site
        self._signatures = set()

    @property
    def num_traces(self):
        return len(self._signatures)

    def __call__(self, *args):
        self._signatures.add(_signature(args))
        return self._fn(*args)


cached_compile = CachedFunction


def maybe_cached_jit(fn, site):
    """The JAX package's compile seam: a :class:`CachedFunction` when the
    cache is on, else `fn` itself (where the JAX package returns a plain
    ``jax.jit``)."""
    return CachedFunction(fn, site) if enabled() else fn
