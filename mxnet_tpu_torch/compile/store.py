"""mxnet_tpu_torch.compile.store — the disk format of the compile cache.

Counterpart of ``mxnet_tpu/compile/store.py``, in the same format, so a
directory written by either package is read by the other's store.

One entry per file, ``cc.<key>.bin``, where ``<key>`` is the hex cache
key (:func:`make_key`). An entry is a one-line JSON header followed by
the raw payload bytes::

    {"format": "mxnet_tpu.compile_cache/1", "key": "...",
     "size": N, "crc": CRC32(payload), "meta": {...}}\\n
    <payload bytes>

This module never interprets the payload: it stores, validates and
retires bytes. In the port the payload is a built kernel library (site
``nvcc``) or an NVRTC cubin (site ``nvrtc``), framed by
:mod:`mxnet_tpu_torch.compile`. The ``meta`` dict is the readable key
anatomy (``python -m mxnet_tpu_torch.tools.compile_cache inspect``
prints it): compile site, the backend fingerprint, compile seconds.

Every commit goes through :func:`telemetry.export.commit_bytes`
(staging file + fsync + one atomic rename, via the checkpoint manager's
``_open_for_write``/``_rename`` seams), so a kill at any byte leaves the
old entry or no entry, never a torn one. Reads validate the format
version, the payload length and the CRC; a damaged entry is quarantined
(unlinked, best-effort) and reported as a miss: the worst corruption
can do is cost one compile.

Retention is LRU by file mtime under a byte budget
(``MXNET_COMPILE_CACHE_MB``); hits re-touch their entry.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib

__all__ = ["CompileCacheStore", "make_key", "entry_name", "ENTRY_FORMAT"]

ENTRY_FORMAT = "mxnet_tpu.compile_cache/1"
_PREFIX = "cc."
_SUFFIX = ".bin"


def make_key(parts):
    """Hex cache key over the canonical JSON of ``parts``: the same hex as
    the JAX package's for the same parts; anything repr-able folds in
    stably."""
    blob = json.dumps(parts, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:32]


def entry_name(key):
    return "%s%s%s" % (_PREFIX, key, _SUFFIX)


def _key_of(filename):
    if filename.startswith(_PREFIX) and filename.endswith(_SUFFIX):
        return filename[len(_PREFIX):-len(_SUFFIX)]
    return None


class CompileCacheStore:
    """Disk-backed entry store.

    Parameters
    ----------
    directory : cache root (created on first ``put``; ``get`` on a
        missing directory is just a miss).
    max_bytes : retention budget for :meth:`gc` (None = unbounded).
    """

    def __init__(self, directory, max_bytes=None):
        self.directory = os.fspath(directory)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()

    # -- paths ----------------------------------------------------------------

    def path_for(self, key):
        return os.path.join(self.directory, entry_name(key))

    def keys(self):
        """Keys of every (not-necessarily-valid) entry on disk."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(k for k in map(_key_of, names) if k)

    # -- read -----------------------------------------------------------------

    def get(self, key, touch=True, quarantine=True):
        """``(meta, payload)`` for a valid entry, else ``None``.

        Validation failures (short file, bad header, length or CRC
        mismatch, format-version skew, a header whose stored key is not
        the requested one: a misplaced or renamed file must never serve
        the wrong library) quarantine the entry and return None —
        the caller counts a miss and recompiles. Read-only callers (the
        inspect CLI) pass ``quarantine=False`` to diagnose without
        destroying the evidence. ``touch`` refreshes mtime so LRU
        retention tracks use, not creation."""
        path = self.path_for(key)
        try:
            with open(path, "rb") as f:
                header_line = f.readline(1 << 20)
                if not header_line.endswith(b"\n"):
                    raise ValueError("unterminated header")
                header = json.loads(header_line)
                if header.get("format") != ENTRY_FORMAT:
                    raise ValueError("format skew: %r"
                                     % (header.get("format"),))
                if header.get("key") != key:
                    raise ValueError("key mismatch: header says %r"
                                     % (header.get("key"),))
                payload = f.read()
        except OSError:
            return None                     # absent: plain miss
        except (ValueError, KeyError, TypeError):
            if quarantine:
                self._quarantine(path)
            return None
        if len(payload) != int(header.get("size", -1)) or \
                zlib.crc32(payload) != int(header.get("crc", -1)):
            if quarantine:
                self._quarantine(path)
            return None
        if touch:
            try:
                os.utime(path, None)
            except OSError:
                pass
        return header.get("meta", {}), payload

    def _quarantine(self, path):
        """A damaged entry must not poison every later start: unlink it
        (best-effort) so the next commit replaces it cleanly."""
        try:
            os.remove(path)
        except OSError:
            pass

    # -- write ----------------------------------------------------------------

    def put(self, key, payload, meta=None):
        """Atomically commit one entry (checkpoint tmp+fsync+rename
        protocol via export.commit_bytes). Raises OSError on commit
        failure — the target is untouched and the staging file removed,
        so a killed or failed commit can never leave a torn entry."""
        from ..telemetry import export as _export

        os.makedirs(self.directory, exist_ok=True)
        header = json.dumps(
            {"format": ENTRY_FORMAT, "key": key, "size": len(payload),
             "crc": zlib.crc32(payload), "meta": meta or {}},
            sort_keys=True, default=repr).encode("utf-8")
        path = self.path_for(key)
        _export.commit_bytes(path, header + b"\n" + payload)
        if self.max_bytes is not None:
            self.gc(self.max_bytes)
        return path

    # -- maintenance ----------------------------------------------------------

    def entries(self):
        """``[(key, path, bytes, mtime)]`` for every entry file."""
        out = []
        for key in self.keys():
            path = self.path_for(key)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((key, path, st.st_size, st.st_mtime))
        return out

    def total_bytes(self):
        return sum(e[2] for e in self.entries())

    def gc(self, max_bytes=None):
        """Retire oldest-by-mtime entries until the store fits
        ``max_bytes``. Returns the paths removed."""
        budget = self.max_bytes if max_bytes is None else max_bytes
        if budget is None:
            return []
        removed = []
        with self._lock:
            entries = sorted(self.entries(), key=lambda e: e[3])
            total = sum(e[2] for e in entries)
            for key, path, size, _ in entries:
                if total <= budget:
                    break
                try:
                    os.remove(path)
                except OSError:
                    continue
                total -= size
                removed.append(path)
        return removed

    def verify(self, remove=False):
        """Validate every entry; returns ``(ok_keys, bad_keys)``.
        ``remove=True`` quarantines the bad ones (the CLI's repair
        mode); ``remove=False`` leaves them for inspection."""
        ok, bad = [], []
        for key in self.keys():
            path = self.path_for(key)
            # get() quarantines on damage; probe without that side
            # effect unless asked.
            try:
                with open(path, "rb") as f:
                    header_line = f.readline(1 << 20)
                    header = json.loads(header_line)
                    payload = f.read()
                valid = (header_line.endswith(b"\n")
                         and header.get("format") == ENTRY_FORMAT
                         and header.get("key") == key
                         and len(payload) == int(header.get("size", -1))
                         and zlib.crc32(payload) == int(
                             header.get("crc", -1)))
            except (OSError, ValueError, KeyError, TypeError):
                valid = False
            if valid:
                ok.append(key)
            else:
                bad.append(key)
                if remove:
                    self._quarantine(path)
        return ok, bad
