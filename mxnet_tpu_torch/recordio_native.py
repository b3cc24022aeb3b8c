"""ctypes loader for the native RecordIO core (``csrc/recordio_core.cc``).

Counterpart of ``mxnet_tpu/recordio_native.py:1-143``. The C++
scanner/reader is the data pipeline's high-throughput path: a
whole-file index scan and random-access record reads with no Python
per-frame overhead. The port keeps its own copy of the source under
``csrc/`` and builds it with ``g++`` at first use into ``_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags
as ``_native.py`` names the CUDA libraries. The build writes a private
temporary file and renames it into place, so concurrent processes
(DataLoader workers, parallel test runs) never load a half-written
library. Where the toolchain or the build is unavailable every entry
point degrades to the pure-python implementation in
:mod:`mxnet_tpu_torch.recordio` — the wire format is identical.

``READS`` and ``INDEXES`` count the native calls made in this process
(a run that must prove the native reader ran reads them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["available", "native_index", "native_read_at", "library_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "recordio_core.cc")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_tried = False

READS = 0
INDEXES = 0

_ERRORS = {-1: "cannot open file", -2: "invalid RecordIO magic",
           -3: "truncated record", -4: "capacity exceeded"}


def library_path():
    """Path of the built library for this source and these flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD, "recordio_core-%s.so"
                        % digest.hexdigest()[:16])


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(_BUILD, exist_ok=True)
                # Build to a private temp path, then rename atomically:
                # the per-process lock cannot serialize across processes.
                tmp = "%s.build.%d" % (so, os.getpid())
                try:
                    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                                   check=True, capture_output=True,
                                   timeout=120)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(so)
            # Binding stays inside the try: a library missing a symbol
            # degrades to the python path instead of raising.
            lib.rio_index.restype = ctypes.c_longlong
            lib.rio_index.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_ulonglong),
                ctypes.c_ulonglong]
            lib.rio_read_at.restype = ctypes.c_int
            lib.rio_read_at.argtypes = [
                ctypes.c_char_p, ctypes.c_ulonglong,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_ulonglong,
                ctypes.POINTER(ctypes.c_ulonglong),
                ctypes.POINTER(ctypes.c_ulonglong)]
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None
        _lib = lib
        return _lib


def available():
    """True when the native core is built and loadable."""
    return _load() is not None


def _check(rc, path):
    if rc < 0:
        raise IOError("%s: %s" % (_ERRORS.get(rc, "error %d" % rc), path))


def native_index(path):
    """Offsets of every logical record in a .rec file (native scan).
    Returns a list of byte offsets; raises IOError on corrupt files."""
    global INDEXES
    lib = _load()
    if lib is None:
        raise RuntimeError("native recordio core unavailable")
    path_b = os.fsencode(os.fspath(path))
    # One pass with a bounded buffer (size // 8 bounds the record count,
    # capped so a huge .rec does not cost its size in RAM); an exact
    # count-then-fill double scan only when that cap overflows.
    cap = max(1, min(os.path.getsize(path) // 8, 1 << 24))
    arr = (ctypes.c_ulonglong * cap)()
    n = lib.rio_index(path_b, arr, cap)
    if n == -4:
        n = lib.rio_index(path_b, None, 0)
        _check(n, path)
        arr = (ctypes.c_ulonglong * n)()
        n = lib.rio_index(path_b, arr, n)
    _check(n, path)
    with _count_lock:
        INDEXES += 1
    return list(arr[:n])


_tls = threading.local()


def _scratch(cap):
    """Reusable per-thread read buffer (a fresh ctypes buffer is
    zero-filled on every call)."""
    buf = getattr(_tls, "buf", None)
    if buf is None or len(buf) < cap:
        buf = (ctypes.c_ubyte * cap)()
        _tls.buf = buf
    return buf


def native_read_at(path, offset):
    """One logical record (continuation chunks reassembled) starting at
    `offset`. Returns (bytes, end_offset), end_offset being the file
    position just past the record."""
    global READS
    lib = _load()
    if lib is None:
        raise RuntimeError("native recordio core unavailable")
    path_b = os.fsencode(os.fspath(path))
    # A capacity miss still reports the exact length: one retry suffices.
    length = ctypes.c_ulonglong()
    end = ctypes.c_ulonglong()
    buf = _scratch(1 << 20)
    rc = lib.rio_read_at(path_b, offset, buf, len(buf),
                         ctypes.byref(length), ctypes.byref(end))
    if rc == -4:
        buf = _scratch(length.value)
        rc = lib.rio_read_at(path_b, offset, buf, len(buf),
                             ctypes.byref(length), ctypes.byref(end))
    _check(rc, path)
    with _count_lock:
        READS += 1
    # string_at copies in C; bytes(buf[:n]) would build a list of n ints
    # first (6 ms for a 196 KB record).
    return ctypes.string_at(buf, length.value), end.value
