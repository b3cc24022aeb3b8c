"""RecordIO file format — readers/writers and packed image records.

Counterpart of ``mxnet_tpu/recordio.py`` (the lrec framing :33-72,
``MXRecordIO``/``MXIndexedRecordIO`` :89-279, ``pack``/``unpack``/
``pack_img``/``unpack_img`` :281-326), kept byte-identical: a
``.rec``/``.idx`` pair written by either package reads back in the
other. Reference: python/mxnet/recordio.py over dmlc-core's framing::

    record := kMagic(u32) | lrec(u32) | data | pad-to-4-bytes
    lrec   := cflag(3 bits) << 29 | length(29 bits)

cflag handles records spanning chunks: 0 = whole record, 1 = begin,
2 = middle, 3 = end. The C++ chunked scanner/reader
(``csrc/recordio_core.cc``, loaded via
:mod:`mxnet_tpu_torch.recordio_native`) is the high-throughput path for
random-access reads; this module is the authoritative pure-python
implementation and the fallback.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img",
           "read_logical_record", "native_reads_enabled"]

_kMagic = 0xced7230a
_LREC_FLAG_BITS = 29
_LREC_LENGTH_MASK = (1 << _LREC_FLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _LREC_FLAG_BITS) | length


def _decode_lrec(lrec):
    return lrec >> _LREC_FLAG_BITS, lrec & _LREC_LENGTH_MASK


def read_logical_record(f, uri="<stream>"):
    """One logical record (continuation chunks reassembled) from the
    current position of an open binary handle; None at clean EOF. The
    single authoritative python frame walk — MXRecordIO.read and the
    data subsystem's random-access reader both delegate here."""
    parts = []
    while True:
        header = f.read(8)
        if len(header) < 8:
            return b"".join(parts) if parts else None
        magic, lrec = struct.unpack("<II", header)
        if magic != _kMagic:
            raise IOError("Invalid RecordIO magic number in %s" % uri)
        cflag, length = _decode_lrec(lrec)
        data = f.read(length)
        if len(data) < length:
            raise IOError("Truncated record in %s" % uri)
        pad = (4 - length % 4) % 4
        if pad:
            f.read(pad)
        parts.append(data)
        if cflag in (0, 3):  # whole record or final continuation
            return b"".join(parts)


_NATIVE_OK = None


def native_reads_enabled():
    """True when random-access reads should go through the C++ core.
    The ``MXNET_USE_NATIVE_RECORDIO`` escape hatch is re-read on every
    call (tests and fault harnesses flip it mid-process); only the
    expensive availability probe is cached."""
    global _NATIVE_OK
    if os.environ.get("MXNET_USE_NATIVE_RECORDIO", "1") == "0":
        return False
    if _NATIVE_OK is None:
        from . import recordio_native

        _NATIVE_OK = recordio_native.available()
    return _NATIVE_OK


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py:36).

    Parameters
    ----------
    uri : path to the .rec file
    flag : 'r' or 'w'
    """

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            # mxlint: disable=atomic-write -- a streaming writer: records
            # land as write() returns; the reader-side magic framing, not
            # whole-file atomicity, guards a half-written file
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Override pickling behavior (multiprocessing DataLoader workers
        re-open their own handle — reference recordio.py:__getstate__)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d["is_open"]
        self.is_open = False
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        """Re-open after fork (reference: recordio.py:_check_pid; the C++
        runtime's pthread_atfork analogue for python file handles)."""
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("RecordIO handle is not fork-safe; reset() first")

    def close(self):
        if not self.is_open:
            return
        self.record.close()
        self.is_open = False
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append one record."""
        assert self.writable
        self._check_pid(allow_reset=False)
        data = bytes(buf)
        self.record.write(struct.pack("<II", _kMagic,
                                      _encode_lrec(0, len(data))))
        self.record.write(data)
        pad = (4 - len(data) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        """Read next record as bytes, or None at EOF."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        return read_logical_record(self.record, self.uri)

    def tell(self):
        """Current file position (valid as an index key when writing)."""
        return self.record.tell()

    def seek(self, pos):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.record.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a `.idx` sidecar mapping keys → byte offsets for
    random access (reference recordio.py:MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, self.flag)
        if not self.writable and os.path.getsize(self.idx_path):
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        """Seek to the record with key `idx`."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        """Random-access read of record `idx`.

        Uses the C++ core's stateless per-call read when available (the
        data pipeline's shuffled-read hot path: no per-frame Python
        parsing, and inherently fork-safe since each call opens its own
        handle); MXNET_USE_NATIVE_RECORDIO=0 forces the python path.
        Either path leaves the sequential position just past the record
        and rejects closed handles, so behavior is backend-independent."""
        if self._native_reads():
            from . import recordio_native

            assert not self.writable
            # same closed/forked-handle recovery as the python path
            # (seek's _check_pid reopens after close/fork)
            self._check_pid(allow_reset=True)
            data, end = recordio_native.native_read_at(self.uri,
                                                       self.idx[idx])
            self.record.seek(end)     # parity with seek+read
            return data
        self.seek(idx)
        return self.read()

    # Explicit test override: None = defer to the shared module gate.
    _native_ok = None

    def _native_reads(self):
        cls = type(self)
        if cls._native_ok is not None:
            return cls._native_ok and not self.writable
        return native_reads_enabled() and not self.writable

    def write_idx(self, idx, buf):
        """Append record and index it under key `idx`."""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# Header stored in front of packed image records: flag, label (scalar or
# vector), image id, id2 (reference recordio.py:IRHeader, :209).
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack `IRHeader` + payload bytes into one record string
    (reference recordio.py:pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    """Unpack a record into (IRHeader, payload bytes)
    (reference recordio.py:unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """Unpack a record into (IRHeader, decoded image ndarray HWC BGR)
    (reference recordio.py:unpack_img; decode via mx.image)."""
    header, s = unpack(s)
    from .image.image import _imdecode_np

    img = _imdecode_np(np.frombuffer(s, dtype=np.uint8), flag=iscolor,
                       to_rgb=False)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack header + encoded image into one record string
    (reference recordio.py:pack_img). PNG goes through the port's own
    codec; JPEG needs cv2."""
    from .image.image import imencode

    buf = imencode(img, quality=quality, img_fmt=img_fmt)
    return pack(header, buf)
