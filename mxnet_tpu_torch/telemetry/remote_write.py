"""mxnet_tpu_torch.telemetry.remote_write — the Prometheus remote-write wire
format, dependency-free.

A copy of ``mxnet_tpu/telemetry/remote_write.py``, which imports no JAX.

The :class:`~mxnet_tpu_torch.telemetry.export.PushExporter` speaks the
classic push-gateway text exposition; modern fleets instead ingest
**remote write** (Prometheus, Mimir, Thanos Receive, VictoriaMetrics,
Grafana Cloud): a snappy-compressed protobuf ``WriteRequest`` POSTed to
``/api/v1/write``. This module encodes that wire format in pure Python
— no protobuf runtime, no C snappy — so the exporter can feed any of
those backends from the container images this framework actually ships
in.

Two deliberately-minimal codecs:

* **Protobuf.** Only the four message shapes remote write 1.0 needs
  (``WriteRequest`` → ``TimeSeries`` → ``Label`` / ``Sample``), emitted
  with hand-rolled varint/length-delimited framing. Field numbers and
  wire types are fixed by the public ``prometheus/prompb`` schema:

  .. code-block:: proto

      message WriteRequest { repeated TimeSeries timeseries = 1; }
      message TimeSeries   { repeated Label  labels  = 1;
                             repeated Sample samples = 2; }
      message Label        { string name = 1; string value = 2; }
      message Sample       { double value = 1; int64 timestamp = 2; }

* **Snappy.** The spec REQUIRES snappy block compression. When the
  ``snappy`` package is importable we use it; otherwise
  :func:`snappy_compress` emits a **valid snappy stream of literal
  chunks** — framing without backreferences. Every conformant
  decompressor accepts it (snappy's format makes "stored" a first-class
  encoding, exactly like gzip's stored blocks); the only cost is zero
  compression ratio, which for KB-scale registry snapshots is noise.

Series derivation follows the text exposition exactly: one series per
counter/gauge child, and per histogram child the cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count`` — so recording
rules and dashboards written against a scraped ``/metrics`` work
unchanged against the pushed stream. Every series carries ``__name__``
first and labels sorted by name (the prompb canonical order; also what
the golden-bytes unit test pins).
"""
from __future__ import annotations

import math
import struct

from . import metrics as _metrics

__all__ = ["encode_write_request", "registry_series", "snappy_compress",
           "CONTENT_HEADERS"]

# Headers a remote-write POST must carry (remote write 1.0).
CONTENT_HEADERS = {
    "Content-Type": "application/x-protobuf",
    "Content-Encoding": "snappy",
    "X-Prometheus-Remote-Write-Version": "0.1.0",
}


# -- protobuf primitives -------------------------------------------------------

def _varint(n):
    n = int(n)
    if n < 0:
        # int64 negatives are 10-byte two's-complement varints; only
        # timestamps use int64 here and they are epoch millis, but the
        # encoder stays correct for completeness.
        n += 1 << 64
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field, wire_type):
    return _varint((field << 3) | wire_type)


def _len_delimited(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field, value):
    return _key(field, 1) + struct.pack("<d", float(value))


def _int64(field, value):
    return _key(field, 0) + _varint(value)


def _label(name, value):
    return (_len_delimited(1, str(name).encode("utf-8"))
            + _len_delimited(2, str(value).encode("utf-8")))


def _sample(value, timestamp_ms):
    return _double(1, value) + _int64(2, int(timestamp_ms))


def _timeseries(labels, value, timestamp_ms):
    """``labels`` is an ordered [(name, value)] INCLUDING __name__."""
    body = b"".join(_len_delimited(1, _label(n, v)) for n, v in labels)
    body += _len_delimited(2, _sample(value, timestamp_ms))
    return body


# -- series derivation ---------------------------------------------------------

def _ordered_labels(metric_name, labelnames, labelvalues, extra):
    """prompb canonical label order: __name__ first, the rest sorted by
    label name. ``extra`` (job/instance) merges in, never overriding a
    series' own label."""
    merged = dict(extra or {})
    merged.update(zip(labelnames, labelvalues))
    return [("__name__", metric_name)] + sorted(merged.items())


def registry_series(registry, extra_labels=None):
    """Yield ``(ordered_labels, value)`` for every series a registry
    exposes — counters and gauges one series each, histograms the
    cumulative ``_bucket``/``_sum``/``_count`` expansion (same series
    set as ``render_prometheus``)."""
    for fam in registry.collect():
        if fam.kind in ("counter", "gauge"):
            for values, child in fam.collect():
                yield (_ordered_labels(fam.name, fam.labelnames, values,
                                       extra_labels), child.value)
        elif fam.kind == "histogram":
            for values, child in fam.collect():
                snap = child.snapshot()
                for bound, cum in snap["buckets"]:
                    # _fmt, not repr: le="1" must match the scraped
                    # text exposition's series identity exactly, or
                    # recording rules silently split across the two
                    # ingest paths.
                    le = "+Inf" if math.isinf(bound) \
                        else _metrics._fmt(bound)
                    yield (_ordered_labels(
                        fam.name + "_bucket",
                        fam.labelnames + ("le",), values + (le,),
                        extra_labels), cum)
                yield (_ordered_labels(fam.name + "_sum",
                                       fam.labelnames, values,
                                       extra_labels), snap["sum"])
                yield (_ordered_labels(fam.name + "_count",
                                       fam.labelnames, values,
                                       extra_labels), snap["count"])


def encode_write_request(registry, timestamp_ms, extra_labels=None,
                         compress=True):
    """Serialize a registry into one remote-write body: the protobuf
    ``WriteRequest`` over :func:`registry_series`, snappy-compressed
    (pass ``compress=False`` for the raw protobuf — what the golden
    tests pin). Every sample carries ``timestamp_ms``."""
    body = b"".join(
        _len_delimited(1, _timeseries(labels, value, timestamp_ms))
        for labels, value in registry_series(registry, extra_labels))
    return snappy_compress(body) if compress else body


# -- snappy ---------------------------------------------------------------------

# A literal chunk's tag byte: low bits 00, upper 6 bits the length-1
# when <= 60; 60..63 select a 1-4 byte little-endian length-1 suffix.
_MAX_LITERAL = (1 << 32) - 1


def _literal(chunk):
    n = len(chunk)
    if n <= 60:
        return bytes([(n - 1) << 2]) + chunk
    for extra, tag in ((1, 60), (2, 61), (3, 62), (4, 63)):
        if n - 1 < 1 << (8 * extra):
            return (bytes([tag << 2])
                    + (n - 1).to_bytes(extra, "little") + chunk)
    raise ValueError("literal too long for snappy: %d" % n)


def snappy_compress(data):
    """Snappy-frame ``data``. Real compression when the ``snappy``
    package is importable; otherwise a valid all-literal stream
    (uncompressed length varint + literal chunks) that every snappy
    decompressor accepts — correctness without the C dependency."""
    try:
        import snappy as _snappy

        return _snappy.compress(data)
    except ImportError:
        pass
    out = [_varint(len(data))]
    for start in range(0, len(data), _MAX_LITERAL):
        out.append(_literal(data[start:start + _MAX_LITERAL]))
    if not data:
        # Empty input: just the zero length varint.
        return out[0]
    return b"".join(out)
