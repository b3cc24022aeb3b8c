"""A PNG codec on ``zlib`` and numpy, so the port decodes PNG without
OpenCV.

The JAX package decodes and encodes only through cv2
(``mxnet_tpu/image/image.py:36-103``); a machine without OpenCV (or PIL)
still needs to read the PNG records a ``.rec`` holds. This codec reads
8-bit PNGs of colour types 0 (gray), 2 (RGB), 4 (gray + alpha) and 6
(RGBA), non-interlaced, with all five row filters, and writes gray, BGR
and BGRA images with filter 0. It returns exactly what ``cv2.imdecode``
returns for the same bytes (BGR channel order, the same flag
semantics), which the tests hold bit for bit where cv2 is installed:

* ``flag=1`` (colour): HxWx3 BGR; gray is replicated, alpha dropped;
* ``flag=0`` (grayscale): HxW; colour goes through libpng's fixed-point
  ``rgb_to_gray`` with the coefficients OpenCV asks for (0.299, 0.587),
  which come out as 9797/19234/3737 over 2^15, truncated, and a pixel
  whose three channels are equal keeps its value;
* ``flag=-1`` (unchanged): gray stays HxW, colour is BGR or BGRA.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["is_png", "decode", "encode"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_GRAY_COEFFS = (9797, 19234, 3737)      # R, G, B over 2^15, truncated


def is_png(buf):
    return bytes(buf[:8]) == _SIGNATURE


def _chunks(data):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError("Decoding failed: truncated PNG chunk %r"
                             % kind)
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("Decoding failed: PNG has no IEND chunk")


def _paeth_row(line, prev, bpp):
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return out


def _average_row(line, prev, bpp):
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x + ((a + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw, height, stride, bpp):
    """(height, stride) uint8 pixels from the filtered scanlines."""
    rows = np.frombuffer(raw, dtype=np.uint8)
    if rows.size < height * (stride + 1):
        raise ValueError("Decoding failed: PNG image data is truncated")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    filters = rows[:, 0]
    if not filters.any():
        return rows[:, 1:].copy()
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        line = rows[y, 1:]
        kind = int(filters[y])
        if kind == 0:
            cur = line
        elif kind == 1:        # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:        # Up
            cur = line + prev
        elif kind == 3:        # Average
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(),
                                             bpp), dtype=np.uint8)
        elif kind == 4:        # Paeth
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(),
                                           bpp), dtype=np.uint8)
        else:
            raise ValueError("Decoding failed: PNG row filter %d" % kind)
        out[y] = cur
        prev = out[y]
    return out


def _read(data):
    """(pixels HxWxC in file order, colour type)."""
    if not is_png(data):
        raise ValueError("Decoding failed: not a PNG stream")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("Decoding failed: PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            "PNG of bit depth %d, colour type %d, interlace %d: the port's "
            "codec reads 8-bit gray, gray+alpha, RGB and RGBA, "
            "non-interlaced; decoding others needs cv2" % (depth, ctype,
                                                           interlace))
    channels = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    pixels = _unfilter(raw, height, width * channels, channels)
    return pixels.reshape(height, width, channels), ctype


def _to_gray(rgb):
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    rc, gc, bc = _GRAY_COEFFS
    gray = ((rc * r + gc * g + bc * b) >> 15).astype(np.uint8)
    same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    return np.where(same, rgb[..., 0], gray)


def decode(buf, flag=1, rgb=False):
    """Decode PNG bytes as ``cv2.imdecode(buf, flag)`` does (BGR order);
    ``rgb=True`` with ``flag=1`` gives the file's RGB order instead, as
    cv2's decode followed by ``COLOR_BGR2RGB`` would, in one pass."""
    pixels, ctype = _read(bytes(buf))
    flag = int(flag)
    if rgb and flag > 0:
        if ctype in (0, 4):
            return np.repeat(pixels[..., :1], 3, axis=-1)
        return np.ascontiguousarray(pixels[..., :3])
    if flag == 0:
        if ctype in (0, 4):
            return pixels[..., 0].copy()
        return _to_gray(pixels[..., :3])
    if flag < 0:
        if ctype == 0:
            return pixels[..., 0].copy()
        if ctype == 4:
            gray = pixels[..., 0]
            return np.stack([gray, gray, gray, pixels[..., 1]], axis=-1)
        if ctype == 2:
            return pixels[..., ::-1].copy()
        return pixels[..., [2, 1, 0, 3]].copy()
    if ctype in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., 2::-1].copy()


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img, level=1):
    """PNG bytes of an 8-bit gray (HxW, HxWx1), BGR (HxWx3) or BGRA
    (HxWx4) image, as ``cv2.imencode(".png", img)`` takes it; rows use
    filter 0, the stream zlib level ``level``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise NotImplementedError(
            "PNG encode of %s: the port's codec writes 8-bit images"
            % img.dtype)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, pixels = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, pixels = 2, img[..., ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        ctype, pixels = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError("Encoding failed: image of shape %s"
                         % (img.shape,))
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(pixels).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return b"".join([_SIGNATURE, _chunk(b"IHDR", header),
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)),
                     _chunk(b"IEND", b"")])
