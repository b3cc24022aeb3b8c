"""2-bit / 1-bit gradient compression with error feedback.

Counterpart of ``mxnet_tpu/gradient_compression.py`` (reference:
src/kvstore/gradient_compression.h:37-134, Quantize2BitKernel /
Dequantize2BitKernel; the 1-bit codec follows 1-bit SGD, Seide et al.
2014). The codec runs in torch on the gradient's own device; its
numbers are the JAX package's numpy codec's, bit for bit.

For ``2bit`` each element (after the key's residual is added) quantizes
to one of {-threshold, 0, +threshold}: ``>= threshold`` encodes as
positive, ``<= -threshold`` as negative, the rest as zero; for ``1bit``
every element quantizes to ``sign(v) * threshold`` (zero maps to
``-threshold``). The quantization error stays in a per-key residual that
is added to the next gradient (error feedback). Codes pack four 2-bit or
eight 1-bit codes per byte, in the JAX package's byte layout (2-bit:
first code in the low bits; 1-bit: ``np.packbits`` order, first code in
the high bit).

The local stores keep compression params without compressing, as in the
JAX package; ``kvstore_dist.KVStoreDist`` compresses each push (and each
shard of a split key) with its residual, and the server decompresses.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["GradientCompression"]

# code values packed 4-per-byte: 0 = zero, 1 = +threshold, 2 = -threshold
_POS_CODE = 1
_NEG_CODE = 2
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _as_tensor(x):
    from .ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(x))


def _pad_to(flat, multiple):
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


class GradientCompression:
    """The 2-bit / 1-bit codecs plus per-key error-feedback residuals."""

    def __init__(self, params=None):
        params = dict(params or {})
        ctype = params.get("type", "2bit")
        if ctype not in ("2bit", "1bit"):
            raise ValueError("unsupported compression type %r (only '2bit' "
                             "and '1bit'; reference "
                             "gradient_compression.h:62)" % ctype)
        self.type = ctype
        self.threshold = float(params.get("threshold", 0.5))
        if self.threshold <= 0:
            raise ValueError("threshold must be positive")
        self._residual = {}

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    # -- codec ---------------------------------------------------------------

    def compress(self, key, grad):
        """grad (NDArray, tensor or numpy) -> (packed uint8 tensor on the
        gradient's device, meta dict). The residual of `key` is folded in
        first and the new quantization error stored back."""
        grad = _as_tensor(grad).to(torch.float32)
        res = self._residual.get(key)
        v = grad + res if res is not None else grad + 0.0
        pos = torch.tensor(self.threshold, dtype=torch.float32,
                           device=v.device)
        neg = -pos
        meta = {"type": self.type, "shape": tuple(grad.shape),
                "threshold": self.threshold}
        if self.type == "1bit":
            bits = v > 0.0
            self._residual[key] = v - torch.where(bits, pos, neg)
            flat = _pad_to(bits.reshape(-1).to(torch.uint8), 8)
            w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                             device=v.device)
            packed = (flat.reshape(-1, 8) * w).sum(1, dtype=torch.uint8)
            return packed, meta
        codes = torch.zeros(v.shape, dtype=torch.uint8, device=v.device)
        codes[v >= pos] = _POS_CODE
        codes[v <= neg] = _NEG_CODE
        zero = torch.zeros((), dtype=torch.float32, device=v.device)
        decompressed = torch.where(codes == _POS_CODE, pos,
                                   torch.where(codes == _NEG_CODE, neg, zero))
        self._residual[key] = v - decompressed
        quads = _pad_to(codes.reshape(-1), 4).reshape(-1, 4)
        packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                  | (quads[:, 3] << 6))
        return packed, meta

    @staticmethod
    def decompress(packed, meta):
        """(packed bytes or uint8 tensor, meta) -> float32 tensor of the
        quantized values, on the packed tensor's device (host for
        bytes)."""
        if isinstance(packed, (bytes, bytearray)):
            packed = np.frombuffer(bytes(packed), dtype=np.uint8).copy()
        b = _as_tensor(packed).to(torch.uint8)
        t = float(meta["threshold"])
        shape = tuple(meta["shape"])
        n = int(np.prod(shape)) if shape else 1
        pos = torch.tensor(t, dtype=torch.float32, device=b.device)
        if meta.get("type", "2bit") == "1bit":
            w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=b.device)
            bits = ((b.reshape(-1, 1) & w) != 0).reshape(-1)[:n]
            return torch.where(bits, pos, -pos).reshape(shape)
        codes = torch.stack([b & 0x3, (b >> 2) & 0x3, (b >> 4) & 0x3,
                             (b >> 6) & 0x3], dim=1).reshape(-1)[:n]
        zero = torch.zeros((), dtype=torch.float32, device=b.device)
        out = torch.where(codes == _POS_CODE, pos,
                          torch.where(codes == _NEG_CODE, -pos, zero))
        return out.reshape(shape)
