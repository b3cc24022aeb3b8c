"""A one-layer causal self-attention block, built from the public API.

It is the attention layer that ``chip_smoke.py`` trains and
``profile_training`` profiles: ``Dense(3 * units)`` -> q, k, v of shape
(batch, heads, seq, units // heads) -> causal ``F.contrib.flash_attention``
-> heads merged -> ``Dense(units)``. Under ``TrainStep`` it runs the
forward attention kernel and both backward kernels once per step.
"""
from __future__ import annotations

from .. import gluon
from ..gluon import nn

__all__ = ["SelfAttention"]


class SelfAttention(gluon.HybridBlock):
    """Causal multi-head self-attention over (batch, seq, units)."""

    def __init__(self, units=1024, heads=16, **kwargs):
        super().__init__(**kwargs)
        if units % heads:
            raise ValueError("units %d must divide by heads %d"
                             % (units, heads))
        self._heads = heads
        self.qkv = nn.Dense(3 * units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)

    def hybrid_forward(self, F, x):
        b, t, c = x.shape
        h = self._heads
        qkv = self.qkv(x).reshape((b, t, 3, h, c // h)) \
            .transpose((2, 0, 3, 1, 4))
        out = F.contrib.flash_attention(qkv[0], qkv[1], qkv[2], causal=True)
        return self.proj(out.transpose((0, 2, 1, 3)).reshape((b, t, c)))
