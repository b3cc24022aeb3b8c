"""Gluon utilities: carrying weights across as numpy arrays.

Gluon names a block's parameters ``<class><n>_<param>`` with a
process-wide counter per class name, so the same network built in two
processes, or after other networks, gets other numbers
(``conv2d20_weight`` against ``conv2d0_weight``). :func:`relative_names`
takes those counters out: after stripping the net's prefix, each
counter is replaced by its rank among the counters of that class name
in the same net. Two nets of the same structure then agree on every
relative name, which is what :func:`params_from_numpy` matches on.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["relative_names", "params_from_numpy"]

_COUNTED = re.compile(r"^(?P<hint>.*?)(?P<n>\d+)_(?P<rest>.+)$")


def relative_names(names, prefix=""):
    """{name: relative name} for a net's parameter names."""
    stripped = {n: n[len(prefix):] if prefix and n.startswith(prefix) else n
                for n in names}
    counters = {}
    for s in stripped.values():
        m = _COUNTED.match(s)
        if m:
            counters.setdefault(m["hint"], set()).add(int(m["n"]))
    rank = {hint: {c: i for i, c in enumerate(sorted(cs))}
            for hint, cs in counters.items()}
    out = {}
    for name, s in stripped.items():
        m = _COUNTED.match(s)
        out[name] = ("%s%d_%s" % (m["hint"], rank[m["hint"]][int(m["n"])],
                                  m["rest"]) if m else s)
    return out


def params_from_numpy(net, arrays, prefix=None):
    """Set every parameter of `net` from `arrays`, a ``{name: ndarray}``
    of another net of the same structure (for example the JAX package's
    net, ``{p.name: p.data().asnumpy()}``).

    `prefix` is the source net's prefix, stripped from the keys of
    `arrays`; the port net's own prefix is stripped from its names; both
    sides are then matched by :func:`relative_names`. Raises ValueError
    on a missing key, an extra key or a shape mismatch.
    """
    params = net.collect_params()
    mine = relative_names(list(params.keys()), net.prefix)
    theirs = relative_names(list(arrays.keys()), prefix or "")
    by_rel = {}
    for name, rel in theirs.items():
        if rel in by_rel:
            raise ValueError("source names %r and %r collide as %r"
                             % (by_rel[rel], name, rel))
        by_rel[rel] = name
    wanted = set(mine.values())
    missing = sorted(wanted - set(by_rel))
    extra = sorted(set(by_rel) - wanted)
    if missing or extra:
        raise ValueError("parameter sets differ: missing %s, extra %s"
                         % (missing, extra))
    for name, p in params.items():
        value = np.asarray(arrays[by_rel[mine[name]]])
        shape = tuple(p.shape) if p.shape is not None else None
        if shape is not None and (
                len(shape) != value.ndim
                or any(s > 0 and s != t for s, t in zip(shape, value.shape))):
            raise ValueError("shape mismatch for %s: net has %s, source "
                             "%s has %s" % (name, shape, by_rel[mine[name]],
                                            value.shape))
        p.set_data(value)
