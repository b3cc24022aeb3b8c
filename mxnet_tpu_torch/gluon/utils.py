"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
python/mxnet/gluon/utils.py): :func:`split_data` and
:func:`split_and_load` (a batch cut along its batch axis, one slice per
context), :func:`clip_global_norm`, :func:`check_sha1` and
:func:`download`, which, as in the JAX package, reads only ``file://``
URLs and files already in place: it never opens a network connection.

Carrying weights across as numpy arrays: gluon names a block's
parameters ``<class><n>_<param>`` with a process-wide counter per class
name, so the same network built in two processes, or after other
networks, gets other numbers (``conv2d20_weight`` against
``conv2d0_weight``). :func:`relative_names` takes those counters out:
after stripping the net's prefix, each counter is replaced by its rank
among the counters of that class name in the same net. Two nets of the
same structure then agree on every relative name, which is what
:func:`params_from_numpy` matches on.
"""
from __future__ import annotations

import hashlib
import math
import os
import re
import shutil
import warnings

import numpy as np
import torch

from ..base import atomic_write
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "relative_names", "params_from_numpy"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis`; the last takes
    the remainder (``even_split=False``), else the size must divide."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d" % (str(data.shape), num_slice, batch_axis))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of `data` on each context of `ctx_list` (the whole batch
    for a single context)."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so that their joint L2 norm is at most
    `max_norm`; returns the norm before scaling (a float). Each array's
    sum of squares is taken on its device in its dtype, as in the JAX
    package; the host adds them in float64 after one read."""
    assert len(arrays) > 0
    device = arrays[0]._data.device
    sums = [torch.sum(a._data.detach() * a._data.detach()).double()
            .to(device) for a in arrays]
    total_norm = math.sqrt(float(torch.stack(sums).sum()))
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn("nan or inf found in gradient norm")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.mul_(scale)
                a.version += 1
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1048576), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The file `url` names, at `path` (a directory or a file name;
    default: the URL's last part here). A file already there is kept
    unless `overwrite` or a `sha1_hash` it fails; ``file://`` URLs are
    copied; any other URL raises, as the package makes no network
    connection."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        with open(url[len("file://"):], "rb") as src, \
                atomic_write(fname) as dst:
            shutil.copyfileobj(src, dst)
        if sha1_hash and not check_sha1(fname, sha1_hash):
            raise ValueError("%s does not match the SHA-1 %s"
                             % (fname, sha1_hash))
        return fname
    raise RuntimeError(
        "download(%s) needs a network connection, which this package does "
        "not make; place the file at %s" % (url, fname))

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
