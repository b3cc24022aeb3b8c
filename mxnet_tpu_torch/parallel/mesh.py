"""Device mesh: named axes over one device, or over the ranks of a group.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` of named axes (dp, tp, sp, ep, pp) over every
device of its program. The port runs one device per process, so a mesh
is one of two things:

- over one device (``make_mesh({"dp": 1}, devices=[ctx])``, or any
  ``make_mesh`` without a process group): every axis of size 1, and
  ``data_sharding``/``replicate`` are plain placements on that device;
- over the ranks of the ``parallel.dist`` group (``make_mesh(axes)``
  once ``dist.initialize`` formed one): rank ``r`` sits at the
  row-major coordinate of ``r`` in the axes' shape, its device is the
  rank's own, and :meth:`Mesh.group` gives the subgroup of the ranks
  that share every other coordinate with this one (the ``dp`` ranks,
  the ``sp`` ranks, ...). Every axis's subgroups are created once, by
  every rank, when the mesh is made (``torch.distributed.new_group``
  is collective).

``shard_params`` and ``P`` keep the JAX package's Megatron rule
(``mesh.py:55-74`` there) as placement specs: a tuple of axis names (or
None) per dimension. Placing a ``tp``-sharded weight, and a TrainStep
over a mesh whose ``tp`` axis is larger than 1, are ROADMAP Queue 1
item 7b.
"""
from __future__ import annotations

import math

import torch

from ..context import Context
from . import dist as _dist

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate",
           "shard_params", "P", "NamedSharding"]


class P(tuple):
    """A placement spec: one entry per dimension, an axis name (the
    dimension is split over that mesh axis) or None (replicated); the
    JAX package's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(p) for p in self)


class NamedSharding:
    """A spec bound to its mesh (the JAX package's ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh.shape, self.spec)


class Mesh:
    """Named axes over a list of devices (one device), or over the
    ranks of the process group (``ranks`` given)."""

    def __init__(self, devices, axis_names, sizes, ranks=None):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.ranks = None if ranks is None else list(ranks)
        self._groups = {}

    @property
    def over_ranks(self):
        """True for a mesh over the ranks of a process group."""
        return self.ranks is not None

    @property
    def context(self):
        """This process's device."""
        return self.devices[0]

    @property
    def device(self):
        """The torch device this process's arrays of the mesh live on."""
        return self.devices[0].torch_device

    def coords(self, rank=None):
        """{axis: index} of `rank` (default: this process's)."""
        r = _dist.rank() if rank is None else rank
        if self.ranks is not None:
            r = self.ranks.index(r)
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, name):
        """This process's index along axis `name` (0 for an absent
        axis)."""
        return self.coords().get(name, 0) if name in self.shape else 0

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def axis_ranks(self, name, rank=None):
        """The ranks that share every coordinate but `name` with `rank`,
        in the order of their index along `name`."""
        c = self.coords(rank)
        out = []
        for i in range(self.shape[name]):
            c[name] = i
            flat = 0
            for n in self.axis_names:
                flat = flat * self.shape[n] + c[n]
            out.append(self.ranks[flat] if self.ranks is not None else flat)
        return out

    def group(self, name=None):
        """The process group of axis `name` containing this rank (the
        mesh's whole group for ``name=None``); None on a one-device
        mesh."""
        if self.ranks is None:
            return None
        return self._groups[name]

    def __repr__(self):
        if self.ranks is not None:
            return "Mesh(%s, ranks=%s)" % (self.shape, self.ranks)
        return "Mesh(%s, devices=%s)" % (self.shape, self.devices)


def _as_context(d):
    if isinstance(d, Context):
        return d
    if isinstance(d, torch.device):
        return Context.of(d)
    raise TypeError("mesh devices are Contexts or torch devices, got %r"
                    % (d,))


def _sizes(axes, n, what):
    names = list(axes)
    sizes = [axes[a] for a in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError("cannot infer axis size: %d %s / %s"
                             % (n, what, axes))
        sizes = [n // known if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError("mesh %s does not cover %d %s"
                         % (dict(zip(names, sizes)), n, what))
    return names, sizes


def _rank_mesh(axes):
    import torch.distributed as tdist

    n = _dist.num_processes()
    if axes is None:
        axes = {"dp": n}
    names, sizes = _sizes(axes, n, "ranks")
    mesh = Mesh([_dist.local_context()], names, sizes, ranks=range(n))
    me = _dist.rank()
    mesh._groups[None] = tdist.group.WORLD
    # new_group is collective: every rank creates every subgroup, in the
    # same order, and keeps the ones it belongs to.
    for name in names:
        seen = set()
        for r in range(n):
            members = tuple(mesh.axis_ranks(name, r))
            if members in seen:
                continue
            seen.add(members)
            if len(members) == n:
                g = tdist.group.WORLD
            else:
                g = tdist.new_group(list(members))
            if me in members:
                mesh._groups[name] = g
    return mesh


def make_mesh(axes=None, devices=None):
    """A Mesh from `axes` = {name: size} (in order). Sizes multiply to
    the device (or rank) count; a -1 size is inferred.

    With `devices` given, or without a process group, the mesh lies
    over those devices (default: the CUDA devices), and only one device
    is supported. After ``parallel.dist.initialize`` formed a group and
    with no `devices`, the mesh lies over the group's ranks.

    >>> mesh = make_mesh({"dp": 1}, devices=[mx.gpu(0)])
    >>> mesh = make_mesh({"dp": -1})          # every rank of the group
    >>> mesh = make_mesh({"dp": 2, "sp": 2})  # 4 ranks
    """
    if devices is None and _dist.is_initialized():
        return _rank_mesh(axes)
    if devices is None:
        n_gpu = torch.cuda.device_count()
        if n_gpu == 0:
            raise RuntimeError(
                "make_mesh() with no devices needs a CUDA device; pass "
                "devices=[mx.cpu()] to build a mesh on the host")
        devices = [Context("gpu", i) for i in range(n_gpu)]
    devices = [_as_context(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names, sizes = _sizes(axes, n, "devices")
    if n > 1:
        raise NotImplementedError(
            "a mesh over %d devices of one process: the port runs one "
            "device per process; start one process per device "
            "(parallel.launch) and call make_mesh after "
            "parallel.dist.initialize()" % n)
    return Mesh(devices, names, sizes)


def data_sharding(mesh, batch_axes=("dp",)):
    """Placement of a [batch, ...] array: on a one-device mesh, the
    mesh's device; over ranks, the batch split over the data axes
    present (each rank holds its rows on its own device)."""
    if not mesh.over_ranks:
        return mesh.device
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    return NamedSharding(mesh, P(axes if axes else None))


def replicate(mesh):
    """Placement of a replicated array."""
    if not mesh.over_ranks:
        return mesh.device
    return NamedSharding(mesh, P())


def _default_param_rule(name, shape, mesh):
    """Megatron-style tensor parallelism for 2D weights when a tp axis
    exists: shard the output-features dim of large matmuls; replicate
    everything else. Biases and BatchNorm stay replicated."""
    if "tp" not in mesh.axis_names or mesh.shape["tp"] == 1:
        return P()
    tp = mesh.shape["tp"]
    if len(shape) == 2 and shape[0] % tp == 0 and min(shape) >= 2 * tp:
        return P("tp", None)
    if len(shape) == 4 and shape[0] % tp == 0 and shape[0] >= 4 * tp:
        return P("tp", None, None, None)  # conv out-channels
    return P()


def shard_params(mesh, named_shapes, rule=None):
    """Map {name: shape} -> {name: NamedSharding} with `rule(name, shape,
    mesh) -> P` (default: the Megatron-style tp rule)."""
    rule = rule or _default_param_rule
    return {name: NamedSharding(mesh, rule(name, shape, mesh))
            for name, shape in named_shapes.items()}
