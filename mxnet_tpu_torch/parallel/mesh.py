"""Device mesh: the single-device part.

Counterpart of ``mxnet_tpu/parallel/mesh.py:19-52``. The JAX package
lays arrays out over a ``jax.sharding.Mesh`` of named axes (dp, tp, sp,
ep, pp). This slice of the port runs on one device: a mesh is that
device under named axes of size 1, and ``data_sharding``/``replicate``
are plain placements on it (a ``torch.device``). A mesh over more than
one device, or any axis but ``dp`` larger than 1, raises
``NotImplementedError``: distribution over torch.distributed/NCCL is
ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import math

import torch

from ..context import Context

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicate"]

_QUEUED = ("a mesh over more than one device, or any axis but 'dp' larger "
           "than 1, is not ported yet (ROADMAP Queue 1 item 7: "
           "distribution over torch.distributed/NCCL)")


class Mesh:
    """Named axes over a list of devices (one, in this slice)."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def context(self):
        return self.devices[0]

    @property
    def device(self):
        """The torch device every array of this mesh lives on."""
        return self.devices[0].torch_device

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (self.shape, self.devices)


def _as_context(d):
    if isinstance(d, Context):
        return d
    if isinstance(d, torch.device):
        return Context.of(d)
    raise TypeError("mesh devices are Contexts or torch devices, got %r"
                    % (d,))


def make_mesh(axes=None, devices=None):
    """A Mesh from `axes` = {name: size} (in order) over `devices`
    (default: every CUDA device). Sizes multiply to the device count; a
    -1 size is inferred.

    >>> mesh = make_mesh({"dp": 1}, devices=[mx.gpu(0)])
    """
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
    names = list(axes)
    sizes = [axes[a] for a in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError("cannot infer axis size: %d devices / %s"
                             % (n, axes))
        sizes = [n // known if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError("mesh %s does not cover %d devices"
                         % (dict(zip(names, sizes)), n))
    if n > 1 or any(s > 1 for a, s in zip(names, sizes) if a != "dp"):
        raise NotImplementedError(_QUEUED)
    return Mesh(devices, names, sizes)


def data_sharding(mesh, batch_axes=("dp",)):
    """Placement of a [batch, ...] array: the mesh's device."""
    return mesh.device


def replicate(mesh):
    """Placement of a replicated array: the mesh's device."""
    return mesh.device
