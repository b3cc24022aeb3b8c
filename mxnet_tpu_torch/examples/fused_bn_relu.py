"""A subgraph backend that fuses BatchNorm (inference) and ReLU.

``FusedBNReLU`` selects ``Activation(act_type="relu")`` and grows into
its BatchNorm producer; each such pair becomes one ``_subgraph`` node
whose function is :func:`bn_relu`. On CUDA tensors that launches the
CUDA C kernel of ``csrc/rtc/fused_bn_relu.cu``, compiled at runtime
through ``rtc.CudaModule``; on host tensors it runs the plain PyTorch
version. The property is ``inference_only``: BatchNorm's moving
statistics enter the fragment as plain inputs and are never written.

Registered under ``BACKEND`` at import, so a graph is partitioned by
``subgraph.partition(sym, BACKEND)``, or at bind with::

    import os
    import mxnet_tpu_torch.examples.fused_bn_relu  # registers the backend
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "fused_bn_relu"

The fused function reads ``eps``, ``fix_gamma`` and ``axis`` from the
fragment's BatchNorm node (the op's defaults are eps 1e-3 and
fix_gamma True; gluon's ``BatchNorm(scale=True)`` writes
fix_gamma=False) and maps its inputs by name, not position. Where the
BatchNorm output is also read outside the pair, the fragment has two
outputs and :func:`bn_and_relu` writes both in one launch.

In ResNet-50 v1 this makes 33 fragments (the stem and two in each of
the 16 bottlenecks); the residual ``add -> relu`` is a single member and
stays as it is.
"""
from __future__ import annotations

import math
import os
import threading

import torch

from .. import rtc, subgraph
from .rtc_kernels import launch_1d

__all__ = ["BACKEND", "SOURCE", "LAUNCHES", "FusedBNReLU", "bn_relu",
           "bn_relu_reference", "bn_and_relu", "bn_and_relu_reference"]

BACKEND = "fused_bn_relu"
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "rtc", "fused_bn_relu.cu")
_ARGS = ("const float *x, const float *gamma, const float *beta, "
         "const float *mean, const float *var, ")
_SCALARS = "int64_t n, int32_t channels, int64_t inner, float eps, " \
    "int32_t fix_gamma"
SIGNATURES = {
    "bn_relu_forward": _ARGS + "float *y, " + _SCALARS,
    "bn_relu_forward_both": _ARGS + "float *z, float *y, " + _SCALARS}

# Launches of the fused kernels by bn_relu and bn_and_relu since import.
LAUNCHES = 0

_lock = threading.Lock()
_kernels = {}


def _get_kernel(name="bn_relu_forward"):
    if not _kernels:
        with _lock:
            if not _kernels:
                with open(SOURCE) as f:
                    mod = rtc.CudaModule(f.read())
                _kernels.update((k, mod.get_kernel(k, sig))
                                for k, sig in SIGNATURES.items())
    return _kernels[name]


def _channel_view(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def bn_and_relu_reference(x, gamma, beta, mean, var, eps=1e-3,
                          fix_gamma=True, axis=1):
    """The plain version of :func:`bn_and_relu`: (BatchNorm, its ReLU)."""
    axis = axis % x.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    z = (x - _channel_view(mean, x.ndim, axis)) \
        * torch.rsqrt(_channel_view(var, x.ndim, axis) + eps) \
        * _channel_view(g, x.ndim, axis) + _channel_view(beta, x.ndim, axis)
    return z, torch.relu(z)


def bn_relu_reference(x, gamma, beta, mean, var, eps=1e-3, fix_gamma=True,
                      axis=1):
    """The plain version: BatchNorm with the moving statistics, then
    ReLU."""
    return bn_and_relu_reference(x, gamma, beta, mean, var, eps, fix_gamma,
                                 axis)[1]


def _check_channels(x, vectors, axis):
    """The kernel reads each of gamma, beta, mean and var at every
    channel c < x.shape[axis]: each must be 1-D with that many
    elements."""
    channels = x.shape[axis]
    for label, v in zip(("gamma", "beta", "mean", "var"), vectors):
        if tuple(v.shape) != (channels,):
            raise ValueError("bn_relu: %s has shape %s, not (%d,) for x of "
                             "shape %s on axis %d"
                             % (label, tuple(v.shape), channels,
                                tuple(x.shape), axis))


def _launch(name, x, vectors, outs, eps, fix_gamma, axis):
    global LAUNCHES
    for t in (x,) + vectors:
        if t.dtype != torch.float32:
            raise TypeError("bn_relu takes float32, got %s" % t.dtype)
    launch_1d(_get_kernel(name), [x, *vectors, *outs],
              [x.numel(), x.shape[axis], math.prod(x.shape[axis + 1:]),
               float(eps), int(bool(fix_gamma))], x.numel())
    LAUNCHES += 1


def bn_relu(x, gamma, beta, mean, var, eps=1e-3, fix_gamma=True, axis=1):
    """Fused BatchNorm(inference) + ReLU: the rtc kernel on CUDA tensors
    (fp32, contiguous), the plain version on host tensors."""
    axis = axis % x.ndim
    vectors = (gamma, beta, mean, var)
    _check_channels(x, vectors, axis)
    if x.is_cpu:
        return bn_relu_reference(x, *vectors, eps, fix_gamma, axis)
    y = torch.empty_like(x)
    _launch("bn_relu_forward", x, vectors, (y,), eps, fix_gamma, axis)
    return y


def bn_and_relu(x, gamma, beta, mean, var, eps=1e-3, fix_gamma=True,
                axis=1):
    """(BatchNorm(inference), its ReLU) from one pass: the rtc kernel on
    CUDA tensors, the plain version on host tensors."""
    axis = axis % x.ndim
    vectors = (gamma, beta, mean, var)
    _check_channels(x, vectors, axis)
    if x.is_cpu:
        return bn_and_relu_reference(x, *vectors, eps, fix_gamma, axis)
    z, y = torch.empty_like(x), torch.empty_like(x)
    _launch("bn_relu_forward_both", x, vectors, (z, y), eps, fix_gamma,
            axis)
    return z, y


class FusedBNReLU(subgraph.SubgraphProperty):
    """BatchNorm -> Activation(relu) pairs, run by :func:`bn_relu`, or by
    :func:`bn_and_relu` where the BatchNorm output is read elsewhere too."""

    inference_only = True

    def select(self, node):
        return node._op == "Activation" and \
            node._attrs.get("act_type", "relu") == "relu"

    def select_input(self, node, input_node):
        return node._op == "Activation" and input_node._op == "BatchNorm"

    def create_fn(self, sub_sym, arg_names):
        bn = next(n for n in sub_sym._topo() if n._op == "BatchNorm")
        attrs = bn._clean_attrs()
        eps = float(attrs.get("eps", 1e-3))
        fix_gamma = bool(attrs.get("fix_gamma", True))
        axis = int(attrs.get("axis", 1))
        index = [arg_names.index(i._name) for i in bn._inputs]
        # One output (the ReLU), or two where the BatchNorm output is also
        # read outside the pair: then in the fragment's output order.
        is_bn = [o._op == "BatchNorm" for o in sub_sym.outputs]

        def fused(*values):
            x, gamma, beta, mean, var = (values[i] for i in index)
            if len(is_bn) == 1:
                return bn_relu(x, gamma, beta, mean, var, eps, fix_gamma,
                               axis)
            z, y = bn_and_relu(x, gamma, beta, mean, var, eps, fix_gamma,
                               axis)
            return tuple(z if b else y for b in is_bn)

        return fused


subgraph.register_backend(BACKEND, FusedBNReLU())
