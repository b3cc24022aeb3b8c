"""CachedOp — the hybridize unit.

Counterpart of ``mxnet_tpu/cached_op.py``. The JAX package compiles one
XLA executable per input signature; PyTorch runs eagerly, so here a
"trace" is the first call of a new signature (shapes, dtypes and
devices of the inputs, plus the train/eval mode). ``num_traces`` keeps
that count: the serving warmup contract, one trace per bucket, is
asserted against it. Capturing each signature as a CUDA graph is a
later step.

Telemetry, as in the JAX package: a new signature counts into
``mx_cachedop_compiles_total{op}`` and fires the ``on_trace`` hook
(``telemetry.StepMonitor.attach`` chains there to flag recompiles), and
that call's wall time is observed as
``mx_compile_seconds{site="cached_op"}``. Calls run inside
``cached_op::execute`` / ``cached_op::inference`` spans, a new
signature's inside ``cached_op::trace``.

Under ``autograd.record()`` a call keeps the graph: the function runs in
the current train/eval mode with recording on, and the gradients reach
the parameters passed in, as the reference's one recorded tape node per
call does (``mxnet_tpu/cached_op.py``). ``inference()`` builds no graph.
"""
from __future__ import annotations

import threading
import time

import torch

from . import autograd
from .ndarray.ndarray import NDArray
from .telemetry import memstats as _ms
from .telemetry import metrics as _tm
from .telemetry import trace as _trace

__all__ = ["CachedOp", "in_cached_call"]

_calls = threading.local()

# New signatures per op: a climbing rate after warmup is a recompile
# storm (telemetry.StepMonitor.attach watches the same event through the
# on_trace hook).
_compiles_total = _tm.REGISTRY.counter(
    "mx_cachedop_compiles_total",
    "CachedOp trace/compile events (one per new input signature)",
    labels=("op",))


def in_cached_call():
    """Whether this thread is inside a CachedOp call: where the JAX
    package traces, so ``nd.contrib.while_loop`` pads its outputs to
    ``max_iterations`` rows there, as the traced JAX op does."""
    return getattr(_calls, "depth", 0) > 0


class CachedOp:
    """Run a function over NDArrays, counting input signatures.

    Parameters
    ----------
    fn : callable(*args) -> NDArray | tuple[NDArray]
        Function of NDArrays using `nd` ops.
    num_params : int
        How many leading arguments of `fn` are parameters.
    static_alloc, static_shape, **flags : accepted for API parity with
        the reference's CachedOpConfig; advisory.

    ``on_trace``: called with the op on each new signature, before the
    call runs.
    """

    _counter = [0]

    def __init__(self, fn, num_params=0, static_alloc=False,
                 static_shape=False, **flags):
        self._fn = fn
        self._num_params = num_params
        self._signatures = set()
        self.num_traces = 0
        self.on_trace = None
        CachedOp._counter[0] += 1
        self.name = "_cached_op_%d" % CachedOp._counter[0]

    def _run(self, args, training, span):
        sig = (training,) + tuple(
            (tuple(a.shape), a._data.dtype, a._data.device)
            if isinstance(a, NDArray) else type(a) for a in args)
        t0 = None
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.num_traces += 1
            _compiles_total.labels(op=self.name).inc()
            if self.on_trace is not None:
                self.on_trace(self)
            t0 = time.perf_counter()
        _calls.depth = getattr(_calls, "depth", 0) + 1
        try:
            with _trace.span(span, op=self.name):
                if t0 is None:
                    out = self._fn(*args)
                else:
                    with _trace.span("cached_op::trace", op=self.name,
                                     trace=self.num_traces):
                        out = self._fn(*args)
        finally:
            _calls.depth -= 1
        if t0 is not None:
            # The call that met a new signature: where the JAX package
            # traces and compiles (mx_compile_seconds{site="cached_op"}).
            _ms.observe_compile("cached_op", time.perf_counter() - t0)
        return out

    def __call__(self, *args):
        """Forward in the current train/eval mode; recorded when the
        caller records."""
        return self._run(args, autograd.is_training(), "cached_op::execute")

    def inference(self, *args):
        """Eval-mode forward that never enables train-mode ops (BatchNorm
        uses its running stats), whatever the ambient autograd scope, and
        builds no autograd graph: the serving hot path."""
        with torch.no_grad(), autograd.pause(train_mode=False):
            return self._run(args, False, "cached_op::inference")
