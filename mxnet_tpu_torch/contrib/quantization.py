"""INT8 model quantization with calibration.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference:
python/mxnet/contrib/quantization.py, quantize_model: calib_mode
'naive' min/max or 'entropy' KL-optimal thresholds via
_get_optimal_threshold; the graph pass quantize_graph_pass.cc replaces
conv/FC with quantized versions carrying their calibrated ranges).

The graph rewrite happens on the Python Symbol DAG, with the JAX
package's names and attrs: each Convolution/FullyConnected (unless
excluded) becomes ``<node>_quantized``, a ``_contrib_quantized_*`` node
reading the int8 argument ``<node>_quantized_weight``, with the
calibrated activation range and the weight's scale as the attrs
``min_data``, ``max_data`` and ``w_scale``. Weights are quantized
per-tensor symmetric on the host at rewrite time, and the KL threshold
scan runs in numpy on the host: both give the JAX package's values bit
for bit for the same arrays.

Calibration evaluates the float32 graph's internal activations over the
calibration batches with one bound Executor on `ctx` (default the
current context, ``gpu(0)``; the JAX package's default is ``cpu()``).
``calib_mode="naive"`` takes each activation's min and max where it
lives (``torch.aminmax``) and moves one (layers, 2) tensor a batch to
the host; min and max are exact, so the ranges are those the host
would take from the same tensors. ``calib_mode="entropy"`` copies the
activations to the host, as the JAX package does.

``calib_mode="none"`` leaves the graph unquantized, as the JAX package
does: a node is rewritten only where a range was calibrated (upstream
MXNet quantizes there with ranges computed at run time).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ndarray as nd
from ..symbol import Symbol, Group

__all__ = ["quantize_model", "_get_optimal_threshold"]

_QUANTIZABLE = {"Convolution": "_contrib_quantized_conv",
                "FullyConnected": "_contrib_quantized_fully_connected"}


def _get_optimal_threshold(arr, num_bins=2001, num_quantized_bins=255):
    """KL-divergence-optimal clip threshold (reference
    quantization.py:_get_optimal_threshold, the TensorRT-style entropy
    calibration): choose |t| minimizing KL(clip(hist, t) || quantized)."""
    arr = np.asarray(arr).ravel()
    amax = float(np.max(np.abs(arr))) or 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(-amax, amax))
    centers = (edges[:-1] + edges[1:]) / 2
    best_kl, best_t = np.inf, amax
    # scan candidate thresholds over the upper half of the histogram
    start = num_quantized_bins // 2 + 1
    for i in range(start, num_bins // 2 + 1, max(1, num_bins // 200)):
        t = centers[num_bins // 2 + i]
        if t <= 0:
            continue
        mask = np.abs(centers) <= t
        p = hist[mask].astype(np.float64)
        # outliers collapse into the edge bins (reference: clipped
        # distribution keeps total mass)
        p[0] += hist[: np.argmax(mask)].sum()
        p[-1] += hist[len(mask) - np.argmax(mask[::-1]):].sum()
        if p.sum() == 0:
            continue
        # quantize p into num_quantized_bins then expand back
        factor = len(p) / num_quantized_bins
        q = np.zeros_like(p)
        for j in range(num_quantized_bins):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        pn = p / p.sum()
        qn = q / q.sum() if q.sum() else q
        valid = (pn > 0) & (qn > 0)
        kl = float(np.sum(pn[valid] * np.log(pn[valid] / qn[valid])))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return -best_t, best_t


def _on(arr, ctx):
    """`arr` as an NDArray on `ctx` (a copy only where it lies elsewhere)."""
    if not isinstance(arr, nd.NDArray):
        return nd.array(arr, ctx=ctx)
    return arr if arr.context == ctx else arr.as_in_context(ctx)


def _collect_ranges(symbol, arg_params, aux_params, calib_data,
                    num_calib_examples, calib_mode, data_names,
                    label_names, ctx):
    """Evaluate the float32 activations feeding each quantizable node
    over the calibration set; return node_name -> (min, max)."""
    targets = [n for n in symbol._topo()
               if n._attrs.get("_op_name", n._op) in _QUANTIZABLE]
    input_syms = {n._name: n._inputs[0] for n in targets}
    group = Group(list(input_syms.values()))
    names = list(input_syms)

    samples = {}          # name -> list of np arrays (entropy) or (mn,mx)
    seen = 0
    if hasattr(calib_data, "reset"):
        calib_data.reset()
    ex = None
    for batch in calib_data:
        feed = dict(zip(data_names, batch.data))
        if ex is None:
            args = dict(arg_params)
            args.update({k: v for k, v in (aux_params or {}).items()})
            for name, arr in feed.items():
                args[name] = arr
            # labels are not inputs of the conv/FC data subgraph; add
            # only the names the group actually needs.
            needed = set(group.list_arguments())
            bind_args = {k: _on(v, ctx) for k, v in args.items()
                         if k in needed}
            missing = needed - set(bind_args)
            for m in missing:
                raise ValueError("calibration: no value for input %r" % m)
            aux_names = group.list_auxiliary_states()
            ex = group.bind(ctx, bind_args,
                            aux_states={k: _on(v, ctx) for k, v in
                                        (aux_params or {}).items()
                                        if k in aux_names})
        outs = ex.forward(is_train=False,
                          **{k: v for k, v in feed.items()
                             if k in ex.arg_dict})
        if calib_mode == "entropy":
            for name, out in zip(names, outs):
                samples.setdefault(name, []).append(out.asnumpy())
        else:
            # Each activation's (min, max) where it lives; one transfer
            # of a (layers, 2) tensor a batch.
            pairs = torch.stack([torch.stack(torch.aminmax(out._data))
                                 for out in outs]).cpu().tolist()
            for name, (mn, mx) in zip(names, pairs):
                if name in samples:
                    omn, omx = samples[name]
                    samples[name] = (min(mn, omn), max(mx, omx))
                else:
                    samples[name] = (mn, mx)
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    if calib_mode == "entropy":
        return {name: _get_optimal_threshold(np.concatenate(
            [a.ravel() for a in arrs])) for name, arrs in samples.items()}
    return samples


def _quantize_weight(w):
    """Per-tensor symmetric int8 on the host (reference: quantize
    weights offline); the int8 array lands on `w`'s context."""
    a = w.asnumpy()
    amax = float(np.max(np.abs(a))) or 1e-8
    scale = 127.0 / amax
    q = np.clip(np.round(a * scale), -127, 127).astype(np.int8)
    return nd.array(q, ctx=w.context, dtype="int8"), scale


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=(), calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None):
    """Quantize conv/FC layers of a model to int8 (reference
    contrib/quantization.py:quantize_model).

    Returns (qsym, qarg_params, aux_params).
    """
    from ..context import Context, current_context

    assert quantized_dtype == "int8", "only int8 is supported"
    ctx = Context(ctx) if ctx is not None else current_context()
    excluded = set(excluded_sym_names)

    if calib_mode != "none":
        assert calib_data is not None, \
            "calib_mode %r requires calib_data" % calib_mode
        ranges = _collect_ranges(sym, arg_params, aux_params, calib_data,
                                 num_calib_examples, calib_mode,
                                 list(data_names), list(label_names), ctx)
    else:
        ranges = {}

    qarg_params = dict(arg_params)
    memo = {}

    def rebuild(node):
        base = memo.get(node._uid)
        if base is not None:
            # Output views share the base rebuild; re-apply the view index.
            if node._out_index is not None and base._num_outputs > 1:
                return base[node._out_index]
            return base
        if node._op is None:
            memo[node._uid] = node
            return node
        new_inputs = [rebuild(i) for i in node._inputs]
        op_name = node._attrs.get("_op_name", node._op)
        if (op_name in _QUANTIZABLE and node._name not in excluded
                and node._name in ranges):
            mn, mx = ranges[node._name]
            weight_var = node._inputs[1]
            w = arg_params[weight_var._name]
            qw, w_scale = _quantize_weight(w)
            qw_name = node._name + "_quantized_weight"
            qarg_params.pop(weight_var._name, None)
            qarg_params[qw_name] = qw
            qweight = Symbol(None, name=qw_name)
            attrs = dict(node._attrs)
            attrs["_op_name"] = _QUANTIZABLE[op_name]
            attrs.update(min_data=float(mn), max_data=float(mx),
                         w_scale=float(w_scale))
            inputs = [new_inputs[0], qweight] + new_inputs[2:]
            new = Symbol(_QUANTIZABLE[op_name], attrs=attrs, inputs=inputs,
                         name=node._name + "_quantized",
                         num_outputs=node._num_outputs)
        else:
            new = Symbol(node._op, attrs=dict(node._attrs),
                         inputs=new_inputs, name=node._name,
                         is_aux=node._is_aux, num_outputs=node._num_outputs)
        memo[node._uid] = new
        if node._out_index is not None and new._num_outputs > 1:
            return new[node._out_index]
        return new

    new_outs = [rebuild(s) for s in sym.outputs]
    qsym = new_outs[0] if len(new_outs) == 1 else Group(new_outs)
    return qsym, qarg_params, dict(aux_params or {})
