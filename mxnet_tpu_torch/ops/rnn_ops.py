"""The fused RNN operator: vanilla (tanh/relu), LSTM and GRU, several
layers, bidirectional.

Counterpart of ``mxnet_tpu/ops/rnn_ops.py:36-226`` (reference
src/operator/rnn.cc, rnn-inl.h and the cuDNN path). The flat parameter
vector has the cuDNN layout: the weights of every (layer, direction)
first, W_input then W_hidden, then every bias, b_input then b_hidden;
gates LSTM [i, f, g, o], GRU [r, z, n].

As in the JAX package's ``_scan_direction``, the input-side projection
of the whole sequence is one ``torch.matmul`` per (layer, direction);
only the h-side product and the gates stay in the per-step loop, whose
steps torch's autograd records for the backward. This op is not a TPU
kernel (the JAX package computes it in ``lax.scan``, outside Pallas), so
it is plain PyTorch here; ``chip_smoke.py`` times it beside cuDNN's
fused LSTM (``torch.nn.LSTM`` with the same weights). Inter-layer
dropout is applied in training to the input of every layer but the
first, where cuDNN applies it. ``projection_size`` (LSTMP) raises: the
JAX package accepts it and ignores it.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["rnn_param_size", "rnn_infer_input_size", "rnn_param_layout"]

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _layer_size(ngates, h, in_size, d):
    # per direction: W_i (G*H, in), W_h (G*H, H), b_i and b_h (G*H)
    return d * (ngates * h * (in_size + h) + 2 * ngates * h)


def rnn_param_size(num_layers, state_size, input_size, mode="lstm",
                   bidirectional=False):
    """Length of the flat parameter vector (reference
    rnn-inl.h:GetRnnParamSize)."""
    ngates, d, h = _NGATES[mode], 2 if bidirectional else 1, state_size
    return sum(_layer_size(ngates, h, input_size if layer == 0 else h * d,
                           d) for layer in range(num_layers))


def rnn_infer_input_size(total_size, num_layers, state_size, mode="lstm",
                         bidirectional=False):
    """The input width a flat vector of `total_size` implies (used by
    the FusedRNN initializer and ``unpack_weights``)."""
    ngates, d, h = _NGATES[mode], 2 if bidirectional else 1, state_size
    rest = total_size - (num_layers - 1) * _layer_size(ngates, h, h * d, d)
    rest -= _layer_size(ngates, h, 0, d)
    in_size = rest // (d * ngates * h)
    if rnn_param_size(num_layers, state_size, in_size, mode,
                      bidirectional) != total_size:
        raise ValueError("parameter vector of length %d does not match "
                         "any input size for this RNN config" % total_size)
    return in_size


def rnn_param_layout(num_layers, state_size, input_size, mode="lstm",
                     bidirectional=False):
    """[(name, shape, offset)] into the flat vector, named as the gluon
    layers name their parameters (``l<layer>_`` forward, ``r<layer>_``
    reverse)."""
    ngates, d, h = _NGATES[mode], 2 if bidirectional else 1, state_size
    layout, off = [], 0

    def add(name, shape):
        nonlocal off
        layout.append((name, shape, off))
        off += math.prod(shape)

    for layer in range(num_layers):
        in_size = input_size if layer == 0 else h * d
        for dr in range(d):
            sfx = ("r%d" if dr else "l%d") % layer
            add("%s_i2h_weight" % sfx, (ngates * h, in_size))
            add("%s_h2h_weight" % sfx, (ngates * h, h))
    for layer in range(num_layers):
        for dr in range(d):
            sfx = ("r%d" if dr else "l%d") % layer
            add("%s_i2h_bias" % sfx, (ngates * h,))
            add("%s_h2h_bias" % sfx, (ngates * h,))
    return layout


def _direction(xg, h, c, wh_t, bh, mode, clip):
    """One pass over xg (T, N, G*H), the input-side gates with both
    biases added (GRU: b_input only; b_hidden is `bh`, gated by r).
    Returns (outputs (T, N, H), h_T, c_T)."""
    ys = []
    for t in range(xg.shape[0]):
        if mode == "lstm":
            gates = torch.addmm(xg[t], h, wh_t)
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip is not None:
                c = torch.clamp(c, clip[0], clip[1])
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            # cuDNN's GRU: the h-side new-gate term, bias included, is
            # gated by r before the add.
            xr, xz, xn = xg[t].chunk(3, dim=1)
            hr, hz, hn = torch.addmm(bh, h, wh_t).chunk(3, dim=1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            pre = torch.addmm(xg[t], h, wh_t)
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        ys.append(h)
    return torch.stack(ys), h, c


@register("RNN", train_aware=True, needs_rng=True)
def _rnn(data, parameters, state, state_cell=None, state_size=0,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None,
         lstm_state_clip_min=None, lstm_state_clip_max=None,
         use_sequence_length=False, training=False, generator=None):
    """Fused multi-layer RNN. data (T, N, I); parameters, the flat
    vector (:func:`rnn_param_layout`); state and, for LSTM, state_cell
    (L*D, N, H). Returns the output (T, N, D*H), or with
    `state_outputs` (output, h_T[, c_T])."""
    if projection_size is not None:
        raise NotImplementedError(
            "RNN projection_size (LSTMP) is not supported; the JAX package "
            "accepts it and ignores it (ROADMAP Queue 3)")
    if use_sequence_length:
        raise NotImplementedError("RNN use_sequence_length is not supported")
    d = 2 if bidirectional else 1
    h = int(state_size)
    weights = {name: parameters[off:off + math.prod(shape)].view(shape)
               for name, shape, off in rnn_param_layout(
                   num_layers, h, data.shape[2], mode, bidirectional)}
    if state_cell is None:
        state_cell = torch.zeros_like(state)
    clip = (lstm_state_clip_min, lstm_state_clip_max) \
        if mode == "lstm" and lstm_state_clip_min is not None else None
    x = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        if layer > 0 and p > 0 and training:
            keep = 1.0 - float(p)
            mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
            x = x * (mask / keep)
        ys = []
        for dr in range(d):
            sfx = ("r%d" if dr else "l%d") % layer
            row = layer * d + dr
            bias = weights[sfx + "_i2h_bias"]
            if mode != "gru":
                bias = bias + weights[sfx + "_h2h_bias"]
            xg = torch.matmul(x, weights[sfx + "_i2h_weight"].t()) + bias
            if dr:
                xg = torch.flip(xg, dims=(0,))
            y, h_t, c_t = _direction(
                xg, state[row], state_cell[row],
                weights[sfx + "_h2h_weight"].t(), weights[sfx + "_h2h_bias"],
                mode, clip)
            ys.append(torch.flip(y, dims=(0,)) if dr else y)
            h_out.append(h_t)
            c_out.append(c_t)
        x = torch.cat(ys, dim=-1) if d > 1 else ys[0]
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(h_out), torch.stack(c_out)
    return x, torch.stack(h_out)
