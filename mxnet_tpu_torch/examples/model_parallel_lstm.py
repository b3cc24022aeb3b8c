#!/usr/bin/env python
"""Model-parallel LSTM: layer groups placed on different devices.

Counterpart of ``examples/model_parallel_lstm.py`` (reference
example/model-parallel and docs/faq/model_parallel_lstm.md): a deep
LSTM language model split by layer with ``group2ctx``. ``AttrScope``
stamps each layer's ops with its group, ``bind(group2ctx=...)`` runs
each group's ops on its device, and the activations cross devices at
every group boundary (their gradients cross back in the backward).

Each parameter is allocated on the device of the group that reads it,
as the reference's executor allocates it, so only activations and
their gradients cross. Devices: with two or more cards the groups cycle
over the cards; with one card they alternate ``gpu(0)`` and ``cpu(0)``,
so that every group edge is a real device boundary; with ``--device
cpu`` they are ``cpu(0)``, ``cpu(1)``, ... (one torch device, distinct
contexts). The flags, groups, data, update and the closing ``nll first
-> last`` line are the JAX example's; ``--embed`` (16 there) and
``--device`` are added::

    python -m mxnet_tpu_torch.examples.model_parallel_lstm --steps 12
    python -m mxnet_tpu_torch.examples.model_parallel_lstm --device cpu \\
        --steps 12
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np


def build_lm(mx, seq_len, vocab, embed, hidden, layers):
    """Unrolled multi-layer LSTM LM with each layer in its own ctx
    group (reference model_parallel_lstm.md's per-layer split)."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    with mx.AttrScope(ctx_group="embed"):
        x = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                             name="embed")
    for layer in range(layers):
        with mx.AttrScope(ctx_group="layer%d" % layer):
            cell = mx.rnn.LSTMCell(hidden, prefix="lstm%d_" % layer)
            x, _ = cell.unroll(seq_len, x, layout="NTC",
                               merge_outputs=True)
    with mx.AttrScope(ctx_group="head"):
        pred = mx.sym.FullyConnected(
            mx.sym.reshape(x, shape=(-1, hidden)), num_hidden=vocab,
            name="pred")
        out = mx.sym.SoftmaxOutput(
            pred, mx.sym.reshape(label, shape=(-1,)), name="softmax")
    return out


def group_contexts(mx, groups, device):
    """{group: Context}: see the module docstring."""
    import torch

    if device == "cpu":
        return {g: mx.cpu(i) for i, g in enumerate(groups)}
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("model_parallel_lstm: no CUDA device; pass "
                           "--device cpu to place the groups on the host")
    if n == 1:
        return {g: mx.gpu(0) if i % 2 == 0 else mx.cpu(0)
                for i, g in enumerate(groups)}
    return {g: mx.gpu(i % n) for i, g in enumerate(groups)}


def argument_groups(sym):
    """{argument name: group of the first op that reads it}."""
    nodes = json.loads(sym.tojson())["nodes"]
    out = {}
    for node in nodes:
        group = node["attrs"].get("__ctx_group__")
        for i, _ in node["inputs"]:
            src = nodes[i]
            if src["op"] == "null" and group is not None:
                out.setdefault(src["name"], group)
    return out


def sample_seqs(rng, batch_size, seq_len, vocab):
    """Repeat-with-noise sequences (next token = current, 10% noise): a
    learnable language, unlike uniform noise."""
    start = rng.randint(1, vocab, (batch_size, 1))
    cols = [start]
    for _ in range(seq_len):
        noise = rng.rand(batch_size, 1) < 0.1
        nxt = np.where(noise, rng.randint(1, vocab, (batch_size, 1)),
                       cols[-1])
        cols.append(nxt)
    return np.concatenate(cols, axis=1)


def train(argv=None, arg_params=None):
    """Train without judging the result; returns {"history": per-step
    nll, "first", "last" (the first and last ``max(3, steps // 6)``-step
    means), "step_ms", "cross_bytes_per_step", "placement"}.
    `arg_params` ({name: numpy array}) replaces the Xavier
    initialisation."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import executor

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=20)
    ap.add_argument("--embed", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)
    mx.random.seed(args.seed)
    rng = np.random.RandomState(args.seed)

    sym = build_lm(mx, args.seq_len, args.vocab, args.embed, args.hidden,
                   args.layers)
    groups = ["embed"] + ["layer%d" % i for i in range(args.layers)] \
        + ["head"]
    group2ctx = group_contexts(mx, groups, args.device)
    logging.info("placement: %s", {g: str(c) for g, c in group2ctx.items()})
    home = argument_groups(sym)

    arg_shapes, _, _ = sym.infer_shape(
        data=(args.batch_size, args.seq_len),
        softmax_label=(args.batch_size, args.seq_len))
    init = mx.init.Xavier()
    args_map, grads_map, moms_map = {}, {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        ctx = group2ctx[home[name]]
        args_map[name] = mx.nd.zeros(shape, ctx=ctx)
        if name in ("data", "softmax_label"):
            continue
        if arg_params is not None:
            args_map[name][:] = mx.nd.array(arg_params[name], ctx=ctx)
        else:
            init(mx.init.InitDesc(name), args_map[name])
        grads_map[name] = mx.nd.zeros(shape, ctx=ctx)
        moms_map[name] = mx.nd.zeros(shape, ctx=ctx)
    exe = sym.bind(group2ctx["embed"], args_map, args_grad=grads_map,
                   group2ctx=group2ctx)
    on_card = any(c.device_type == "gpu" for c in group2ctx.values())

    history, step_ms, crossed = [], [], []
    for step in range(args.steps):
        seqs = sample_seqs(rng, args.batch_size, args.seq_len, args.vocab)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = sum(executor.CROSS_DEVICE_BYTES)
        for name, cols in (("data", seqs[:, :-1]),
                           ("softmax_label", seqs[:, 1:])):
            args_map[name][:] = mx.nd.array(cols.astype(np.float32),
                                            ctx=args_map[name].context)
        out = exe.forward(is_train=True)[0]
        exe.backward()
        for name, grad in grads_map.items():
            # SoftmaxOutput grads sum over batch*seq_len rows; momentum
            # + clipping keep the raw-SGD LM stable.
            mx.nd.sgd_mom_update(
                args_map[name], grad, moms_map[name],
                lr=args.lr / (args.batch_size * args.seq_len),
                momentum=0.9, clip_gradient=5.0,
                out=(args_map[name], moms_map[name]))
        p = out.asnumpy().reshape(args.batch_size, args.seq_len,
                                  args.vocab)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        crossed.append(sum(executor.CROSS_DEVICE_BYTES) - moved)
        idx = seqs[:, 1:].astype(int)
        nll = -np.log(np.maximum(
            np.take_along_axis(p, idx[..., None], axis=2), 1e-9)).mean()
        history.append(float(nll))
        if step % 5 == 0 or step == args.steps - 1:
            logging.info("step %d  nll %.4f  (ppl %.1f)", step, nll,
                         np.exp(nll))

    k = max(3, args.steps // 6)
    return {"history": history, "first": float(np.mean(history[:k])),
            "last": float(np.mean(history[-k:])), "window": k,
            "step_ms": step_ms, "cross_bytes_per_step": crossed,
            "placement": {g: str(c) for g, c in group2ctx.items()}}


def main(argv=None, arg_params=None):
    """Train (:func:`train`), log the first and last means of the nll,
    and raise SystemExit unless it fell; returns train's result."""
    got = train(argv, arg_params)
    first, last = got["first"], got["last"]
    logging.info("nll %.4f -> %.4f (first/last %d-step means)", first,
                 last, got["window"])
    if not (np.isfinite(last) and last < first):
        raise SystemExit("model-parallel LSTM did not learn")
    return got


if __name__ == "__main__":
    main()
