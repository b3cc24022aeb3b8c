"""A bidirectional LSTM learns to sort short digit sequences, on the
port.

Counterpart of ``examples/bi_lstm_sort.py`` (reference:
example/bi-lstm-sort): N unsorted tokens in, the same tokens sorted out,
one output per input position, through ``mx.rnn.BidirectionalCell``
over two LSTMCells unrolled symbolically, per-position softmax heads,
trained with the Module API on batches made from the seed::

    python -m mxnet_tpu_torch.examples.bi_lstm_sort --steps 200

It runs on ``gpu(0)`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

import mxnet_tpu_torch as mx

SEQ = 5


def build(vocab, hidden):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=16,
                             name="embed")
    bi = mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(hidden, prefix="fwd_"),
        mx.rnn.LSTMCell(hidden, prefix="bwd_"))
    out, _ = bi.unroll(SEQ, embed, layout="NTC", merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.reshape(out, shape=(-1, 2 * hidden)),
                                 num_hidden=vocab, name="pred")
    return mx.sym.SoftmaxOutput(pred, mx.sym.reshape(label, shape=(-1,)),
                                name="softmax")


class SortIter(mx.io.DataIter):
    """(unsorted sequence, sorted sequence) batches, `batches_per_epoch`
    of them an epoch."""

    def __init__(self, batch_size, vocab, batches_per_epoch, seed):
        super().__init__(batch_size)
        self.vocab = vocab
        self.rng = np.random.RandomState(seed)
        self.batches_per_epoch = batches_per_epoch
        self._i = 0
        self.provide_data = [mx.io.DataDesc("data", (batch_size, SEQ))]
        self.provide_label = [mx.io.DataDesc("softmax_label",
                                             (batch_size, SEQ))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self.batches_per_epoch:
            raise StopIteration
        self._i += 1
        x = self.rng.randint(0, self.vocab, (self.batch_size, SEQ))
        y = np.sort(x, axis=1)
        return mx.io.DataBatch(
            data=[mx.nd.array(x.astype(np.float32))],
            label=[mx.nd.array(y.astype(np.float32))],
            provide_data=self.provide_data,
            provide_label=self.provide_label)


def run(steps=300, batch_size=32, vocab=10, hidden=32, lr=0.01, seed=5,
        ctx=None):
    """Train with ``Module.fit``; returns {"accuracy": sorted-position
    accuracy on fresh sequences, "perplexity": [validation, per
    epoch]}."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mx.random.seed(seed)
    per_epoch = 20
    epochs = max(steps // per_epoch, 1)
    perplexity = []

    def record(param):
        for name, value in param.eval_metric.get_name_value():
            perplexity.append(value)
            print("epoch %d  validation %s %.4f" % (param.epoch, name,
                                                    value), flush=True)

    with ctx:
        sym = build(vocab, hidden)
        train = SortIter(batch_size, vocab, per_epoch, seed)
        val = SortIter(batch_size, vocab, 4, seed + 1)
        mod = mx.mod.Module(sym, data_names=("data",),
                            label_names=("softmax_label",), context=ctx)
        mod.fit(train, eval_data=val, optimizer="adam",
                optimizer_params={"learning_rate": lr},
                initializer=mx.init.Xavier(), num_epoch=epochs,
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                eval_end_callback=record)
        # Position-wise accuracy on fresh sequences.
        val.reset()
        batch = next(val)
        mod.forward(batch, is_train=False)
        pred = mod.get_outputs()[0].asnumpy().reshape(
            batch_size, SEQ, vocab).argmax(-1)
    truth = batch.label[0].asnumpy().astype(int)
    acc = float((pred == truth).mean())
    print("sorted-position accuracy %.3f" % acc, flush=True)
    print("sample: in=%s out=%s truth=%s"
          % (batch.data[0].asnumpy()[0].astype(int).tolist(),
             pred[0].tolist(), truth[0].tolist()), flush=True)
    if acc < 0.5:
        raise SystemExit("bi-lstm sort accuracy too low: %.3f" % acc)
    return {"accuracy": acc, "perplexity": perplexity}


def main(argv=None):
    ap = argparse.ArgumentParser(description="bidirectional LSTM sort")
    ap.add_argument("--steps", type=int, default=300,
                    help="total training batches")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(args.steps, args.batch_size, args.vocab, args.hidden,
               args.lr, args.seed,
               ctx=mx.cpu() if args.device == "cpu" else mx.gpu(0))


if __name__ == "__main__":
    main(sys.argv[1:])
