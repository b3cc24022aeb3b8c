"""Train the bucketed LSTM word language model with ``BucketingModule``.

Counterpart of ``examples/train_rnn_lm.py`` (reference
example/rnn/bucketing/lstm_bucketing.py, the "LSTM PTB" configuration):
sentences go through ``mx.rnn.BucketSentenceIter`` into length buckets;
``sym_gen`` builds, per bucket, Embedding -> a ``SequentialRNNCell`` of
``FusedRNNCell`` LSTM layers -> FullyConnected(vocabulary) ->
SoftmaxOutput; ``BucketingModule.fit`` trains it with the
``Perplexity(ignore_label=0)`` metric. It runs on ``gpu(0)`` unless
``--device cpu`` is given. With ``--synthetic`` (or no ``--train-data``
file) the corpus is made from ``--seed``: every token has a few
successors, so the model has structure to learn, and the corpus takes
O(vocabulary) memory at PTB's vocabulary of 10 000. Token 0 is the
padding label; real tokens are 1..V-1. Nothing is downloaded::

    python -m mxnet_tpu_torch.examples.train_rnn_lm --synthetic \\
        --vocab-size 10000 --buckets 10,20,30,40,50,60
    python -m mxnet_tpu_torch.examples.train_rnn_lm --synthetic \\
        --device cpu --num-hidden 16 --num-embed 16 --num-sentences 200
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def tokenize_text(mx, fname, vocab=None, invalid_label=-1, start_label=0):
    """(reference lstm_bucketing.py:tokenize_text)."""
    with open(fname) as f:
        lines = [[w for w in line.split(" ") if w] for line in f]
    return mx.rnn.encode_sentences(lines, vocab=vocab,
                                   invalid_label=invalid_label,
                                   start_label=start_label)


def synthetic_corpus(vocab_size, num_sentences, buckets, seed=0,
                     successors=4):
    """Markov-chain sentences over tokens 1..V-1: each token has
    `successors` next tokens, drawn once with Dirichlet weights. Lengths
    are drawn from `buckets`."""
    rng = np.random.RandomState(seed)
    v = vocab_size
    nxt = rng.randint(1, v, size=(v, successors))
    cum = np.cumsum(rng.dirichlet(np.ones(successors), size=v), axis=1)
    sents = []
    for n in rng.choice(buckets, size=num_sentences):
        w = int(rng.randint(1, v))
        out = [w]
        for u in rng.random_sample(n - 1):
            w = int(nxt[w, min(np.searchsorted(cum[w], u), successors - 1)])
            out.append(w)
        sents.append(out)
    return sents


def sym_gen_factory(mx, num_layers, num_hidden, num_embed, vocab_size):
    """Per bucket length: (symbol, data names, label names)."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=num_embed, name="embed")
        stack = mx.rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(mx.rnn.FusedRNNCell(num_hidden, num_layers=1,
                                          mode="lstm",
                                          prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                  merge_outputs=True)
        pred = mx.sym.reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size,
                                     name="pred")
        label_flat = mx.sym.reshape(label, shape=(-1,))
        out = mx.sym.SoftmaxOutput(pred, label_flat, name="softmax")
        return out, ("data",), ("softmax_label",)

    return sym_gen


def optimizer_params(args):
    if args.optimizer == "sgd":
        return {"learning_rate": args.lr, "momentum": args.mom,
                "wd": args.wd}
    return {"learning_rate": args.lr, "wd": args.wd}


def main(argv=None):
    import mxnet_tpu_torch as mx

    parser = argparse.ArgumentParser(
        description="Train a bucketed LSTM LM (reference lstm_bucketing)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--num-hidden", type=int, default=200)
    parser.add_argument("--num-embed", type=int, default=200)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--num-epochs", type=int, default=5)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--optimizer", default="adam")
    parser.add_argument("--mom", type=float, default=0.0)
    parser.add_argument("--wd", type=float, default=1e-5)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--disp-batches", type=int, default=50)
    parser.add_argument("--buckets", default="10,20,30,40",
                        help="comma-separated bucket lengths")
    parser.add_argument("--train-data", default=None,
                        help="tokenized text file (one sentence/line)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--vocab-size", type=int, default=200,
                        help="synthetic corpus vocabulary")
    parser.add_argument("--num-sentences", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="gpu", choices=["gpu", "cpu"],
                        help="train on gpu(0) or on the host")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    buckets = [int(b) for b in args.buckets.split(",")]
    mx.random.seed(args.seed)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)

    if args.train_data and os.path.isfile(args.train_data) \
            and not args.synthetic:
        sents, vocab = tokenize_text(mx, args.train_data, start_label=1,
                                     invalid_label=0)
        vocab_size = len(vocab) + 1
    else:
        sents = synthetic_corpus(args.vocab_size, args.num_sentences,
                                 buckets, seed=args.seed)
        vocab_size = args.vocab_size
    # Next-token labels come from the iterator (input shifted one step;
    # padding gets invalid_label 0, which the metric ignores).
    it = mx.rnn.BucketSentenceIter(sents, batch_size=args.batch_size,
                                   buckets=buckets, invalid_label=0,
                                   seed=args.seed, ctx=ctx)
    mod = mx.mod.BucketingModule(
        sym_gen_factory(mx, args.num_layers, args.num_hidden,
                        args.num_embed, vocab_size),
        default_bucket_key=max(buckets), context=ctx)
    mod.fit(it, num_epoch=args.num_epochs,
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            kvstore=args.kv_store, optimizer=args.optimizer,
            optimizer_params=optimizer_params(args),
            initializer=mx.init.Xavier(),
            batch_end_callback=mx.callback.Speedometer(
                args.batch_size, args.disp_batches))
    it.reset()
    ppl = mod.score(it, mx.metric.Perplexity(ignore_label=0))[0][1]
    logging.info("final train perplexity: %.2f", ppl)
    print("final-perplexity %.4f" % ppl, flush=True)
    return ppl


if __name__ == "__main__":
    main()
