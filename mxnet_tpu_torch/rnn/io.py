"""Bucketed sentence iterator for variable-length sequence training.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference python/mxnet/rnn/io.py:
``encode_sentences``, ``BucketSentenceIter``). Each bucket is one padded
host matrix with its next-token labels computed once; an epoch is a
shuffled schedule of (bucket, row offset) batches, and each batch is a
view of the bucket's array on the iterator's context (default: the
current one) with its ``bucket_key``, which ``BucketingModule`` binds
one Executor per.

The shuffles draw from generators the iterator owns, seeded from
``seed`` (default: one drawn from ``mx.random.seed``): a
``random.Random`` orders the schedule and a ``numpy.random.RandomState``
permutes each bucket's rows, the draws the JAX package makes from the
process-global ``random`` and ``numpy.random`` seeded alike.
"""
from __future__ import annotations

import logging
import random

import numpy as np

from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences to integer ids, building `vocab` on the
    fly (reference rnn/io.py:encode_sentences).

    With a caller-provided vocab, unseen words either map to
    ``unknown_token`` or raise; fresh ids continue above the vocab's
    current maximum so they can never collide with existing entries.
    """
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        grow = True
        next_id = start_label
    else:
        grow = False
        next_id = max(start_label, max(vocab.values()) + 1)

    def encode(word):
        nonlocal next_id
        got = vocab.get(word)
        if got is not None:
            return got
        if not grow:
            if not unknown_token:
                raise ValueError("Unknown token %s" % word)
            # Lazily adopt the unknown token the first time an OOV word
            # actually occurs — a fully in-vocabulary corpus leaves the
            # caller's dict untouched.
            if unknown_token not in vocab:
                vocab[unknown_token] = next_id
                next_id += 1
            return vocab[unknown_token]
        if next_id == invalid_label:  # never hand out the invalid id
            next_id += 1
        vocab[word] = next_id
        next_id += 1
        return vocab[word]

    return [[encode(w) for w in sent] for sent in sentences], vocab


class BucketSentenceIter(DataIter):
    """Pads encoded sentences into per-length buckets and yields batches
    with a `bucket_key` for BucketingModule (reference
    rnn/io.py:BucketSentenceIter). Labels are the input shifted one step
    left (next-token LM targets), padded with ``invalid_label``.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", seed=None, ctx=None):
        super().__init__(batch_size)
        if seed is None:
            from .. import random as _random

            seed = _random.host_seed()
        self._shuffle_rng = random.Random(seed)
        self._perm_rng = np.random.RandomState(seed)
        self.ctx = ctx if ctx is not None else current_context()
        lengths = [len(s) for s in sentences]
        auto_buckets = not buckets
        if auto_buckets:
            # Auto buckets: every length frequent enough to fill at
            # least one batch; if nothing qualifies, one bucket that
            # fits everything.
            freq = np.bincount(lengths)
            buckets = [n for n in range(len(freq)) if freq[n] >= batch_size]
            if not buckets:
                buckets = [max(lengths)]
        buckets = sorted(buckets)

        # Assign each sentence to the smallest bucket that holds it;
        # longer ones are dropped (the reference's discard contract).
        rows = {b: [] for b in buckets}
        dropped = 0
        for sent in sentences:
            fit = np.searchsorted(buckets, len(sent))
            if fit == len(buckets):
                dropped += 1
            else:
                rows[buckets[fit]].append(sent)
        if dropped:
            logging.info("discarded %d sentences longer than the largest "
                         "bucket", dropped)
        # Dead-bucket pruning — auto-generated buckets only: an unused
        # auto bucket would just bind an Executor no batch uses, but
        # explicit buckets are a declared shape contract (train and val
        # iterators built with the same list must advertise the same
        # default_bucket_key / provide_data even if one split happens to
        # miss some lengths).
        if auto_buckets:
            buckets = [b for b in buckets if rows[b]]

        def pad_block(b):
            block = np.full((len(rows[b]), b), invalid_label, dtype=dtype)
            for r, sent in enumerate(rows[b]):
                block[r, :len(sent)] = sent
            return block

        self.data = [pad_block(b) for b in buckets]
        # Next-token labels, computed once: shift left, tail padded.
        self.labels = []
        for block in self.data:
            lab = np.roll(block, -1, axis=1)
            lab[:, -1] = invalid_label
            self.labels.append(lab)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)
        self.default_bucket_key = max(buckets)
        self.provide_data = [DataDesc(
            data_name, self._batch_shape(self.default_bucket_key),
            layout=layout)]
        self.provide_label = [DataDesc(
            label_name, self._batch_shape(self.default_bucket_key),
            layout=layout)]

        # An epoch = every full batch_size window of every bucket, in
        # shuffled order. Built once; reshuffled per reset.
        self._schedule = [(bi, off)
                          for bi, block in enumerate(self.data)
                          for off in range(0,
                                           len(block) - batch_size + 1,
                                           batch_size)]
        self._cursor = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    def _batch_shape(self, seq_len):
        if self.major_axis == 0:
            return (self.batch_size, seq_len)
        return (seq_len, self.batch_size)

    def reset(self):
        from .. import ndarray as nd

        self._cursor = 0
        self._shuffle_rng.shuffle(self._schedule)
        self.nddata = []
        self.ndlabel = []
        for block, lab in zip(self.data, self.labels):
            # One permutation reorders data and labels together, so the
            # pairing survives the per-epoch shuffle.
            perm = self._perm_rng.permutation(len(block))
            block[:] = block[perm]
            lab[:] = lab[perm]
            self.nddata.append(nd.array(block, ctx=self.ctx,
                                        dtype=self.dtype))
            self.ndlabel.append(nd.array(lab, ctx=self.ctx,
                                         dtype=self.dtype))

    def next(self):
        if self._cursor >= len(self._schedule):
            raise StopIteration
        bi, off = self._schedule[self._cursor]
        self._cursor += 1
        data = self.nddata[bi][off:off + self.batch_size]
        label = self.ndlabel[bi][off:off + self.batch_size]
        if self.major_axis == 1:  # time-major
            data, label = data.transpose(), label.transpose()
        return DataBatch(
            [data], [label], pad=0,
            bucket_key=self.buckets[bi],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
