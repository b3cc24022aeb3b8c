"""Shape-bucketing policy for inference batching.

Counterpart of ``mxnet_tpu/serving/buckets.py``. Padding every batch up
to a small fixed set of bucket sizes (TensorFlow Serving's
`allowed_batch_sizes`, bucketed binds in the reference) bounds the
number of input signatures a server ever runs: each is warmed once, and
no request pays the first-signature cost after that (in the port, the
cuDNN algorithm search and allocator growth of a new shape; a CUDA
graph per bucket later).

Default buckets are powers of two up to ``max_batch`` — geometric
spacing bounds padding waste at <2x while keeping the executable count
logarithmic in ``max_batch``.
"""
from __future__ import annotations

__all__ = ["BucketPolicy"]


class BucketPolicy:
    """Quantize batch-row counts onto a fixed ladder of bucket sizes.

    Parameters
    ----------
    max_batch : int
        Largest batch the device executes in one call.
    buckets : sequence of int, optional
        Explicit bucket ladder (sorted, deduped). Overrides the
        powers-of-two default; ``max_batch`` becomes ``max(buckets)``.
    """

    def __init__(self, max_batch=32, buckets=None):
        if buckets:
            ladder = sorted({int(b) for b in buckets})
            if ladder[0] < 1:
                raise ValueError("bucket sizes must be >= 1, got %r"
                                 % (ladder,))
            self.buckets = tuple(ladder)
        else:
            if max_batch < 1:
                raise ValueError("max_batch must be >= 1, got %r"
                                 % (max_batch,))
            ladder = []
            b = 1
            while b < max_batch:
                ladder.append(b)
                b *= 2
            ladder.append(max_batch)  # top bucket is exactly max_batch
            self.buckets = tuple(ladder)
        self.max_batch = self.buckets[-1]

    def bucket_for(self, rows):
        """Smallest bucket that holds `rows` rows."""
        if rows < 1:
            raise ValueError("rows must be >= 1, got %d" % rows)
        if rows > self.max_batch:
            raise ValueError("rows %d exceeds max_batch %d"
                             % (rows, self.max_batch))
        for b in self.buckets:
            if b >= rows:
                return b
        raise AssertionError("unreachable")  # pragma: no cover

    def pad_rows(self, rows):
        """How many filler rows padding to the bucket adds."""
        return self.bucket_for(rows) - rows

    def __repr__(self):
        return "BucketPolicy(buckets=%r)" % (self.buckets,)
