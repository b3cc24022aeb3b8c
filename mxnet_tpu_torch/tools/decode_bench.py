"""Input-pipeline throughput: ``ImageIter`` img/s against
``preprocess_threads``. One JSON line per thread count::

    python -m mxnet_tpu_torch.tools.decode_bench [--size 224] [--n 256] [--batches 6]
    python -m mxnet_tpu_torch.tools.decode_bench --img-fmt .png --resize 0

Counterpart of the repo's ``tools/decode_bench.py``, with its JSON keys,
metric name and units; each line adds ``img_fmt``, ``resize`` and
``device``. The default workload is the JAX tool's: ``--n`` JPEG records
of natural-image-like content at ``--size``, resized to ``size + 32``,
randomly cropped back to ``--size`` and mirrored, mean/std normalized.
JPEG and every resize need OpenCV (cv2); without it they raise, naming
cv2, and nothing switches format on its own. ``--img-fmt .png`` and
``--resize 0`` take the PNG records and no resize, which the port's own
codec serves without cv2.

``--device``: ``auto`` (the current context, the port's default
``gpu(0)``: the batches land on the card, so the rate includes the
upload), ``cpu`` (the JAX tool's host-only rate) or ``gpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_dataset(tmpdir, n, size, img_fmt=".jpg"):
    """`n` records of `size` x `size` images from seed 0 in `tmpdir`;
    returns the .rec and .idx paths."""
    from .. import recordio

    rec = os.path.join(tmpdir, "bench.rec")
    idx = os.path.join(tmpdir, "bench.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    try:
        for i in range(n):
            # Natural-image-like low-frequency content (pure noise
            # decodes unrealistically slowly or quickly).
            base = rng.rand(16, 16, 3)
            im = np.kron(base, np.ones((size // 16, size // 16, 1)))
            im = ((im + 0.1 * rng.rand(size, size, 3)) * 200).astype(
                np.uint8)
            w.write_idx(i, recordio.pack_img(
                recordio.IRHeader(0, float(i % 10), i, 0), im,
                img_fmt=img_fmt, quality=90))
    finally:
        w.close()
    return rec, idx


def bench(rec, idx, size, batch_size, batches, threads, resize=None,
          ctx=None, seen=None):
    """img/s of `batches` batches of the iterator at `threads` decode
    threads on `ctx` (default: the current context), after one warm
    batch. ``resize`` None is the JAX tool's ``size + 32``; 0 resizes
    nothing. Each batch's context is appended to `seen` when given."""
    from ..image import ImageIter

    resize = size + 32 if resize is None else resize
    it = ImageIter(batch_size=batch_size, data_shape=(3, size, size),
                   path_imgrec=rec, path_imgidx=idx,
                   rand_crop=True, rand_mirror=True, resize=resize,
                   mean=True, std=True, preprocess_threads=threads, ctx=ctx)
    try:
        next(it)  # warm (pool spin-up, first-call costs)
        it.reset()
        n_img = 0
        t0 = time.monotonic()
        for _ in range(batches):
            try:
                b = next(it)
            except StopIteration:
                it.reset()
                b = next(it)
            n_img += b.data[0].shape[0] - b.pad
            if seen is not None:
                seen.append(b.data[0].context)
        # The last batch's upload is part of the window.
        b.data[0].wait_to_read()
        dt = time.monotonic() - t0
    finally:
        it.close()
    return n_img / dt


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ImageIter img/s by preprocess_threads")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--threads", type=str, default="0,2,4,8")
    ap.add_argument("--img-fmt", default=".jpg", choices=[".jpg", ".png"])
    ap.add_argument("--resize", type=int, default=None,
                    help="shorter side before the crop (default size + "
                         "32; 0: no resize)")
    ap.add_argument("--device", default="auto",
                    choices=["auto", "cpu", "gpu"])
    args = ap.parse_args(argv)

    from ..context import current_context
    from ..util import platform_context

    with platform_context(args.device):
        ctx = current_context()
    resize = args.size + 32 if args.resize is None else args.resize
    with tempfile.TemporaryDirectory() as td:
        rec, idx = make_dataset(td, args.n, args.size, args.img_fmt)
        for t in (int(x) for x in args.threads.split(",")):
            rate = bench(rec, idx, args.size, args.batch_size,
                         args.batches, t, resize=resize, ctx=ctx)
            print(json.dumps({
                "metric": "decode_img_per_s", "value": round(rate, 1),
                "unit": "img/s", "preprocess_threads": t,
                "size": args.size, "host_cores": os.cpu_count(),
                "img_fmt": args.img_fmt, "resize": resize,
                "device": str(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
