"""Pack an image list into RecordIO (.rec + .idx)::

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --encoding .png

Counterpart of the repo's ``tools/im2rec.py`` over the port's
``recordio`` (reference: tools/im2rec.py / tools/im2rec.cc) — reads a
.lst file (``index\\tlabel[\\tlabel...]\\tpath``), encodes each image
with the IRHeader wire format, and writes an indexed RecordIO pair that
ImageRecordIter streams at training time. ``--list`` generates the .lst
from a directory tree (one class per subdirectory), like the reference.

Each image is read through the port's own decode (BGR, as
``cv2.imread`` returns it), so a PNG tree packs with ``--encoding .png``
where OpenCV is not installed. JPEG (reading or writing) and
``--resize`` need cv2 and raise naming it where it is missing.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from ..base import atomic_write


def make_list(args):
    """Directory tree -> .lst (reference im2rec.py:make_list)."""
    exts = tuple(args.exts.split(","))
    classes = sorted(d for d in os.listdir(args.root)
                     if os.path.isdir(os.path.join(args.root, d)))
    entries = []
    for label, cls in enumerate(classes):
        for dirpath, _, files in os.walk(os.path.join(args.root, cls)):
            for fn in sorted(files):
                if fn.lower().endswith(exts):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          args.root)
                    entries.append((label, rel))
    if args.shuffle:
        random.Random(args.seed).shuffle(entries)
    lst_path = args.prefix + ".lst"
    with atomic_write(lst_path, "w") as f:
        for i, (label, rel) in enumerate(entries):
            f.write("%d\t%f\t%s\n" % (i, float(label), rel))
    print("wrote %d entries to %s (%d classes)"
          % (len(entries), lst_path, len(classes)))
    return lst_path


def read_list(path):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield int(parts[0]), [float(x) for x in parts[1:-1]], parts[-1]


def read_image(path):
    """HWC uint8 BGR pixels of the image at `path` (what
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns), or None where the
    file cannot be read or decoded."""
    from ..image.image import _imdecode_np

    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    try:
        img = _imdecode_np(buf, flag=1, to_rgb=False)
    except ValueError:
        return None
    return img


def pack(args):
    """.lst + images -> .rec/.idx (reference im2rec.py:write_record)."""
    from .. import recordio

    rec_path = args.prefix + ".rec"
    idx_path = args.prefix + ".idx"
    writer = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
    count = 0
    for idx, labels, rel in read_list(args.prefix + ".lst"):
        path = os.path.join(args.root, rel)
        img = read_image(path)
        if img is None:
            print("skipping unreadable image %s" % path, file=sys.stderr)
            continue
        if args.resize:
            from ..image.image import _cv2

            h, w = img.shape[:2]
            scale = args.resize / min(h, w)
            img = _cv2().resize(img, (int(round(w * scale)),
                                      int(round(h * scale))))
        if args.center_crop:
            h, w = img.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            img = img[y0:y0 + s, x0:x0 + s]
        label = labels[0] if len(labels) == 1 else np.asarray(
            labels, np.float32)
        header = recordio.IRHeader(0, label, idx, 0)
        packed = recordio.pack_img(header, img, quality=args.quality,
                                   img_fmt=args.encoding)
        writer.write_idx(idx, packed)
        count += 1
    writer.close()
    print("packed %d images into %s" % (count, rec_path))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="create an image RecordIO dataset",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("prefix", help="output prefix (prefix.lst/.rec/.idx)")
    parser.add_argument("root", help="image root directory")
    parser.add_argument("--list", action="store_true",
                        help="generate the .lst from the directory tree")
    parser.add_argument("--exts", default=".jpg,.jpeg,.png")
    parser.add_argument("--shuffle", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resize", type=int, default=0,
                        help="resize shorter edge to this")
    parser.add_argument("--center-crop", action="store_true")
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--encoding", default=".jpg")
    args = parser.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        if not os.path.exists(args.prefix + ".lst"):
            make_list(args)
        pack(args)


if __name__ == "__main__":
    main()
