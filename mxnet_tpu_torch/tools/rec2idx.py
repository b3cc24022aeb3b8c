"""Create a random-access .idx for an existing RecordIO .rec file::

    python -m mxnet_tpu_torch.tools.rec2idx train.rec [train.idx]

Counterpart of the repo's ``tools/rec2idx.py`` over the port's
``recordio`` and ``recordio_native`` (reference: tools/rec2idx.py,
IndexCreator over MXRecordIO) — needed when a .rec was packed without
its index (shuffling/partitioning in ImageRecordIter requires one).
"""
from __future__ import annotations

import argparse
import os
import time

from .. import recordio
from ..base import atomic_write


class IndexCreator(recordio.MXRecordIO):
    """Reads a .rec sequentially, writing `key\\tposition` lines
    (reference rec2idx.py:IndexCreator)."""

    def __init__(self, uri, idx_path, key_type=int):
        self.key_type = key_type
        self.idx_path = idx_path
        super().__init__(uri, "r")

    def create_index(self):
        """Walk the record stream, emitting one index row per record;
        the index file appears whole when the walk ends."""
        self.reset()
        counter = 0
        t0 = time.time()
        with atomic_write(self.idx_path, "w") as fidx:
            while True:
                pos = self.tell()
                if self.read() is None:
                    break
                fidx.write("%s\t%d\n" % (self.key_type(counter), pos))
                counter += 1
                if counter % 1000 == 0:
                    print("%d records indexed (%.1fs)"
                          % (counter, time.time() - t0))
        return counter


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create an index file for a RecordIO file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("record", help="path to the .rec file")
    parser.add_argument("index", nargs="?", default=None,
                        help="output .idx path (default: .rec -> .idx)")
    parser.add_argument("--no-native", action="store_true",
                        help="force the pure-python scanner")
    args = parser.parse_args(argv)
    idx = args.index or os.path.splitext(args.record)[0] + ".idx"

    from .. import recordio_native

    if not args.no_native and recordio_native.available():
        # native scan: no per-frame Python overhead
        offsets = recordio_native.native_index(args.record)
        with atomic_write(idx, "w") as f:
            for i, pos in enumerate(offsets):
                f.write("%d\t%d\n" % (i, pos))
        n = len(offsets)
    else:
        creator = IndexCreator(args.record, idx)
        n = creator.create_index()
        creator.close()
    print("wrote %s (%d records)" % (idx, n))


if __name__ == "__main__":
    main()
