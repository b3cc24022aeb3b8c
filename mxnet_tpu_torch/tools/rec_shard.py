"""Split / inspect RecordIO datasets for sharded training: counterpart
of the repo's ``tools/rec_shard.py`` over the port's ``recordio`` and
``data.reader``.

``split`` rewrites one ``.rec(+.idx)`` into N balanced shard files
(round-robin by record, so shard sizes differ by at most one record)
plus a ``<prefix>-manifest.json`` describing the result — the file-level
counterpart of the runtime equal-size sharding in
``mxnet_tpu_torch.data.sharding``: pre-split shards feed per-rank
``data.RecordDataset`` instances with no runtime striping at all.

``inspect`` prints a JSON summary (record count, byte sizes, payload
stats) of a ``.rec`` file or of a shard manifest.

    python -m mxnet_tpu_torch.tools.rec_shard split train.rec \
        --num-shards 8 --out-prefix shards/train
    python -m mxnet_tpu_torch.tools.rec_shard inspect \
        shards/train-manifest.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .. import recordio
from ..base import atomic_write
from ..data.reader import RecordDataset


def shard_paths(out_prefix, num_shards):
    """The ``<prefix>-00i.rec/.idx`` names split produces."""
    width = max(3, len(str(num_shards - 1)))
    return [("%s-%0*d.rec" % (out_prefix, width, i),
             "%s-%0*d.idx" % (out_prefix, width, i))
            for i in range(num_shards)]


def split(rec_path, num_shards, out_prefix, idx_path=None):
    """Round-robin the records of ``rec_path`` into ``num_shards``
    indexed shard files. Returns the manifest dict (also written next
    to the shards)."""
    if num_shards < 1:
        raise ValueError("--num-shards must be >= 1")
    dataset = RecordDataset([rec_path],
                            [idx_path] if idx_path else None)
    out_dir = os.path.dirname(out_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    paths = shard_paths(out_prefix, num_shards)
    writers = [recordio.MXIndexedRecordIO(idx, rec, "w")
               for rec, idx in paths]
    counts = [0] * num_shards
    nbytes = [0] * num_shards
    try:
        for i in range(len(dataset)):
            record = dataset.read(i)
            k = i % num_shards
            writers[k].write_idx(counts[k], record)
            counts[k] += 1
            nbytes[k] += len(record)
    finally:
        for w in writers:
            w.close()
    manifest = {
        "source": os.path.basename(rec_path),
        "total_records": len(dataset),
        "num_shards": num_shards,
        "assignment": "round_robin",
        "shards": [{"rec": os.path.basename(rec),
                    "idx": os.path.basename(idx),
                    "records": counts[i],
                    "payload_bytes": nbytes[i]}
                   for i, (rec, idx) in enumerate(paths)],
    }
    manifest_path = out_prefix + "-manifest.json"
    with atomic_write(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return manifest


def inspect(path):
    """Summary dict for a .rec file or a shard manifest."""
    if path.endswith(".json"):
        with open(path) as f:
            manifest = json.load(f)
        counts = [s["records"] for s in manifest["shards"]]
        manifest["balanced"] = (max(counts) - min(counts) <= 1) \
            if counts else True
        return manifest
    dataset = RecordDataset([path])
    sizes = [len(dataset.read(i)) for i in range(len(dataset))]
    return {
        "rec": os.path.basename(path),
        "records": len(dataset),
        "file_bytes": os.path.getsize(path),
        "payload_bytes": sum(sizes),
        "min_record_bytes": min(sizes),
        "max_record_bytes": max(sizes),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Split or inspect RecordIO datasets for sharded "
                    "training")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_split = sub.add_parser("split", help="split a .rec into N shards")
    p_split.add_argument("rec", help="input .rec file")
    p_split.add_argument("--idx", default=None,
                         help="input .idx (default: sibling of the .rec)")
    p_split.add_argument("--num-shards", type=int, required=True)
    p_split.add_argument("--out-prefix", required=True,
                         help="shard files land at <prefix>-00i.rec/.idx")
    p_inspect = sub.add_parser("inspect",
                               help="summarize a .rec or a manifest")
    p_inspect.add_argument("path")
    args = parser.parse_args(argv)
    if args.cmd == "split":
        out = split(args.rec, args.num_shards, args.out_prefix,
                    idx_path=args.idx)
    else:
        out = inspect(args.path)
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
