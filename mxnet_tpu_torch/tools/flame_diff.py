"""Diff two collapsed flamegraph captures: which ops' self-time share
regressed?

Counterpart of the repo's ``tools/flame_diff.py`` over the port's
``telemetry.flamegraph``, with the same text.
``mxnet_tpu_torch.telemetry.flamegraph.dump_collapsed()`` writes folded-stack
captures (``thread;outer;inner <self_us>`` lines). Given a *before* and
an *after* capture — two commits, two configs, two days of the same job
— this tool normalizes each to its own total, folds to leaf frames, and
prints the ops whose **share** of self time moved, worst regression
first (the `flamegraph.diff_top` view). Absolute time is not compared:
captures of different lengths are still honestly diffable by share.

Usage::

    python -m mxnet_tpu_torch.tools.flame_diff before.folded after.folded
    python -m mxnet_tpu_torch.tools.flame_diff -k 40 --min-share 0.005 a.folded b.folded
"""
from __future__ import annotations

import argparse
import sys

from ..telemetry import flamegraph


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Diff two collapsed flamegraph captures by "
                    "self-time share (regressions first).")
    parser.add_argument("before", help="baseline collapsed capture")
    parser.add_argument("after", help="candidate collapsed capture")
    parser.add_argument("-k", type=int, default=20,
                        help="rows to print (default 20)")
    parser.add_argument("--min-share", type=float, default=0.001,
                        help="noise floor: drop ops below this share in "
                             "BOTH captures (default 0.001)")
    args = parser.parse_args(argv)

    with open(args.before) as f:
        before = f.read()
    with open(args.after) as f:
        after = f.read()
    print(flamegraph.render_diff(before, after, k=args.k,
                                 min_share=args.min_share))
    return 0


if __name__ == "__main__":
    sys.exit(main())
