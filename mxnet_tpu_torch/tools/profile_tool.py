"""Work with continuous-profiler captures: top / diff / merge.

Counterpart of the repo's ``tools/profile_tool.py`` over the port's
``telemetry.flamegraph``, ``telemetry.profiling`` and
``telemetry.export``, with the same text.
``mxnet_tpu_torch.telemetry.profiling.ContinuousProfiler`` (and the
`/debug/pprof` endpoint, and pod-profile collection) produce
collapsed-stack captures — ``root;frame;frame <self_us>`` lines, the
format every flamegraph tool eats. This CLI gives the three operations
an operator reaches for without leaving the terminal:

* ``top``    — rank leaf frames by self time (pprof -top for a capture)
* ``diff``   — self-time **share** regressions between two captures
               (`flamegraph.diff_top`; same view as the ``flame_diff`` tool,
               here for sampler captures)
* ``merge``  — fold several captures (windows, ranks) into one

Usage::

    python -m mxnet_tpu_torch.tools.profile_tool top capture.collapsed [-k 30]
    python -m mxnet_tpu_torch.tools.profile_tool diff before.collapsed after.collapsed
    python -m mxnet_tpu_torch.tools.profile_tool merge -o pod.collapsed rank0.collapsed rank1.collapsed
"""
from __future__ import annotations

import argparse
import os
import sys

from ..telemetry import export, flamegraph, profiling


def _read(path):
    with open(path) as f:
        return f.read()


def cmd_top(args):
    folded = flamegraph._parse_collapsed(_read(args.capture))
    # trace:<id> leaf markers become per-frame exemplars: the real hot
    # frame keeps its self time, and its row links to the concrete
    # traces the sampler caught it inside.
    folded, exemplars = flamegraph.trace_exemplars(folded)
    leaf = flamegraph._by_leaf(folded)
    total = sum(leaf.values()) or 1.0
    rows = sorted(leaf.items(), key=lambda kv: kv[1], reverse=True)
    print("Top %d frames by self time (%s)"
          % (args.k, os.path.basename(args.capture)))
    print("%-64s %12s %7s" % ("Frame", "Self(ms)", "Share"))
    for name, us in rows[:args.k]:
        print("%-64s %12.3f %6.1f%%" % (name, us / 1e3,
                                        us / total * 100.0))
        ids = exemplars.get(name)
        if ids:
            ranked = sorted(ids.items(), key=lambda kv: -kv[1])
            print("    exemplars: %s" % ", ".join(
                "trace:%s" % tid for tid, _ in ranked[:3]))
    if not rows:
        print("(empty capture)")
    return 0


def cmd_diff(args):
    print(flamegraph.render_diff(_read(args.before), _read(args.after),
                                 k=args.k, min_share=args.min_share))
    return 0


def cmd_merge(args):
    folded = profiling.merge_collapsed([_read(p) for p in args.captures])
    text = flamegraph.render_collapsed(folded)
    if args.output:
        export.commit_bytes(args.output, text.encode("utf-8"))
        print("merged %d captures (%d stacks) -> %s"
              % (len(args.captures), len(folded), args.output))
    else:
        sys.stdout.write(text)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="top/diff/merge over collapsed profiler captures.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_top = sub.add_parser("top", help="rank leaf frames by self time")
    p_top.add_argument("capture")
    p_top.add_argument("-k", type=int, default=20)
    p_top.set_defaults(fn=cmd_top)

    p_diff = sub.add_parser("diff",
                            help="self-time share diff of two captures")
    p_diff.add_argument("before")
    p_diff.add_argument("after")
    p_diff.add_argument("-k", type=int, default=20)
    p_diff.add_argument("--min-share", type=float, default=0.001)
    p_diff.set_defaults(fn=cmd_diff)

    p_merge = sub.add_parser("merge",
                             help="fold several captures into one")
    p_merge.add_argument("captures", nargs="+")
    p_merge.add_argument("-o", "--output",
                         help="write merged capture here (atomic "
                              "commit); default stdout")
    p_merge.set_defaults(fn=cmd_merge)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
