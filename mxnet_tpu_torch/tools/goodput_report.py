"""Render committed goodput ledgers: summary / merge / compare.

Counterpart of the repo's ``tools/goodput_report.py`` over the port's
``telemetry.goodput``, with the same text; it reads the ledgers of
either package. ``telemetry.goodput.GoodputLedger`` commits one
``goodput.rank<R>.json`` per rank (atomic, crash-durable). This CLI is
the offline reader — the same numbers ``GET /debug/goodput`` and the
flight-recorder bundle's ``goodput`` section serve live, for when the
pod is gone and the ledger files are what's left:

* ``summary`` — one ledger: wall-clock, per-category seconds + share,
                goodput ratio, closure, restart/replay accounting
* ``merge``   — fold every rank's ledger into the pod view (the file
                analog of ``goodput.fleet_snapshot`` on rank 0)
* ``compare`` — category-share deltas between two runs: where did the
                lost seconds move?

Usage::

    python -m mxnet_tpu_torch.tools.goodput_report summary ckpt/goodput.rank0.json
    python -m mxnet_tpu_torch.tools.goodput_report merge ckpt/goodput.rank*.json
    python -m mxnet_tpu_torch.tools.goodput_report compare before.json after.json
"""
from __future__ import annotations

import argparse
import os
import sys

from ..telemetry import goodput


def _load(path):
    try:
        return goodput.load_ledger(path)
    except (OSError, ValueError) as exc:
        print("error: %s" % exc, file=sys.stderr)
        raise SystemExit(2)


def _categories(snap):
    cats = snap.get("categories") or {}
    # Taxonomy order first, then anything a newer format added.
    ordered = [c for c in goodput.CATEGORIES if c in cats]
    ordered += sorted(c for c in cats if c not in goodput.CATEGORIES)
    return [(c, float(cats[c])) for c in ordered]


def render(snap, title):
    wall = float(snap.get("wall_s", 0.0))
    lines = ["Goodput ledger — %s" % title]
    lines.append("  wall-clock       %12.3f s" % wall)
    lines.append("  goodput ratio    %11.1f %%  (%s)"
                 % (float(snap.get("goodput_ratio", 0.0)) * 100.0,
                    " + ".join(goodput.GOODPUT_CATEGORIES)))
    closure = snap.get("closure_pct")
    if closure is not None:
        lines.append("  closure          %11.2f %%  (%s; tolerance %s%%)"
                     % (float(closure),
                        "OK" if snap.get("closure_ok", True) else "BREACH",
                        snap.get("closure_tolerance_pct", "?")))
    lines.append("  %-16s %12s %7s" % ("category", "seconds", "share"))
    for cat, secs in _categories(snap):
        share = secs / wall * 100.0 if wall > 0.0 else 0.0
        lines.append("  %-16s %12.3f %6.1f%%" % (cat, secs, share))
    extra = []
    if snap.get("resumes"):
        extra.append("resumes=%d" % snap["resumes"])
    if snap.get("restart_replay_steps"):
        extra.append("replayed_steps=%d" % snap["restart_replay_steps"])
    if snap.get("last_step") is not None:
        extra.append("last_step=%s" % snap["last_step"])
    if extra:
        lines.append("  " + "  ".join(extra))
    serving = snap.get("serving")
    if serving:
        gw = serving.get("gateway") or {}
        lines.append("  serving: rows=%d shed=%d padding=%.1f%% "
                     "drained=%d"
                     % (gw.get("rows_total", 0),
                        gw.get("shed_total", 0),
                        float(gw.get("padding_fraction", 0.0)) * 100.0,
                        gw.get("unregister_drained_total", 0)))
        dec = serving.get("decode") or {}
        if dec.get("idle_fraction") is not None:
            lines.append("  decode: slot idle fraction %.1f%% "
                         "(occupancy %.0f / %.0f slots)"
                         % (float(dec["idle_fraction"]) * 100.0,
                            dec.get("occupancy_total", 0.0),
                            dec.get("slots_total", 0.0)))
    return "\n".join(lines)


def merge_ledgers(snaps):
    """Fold per-rank ledgers into the pod view — same arithmetic the
    rank-0 fleet registry performs on the pushed counters (sum of
    per-category seconds, sum of walls)."""
    cats = {}
    wall = 0.0
    replay_steps = 0
    resumes = 0
    for snap in snaps:
        wall += float(snap.get("wall_s", 0.0))
        resumes += int(snap.get("resumes", 0))
        replay_steps += int(snap.get("restart_replay_steps", 0))
        for cat, secs in (snap.get("categories") or {}).items():
            cats[cat] = cats.get(cat, 0.0) + float(secs)
    goodput_s = sum(cats.get(c, 0.0) for c in goodput.GOODPUT_CATEGORIES)
    return {
        "rank": "all",
        "ranks": sorted(str(s.get("rank")) for s in snaps),
        "wall_s": wall,
        "categories": cats,
        "goodput_s": goodput_s,
        "goodput_ratio": goodput_s / wall if wall > 0.0 else 0.0,
        "resumes": resumes,
        "restart_replay_steps": replay_steps,
    }


def cmd_summary(args):
    snap = _load(args.ledger)
    print(render(snap, "rank %s (%s)"
                 % (snap.get("rank", "?"),
                    os.path.basename(args.ledger))))
    return 0


def cmd_merge(args):
    snaps = [_load(p) for p in args.ledgers]
    merged = merge_ledgers(snaps)
    print(render(merged, "%d ranks merged" % len(snaps)))
    for snap, path in zip(snaps, args.ledgers):
        wall = float(snap.get("wall_s", 0.0))
        print("    rank %-4s %10.3f s wall, goodput %5.1f%%  (%s)"
              % (snap.get("rank", "?"), wall,
                 float(snap.get("goodput_ratio", 0.0)) * 100.0,
                 os.path.basename(path)))
    return 0


def cmd_compare(args):
    before = _load(args.before)
    after = _load(args.after)
    bw = float(before.get("wall_s", 0.0)) or 1.0
    aw = float(after.get("wall_s", 0.0)) or 1.0
    cats = [c for c, _ in _categories(before)]
    cats += [c for c, _ in _categories(after) if c not in cats]
    print("Goodput compare — %s -> %s"
          % (os.path.basename(args.before),
             os.path.basename(args.after)))
    delta_ratio = (float(after.get("goodput_ratio", 0.0))
                   - float(before.get("goodput_ratio", 0.0))) * 100.0
    print("  goodput ratio    %6.1f%% -> %6.1f%%  (%+.1f pp)"
          % (float(before.get("goodput_ratio", 0.0)) * 100.0,
             float(after.get("goodput_ratio", 0.0)) * 100.0,
             delta_ratio))
    print("  %-16s %8s %8s %8s" % ("category", "before", "after",
                                   "delta"))
    worst = None
    for cat in cats:
        b = float((before.get("categories") or {}).get(cat, 0.0)) / bw
        a = float((after.get("categories") or {}).get(cat, 0.0)) / aw
        d = (a - b) * 100.0
        print("  %-16s %7.1f%% %7.1f%% %+7.1f pp"
              % (cat, b * 100.0, a * 100.0, d))
        if cat != "device_compute" and (worst is None or d > worst[1]):
            worst = (cat, d)
    if delta_ratio < 0 and worst is not None and worst[1] > 0:
        print("  regression: %.1f pp of goodput moved into %r"
              % (-delta_ratio, worst[0]))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="summary/merge/compare over committed goodput "
                    "ledger files (goodput.rank<R>.json).")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser("summary", help="render one rank's ledger")
    p_sum.add_argument("ledger")
    p_sum.set_defaults(fn=cmd_summary)

    p_merge = sub.add_parser(
        "merge", help="fold per-rank ledgers into the pod view")
    p_merge.add_argument("ledgers", nargs="+")
    p_merge.set_defaults(fn=cmd_merge)

    p_cmp = sub.add_parser(
        "compare", help="category-share deltas between two runs")
    p_cmp.add_argument("before")
    p_cmp.add_argument("after")
    p_cmp.set_defaults(fn=cmd_compare)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
