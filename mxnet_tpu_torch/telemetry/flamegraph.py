"""mxnet_tpu_torch.telemetry.flamegraph — pprof-style top-K and collapsed
stacks from the dispatch histograms and trace rings.

A copy of ``mxnet_tpu/telemetry/flamegraph.py``, which imports no JAX.

Two complementary views of "where does the time go":

1. **Top-K self time** (:func:`top` / :func:`render_top`) — the
   ``mx_dispatch_seconds{op}`` histogram family folded into a ranked
   table (calls, total, share, mean, p50/p99 from the bucket vectors).
   This is ``pprof -top`` for the dispatch path and is what
   ``profiler.dumps(format="top")`` renders.
2. **Collapsed stacks** (:func:`collapsed` / :func:`dump_collapsed`) —
   the trace rings' nested spans rebuilt into
   ``thread;outer;inner <self_time_us>`` lines, the folded-stack format
   every standard flamegraph tool consumes (flamegraph.pl, speedscope,
   inferno). Self time is each span's duration minus its children's, so
   the flame widths are honest — a parent that only dispatches shows
   thin, the op that actually burns the time shows wide.

Stack reconstruction uses the chrome events' ``ts``/``dur`` nesting per
thread track: events are sorted by start (ties: longer first, i.e.
parents before children) and a frame stack is maintained by popping
every frame that ended before the next event starts. Spans recorded
from ring overflow (oldest events silently dropped) can orphan a child
— it then roots its own stack, which is the right degradation for a
sampled view.
"""
from __future__ import annotations

import os
import re

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["top", "render_top", "collapsed", "dump_collapsed",
           "diff_top", "render_diff", "frame_label", "render_collapsed",
           "trace_exemplars"]

# Clock-granularity slack when deciding whether one span nests inside
# another (µs; perf_counter is ns-resolution but float µs rounding can
# put a child's end a hair past its parent's).
_NEST_SLACK_US = 0.5


def top(k=20, registry=None):
    """Rank ops by total self time. Returns up to ``k`` rows
    ``{op, calls, total_s, share, mean_ms, p50_ms, p99_ms}`` sorted by
    ``total_s`` descending; ``share`` is the fraction of the summed
    dispatch time. Dispatch spans do not nest (one per op call), so
    self time == total time here."""
    reg = registry or _metrics.REGISTRY
    fam = reg.get("mx_dispatch_seconds")
    rows = []
    if fam is not None:
        for (op,), child in fam.collect():
            snap = child.snapshot()
            if not snap["count"]:
                continue
            rows.append({
                "op": op, "calls": snap["count"],
                "total_s": snap["sum"],
                "mean_ms": snap["sum"] / snap["count"] * 1e3,
                "p50_ms": child.quantile(0.5) * 1e3,
                "p99_ms": child.quantile(0.99) * 1e3,
            })
    grand = sum(r["total_s"] for r in rows) or 1.0
    rows.sort(key=lambda r: r["total_s"], reverse=True)
    for row in rows:
        row["share"] = row["total_s"] / grand
    return rows[:int(k)]


def render_top(k=20, registry=None):
    """The ``pprof -top``-shaped table over :func:`top`."""
    rows = top(k=k, registry=registry)
    lines = [
        "Top %d ops by dispatch self time" % int(k),
        "%-40s %10s %12s %7s %10s %10s %10s"
        % ("Op", "Calls", "Total(ms)", "Share", "Mean(ms)", "P50(ms)",
           "P99(ms)"),
    ]
    for r in rows:
        lines.append(
            "%-40s %10d %12.3f %6.1f%% %10.3f %10.3f %10.3f"
            % (r["op"], r["calls"], r["total_s"] * 1e3,
               r["share"] * 100.0, r["mean_ms"], r["p50_ms"],
               r["p99_ms"]))
    if not rows:
        lines.append("(no dispatch spans recorded)")
    return "\n".join(lines)


def frame_label(func, filename, lineno):
    """Collapsed-stack frame key for one code location:
    ``func (file.py:123)``. Folding by function name ALONE merges every
    same-named method into one frame — a process full of ``run`` loops
    (decode workers, the prefetcher, the checkpoint writer) collapses
    into a single meaningless ``run`` tower — so the frame key carries
    the defining file:line. The location uses the file's basename:
    stable across checkouts/venv paths, unique enough with the line
    number, short enough to read on a flame."""
    return "%s (%s:%d)" % (func, os.path.basename(str(filename)),
                           int(lineno))


def render_collapsed(folded):
    """``{stack_path: self_us}`` -> collapsed-stack text (one
    ``path self_us`` line per stack, integer µs, zero-weight stacks
    dropped) — the exact format :func:`collapsed` emits, shared with
    the continuous profiler's windows."""
    return "\n".join("%s %d" % (path, round(us))
                     for path, us in sorted(folded.items())
                     if round(us) > 0) + ("\n" if folded else "")


def _track_stacks(events, root, folded):
    """Fold one thread track's complete events into ``folded``
    ({stack_path: self_time_us})."""
    spans = sorted(
        ((e["ts"], e.get("dur", 0.0), e["name"]) for e in events
         if e.get("ph") == "X"),
        key=lambda s: (s[0], -s[1]))
    stack = []              # [[path, start_us, end_us, child_time_us]]

    def pop():
        path, start, end, child_time = stack.pop()
        self_us = max(0.0, (end - start) - child_time)
        folded[path] = folded.get(path, 0.0) + self_us

    for ts, dur, name in spans:
        while stack and ts >= stack[-1][2] - _NEST_SLACK_US:
            pop()
        path = (stack[-1][0] + ";" + name) if stack else \
            (root + ";" + name)
        if stack:
            stack[-1][3] += dur
        stack.append([path, ts, ts + dur, 0.0])
    while stack:
        pop()


def collapsed(trace_data=None):
    """Fold trace events into collapsed-stack lines
    (``thread;span;child <self_us>``, one per unique stack, self time
    in integer microseconds). ``trace_data`` defaults to the live
    rings' :func:`mxnet_tpu_torch.telemetry.trace.chrome_trace` merge; pass a
    loaded dump (or ``tools/trace_merge.py`` output) to fold a file."""
    data = _trace.chrome_trace() if trace_data is None else trace_data
    events = data if isinstance(data, list) \
        else data.get("traceEvents", [])
    tracks = {}
    names = {}
    for event in events:
        key = (event.get("pid", 0), event.get("tid", 0))
        if event.get("ph") == "M" and event.get("name") == "thread_name":
            names[key] = (event.get("args") or {}).get("name") \
                or "tid-%s" % (key[1],)
            continue
        tracks.setdefault(key, []).append(event)
    folded = {}
    for key, track in sorted(tracks.items()):
        root = names.get(key, "tid-%s" % (key[1],))
        _track_stacks(track, root, folded)
    return render_collapsed(folded)


def dump_collapsed(path, trace_data=None):
    """Write :func:`collapsed` output to ``path`` atomically (the
    export module's tmp+fsync+rename commit); returns the path."""
    from . import export as _export

    _export.commit_bytes(path, collapsed(trace_data).encode("utf-8"))
    return path


# -- diffing two captures -----------------------------------------------------

def _parse_collapsed(capture):
    """``{stack_path: self_us}`` from a collapsed capture: a string of
    ``stack self_us`` lines (what :func:`collapsed` / a capture file
    holds) or an already-folded dict. Unparsable lines are skipped —
    a diff of a crashed job's capture must succeed on what committed."""
    if isinstance(capture, dict):
        return {str(k): float(v) for k, v in capture.items()}
    folded = {}
    for line in str(capture).splitlines():
        line = line.strip()
        if not line:
            continue
        path, _, us = line.rpartition(" ")
        if not path:
            continue
        try:
            folded[path] = folded.get(path, 0.0) + float(us)
        except ValueError:
            continue
    return folded


# Frame-location suffix frame_label appends ("func (file.py:123)"):
# stripped for cross-era diffs against captures folded before locations
# existed.
_LOC_RE = re.compile(r" \([^();]+:\d+\)$")


def _strip_loc(name):
    return _LOC_RE.sub("", name)


def _has_loc(leaf):
    return any(_LOC_RE.search(name) for name in leaf)


def trace_exemplars(folded):
    """Split the ``trace:<id>`` leaf markers (the continuous profiler
    tags onto threads holding a sampled TraceContext) out of a folded
    capture. Returns ``(clean_folded, exemplars)``: ``clean_folded``
    has the marker leaves stripped so the real hot frame is the leaf
    again, and ``exemplars`` maps each such frame to its
    ``{trace_id: self_us}`` evidence — a hot frame in a profile links
    to concrete traces in the merged timeline."""
    clean = {}
    exemplars = {}
    for path, us in folded.items():
        head, _, leaf = path.rpartition(";")
        if head and leaf.startswith("trace:"):
            trace_id = leaf[len("trace:"):]
            frame = head.rsplit(";", 1)[-1]
            by_id = exemplars.setdefault(frame, {})
            by_id[trace_id] = by_id.get(trace_id, 0.0) + us
            path = head
        clean[path] = clean.get(path, 0.0) + us
    return clean, exemplars


def _by_leaf(folded, strip_loc=False):
    """Fold full stacks down to leaf-frame self time (the op/span that
    actually burned the cycles, regardless of which thread or caller it
    ran under — two captures rarely share exact thread/stack shapes).
    ``strip_loc`` drops the ``(file:line)`` frame-key suffix — the
    compatibility fold for diffing a located capture against one from
    before frame keys carried locations."""
    leaf = {}
    for path, us in folded.items():
        name = path.rsplit(";", 1)[-1]
        if strip_loc:
            name = _strip_loc(name)
        leaf[name] = leaf.get(name, 0.0) + us
    return leaf


def diff_top(before, after, k=20, min_share=0.001):
    """Self-time **share** regressions between two collapsed captures.

    Each capture is normalized to its own total (absolute wall time is
    not comparable across runs of different length), folded to leaf
    frames, and compared: a row per op whose share of total self time
    moved, sorted worst regression first. Returns up to ``k`` rows
    ``{op, before_us, after_us, before_share, after_share, delta_pp}``
    (``delta_pp`` = after minus before share, in percentage points;
    positive = regressed). Ops below ``min_share`` in BOTH captures are
    noise and dropped.

    Frame keys may carry ``(file:line)`` locations (sampler captures,
    :func:`frame_label`) or not (span captures, pre-location files).
    When exactly ONE side carries locations the diff folds both to bare
    names — an old capture stays diffable against a new one instead of
    every frame reading as a 100% add/remove pair."""
    b_folded = _parse_collapsed(before)
    a_folded = _parse_collapsed(after)
    b_leaf = _by_leaf(b_folded)
    a_leaf = _by_leaf(a_folded)
    if _has_loc(b_leaf) != _has_loc(a_leaf):
        b_leaf = _by_leaf(b_folded, strip_loc=True)
        a_leaf = _by_leaf(a_folded, strip_loc=True)
    b_total = sum(b_leaf.values()) or 1.0
    a_total = sum(a_leaf.values()) or 1.0
    rows = []
    for op in set(b_leaf) | set(a_leaf):
        bs = b_leaf.get(op, 0.0) / b_total
        as_ = a_leaf.get(op, 0.0) / a_total
        if bs < min_share and as_ < min_share:
            continue
        rows.append({
            "op": op,
            "before_us": b_leaf.get(op, 0.0),
            "after_us": a_leaf.get(op, 0.0),
            "before_share": bs,
            "after_share": as_,
            "delta_pp": (as_ - bs) * 100.0,
        })
    rows.sort(key=lambda r: r["delta_pp"], reverse=True)
    return rows[:int(k)]


def render_diff(before, after, k=20, min_share=0.001):
    """Human table over :func:`diff_top` — regressions first, flagged
    when an op's self-time share grew by more than one point."""
    rows = diff_top(before, after, k=k, min_share=min_share)
    lines = [
        "Self-time share diff (worst regression first)",
        "%-40s %12s %8s %12s %8s %9s"
        % ("Op", "Before(ms)", "Share", "After(ms)", "Share", "Delta"),
    ]
    for r in rows:
        flag = "  << REGRESSED" if r["delta_pp"] > 1.0 else ""
        lines.append(
            "%-40s %12.3f %7.1f%% %12.3f %7.1f%% %+8.2fpp%s"
            % (r["op"], r["before_us"] / 1e3, r["before_share"] * 100.0,
               r["after_us"] / 1e3, r["after_share"] * 100.0,
               r["delta_pp"], flag))
    if not rows:
        lines.append("(no overlapping self time above the noise floor)")
    return "\n".join(lines)
