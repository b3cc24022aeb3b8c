"""Pretty-print / summarize flight-recorder diagnostic bundles::

    python -m mxnet_tpu_torch.tools.diagnose DIAG_DIR
    python -m mxnet_tpu_torch.tools.diagnose --merge diag.rank0.000003.json diag.rank1.000002.json
    python -m mxnet_tpu_torch.tools.diagnose --merge COLLECTED_DIR LOCAL_DIAG_DIR

Counterpart of the repo's ``tools/diagnose.py`` over the port's
``telemetry.recorder.DIAG_RE``, with the same text. The port's
``FlightRecorder`` commits one ``diag.rank<R>.<SEQ>.json`` bundle per
(rate-limited) anomaly — thread stacks, last-N trace spans, a registry
snapshot, anomaly history, data batch provenance, watchdog lanes, device
memory and compile accounting. This tool turns a bundle (or a directory
of them) back into something a human reads at 3am:

* **Summary** (default): one section per bundle — what fired, when,
  where every thread was, which batch was in flight, the anomaly
  history tail, device memory and compile totals.
* **`--merge`**: group bundles from MULTIPLE ranks into *incidents*
  (same anomaly kind within a `--window` of wall time) — one section
  per incident listing the ranks that fired, the union of in-flight
  batch ids, and each rank's stuck threads.
* **`--verbose`**: full stacks and span listings instead of tails.

Directories expand recursively into per-rank subdirectories
(`rank<R>/diag.rank<R>.<seq>.json` — the layout
`telemetry.healthplane.DiagCollector` commits when rank 0 pulls the
pod's bundles over the kvstore), so a rank-0 collected tree and a
shared-filesystem bundle directory summarize and `--merge`
interchangeably.

Bundles of either package read alike. The ``env:`` line names what the
bundle recorded: ``torch``, ``cuda`` and ``device`` (the card's name)
for a bundle of the port, ``jax`` for one of the JAX package. A card's
memory entry may carry no buffer count (``buffers`` None: the CUDA
allocator counts active blocks, not arrays); its line then omits it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from ..telemetry.recorder import DIAG_RE


_RANKDIR_RE = re.compile(r"^rank\d+$")


def _expand(paths):
    """Directories expand to their bundle files (sorted rank, seq),
    including one level of ``rank<R>/`` subdirectories — the
    DiagCollector layout rank 0 commits pulled bundles into; explicit
    files pass through."""
    out = []
    for path in paths:
        if os.path.isdir(path):
            found = []
            for name in os.listdir(path):
                m = DIAG_RE.match(name)
                sub = os.path.join(path, name)
                if m:
                    found.append((int(m.group(1)), int(m.group(2)), sub))
                elif _RANKDIR_RE.match(name) and os.path.isdir(sub):
                    for inner in os.listdir(sub):
                        m = DIAG_RE.match(inner)
                        if m:
                            found.append((int(m.group(1)),
                                          int(m.group(2)),
                                          os.path.join(sub, inner)))
            out.extend(p for _, _, p in sorted(found))
        else:
            out.append(path)
    return out


def load(path):
    """Load one bundle; unreadable/foreign files return None (a crashed
    job's directory must summarize on whatever committed)."""
    try:
        with open(path) as f:
            bundle = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(bundle, dict) or "meta" not in bundle:
        return None
    bundle["_path"] = path
    return bundle


def _when(wall):
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(float(wall)))
    except (TypeError, ValueError):
        return str(wall)


def _fmt_bytes(n):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return "%.1f%s" % (n, unit) if unit != "B" else "%dB" % n
        n /= 1024.0


def _thread_lines(threads, verbose):
    lines = []
    for th in threads or []:
        stack = th.get("stack") or []
        lines.append("  thread %r (ident %s)%s" % (
            th.get("name"), th.get("thread_id"),
            " [daemon]" if th.get("daemon") else ""))
        frames = stack if verbose else stack[-4:]
        if not verbose and len(stack) > 4:
            lines.append("      ... %d outer frames elided" %
                         (len(stack) - 4))
        for f in frames:
            lines.append("      %s:%s in %s" % (
                f.get("file"), f.get("line"), f.get("func")))
            if f.get("code"):
                lines.append("          %s" % f["code"])
    return lines


def _batch_ids(bundle):
    ids = []
    for entry in bundle.get("data") or []:
        last = (entry or {}).get("last_batch") or {}
        ids.extend(last.get("ids") or [])
    return ids


def _registry_highlights(bundle):
    """The counters a post-mortem reads first: anomalies + step count."""
    reg = bundle.get("registry") or {}
    lines = []
    for fam in reg.get("counters", []):
        if fam.get("name") not in ("mx_anomalies_total",
                                   "mx_nonfinite_total",
                                   "mx_train_steps_total",
                                   "mx_watchdog_fired_total",
                                   "mx_diag_bundles_total"):
            continue
        for values, value in fam.get("children", []):
            label = ",".join("%s=%s" % kv
                             for kv in zip(fam.get("labels", []), values))
            lines.append("  %s{%s} = %s" % (fam["name"], label, value))
    return lines


def summarize(bundle, verbose=False):
    """One bundle -> human text."""
    meta = bundle.get("meta", {})
    lines = []
    lines.append("=" * 72)
    lines.append("bundle %s" % bundle.get("_path", "<memory>"))
    lines.append("  kind=%s rank=%s seq=%s pid=%s" % (
        meta.get("kind"), meta.get("rank"), meta.get("seq"),
        meta.get("pid")))
    lines.append("  at %s (uptime %.1fs)" % (
        _when(meta.get("wall_time")), float(meta.get("uptime_s") or 0)))
    if meta.get("msg"):
        lines.append("  msg: %s" % meta["msg"])
    suppressed = meta.get("suppressed_since_last") or {}
    if suppressed:
        lines.append("  suppressed since previous bundle: %s" % suppressed)

    anomalies = bundle.get("anomalies") or {}
    history = anomalies.get("history") or []
    if history:
        lines.append("anomaly history (last %d):" % min(5, len(history)))
        for h in history[-5:]:
            lines.append("  %s %s: %s" % (_when(h.get("wall_time")),
                                          h.get("kind"), h.get("msg")))
    for mon in anomalies.get("monitors") or []:
        lines.append("monitor: steps=%s ewma_ms=%s anomalies=%s" % (
            mon.get("steps"), mon.get("ewma_ms"), mon.get("anomalies")))

    ids = _batch_ids(bundle)
    for entry in bundle.get("data") or []:
        wm = (entry or {}).get("watermark") or {}
        lines.append("data watermark: epoch=%s cursor=%s shard=%s/%s" % (
            wm.get("epoch"), wm.get("cursor"), wm.get("shard_index"),
            wm.get("num_shards")))
    if ids:
        lines.append("in-flight batch ids: %s" % ids)

    lanes = bundle.get("watchdog") or {}
    busy = {k: v for k, v in lanes.items()
            if isinstance(v, dict) and v.get("busy_s") is not None}
    if busy:
        for name, lane in busy.items():
            lines.append("watchdog lane %r IN FLIGHT %.2fs "
                         "(thread ident %s, ewma %s)" % (
                             name, lane["busy_s"], lane.get("thread_id"),
                             lane.get("ewma_s")))

    threads = bundle.get("threads")
    if isinstance(threads, list):
        lines.append("threads (%d):" % len(threads))
        lines.extend(_thread_lines(threads, verbose))

    spans = bundle.get("spans")
    if isinstance(spans, list) and spans:
        lines.append("last %d spans (newest last):" % len(spans))
        tail = spans if verbose else spans[-8:]
        if not verbose and len(spans) > 8:
            lines.append("  ... %d older spans elided" % (len(spans) - 8))
        for e in tail:
            dur = e.get("dur")
            lines.append("  %s%s%s" % (
                e.get("name"),
                "" if dur is None else " %.3fms" % (float(dur) / 1e3),
                " args=%s" % e.get("args") if e.get("args") else ""))

    mem = bundle.get("device_memory")
    if isinstance(mem, dict):
        for dev, rec in sorted(mem.items()):
            if not isinstance(rec, dict):
                continue
            buffers = rec.get("buffers")
            lines.append("device %s: %s live%s, peak %s" % (
                dev, _fmt_bytes(rec.get("bytes") or 0),
                "" if buffers is None else " (%s buffers)" % buffers,
                _fmt_bytes(rec.get("peak_bytes") or 0)))
    comp = bundle.get("compile")
    if isinstance(comp, dict) and comp:
        for site, rec in sorted(comp.items()):
            lines.append("compile %s: %s fills, %.3fs total" % (
                site, rec.get("count"), float(rec.get("total_s") or 0)))

    highlights = _registry_highlights(bundle)
    if highlights:
        lines.append("registry highlights:")
        lines.extend(highlights)

    exemplars = bundle.get("exemplars")
    if isinstance(exemplars, list) and exemplars:
        lines.append("exemplars: %d bucket->span links (e.g. %s le=%s "
                     "-> span %s)" % (
                         len(exemplars), exemplars[0].get("metric"),
                         exemplars[0].get("le"),
                         exemplars[0].get("span_id")))
    env = bundle.get("env") or {}
    if env.get("python"):
        lines.append("env: %s" % _env_line(env))
    return "\n".join(lines)


def _env_line(env):
    """``python X, jax Y, platform`` for a JAX bundle (the JAX tool's
    line); ``python X, torch Y, cuda Z, device NAME, platform`` for a
    port bundle, each part where the bundle recorded it."""
    parts = ["python %s" % env.get("python")]
    for key in ("jax", "torch", "cuda", "device"):
        if env.get(key) is not None:
            parts.append("%s %s" % (key, env[key]))
    parts.append(str(env.get("platform", "?")))
    return ", ".join(parts)


def merge_incidents(bundles, window_s=60.0):
    """Group bundles into incidents: same anomaly kind, wall times
    within ``window_s`` of the incident's first bundle. Bundles sorted
    by time; returns ``[{kind, t0, ranks, bundles, ids}]``."""
    ordered = sorted(bundles,
                     key=lambda b: float(b["meta"].get("wall_time") or 0))
    incidents = []
    for bundle in ordered:
        meta = bundle["meta"]
        kind = meta.get("kind")
        wall = float(meta.get("wall_time") or 0)
        home = None
        for inc in incidents:
            if inc["kind"] == kind and wall - inc["t0"] <= window_s:
                home = inc
                break
        if home is None:
            home = {"kind": kind, "t0": wall, "ranks": set(),
                    "bundles": [], "ids": set()}
            incidents.append(home)
        home["ranks"].add(meta.get("rank"))
        home["bundles"].append(bundle)
        home["ids"].update(_batch_ids(bundle))
    return incidents


def render_incident(inc, verbose=False):
    lines = ["#" * 72,
             "INCIDENT kind=%s at %s — %d bundle(s) from rank(s) %s" % (
                 inc["kind"], _when(inc["t0"]), len(inc["bundles"]),
                 sorted(inc["ranks"]))]
    if inc["ids"]:
        lines.append("union of in-flight batch ids: %s"
                     % sorted(inc["ids"]))
    for bundle in inc["bundles"]:
        lines.append(summarize(bundle, verbose=verbose))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Summarize flight-recorder diagnostic bundles "
                    "(and merge per-rank bundles into incidents).")
    parser.add_argument("inputs", nargs="+",
                        help="bundle files or directories of "
                             "diag.rank<R>.<SEQ>.json")
    parser.add_argument("--merge", action="store_true",
                        help="group bundles across ranks into incidents "
                             "(same kind within --window seconds)")
    parser.add_argument("--window", type=float, default=60.0,
                        help="incident grouping window in seconds")
    parser.add_argument("--verbose", action="store_true",
                        help="full stacks and span listings")
    args = parser.parse_args(argv)

    bundles = [b for b in (load(p) for p in _expand(args.inputs))
               if b is not None]
    if not bundles:
        print("no readable diagnostic bundles in %s" % (args.inputs,))
        return 1
    if args.merge:
        for inc in merge_incidents(bundles, window_s=args.window):
            print(render_incident(inc, verbose=args.verbose))
    else:
        for bundle in bundles:
            print(summarize(bundle, verbose=args.verbose))
    print("\n%d bundle(s) summarized" % len(bundles))
    return 0


if __name__ == "__main__":
    sys.exit(main())
