"""mxnet_tpu_torch.telemetry.goodput — wall-clock-complete accounting of
useful work vs. badput, durable across restarts, aggregated fleet-wide.

A copy of ``mxnet_tpu/telemetry/goodput.py``, which imports no JAX.

The rest of the telemetry teaches the stack to explain a *step* (phase
attribution, overlap accounting, compile timing, hang detection) but
not a *run*: nothing answered "of the last N hours of wall-clock, how
many seconds were useful training/serving work, and which subsystem ate
the rest?" — the number preemptible accelerator time is budgeted against.
:class:`GoodputLedger` closes that gap by folding the telemetry the
system already emits into a mutually-exclusive, collectively-exhaustive
category taxonomy whose members are REQUIRED to sum to wall-clock:

==================  ==========================================================
``device_compute``  goodput — the device chewing the fused step
                    (``mx_step_phase_seconds{phase="device_compute"}``)
``compile``         XLA tracing/compilation (``mx_compile_seconds`` sums,
                    all sites); compile that ran inside a step's
                    dispatch/other slice is de-overlapped, not double-booked
``input_stall``     the loop blocked on the input pipeline (``data_wait``)
``h2d``             host→device placement on the step thread
``exposed_comm``    gradient-sync seconds NOT hidden behind compute:
                    attribution's ``allreduce`` phase plus the Trainer's
                    ``reduce − reduce_hidden`` counter gap
``checkpoint``      the synchronous slice of checkpoint saves
``restart_replay``  steps re-run after a crash: everything booked between
                    the restore watermark and the last step the previous
                    incarnation committed to its ledger
``hang_recovery``   watchdog-detected hang intervals (lane wait seconds at
                    fire time)
``idle``            the derived remainder — wall-clock no category claims
``other``           host-side step time no phase claims (dispatch, GIL,
                    callbacks), after compile de-overlap
==================  ==========================================================

**Closure** is the contract the per-subsystem metrics never offered:
``idle`` is *derived* (``wall − Σ booked``), so the categories sum to
wall-clock *by construction* when the ledger undercounts — and
``closure_pct`` measures the only possible failure, overcounting
(``Σ booked > wall`` means two sources claimed the same second).

**Durability**: the ledger commits ``goodput.rank<R>.json`` atomically
via :func:`export.commit_bytes` on a cadence
(``MXNET_GOODPUT_INTERVAL_S``). A restarted process loads the prior
file as its baseline; :meth:`resume_from` arms a replay window from the
checkpoint restore step to the prior incarnation's last committed step,
and every step booked inside the window lands in ``restart_replay`` —
a SIGKILL'd-and-resumed run tells the truth about its own rework.

**Fleet**: :meth:`update` publishes booked seconds into
``mx_goodput_seconds_total{category}`` (+ ``mx_goodput_wall_seconds_total``
and the ``mx_goodput_ratio`` gauge), which ride the existing
``telemetry_push`` aggregation channel; rank 0's merged registry then
carries per-rank AND ``rank="all"`` summed series, and
:func:`fleet_snapshot` renders the pod-wide ledger from it.

**Serving analog**: :func:`serving_snapshot` folds the gateway/decode
counters into useful-vs-shed work, bucket-padding waste from
the ladder, drain-before-unregister accounting and decode slot-idle
fraction — the ledger's ``serving`` section when those families exist.

Read surfaces — all rendering the SAME numbers from the same ledger
state: ``GET /debug/goodput`` (HealthPlane), the ``goodput`` section of
FlightRecorder bundles (via :func:`active_ledger`), and
``tools/goodput_report.py`` (summary / ``--merge`` / ``--compare``).
"""
from __future__ import annotations

import json
import os
import threading
import time

from . import metrics as _metrics
from .. import env as _env
from .. import log as _log

__all__ = ["GoodputLedger", "CATEGORIES", "GOODPUT_CATEGORIES",
           "ledger_name", "install", "uninstall", "active_ledger",
           "serving_snapshot", "fleet_snapshot", "load_ledger"]

# The MECE taxonomy. Order is the report/render order: goodput first,
# then badput by "how directly fixable", idle/other last.
CATEGORIES = ("device_compute", "compile", "input_stall", "h2d",
              "exposed_comm", "checkpoint", "restart_replay",
              "hang_recovery", "idle", "other")
GOODPUT_CATEGORIES = ("device_compute",)

# Attribution phase -> ledger category. dispatch intentionally absent:
# it pools with attribution's "other" into the ledger's "other" so the
# compile de-overlap (compile wall lives inside dispatch) has one pool
# to subtract from.
_PHASE_CATEGORY = {
    "device_compute": "device_compute",
    "data_wait": "input_stall",
    "h2d": "h2d",
    "allreduce": "exposed_comm",
    "checkpoint": "checkpoint",
}

_HELP_SECONDS = ("Wall-clock seconds attributed per goodput/badput "
                 "category (device_compute is goodput; idle is the "
                 "derived remainder, published as a high-watermark)")
_HELP_WALL = ("Ledger-observed wall-clock seconds this process "
              "(denominator for fleet goodput ratios)")
_HELP_RATIO = ("goodput share of wall-clock (device_compute / wall) "
               "including prior incarnations of this rank's ledger")

_logger = _log.get_logger("mxnet_tpu_torch.telemetry")

LEDGER_FORMAT = 1


def ledger_name(rank):
    """Canonical per-rank ledger file name."""
    return "goodput.rank%d.json" % int(rank)


# -- the active ledger (recorder bundles / health plane default) --------------

_active = [None]


def install(ledger):
    """Make ``ledger`` the process's active ledger — the one
    FlightRecorder bundles and ``/debug/goodput`` pick up when no
    explicit instance was attached. Returns the ledger."""
    _active[0] = ledger
    return ledger


def uninstall(ledger=None):
    """Clear the active ledger (only if it IS ``ledger`` when one is
    given — a later install wins)."""
    if ledger is None or _active[0] is ledger:
        _active[0] = None


def active_ledger():
    return _active[0]


# -- registry reading helpers --------------------------------------------------

def _counter_sum(reg, name):
    """Sum of every child of a counter family (0.0 when absent)."""
    fam = reg.get(name)
    if fam is None or fam.kind != "counter":
        return 0.0
    return float(sum(child.value for _, child in fam.collect()))


def _histogram_sum(reg, name):
    """Sum of observed values across every child of a histogram family
    (0.0 when absent)."""
    fam = reg.get(name)
    if fam is None or fam.kind != "histogram":
        return 0.0
    total = 0.0
    for _, child in fam.collect():
        total += float(child.snapshot()["sum"])
    return total


# -- the ledger ----------------------------------------------------------------

class GoodputLedger:
    """Closure-checked goodput/badput accounting for one rank.

    Parameters
    ----------
    directory : ledger root; ``goodput.rank<R>.json`` is committed
        there atomically on the :meth:`tick` cadence and loaded back as
        the baseline after a restart. Default: the ``MXNET_GOODPUT_DIR``
        knob; empty means in-memory only (no durability, no resume).
    rank : ledger identity (default :func:`export.default_rank`).
    interval_s : commit/update cadence for :meth:`tick` (default the
        ``MXNET_GOODPUT_INTERVAL_S`` knob; 0 commits on every tick —
        what the crash-accounting tests use).
    closure_pct : overcount tolerance in percent (default the
        ``MXNET_GOODPUT_CLOSURE_PCT`` knob); a snapshot past it warns
        rate-limited and reports ``closure_ok: false``.
    attribution : StepAttribution, optional — with one attached, every
        :meth:`update` folds the per-phase counter deltas into
        categories (attribution mode, the closure-tight mode). Without
        one, book steps yourself via ``observe_step(step, seconds)``
        (direct mode: the whole step is goodput, or ``restart_replay``
        inside the replay window).
    watchdog : HangWatchdog, optional — new ``fired`` entries are
        consumed into ``hang_recovery`` (an index watermark; entries
        fired before attach are not booked).
    registry : metric source AND publish target (default the global
        REGISTRY — what attribution/compile/trainer/serving write to).
    clock : injectable monotonic clock.

    Drive it with ``tick(step=num_update)`` from the training loop;
    serving-only processes can tick without a step. ``update()`` forces
    an immediate fold, ``commit()`` an immediate durable write.
    """

    def __init__(self, directory=None, rank=None, interval_s=None,
                 closure_pct=None, attribution=None, watchdog=None,
                 registry=None, clock=time.monotonic):
        from . import export as _export

        if directory is None:
            directory = _env.get("MXNET_GOODPUT_DIR") or None
        self.directory = directory
        self.rank = _export.default_rank() if rank is None else int(rank)
        self.interval_s = float(_env.get("MXNET_GOODPUT_INTERVAL_S")
                                if interval_s is None else interval_s)
        self.closure_pct = float(_env.get("MXNET_GOODPUT_CLOSURE_PCT")
                                 if closure_pct is None else closure_pct)
        self._attribution = attribution
        self._watchdog = watchdog
        self._watchdog_idx = (len(watchdog.fired)
                              if watchdog is not None else 0)
        self._registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._last_commit = None
        self._totals = {c: 0.0 for c in CATEGORIES if c != "idle"}
        self._published = {}        # category -> seconds inc'ed so far
        self._published_wall = 0.0
        # Source cursors: only activity DURING this ledger's lifetime
        # is booked, so a late-constructed ledger does not swallow a
        # process's whole metric history as if it just happened.
        self._cursor_phase = {}
        self._cursor_compile = _histogram_sum(self._registry,
                                              "mx_compile_seconds")
        self._cursor_reduce = _counter_sum(
            self._registry, "mx_trainer_reduce_seconds_total")
        self._cursor_hidden = _counter_sum(
            self._registry, "mx_trainer_reduce_hidden_seconds_total")
        fam = self._registry.get("mx_step_phase_seconds")
        if fam is not None:
            for values, child in fam.collect():
                self._cursor_phase[values[0]] = float(child.value)
        # Durable baseline (a prior incarnation's committed ledger).
        self._base = {c: 0.0 for c in CATEGORIES}
        self._base_wall = 0.0
        self._base_replay_steps = 0
        self._resumes = 0
        self._loaded_last_step = None
        self._last_step = None
        self._replay_until = None       # step watermark while replaying
        self._replay_steps_run = 0
        self._path = None
        if self.directory:
            self._path = os.path.join(self.directory,
                                      ledger_name(self.rank))
            self._load_baseline()
        self._seconds_fam = self._registry.counter(
            "mx_goodput_seconds_total", _HELP_SECONDS,
            labels=("category",))
        self._wall_fam = self._registry.counter(
            "mx_goodput_wall_seconds_total", _HELP_WALL)
        self._ratio_gauge = self._registry.gauge(
            "mx_goodput_ratio", _HELP_RATIO)

    # -- durable baseline ------------------------------------------------------

    def _load_baseline(self):
        """Adopt a prior incarnation's committed ledger as the
        baseline. A corrupt/unreadable file starts fresh (warned) —
        accounting must never block a restart."""
        try:
            with open(self._path, "rb") as fh:
                prior = json.loads(fh.read().decode("utf-8"))
        except FileNotFoundError:
            return
        except (OSError, ValueError, UnicodeDecodeError) as exc:
            _log.warn_rate_limited(
                _logger, "goodput:load:%s" % self._path, 60.0,
                "goodput ledger %s unreadable (%r); starting fresh",
                self._path, exc)
            return
        try:
            cats = prior.get("categories") or {}
            for c in CATEGORIES:
                self._base[c] = float(cats.get(c, 0.0))
            self._base_wall = float(prior.get("wall_s", 0.0))
            self._base_replay_steps = int(
                prior.get("restart_replay_steps", 0))
            self._resumes = int(prior.get("resumes", 0))
            last = prior.get("last_step")
            self._loaded_last_step = None if last is None else int(last)
        except (TypeError, ValueError) as exc:
            _log.warn_rate_limited(
                _logger, "goodput:load:%s" % self._path, 60.0,
                "goodput ledger %s malformed (%r); starting fresh",
                self._path, exc)
            self._base = {c: 0.0 for c in CATEGORIES}
            self._base_wall = 0.0
            self._base_replay_steps = 0
            self._resumes = 0
            self._loaded_last_step = None

    @property
    def loaded_last_step(self):
        """The last step the PRIOR incarnation committed (None when no
        ledger file was resumed) — the replay watermark
        :meth:`resume_from` arms against."""
        return self._loaded_last_step

    def resume_from(self, restore_step):
        """Declare a post-crash restore at ``restore_step`` (the step
        :class:`CheckpointManager` handed back). Arms the replay
        window: everything booked until the step counter passes the
        prior incarnation's last committed step is ``restart_replay``
        badput. Returns the replay watermark, or None when there is
        nothing to replay (no prior ledger, or the checkpoint was at
        least as fresh)."""
        restore_step = int(restore_step)
        with self._lock:
            self._resumes += 1
            self._last_step = restore_step
            if self._loaded_last_step is not None and \
                    restore_step < self._loaded_last_step:
                self._replay_until = self._loaded_last_step
            else:
                self._replay_until = None
            return self._replay_until

    # -- booking ---------------------------------------------------------------

    def _replaying_locked(self):
        return (self._replay_until is not None and
                (self._last_step is None or
                 self._last_step < self._replay_until))

    def note_step(self, step):
        """Advance the step watermark without booking time (attribution
        mode — the phase counters carry the seconds)."""
        self.observe_step(step, None)

    def observe_step(self, step, seconds=None):
        """Advance the step watermark; with ``seconds``, book the whole
        step (direct mode): ``device_compute`` goodput, or
        ``restart_replay`` while inside the replay window."""
        step = int(step)
        with self._lock:
            replaying = (self._replay_until is not None and
                         step <= self._replay_until)
            if replaying and (self._last_step is None or
                              step > self._last_step):
                self._replay_steps_run += 1
            if self._last_step is None or step > self._last_step:
                self._last_step = step
            if not replaying:
                self._replay_until = None
            if seconds is not None:
                cat = "restart_replay" if replaying else "device_compute"
                self._totals[cat] += float(seconds)

    def book(self, category, seconds):
        """Book seconds into a category directly (escape hatch for
        subsystems the fold does not cover)."""
        if category not in self._totals:
            raise ValueError("unknown goodput category %r (idle is "
                             "derived, not bookable)" % (category,))
        with self._lock:
            self._totals[category] += float(seconds)

    def attach_watchdog(self, watchdog):
        """Consume ``watchdog.fired`` entries (from now on) into
        ``hang_recovery``. Returns the watchdog."""
        with self._lock:
            self._watchdog = watchdog
            self._watchdog_idx = len(watchdog.fired)
        return watchdog

    # -- the fold --------------------------------------------------------------

    def update(self):
        """One accounting pass: fold new counter/histogram deltas into
        category totals and publish the fleet metrics. Never raises
        from the attribution sub-pass (accounting must not kill the
        loop)."""
        if self._attribution is not None:
            try:
                self._attribution.update()
            except Exception as exc:
                _log.warn_rate_limited(
                    _logger, "goodput:attr:%d" % id(self), 60.0,
                    "goodput attribution pass failed (will retry): %s",
                    exc)
        with self._lock:
            self._fold_locked()
            snap = self._snapshot_locked()
            self._publish_locked(snap)
        return snap

    def _fold_locked(self):
        reg = self._registry
        replaying = self._replaying_locked()
        # Step phases (attribution mode only: in direct mode the step
        # seconds arrive via observe_step and folding the counters too
        # would double-book any attribution running elsewhere).
        pending_other = 0.0
        if self._attribution is not None:
            fam = reg.get("mx_step_phase_seconds")
            if fam is not None:
                for values, child in fam.collect():
                    phase = values[0]
                    cur = float(child.value)
                    delta = cur - self._cursor_phase.get(phase, 0.0)
                    self._cursor_phase[phase] = cur
                    if delta <= 0.0:
                        continue
                    if replaying:
                        self._totals["restart_replay"] += delta
                    elif phase in ("dispatch", "other"):
                        pending_other += delta
                    else:
                        self._totals[_PHASE_CATEGORY[phase]] += delta
        # Compile: histogram sums across sites. Compile wall that ran
        # inside a step lives in the dispatch/other slice — subtract
        # the overlap there so the second is booked once, as compile.
        comp = _histogram_sum(reg, "mx_compile_seconds")
        comp_delta = max(0.0, comp - self._cursor_compile)
        self._cursor_compile = comp
        if comp_delta > 0.0:
            overlap = min(comp_delta, pending_other)
            pending_other -= overlap
            self._totals["compile"] += comp_delta
        self._totals["other"] += pending_other
        # Exposed communication the Trainer path measures itself
        # (reduce busy seconds minus the part hidden behind compute).
        reduce = _counter_sum(reg, "mx_trainer_reduce_seconds_total")
        hidden = _counter_sum(reg,
                              "mx_trainer_reduce_hidden_seconds_total")
        exposed = max(0.0, (reduce - self._cursor_reduce) -
                      (hidden - self._cursor_hidden))
        self._cursor_reduce = reduce
        self._cursor_hidden = hidden
        if exposed > 0.0:
            self._totals["exposed_comm"] += exposed
        # Watchdog hang intervals: each fire books the lane's waited
        # seconds once (index watermark over the fired list).
        if self._watchdog is not None:
            fired = self._watchdog.fired
            while self._watchdog_idx < len(fired):
                entry = fired[self._watchdog_idx]
                self._watchdog_idx += 1
                try:
                    self._totals["hang_recovery"] += float(entry[2])
                except (TypeError, ValueError, IndexError):
                    pass

    def _publish_locked(self, snap):
        """Publish cumulative category seconds as monotonic counters
        (inc by growth since last publish). ``idle`` shrinks when a
        late fold claims seconds an earlier snapshot left idle, so its
        counter is a high-watermark — transient overstatement bounded
        by one update interval's booking lag."""
        for cat in CATEGORIES:
            total = snap["categories"][cat]
            prev = self._published.get(cat, 0.0)
            if total > prev:
                self._seconds_fam.labels(category=cat).inc(total - prev)
                self._published[cat] = total
        wall = snap["wall_s"]
        if wall > self._published_wall:
            self._wall_fam.inc(wall - self._published_wall)
            self._published_wall = wall
        self._ratio_gauge.set(snap["goodput_ratio"])

    # -- reading ---------------------------------------------------------------

    def _snapshot_locked(self):
        run_wall = max(0.0, self._clock() - self._t0)
        run_booked = sum(self._totals.values())
        run_idle = run_wall - run_booked
        cats = {}
        for c in CATEGORIES:
            if c == "idle":
                cats[c] = self._base[c] + max(0.0, run_idle)
            else:
                cats[c] = self._base[c] + self._totals[c]
        wall = self._base_wall + run_wall
        closure_pct = (max(0.0, -run_idle) / run_wall * 100.0
                       if run_wall > 0.0 else 0.0)
        goodput = sum(cats[c] for c in GOODPUT_CATEGORIES)
        run_cats = dict(self._totals)
        run_cats["idle"] = max(0.0, run_idle)
        return {
            "version": LEDGER_FORMAT,
            "rank": self.rank,
            "wall_s": wall,
            "categories": cats,
            "goodput_s": goodput,
            "goodput_ratio": goodput / wall if wall > 0.0 else 0.0,
            "closure_pct": closure_pct,
            "closure_tolerance_pct": self.closure_pct,
            "closure_ok": closure_pct <= self.closure_pct,
            "last_step": self._last_step,
            "resumes": self._resumes,
            "restart_replay_steps": (self._base_replay_steps +
                                     self._replay_steps_run),
            "replaying": self._replaying_locked(),
            "updated_unix": time.time(),
            "this_run": {"wall_s": run_wall, "categories": run_cats},
        }

    def snapshot(self, serving=True):
        """JSON-able ledger state (``/debug/goodput``, bundle sections,
        the durable file). With ``serving=True`` (default) the gateway/
        decode analog is folded in when those families exist."""
        with self._lock:
            snap = self._snapshot_locked()
        if snap["closure_pct"] > self.closure_pct:
            _log.warn_rate_limited(
                _logger, "goodput:closure:%d" % id(self), 60.0,
                "goodput closure breached: categories overcount "
                "wall-clock by %.2f%% (tolerance %.2f%%) — two sources "
                "booked the same second", snap["closure_pct"],
                self.closure_pct)
        if serving:
            snap["serving"] = serving_snapshot(self._registry)
        return snap

    # -- durability ------------------------------------------------------------

    def commit(self):
        """Fold + atomically commit the ledger file NOW. Returns the
        path, or None (in-memory ledger, or a failed write — warned,
        never raised; the previous committed file survives intact)."""
        from . import export as _export

        snap = self.update()
        if self._path is None:
            return None
        try:
            _export.commit_bytes(
                self._path,
                json.dumps(snap, sort_keys=True).encode("utf-8"))
        except OSError as exc:
            _log.warn_rate_limited(
                _logger, "goodput:commit:%s" % self._path, 60.0,
                "goodput ledger commit to %s failed (will retry): %s",
                self._path, exc)
            return None
        return self._path

    def tick(self, step=None):
        """Step-loop cadence call: advance the step watermark, and once
        per ``interval_s`` run a fold + durable commit. Cheap when the
        cadence has not elapsed (a clock read and a compare)."""
        if step is not None:
            self.note_step(step)
        now = self._clock()
        if self._last_commit is not None and \
                now - self._last_commit < self.interval_s:
            return None
        self._last_commit = now
        return self.commit()

    def close(self, commit=True):
        """Final commit (by default) and release the active-ledger slot
        if this instance holds it."""
        if commit:
            self.commit()
        uninstall(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- serving analog ------------------------------------------------------------

def serving_snapshot(registry=None):
    """Fold the gateway/decode families into the serving goodput view:
    useful rows vs. shed/expired work, bucket-padding waste from the
    ladder, drain-before-unregister accounting, and decode slot-idle
    fraction. Returns None when no serving family exists (training-only
    processes keep their ledgers clean)."""
    reg = registry or _metrics.REGISTRY
    rows_fam = reg.get("mx_serving_gateway_rows_total")
    batches_fam = reg.get("mx_serving_gateway_batches_total")
    shed_fam = reg.get("mx_serving_gateway_shed_total")
    occ_fam = reg.get("mx_decode_slot_occupancy")
    if rows_fam is None and batches_fam is None and shed_fam is None \
            and occ_fam is None:
        return None
    rows = _counter_sum(reg, "mx_serving_gateway_rows_total")
    # Padding waste: every batch executes bucket-many rows; the gap to
    # the real row count is device work spent on padding.
    capacity = 0.0
    if batches_fam is not None:
        idx = list(batches_fam.labelnames).index("bucket") \
            if "bucket" in batches_fam.labelnames else None
        for values, child in batches_fam.collect():
            if idx is None:
                continue
            try:
                capacity += int(values[idx]) * float(child.value)
            except (TypeError, ValueError):
                continue
    padded = max(0.0, capacity - rows)
    shed = {}
    if shed_fam is not None and "reason" in shed_fam.labelnames:
        ridx = list(shed_fam.labelnames).index("reason")
        for values, child in shed_fam.collect():
            reason = values[ridx]
            shed[reason] = shed.get(reason, 0.0) + float(child.value)
    decode = {}
    occ_total = 0.0
    if occ_fam is not None:
        for values, child in occ_fam.collect():
            model = values[0] if values else ""
            occupancy = float(child.value)
            occ_total += occupancy
            decode[model] = {"occupancy": occupancy}
    slots_by = {}
    slots_fam = reg.get("mx_decode_slots")
    if slots_fam is not None:
        for values, child in slots_fam.collect():
            slots_by[values[0] if values else ""] = float(child.value)
    slots_total = 0.0
    for model, rec in decode.items():
        slots = slots_by.get(model)
        if slots:
            slots_total += slots
            rec["slots"] = slots
            rec["idle_fraction"] = max(
                0.0, 1.0 - rec["occupancy"] / slots)
    out = {
        "gateway": {
            "requests_total": _counter_sum(
                reg, "mx_serving_gateway_requests_total"),
            "rows_total": rows,
            "padded_rows_total": padded,
            "padding_fraction": (padded / capacity
                                 if capacity > 0.0 else 0.0),
            "shed": shed,
            "shed_total": sum(shed.values()),
            "unregister_drained_total": _counter_sum(
                reg, "mx_gateway_unregister_drained_total"),
        },
        "decode": {
            "models": decode,
            "tokens_total": _counter_sum(reg, "mx_decode_tokens_total"),
            "steps_total": _counter_sum(reg, "mx_decode_steps_total"),
            "occupancy_total": occ_total,
            "slots_total": slots_total,
            "idle_fraction": (max(0.0, 1.0 - occ_total / slots_total)
                              if slots_total > 0.0 else None),
        },
    }
    return out


# -- fleet view ----------------------------------------------------------------

def fleet_snapshot(registry):
    """Render the pod-wide ledger from a merged fleet registry (rank
    0's ``Aggregator.fleet``): per-rank category seconds, the summed
    ``rank="all"`` series the merge adds, and the fleet goodput ratio.
    Returns None before any rank published goodput counters."""
    fam = registry.get("mx_goodput_seconds_total") \
        if registry is not None else None
    if fam is None:
        return None
    rlabel = "src_rank" if "src_rank" in fam.labelnames else "rank"
    try:
        ridx = list(fam.labelnames).index(rlabel)
        cidx = list(fam.labelnames).index("category")
    except ValueError:
        return None
    ranks = {}
    for values, child in fam.collect():
        rank = str(values[ridx])
        cat = values[cidx]
        ranks.setdefault(rank, {})[cat] = float(child.value)
    merged = ranks.pop("all", None)
    if merged is None:
        merged = {}
        for cats in ranks.values():
            for cat, seconds in cats.items():
                merged[cat] = merged.get(cat, 0.0) + seconds
    walls = {}
    wall_fam = registry.get("mx_goodput_wall_seconds_total")
    if wall_fam is not None and rlabel in wall_fam.labelnames:
        widx = list(wall_fam.labelnames).index(rlabel)
        for values, child in wall_fam.collect():
            walls[str(values[widx])] = float(child.value)
    wall_all = walls.pop("all", None)
    if wall_all is None:
        wall_all = sum(walls.values())
    goodput = sum(merged.get(c, 0.0) for c in GOODPUT_CATEGORIES)
    return {
        "ranks": ranks,
        "all": merged,
        "wall_s": walls,
        "wall_all_s": wall_all,
        "goodput_s": goodput,
        "goodput_ratio": goodput / wall_all if wall_all > 0.0 else 0.0,
    }


def load_ledger(path):
    """Read one committed ledger file (the report CLI's loader).
    Raises ValueError on a malformed file."""
    with open(path, "rb") as fh:
        data = json.loads(fh.read().decode("utf-8"))
    if not isinstance(data, dict) or "categories" not in data:
        raise ValueError("%s is not a goodput ledger (no categories)"
                         % path)
    return data
