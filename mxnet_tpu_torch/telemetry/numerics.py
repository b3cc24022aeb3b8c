"""mxnet_tpu_torch.telemetry.numerics — numeric-health guards with batch
provenance.

Counterpart of ``mxnet_tpu/telemetry/numerics.py``: the JAX package
queues a jitted ``jnp.isfinite(v).all()`` per bucket, the port queues
``torch.isfinite(flat).all()``, a 0-d tensor on the bucket's device
that :meth:`NumericGuard.flush` reads for the whole apply at once.

A loss that goes NaN at step 48,000 is cheap to *detect* and expensive
to *debug*: by the time a human looks, the batch that poisoned it is
gone. :class:`NumericGuard` is the detection half wired for forensics —
opt-in, cadence-gated ``isfinite`` checks at the two spots where one
reduction covers the whole model:

* **Loss** — ``guard.check_loss(loss, step=i, batch_ids=batch.index)``
  after each step (or on an ``every=N`` cadence). One scalar check;
  reading the loss forces the same device sync a training loop's
  logging read already pays.
* **Fused-update flat buckets** — ``guard.install(trainer._applier)``
  hooks the FusedApplier: after each coalesced apply, ONE device-side
  ``isfinite(flat).all()`` reduction per bucket runs over the flat
  vectors the applier already maintains, so the cost is O(buckets),
  not O(params). A NaN/Inf gradient anywhere in a 25 MB bucket trips
  it the same step it happens.

A violation raises a ``nonfinite`` anomaly through
``StepMonitor.record_anomaly`` carrying the step and in-flight batch
ids — an attached :class:`~mxnet_tpu_torch.telemetry.recorder.FlightRecorder`
turns that into a bundle naming the exact samples to replay. With
``halt=True`` the guard additionally raises :class:`NonFiniteError`
after recording, stopping the job before it burns further compute on
poisoned state (restore the last checkpoint, skip or inspect the named
batch).

The every-step configuration costs one host sync per armed apply,
after every bucket has been dispatched.
"""
from __future__ import annotations

import time

import numpy as np

from . import metrics as _metrics
from .. import log as _log

__all__ = ["NumericGuard", "NonFiniteError"]

_checks_total = _metrics.REGISTRY.counter(
    "mx_numeric_checks_total",
    "Numeric-health isfinite checks run", labels=("site",))
_nonfinite_total = _metrics.REGISTRY.counter(
    "mx_nonfinite_total",
    "Non-finite values caught by the numeric guards", labels=("site",))


class NonFiniteError(ArithmeticError):
    """Raised by a ``halt=True`` NumericGuard after recording the
    ``nonfinite`` anomaly (and bundle); the message names the site,
    step and in-flight batch ids."""


class NumericGuard:
    """Parameters
    ----------
    monitor : StepMonitor, optional — violations fire
        ``record_anomaly("nonfinite", ...)`` (counted, warned, bundled
        by an attached FlightRecorder). Preferred wiring.
    recorder : FlightRecorder, optional — direct capture when no
        monitor is in play.
    every : check cadence — 1 checks every step (default), N every Nth,
        0 disables all checks (the guard becomes free).
    halt : raise :class:`NonFiniteError` after recording a violation.
    pipeline : DataPipeline, optional — batch-id provenance is read
        from its ``debug_state()`` when the caller did not pass ids
        explicitly.

    The loss and grad sites keep independent cadence counters, so
    mixing ``check_loss`` per step with an installed fused-update hook
    keeps both on the declared cadence.
    """

    def __init__(self, monitor=None, recorder=None, every=1, halt=False,
                 pipeline=None):
        self._monitor = monitor
        self._recorder = recorder
        self.every = int(every)
        self.halt = bool(halt)
        self._pipeline = pipeline
        self._counts = {}           # site -> checks requested
        self._step = None
        self._ids = None
        self.violations = []        # (site, step, ids, detail)
        self._pending = []          # queued device-side check results

    # -- provenance -----------------------------------------------------------

    def observe_batch(self, step=None, batch_ids=None):
        """Set the provenance attached to the NEXT violation (call at
        the top of the step loop; overridden by explicit ``check_loss``
        arguments)."""
        if step is not None:
            self._step = step
        if batch_ids is not None:
            self._ids = self._id_list(batch_ids)

    def watch_pipeline(self, pipeline):
        """Read batch-id provenance from a DataPipeline at violation
        time. Returns the pipeline."""
        self._pipeline = pipeline
        return pipeline

    def install(self, applier):
        """Hook a :class:`~mxnet_tpu_torch.fused_update.FusedApplier`: every
        coalesced apply (on cadence) gets one per-bucket flat isfinite
        reduction. Returns the applier so
        ``guard.install(trainer._applier)`` composes."""
        applier.grad_guard = self
        return applier

    @staticmethod
    def _id_list(ids):
        try:
            return [int(i) for i in np.asarray(ids).ravel()]
        except Exception:
            return list(ids) if isinstance(ids, (list, tuple)) else None

    def _provenance(self, step, batch_ids):
        if step is None:
            step = self._step
        ids = self._id_list(batch_ids) if batch_ids is not None \
            else self._ids
        if ids is None and self._pipeline is not None:
            try:
                debug = self._pipeline.debug_state()
                last = debug.get("last_batch") or {}
                ids = last.get("ids")
            except Exception:
                ids = None
        return step, ids

    # -- cadence --------------------------------------------------------------

    def _armed(self, site):
        if self.every <= 0:
            return False
        count = self._counts.get(site, 0) + 1
        self._counts[site] = count
        return count % self.every == 0

    # -- checks ---------------------------------------------------------------

    def check_loss(self, loss, step=None, batch_ids=None):
        """Cadence-gated finiteness check of a (scalar or array) loss.
        Returns True when finite or skipped by cadence; records the
        ``nonfinite`` anomaly (and raises under ``halt``) otherwise."""
        if not self._armed("loss"):
            return True
        _checks_total.labels(site="loss").inc()
        value = getattr(loss, "_data", loss)
        if hasattr(value, "detach"):
            # A torch tensor, on the card or not: read it in float64
            # (numpy has no bfloat16).
            value = value.detach().cpu().double().numpy()
        arr = np.asarray(value)
        if np.isfinite(arr).all():
            return True
        detail = "loss=%s" % (arr if arr.ndim == 0
                              else "array%s" % (arr.shape,),)
        return self._violation("loss", detail, step, batch_ids)

    def check_flat(self, flat, site="grad", **detail):
        """Queue one device-side ``isfinite(flat).all()`` reduction
        over a flat vector (the FusedApplier hook path — already
        cadence-gated by :meth:`arm_apply`). Deliberately ASYNC: the
        scalar result stays on device so bucket k's check never blocks
        bucket k+1's dispatch; :meth:`flush` (called by the applier
        after every chunk has dispatched) pays one sync for the whole
        apply instead of one per bucket."""
        import torch

        _checks_total.labels(site=site).inc()
        with torch.no_grad():
            result = torch.isfinite(flat).all()
        self._pending.append((result, site, dict(detail)))

    def flush(self):
        """Resolve every queued :meth:`check_flat` result (the one sync
        point of an armed apply). Returns True when all were finite;
        records a ``nonfinite`` anomaly per offending bucket (and, under
        ``halt``, raises on the first — remaining queued results are
        dropped with it)."""
        import torch

        pending, self._pending = self._pending, []
        finite = [True] * len(pending)
        by_device = {}
        for i, (result, _, _) in enumerate(pending):
            by_device.setdefault(result.device, []).append(i)
        for rows in by_device.values():
            # One read per device for every queued bucket on it.
            flags = torch.stack([pending[i][0] for i in rows]).tolist()
            for i, flag in zip(rows, flags):
                finite[i] = flag
        ok = True
        for (result, site, detail), flag in zip(pending, finite):
            if flag:
                continue
            ok = False
            text = ", ".join("%s=%s" % kv
                             for kv in sorted(detail.items()))
            self._violation(site, "non-finite flat bucket (%s)" % text,
                            None, None)
        return ok

    def arm_apply(self):
        """Cadence gate for one fused apply (called by FusedApplier once
        per ``apply``): True when this apply's buckets should be
        checked."""
        return self._armed("grad")

    # -- violation path -------------------------------------------------------

    def _violation(self, site, detail, step, batch_ids):
        _nonfinite_total.labels(site=site).inc()
        step, ids = self._provenance(step, batch_ids)
        msg = "non-finite %s at step %s (%s); in-flight batch ids: %s" % (
            site, "?" if step is None else step, detail,
            "unknown" if ids is None else ids)
        self.violations.append((site, step, ids, detail))
        if self._monitor is not None:
            self._monitor.record_anomaly("nonfinite", msg)
        elif self._recorder is not None:
            self._recorder.capture("nonfinite", msg)
        else:
            _log.warn_rate_limited(
                _log.get_logger("mxnet_tpu_torch.telemetry"),
                "numerics:%s" % site, 30.0, "[telemetry:nonfinite] %s",
                msg, now=time.monotonic())
        if self.halt:
            raise NonFiniteError(msg)
        return False
