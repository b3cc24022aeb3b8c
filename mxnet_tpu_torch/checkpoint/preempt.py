"""Preemption-safe shutdown: one final synchronous checkpoint on
SIGTERM/SIGINT.

Counterpart of ``mxnet_tpu/checkpoint/preempt.py``. Preemptible fleets
deliver a SIGTERM with a short grace window
before the kill. :class:`PreemptionHook` turns that signal into: flush
any queued async saves, write one final *synchronous* checkpoint of the
current training state (atomic-commit path, so a second kill mid-save
still can't corrupt anything), then chain to the previous handler or
exit with the conventional ``128+signum`` code.

Usage::

    hook = PreemptionHook(manager,
                          state_fn=lambda: step.state_dict(),
                          step_fn=lambda: step.num_update)
    with hook:                      # or hook.install() / hook.uninstall()
        for s in range(start, steps):
            loss = step(x, y)
            if hook.preempted:      # exit=False mode: cooperative stop
                break

A signal that lands inside one of the port's in-place update loops finds
the state torn: the snapshot raises ``checkpoint.guard.
StepInProgressError`` and the handler re-delivers the signal after
``snapshot_retry_delay``, once the step has finished (see
``checkpoint/guard.py``).
"""
from __future__ import annotations

import os
import signal
import threading

__all__ = ["PreemptionHook"]


class PreemptionHook:
    """Install signal handlers that checkpoint once, then exit.

    Parameters
    ----------
    manager : CheckpointManager — receives the final synchronous save.
    state_fn : callable() -> state dict (e.g. ``train_step.state_dict``).
    step_fn : callable() -> int — the step to commit the final save as.
    signals : which signals to intercept (default SIGTERM + SIGINT).
    exit : bool — after the final save, raise ``SystemExit(128+signum)``
        (default). With ``exit=False`` only the ``preempted`` flag is
        set and the training loop is expected to stop cooperatively.
    """

    def __init__(self, manager, state_fn, step_fn,
                 signals=(signal.SIGTERM, signal.SIGINT), exit=True,
                 drain_timeout=60.0, snapshot_retries=20,
                 snapshot_retry_delay=0.25):
        self.manager = manager
        self.state_fn = state_fn
        self.step_fn = step_fn
        self.signals = tuple(signals)
        self.exit = bool(exit)
        self.drain_timeout = float(drain_timeout)
        self.snapshot_retries = int(snapshot_retries)
        self.snapshot_retry_delay = float(snapshot_retry_delay)
        self._snapshot_attempts = 0
        self.preempted = False
        self.saved_step = None
        self._fired = False
        self._prev = {}
        self._installed = False

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionHook.install must run on the main thread "
                "(signal module contract)")
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    @staticmethod
    def _say(msg):
        # The handler runs on the main thread wherever the signal
        # interrupted it — possibly inside a logging call holding the
        # logging module's lock. os.write to stderr takes no locks.
        try:
            os.write(2, (msg + "\n").encode())
        except OSError:
            pass

    def _handler(self, signum, frame):
        if self._fired:
            # Second signal: the grace window is over — get out now.
            raise SystemExit(128 + signum)
        self._fired = True
        self.preempted = True
        self._say("mxnet_tpu_torch.checkpoint: signal %d — writing final "
                  "checkpoint before exit" % signum)
        # The save itself only takes the manager's RLock plus file IO;
        # _quiet skips profiler counters (plain Locks the interrupted
        # frame might hold), and drain() polls instead of queue.join()
        # for the same reason.
        self.manager._quiet = True
        try:
            state = self.state_fn()
            # Label the commit from the state itself when possible:
            # step_fn() and state_fn() are two separate reads, and a
            # signal landing between a step's state commit and its
            # counter update would otherwise label post-step-N state as
            # step N-1 — resume would then double-apply one update.
            if isinstance(state, dict) and "num_update" in state:
                step = int(state["num_update"])
            else:
                step = int(self.step_fn())
        except Exception as exc:
            self.manager._quiet = False
            # A signal delivered inside an update loop finds the state
            # torn and the snapshot raises (checkpoint.guard). Let the
            # interrupted step finish and re-deliver the signal from a
            # timer thread; the retry sees a consistent view.
            if self._snapshot_attempts < self.snapshot_retries:
                self._snapshot_attempts += 1
                self._fired = False
                self._say("mxnet_tpu_torch.checkpoint: snapshot raced the "
                          "step (%r); retrying in %.2fs"
                          % (exc, self.snapshot_retry_delay))
                # mxlint: disable=signal-safety -- deliberate: CPython
                # handlers run between bytecodes (not async-signal
                # context), so the Timer's lock allocation is safe; the
                # timer re-delivers the signal AFTER the interrupted
                # statement finishes, which is the whole retry mechanism
                threading.Timer(self.snapshot_retry_delay, os.kill,
                                (os.getpid(), signum)).start()
                return
            self._say("mxnet_tpu_torch.checkpoint: snapshot kept failing "
                      "(%r); exiting without a final save" % (exc,))
            self._finish(signum, frame)
            return
        try:
            self.manager.save(step, state, sync=True)
            self.saved_step = step
            # Older async saves still queued land too — their order is
            # irrelevant for correctness (the final save is newest), but
            # dropping them would waste work already snapshotted.
            self.manager.drain(timeout=self.drain_timeout)
            self._say("mxnet_tpu_torch.checkpoint: final checkpoint committed "
                      "at step %d" % step)
        except Exception as exc:
            self._say("mxnet_tpu_torch.checkpoint: final checkpoint failed "
                      "(%r); exiting anyway" % (exc,))
        finally:
            self.manager._quiet = False
            self._finish(signum, frame)

    def _finish(self, signum, frame):
        prev = self._prev.get(signum)
        self.uninstall()
        if not self.exit:
            # Cooperative mode: ONLY the preempted flag is set — chaining
            # to the previous handler here would e.g. throw
            # KeyboardInterrupt (default SIGINT) into the training loop
            # the flag asks to stop gracefully.
            return
        if callable(prev):
            prev(signum, frame)
        else:
            raise SystemExit(128 + signum)
