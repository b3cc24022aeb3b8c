"""Preemption-safe training with fault-tolerant async checkpoints.

Counterpart of ``examples/train_resume.py``, driving the port
(``mxnet_tpu_torch.checkpoint``): every step is checkpointed
*asynchronously* with atomic commit, a SIGTERM triggers one final
synchronous save, and a restarted process resumes **bit-exact** from
the latest committed step — params, optimizer momentum, step counter and
RNG position all continue exactly as the uninterrupted run would.

Two modes:

* default (demo): spawns itself as a worker, SIGTERMs it mid-run,
  restarts it to completion, then runs an uninterrupted reference in a
  fresh directory and proves the final state digests are identical::

      python -m mxnet_tpu_torch.examples.train_resume --steps 18 \\
          --kill-after 6 [--cpu]

* ``--worker``: the training loop itself (what a fleet scheduler would
  launch). Restarting it with the same ``--ckpt-dir`` resumes from the
  newest fully committed checkpoint; corrupt or torn checkpoints are
  skipped.

Runs on ``gpu(0)`` unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np


def make_batch(step, batch_size=32, in_dim=64, classes=8):
    """Deterministic batch for a given global step — the data position
    is a pure function of the step counter, so a resumed run reads
    exactly the batches the killed run would have."""
    rng = np.random.RandomState(77_000 + step)
    x = rng.rand(batch_size, in_dim).astype(np.float32)
    y = rng.randint(0, classes, batch_size)
    return x, y


def build_step(args, ctx):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    mx.random.seed(args.seed)
    np.random.seed(args.seed)
    # Fixed prefixes: checkpoint keys must be stable across restarts.
    net = gluon.nn.HybridSequential(prefix="net_")
    net.add(gluon.nn.Dense(64, activation="relu", in_units=64,
                           prefix="fc1_"))
    net.add(gluon.nn.Dense(8, in_units=64, prefix="fc2_"))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd",
                     optimizer_params={"learning_rate": args.lr,
                                       "momentum": 0.9},
                     mesh=make_mesh({"dp": 1}, devices=[ctx]))


def state_digest(state_dict):
    """SHA-256 over params + optimizer state + step counter — the
    bit-exactness witness printed by every finished worker."""
    h = hashlib.sha256()
    for section in ("params", "opt"):
        sec = state_dict.get(section, {})
        for name in sorted(sec):
            leaf = sec[name]
            leaves = [leaf[k] for k in sorted(leaf)] \
                if isinstance(leaf, dict) else [leaf]
            for t in leaves:
                h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(state_dict.get("num_update", 0)).encode())
    return h.hexdigest()


def worker(args):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager, \
        PreemptionHook, CheckpointNotFoundError

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    step = build_step(args, ctx)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)

    start = 0
    try:
        restored_step, state = mgr.restore()
        step.load_state_dict(state)
        start = restored_step
        print("resumed-from %d" % restored_step, flush=True)
    except CheckpointNotFoundError:
        print("fresh-start", flush=True)

    hook = PreemptionHook(mgr, state_fn=step.state_dict,
                          step_fn=lambda: step.num_update).install()
    loss = None
    for s in range(start, args.steps):
        x, y = make_batch(s)
        loss = float(step(x, y))
        if (s + 1) % args.save_every == 0:
            mgr.save(s + 1, step.state_dict())   # async, off the step path
        print("step %d loss %.6f" % (s, loss), flush=True)
        if args.step_delay:
            time.sleep(args.step_delay)
    mgr.save(args.steps, step.state_dict(), sync=True)
    mgr.close()
    hook.uninstall()
    if loss is not None:
        print("final-loss %.6f" % loss, flush=True)
    else:   # restarted at/after completion: clean no-op resume
        print("already-complete at step %d" % start, flush=True)
    print("final-digest %s" % state_digest(step.state_dict()), flush=True)


def _spawn(args, ckpt_dir):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.examples.train_resume",
           "--worker", "--steps", str(args.steps), "--ckpt-dir", ckpt_dir,
           "--seed", str(args.seed), "--lr", str(args.lr),
           "--save-every", str(args.save_every),
           "--step-delay", str(args.step_delay)]
    if args.cpu:
        cmd.append("--cpu")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1,
                            env=env)


def _drain(proc):
    out = []
    for line in proc.stdout:
        line = line.rstrip()
        out.append(line)
        print("  | " + line, flush=True)
    proc.wait()
    return out


def demo(args):
    """Kill, resume, and compare with an uninterrupted run. Returns
    {"resumed_from", "bitexact", "exit_code", "digest"}."""
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "ckpt")

        # Phase 1: train, then kill mid-run once enough steps committed.
        print("phase-1: training (will be SIGTERMed)", flush=True)
        p1 = _spawn(args, ckpt)
        seen = -1
        try:
            for line in p1.stdout:
                line = line.rstrip()
                print("  | " + line, flush=True)
                if line.startswith("step "):
                    seen = int(line.split()[1])
                    if seen + 1 >= args.kill_after:
                        break
            assert seen >= 0, "worker produced no steps"
            p1.send_signal(signal.SIGTERM)
            _drain(p1)
        finally:
            if p1.poll() is None:
                p1.kill()
                p1.wait()
        print("phase-1 exit code %d (expect 143 = clean preempt)"
              % p1.returncode, flush=True)

        # Phase 2: restart with the same dir → resumes and finishes.
        print("phase-2: resuming", flush=True)
        out2 = _drain(_spawn(args, ckpt))
        resumed = [l for l in out2 if l.startswith("resumed-from")]
        digest2 = [l for l in out2 if l.startswith("final-digest")]
        assert resumed, "phase-2 did not resume from a checkpoint"
        assert digest2, "phase-2 did not finish"

        # Reference: same run, never interrupted, fresh directory.
        print("reference: uninterrupted run", flush=True)
        out3 = _drain(_spawn(args, os.path.join(td, "ref")))
        digest3 = [l for l in out3 if l.startswith("final-digest")]
        assert digest3, "reference run did not finish"

        bitexact = digest2[0] == digest3[0]
        print("resumed-from-step %s" % resumed[0].split()[1], flush=True)
        print("bitexact %s" % bitexact, flush=True)
        if not bitexact:
            raise SystemExit("kill/resume diverged from uninterrupted run")
        return {"resumed_from": int(resumed[0].split()[1]),
                "bitexact": bitexact, "exit_code": p1.returncode,
                "digest": digest3[0].split()[1]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--kill-after", type=int, default=6,
                    help="demo: SIGTERM the worker after this many steps")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="artificial per-step pause (keeps the demo's "
                         "kill window wide on fast machines)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host (default: gpu(0))")
    args = ap.parse_args(argv)
    if args.worker:
        assert args.ckpt_dir, "--worker requires --ckpt-dir"
        worker(args)
        return None
    return demo(args)


if __name__ == "__main__":
    main()
