"""Launch a job of this host: N workers, and a scheduler with S servers.

The port's own copy of the repository's ``tools/launch.py``
(``launch_local`` and its CLI: ``-n``, ``-s``, ``--launcher local``).
Each role is a process of this host with the ``DMLC_*`` contract:

- ``-s 0``: an SPMD group of N workers, each with its rank in
  ``DMLC_WORKER_ID`` and the root address free for
  ``parallel.dist.initialize`` (rank 0 binds it);
- ``-s S``: a scheduler, S parameter servers and N workers for the
  ``dist_*`` kvstores (a server or scheduler process runs its loop
  inside ``import mxnet_tpu_torch`` and never returns).

Ports are taken free (bind to port 0), never fixed, so two jobs can
start at once. Every wait has a timeout: when a worker outlives it, or
fails while its peers wait on a collective that can no longer finish,
the launcher kills every process group it started and raises
:class:`LaunchError` with the tail of each role's standard error.

Usage::

    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 0 python train.py
    python -m mxnet_tpu_torch.parallel.launch -n 2 -s 1 python train.py \\
        --kv-store dist_sync
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["launch_local", "free_port", "LaunchError", "main"]


class LaunchError(RuntimeError):
    """A launched job timed out or a worker failed; ``outputs`` holds
    each role's (name, exit code, stderr tail)."""

    def __init__(self, msg, outputs):
        super().__init__(msg + "\n" + "\n".join(
            "--- %s (exit %s) ---\n%s" % o for o in outputs))
        self.outputs = outputs


def free_port():
    """A port of 127.0.0.1 that was free a moment ago."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _read(f, tail=None):
    if f is None:
        return ""
    f.flush()
    f.seek(0, os.SEEK_END)
    size = f.tell()
    f.seek(max(0, size - tail) if tail else 0)
    return f.read().decode("utf-8", "replace")


def launch_local(num_workers, num_servers, cmd, env_extra=None,
                 worker_envs=None, timeout=600, capture=False,
                 fail_fast=True):
    """Spawn the roles, wait for the workers, reap everything.

    Returns the workers' exit codes; with ``capture=True`` the pair
    ``(codes, outputs)``, one ``(stdout, stderr)`` per worker (without
    it every role writes to this process's streams). ``worker_envs``
    gives per-worker env overrides. Raises :class:`LaunchError` when the
    workers outlive ``timeout`` seconds, or (``fail_fast``) when one
    worker fails while another still runs ten seconds later: a rank
    whose peer died waits on a collective that cannot complete. Each
    role runs in its own session, whose process group is killed at the
    end, so no grandchild outlives the launch.
    """
    port = free_port()
    base = dict(os.environ)
    base.update(env_extra or {})
    base.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": str(num_servers),
    })
    procs = []                      # (name, Popen, stdout, stderr)

    def spawn(name, role, extra=None):
        env = dict(base)
        env["DMLC_ROLE"] = role
        env.update(extra or {})
        out = tempfile.TemporaryFile() if capture else None
        err = tempfile.TemporaryFile() if capture else None
        p = subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                             start_new_session=True)
        procs.append((name, p, out, err))
        return p

    def outputs():
        return [(name, p.poll(), _read(err, 6000))
                for name, p, _, err in procs]

    try:
        if num_servers > 0:
            spawn("scheduler", "scheduler")
            for s in range(num_servers):
                spawn("server%d" % s, "server")
        workers = []
        for i in range(num_workers):
            extra = dict(worker_envs[i]) if worker_envs else {}
            extra.setdefault("DMLC_WORKER_ID", str(i))
            workers.append(spawn("worker%d" % i, "worker", extra))
        deadline = time.monotonic() + timeout
        failed_at = None
        while True:
            codes = [w.poll() for w in workers]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if now > deadline:
                raise LaunchError(
                    "launch: workers still running after %s s (codes %s); "
                    "killed every process of the job" % (timeout, codes),
                    outputs())
            if fail_fast and any(c not in (None, 0) for c in codes):
                # Peers get a moment to fail on their own; then the job
                # is cut: a collective with a dead peer never returns.
                failed_at = failed_at or now
                if now - failed_at > 10:
                    raise LaunchError(
                        "launch: a worker failed (codes %s) while its peers "
                        "still ran; killed every process of the job"
                        % codes, outputs())
            time.sleep(0.05)
        if capture:
            return codes, [(_read(out), _read(err))
                           for name, _, out, err in procs
                           if name.startswith("worker")]
        return codes
    finally:
        for _, p, _, _ in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for _, p, out, err in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            for f in (out, err):
                if f is not None:
                    f.close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Launch a distributed job on this host.")
    parser.add_argument("-n", "--num-workers", type=int, required=True,
                        help="number of worker processes")
    parser.add_argument("-s", "--num-servers", type=int, default=None,
                        help="number of server processes (default: the "
                        "number of workers; 0 = an SPMD group)")
    parser.add_argument("--launcher", choices=["local", "ssh", "mpi",
                                               "sge", "yarn"],
                        default="local")
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the command each role runs")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.launcher != "local":
        raise SystemExit(
            "launcher %r is not supported: this launcher starts the roles "
            "on one host; on a cluster start one process per rank with "
            "the DMLC_* variables set" % args.launcher)
    num_servers = (args.num_servers if args.num_servers is not None
                   else args.num_workers)
    codes = launch_local(args.num_workers, num_servers, args.command,
                         timeout=args.timeout)
    if any(codes):
        sys.exit("worker exit codes: %s" % codes)


if __name__ == "__main__":
    main()
