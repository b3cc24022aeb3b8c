"""Kernel records that torch.profiler drops at a session's start, by the
age of the process.

Run on a card: ``python3 -m mxnet_tpu_torch.profile_trace_loss``. Two
processes start together and keep the card a little busy (20 training
steps, then 2 s idle, over and over). At each age of ``--ages`` (seconds
since the process started) each profiles three training steps of a
causal bf16 attention layer (SDPA at (8, 16, 2048, 64), a projection,
the backward and an update: 24 kernel launches a step) and prints one
JSON line: the launches in the window, how many have no kernel record
(a launch and its kernel share a correlation id) and where they lie in
the window.

- ``--session torch`` runs ``torch.profiler.profile`` start/stop and
  imports nothing of this package;
- ``--session port`` opens each window through
  ``mxnet_tpu_torch.profiler.open_session()``, whose primer runs between
  ``prepare_trace`` and ``start_trace``.

Afterwards the torch process takes ``--side-captures`` captures of 0.3 s
each on a second thread while its main thread launches steps, as a
health plane's ``/debug/xprof`` does, and prints how many ended and the
fewest and most kernel records one held. With no ``--session``, the
script starts both processes, relays their lines and fails if either
fails. It writes its traces to temporary files and removes them.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

T0 = time.monotonic()
STEP_LAUNCHES = 24


def _lost(events):
    """(launches, lost, first lost index, last lost index) of a chrome
    trace, the launches in time order."""
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    launches = sorted(
        (e for e in events
         if e.get("cat") in ("cuda_runtime", "cuda_driver")
         and re.match(r"cu(da)?LaunchKernel", e.get("name", ""))
         and "correlation" in e.get("args", {})), key=lambda e: e["ts"])
    idx = [i for i, e in enumerate(launches)
           if e["args"]["correlation"] not in kernels]
    return (len(launches), len(idx), idx[0] if idx else None,
            idx[-1] if idx else None)


def _layer():
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(8, 16, 2048, 64, device=dev, dtype=torch.bfloat16,
                    generator=g, requires_grad=True)
    k = torch.randn_like(q).requires_grad_()
    v = torch.randn_like(q).requires_grad_()
    w = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16,
                    generator=g, requires_grad=True)

    def step():
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        h = o.transpose(1, 2).reshape(8, 2048, 1024) @ w
        h.float().square().mean().backward()
        with torch.no_grad():
            for t in (q, k, v, w):
                t.sub_(1e-6 * t.grad)
                t.grad = None
    return step


def _window_torch(step, steps=3):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    prof.stop()
    return _export(prof.export_chrome_trace)


def _window_port(step, steps=3):
    import torch

    from mxnet_tpu_torch import profiler

    torch.cuda.synchronize()
    session = profiler.open_session()
    if session is None:
        raise RuntimeError("another torch.profiler session runs")
    with session:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return _export(lambda path: profiler.export_trace(session, path))


def _export(write):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        write(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _emit(rec):
    rec["age_s"] = round(time.monotonic() - T0, 1)
    print(json.dumps(rec), flush=True)


def _run(session, ages, side_captures):
    import torch

    step = _layer()
    step()
    torch.cuda.synchronize()
    window = _window_torch if session == "torch" else _window_port
    for age in ages:
        while time.monotonic() - T0 < age:
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            time.sleep(2.0)
        launches, lost, first, last = _lost(window(step))
        _emit({"session": session, "window_at_s": age,
               "package_imported": "mxnet_tpu_torch" in sys.modules,
               "launches": launches, "lost": lost,
               "lost_first_index": first, "lost_last_index": last,
               "steps_launches": 3 * STEP_LAUNCHES})
    if session != "torch" or not side_captures:
        return
    held, done = [], threading.Event()

    def captures():
        try:
            for _ in range(side_captures):
                events = _window_side()
                held.append(sum(1 for e in events
                                if e.get("cat") == "kernel"))
        finally:
            done.set()

    th = threading.Thread(target=captures)
    th.start()
    while not done.is_set():
        step()
    torch.cuda.synchronize()
    th.join()
    _emit({"session": session, "side_thread_captures": len(held),
           "kernel_records_min_max": [min(held), max(held)]
           if held else None})


def _window_side():
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    time.sleep(0.3)
    prof.stop()
    return _export(prof.export_chrome_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ages", default="15,120,360,600",
                    help="process ages (s) at which a window is taken")
    ap.add_argument("--side-captures", type=int, default=30)
    ap.add_argument("--session", choices=("torch", "port"))
    args = ap.parse_args(argv)
    ages = [float(a) for a in args.ages.split(",")]
    if args.session:
        import torch

        if not torch.cuda.is_available():
            print("profile_trace_loss needs a CUDA device", file=sys.stderr)
            return 2
        _run(args.session, ages, args.side_captures)
        return 0
    # The torch process runs this file by its path, so that not even the
    # package's __init__ is imported there.
    run_file = ("import runpy, sys; sys.argv = sys.argv[1:]; "
                "runpy.run_path(sys.argv[0], run_name='__main__')")
    common = ["--ages", args.ages, "--side-captures",
              str(args.side_captures), "--session"]
    procs = [subprocess.Popen([sys.executable, "-c", run_file,
                               os.path.abspath(__file__)] + common
                              + ["torch"]),
             subprocess.Popen([sys.executable, "-m",
                               "mxnet_tpu_torch.profile_trace_loss"]
                              + common + ["port"])]
    codes = [p.wait() for p in procs]
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
