"""Build and load the port's hand-written CUDA kernels (and the host
code that launches the rtc kernels).

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with the
installed toolkit's ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in ``.gitignore``), keyed by a hash of the source,
the headers it may include (``csrc/*.cuh``) and the flags, and loaded
with ``ctypes``. The build happens at first
use, never at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import atomic_write

__all__ = ["SOURCES", "build", "load", "build_log"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

# Every source of the port built by nvcc: the attention kernels and the
# host-side launcher of the rtc kernels (which NVRTC compiles at run
# time, csrc/rtc/).
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "rtc_launch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc():
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels of mxnet_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def _target(name):
    """Library path of `name`, keyed by its source, every header under
    csrc/ (the kernels share them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    return os.path.join(BUILD, "%s-%s.so" % (name, digest.hexdigest()[:16]))


def build(names=SOURCES):
    """Compile every missing library of `names`, one nvcc process per
    source, all started together. Returns {name: library path}."""
    targets = {n: _target(n) for n in names}
    missing = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if missing:
        nvcc = _nvcc()
        os.makedirs(BUILD, exist_ok=True)
        procs = {}
        for name, target in missing.items():
            tmp = "%s.tmp%d" % (target, os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            with atomic_write(targets[name][:-3] + ".log", "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, log))
                continue
            os.replace(tmp, targets[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def build_log(name):
    """nvcc's output (ptxas register and shared-memory report) of the
    last build of `name` in this checkout."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name):
    """The ctypes library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build([name])[name])
        return lib
