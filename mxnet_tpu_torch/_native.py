"""Build and load the port's hand-written CUDA kernels (and the host
code that launches the rtc kernels).

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with the
installed toolkit's ``nvcc`` for ``sm_90a`` into a shared library under
``BUILD`` (``_build/``, listed in ``.gitignore``), keyed by a hash of the
source, the headers it may include (``csrc/*.cuh``), the flags and
nvcc's ``--version`` line, and loaded with ``ctypes``. The build happens
at first use, never at import: the CPU tests import every module on a
machine without ``nvcc``. A machine without ``nvcc`` loads what was
built from the same sources: ``BUILD`` records, per source hash, the
toolkit that made the library (``<name>-<hash>.toolkit``), and the
compile cache holds the same record beside each library (site
``nvcc_toolkit``).

With the compile cache on (``MXNET_COMPILE_CACHE``, :mod:`.compile`), a
library missing from ``BUILD`` is first asked of the cache (site
``nvcc``: this process's store, then a peer's), and a library nvcc
builds is committed there with its log. An entry has the library's
hash as its key, so it comes from the same sources, flags and toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import atomic_write

__all__ = ["SOURCES", "BUILD", "STATS", "build", "load", "build_log",
           "nvcc_version"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

# Every source of the port built by nvcc: the attention kernels, the
# host-side launcher of the rtc kernels (which NVRTC compiles at run
# time, csrc/rtc/) and the detection kernels.
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "rtc_launch",
           "detection")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Flags of one source beside NVCC_FLAGS. The detection kernels round
# every product and sum on their own (no FMA contraction), as their plain
# PyTorch versions do, so that their results equal those bit for bit.
EXTRA_FLAGS = {"detection": ("--fmad=false",)}

# What the builds of this process did: "nvcc_runs" libraries nvcc
# compiled, in "build_seconds" (wall, all sources at once), and
# "cache_hits" libraries the compile cache served instead.
STATS = {"nvcc_runs": 0, "build_seconds": 0.0, "cache_hits": 0}

_lock = threading.Lock()
_libs: dict = {}
_versions: dict = {}    # nvcc path -> its --version line


_NO_NVCC = ("nvcc not found: the CUDA kernels of mxnet_tpu_torch build on "
            "a machine with the CUDA toolkit")


def _find_nvcc():
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.isfile(path):
            return path
    return None


def _nvcc():
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(_NO_NVCC)
    return nvcc


def nvcc_version():
    """The last line of ``nvcc --version`` (the toolkit's release and
    build), read once per nvcc."""
    nvcc = _nvcc()
    line = _versions.get(nvcc)
    if line is None:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
        line = _versions[nvcc] = out.strip().splitlines()[-1]
    return line


def _flags(name):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _source_digest(name):
    """Hex hash of library `name`'s inputs: its source, every header
    under csrc/ (the kernels share them) and the flags."""
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    return digest.hexdigest()


def _toolkit_record(name, source):
    """BUILD's record of the toolkit that made library `name` from the
    inputs hashed `source`."""
    return os.path.join(BUILD, "%s-%s.toolkit" % (name, source[:16]))


def _toolkit_key(name, source):
    from . import compile as _cc

    return _cc.make_key(["nvcc_toolkit", name, source])


def _toolkit(name, source):
    """nvcc's ``--version`` line; without nvcc, that of the toolkit that
    made the library from the same inputs, from BUILD's record, else
    from the compile cache's. RuntimeError where none knows it."""
    if _find_nvcc() is not None:
        return nvcc_version()
    try:
        with open(_toolkit_record(name, source)) as f:
            return f.read()
    except OSError:
        pass
    from . import compile as _cc

    rec = _cc.fetch("nvcc_toolkit", _toolkit_key(name, source))
    if rec is None:
        raise RuntimeError(_NO_NVCC)
    return rec[0]["nvcc"]


def _digest(name):
    """Hex hash of what decides library `name`: its inputs and the
    toolkit; and the inputs' hash alone."""
    source = _source_digest(name)
    toolkit = _toolkit(name, source)
    return (hashlib.sha256((source + "\0" + toolkit).encode()).hexdigest(),
            source, toolkit)


def _target(digest, name):
    """Library path of `name` under BUILD."""
    return os.path.join(BUILD, "%s-%s.so" % (name, digest[:16]))


def _cache_key(name, digest):
    from . import compile as _cc

    return _cc.make_key(["nvcc", name, digest])


def _from_cache(name, digest, target):
    """Write library `name` and its log into BUILD from the compile
    cache; False on a miss (or with the cache off)."""
    from . import compile as _cc

    rec = _cc.fetch("nvcc", _cache_key(name, digest))
    if rec is None:
        return False
    fields, lib = rec
    with atomic_write(target[:-3] + ".log", "w") as f:
        f.write(fields.get("log", ""))
    with atomic_write(target, "wb") as f:
        f.write(lib)
    STATS["cache_hits"] += 1
    return True


def build(names=SOURCES):
    """Make every missing library of `names`: from the compile cache
    where it holds one, else with one nvcc process per source, all
    started together. Returns {name: library path}."""
    keyed = {n: _digest(n) for n in names}
    digests = {n: k[0] for n, k in keyed.items()}
    targets = {n: _target(d, n) for n, d in digests.items()}
    missing = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if missing:
        os.makedirs(BUILD, exist_ok=True)
        for n in missing:
            with atomic_write(_toolkit_record(n, keyed[n][1]), "w") as f:
                f.write(keyed[n][2])
        missing = {n: t for n, t in missing.items()
                   if not _from_cache(n, digests[n], t)}
    if missing:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, target in missing.items():
            tmp = "%s.tmp%d" % (target, os.getpid())
            cmd = [nvcc, *_flags(name), "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed, built = [], {}
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            with atomic_write(targets[name][:-3] + ".log", "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, log))
                continue
            os.replace(tmp, targets[name])
            built[name] = log
        seconds = time.perf_counter() - t0
        STATS["nvcc_runs"] += len(procs)
        STATS["build_seconds"] += seconds
        _commit(built, keyed, targets, seconds)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def _commit(built, keyed, targets, seconds):
    """Commit each library nvcc built to the compile cache, with its log,
    and the record of its toolkit beside it; the sources compiled in
    parallel, so each carries the build's wall seconds."""
    from . import compile as _cc

    for name, log in built.items():
        digest, source, toolkit = keyed[name]
        with open(targets[name], "rb") as f:
            lib = f.read()
        _cc.commit("nvcc", _cache_key(name, digest), {"log": log}, lib,
                   seconds, meta={"name": name, "library":
                                  os.path.basename(targets[name])})
        _cc.commit("nvcc_toolkit", _toolkit_key(name, source),
                   {"nvcc": toolkit}, b"", None, meta={"name": name})


def build_log(name):
    """nvcc's output (ptxas register and shared-memory report) of the
    last build of `name` in this checkout."""
    path = _target(_digest(name)[0], name)[:-3] + ".log"
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
