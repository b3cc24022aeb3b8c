"""Inspect, verify or GC a compile-cache directory
(``MXNET_COMPILE_CACHE``, :mod:`mxnet_tpu_torch.compile`)::

    python -m mxnet_tpu_torch.tools.compile_cache inspect DIR
    python -m mxnet_tpu_torch.tools.compile_cache verify  DIR [--remove]
    python -m mxnet_tpu_torch.tools.compile_cache gc      DIR --max-mb 512

Counterpart of the repo's ``tools/compile_cache.py``, over the port's
store; the format is the same, so it reads a directory written by either
package. ``inspect`` prints one JSON summary: entry count, total bytes,
and per entry the key anatomy (site, library or program, the backend
fingerprint's card and versions, and the seconds its compile took, which
a warm start saves by loading it). ``verify`` CRC-checks every entry
(``--remove`` quarantines the damaged ones); ``gc`` applies the
LRU-by-mtime byte budget the runtime applies on every commit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..compile.store import CompileCacheStore


_VERSIONS = ("torch", "cuda", "nvrtc", "nvcc", "driver", "jax", "jaxlib")


def inspect(directory):
    store = CompileCacheStore(directory)
    now = time.time()
    entries = []
    for key, path, size, mtime in sorted(store.entries(),
                                         key=lambda e: -e[3]):
        # Read-only: a damaged entry is evidence for `verify`.
        rec = store.get(key, touch=False, quarantine=False)
        meta = rec[0] if rec is not None else {"damaged": True}
        backend = meta.get("backend", {})
        entries.append({
            "key": key,
            "bytes": size,
            "age_s": round(now - mtime, 1),
            "site": meta.get("site"),
            "compile_seconds": meta.get("compile_seconds"),
            "name": meta.get("name"),
            "platform": backend.get("platform"),
            "device_kind": backend.get("device_kind"),
            "num_devices": backend.get("num_devices"),
            # The versions that made it: the port's stack, or the JAX
            # package's for an entry it wrote.
            "versions": {k: backend[k] for k in _VERSIONS if k in backend},
            "damaged": meta.get("damaged", False),
        })
    saved = sum(e["compile_seconds"] or 0 for e in entries)
    return {
        "directory": os.path.abspath(directory),
        "entries": len(entries),
        "total_bytes": sum(e["bytes"] for e in entries),
        "warm_restart_saves_seconds": round(saved, 3),
        "by_site": _by_site(entries),
        "detail": entries,
    }


def _by_site(entries):
    out = {}
    for e in entries:
        site = e["site"] or "?"
        rec = out.setdefault(site, {"entries": 0, "bytes": 0,
                                    "compile_seconds": 0.0})
        rec["entries"] += 1
        rec["bytes"] += e["bytes"]
        rec["compile_seconds"] = round(
            rec["compile_seconds"] + (e["compile_seconds"] or 0), 3)
    return out


def verify(directory, remove=False):
    store = CompileCacheStore(directory)
    ok, bad = store.verify(remove=remove)
    return {
        "directory": os.path.abspath(directory),
        "valid": len(ok),
        "damaged": len(bad),
        "damaged_keys": bad,
        "removed": remove and bool(bad),
    }


def gc(directory, max_mb):
    store = CompileCacheStore(directory)
    before = store.total_bytes()
    removed = store.gc(int(max_mb) * (1 << 20))
    return {
        "directory": os.path.abspath(directory),
        "bytes_before": before,
        "bytes_after": store.total_bytes(),
        "removed_entries": len(removed),
        "removed": [os.path.basename(p) for p in removed],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Inspect / GC / verify a persistent compilation "
                    "cache directory")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_ins = sub.add_parser("inspect", help="summarize the cache")
    p_ins.add_argument("directory")
    p_ver = sub.add_parser("verify", help="CRC-check every entry")
    p_ver.add_argument("directory")
    p_ver.add_argument("--remove", action="store_true",
                       help="quarantine damaged entries")
    p_gc = sub.add_parser("gc", help="apply an LRU byte budget")
    p_gc.add_argument("directory")
    p_gc.add_argument("--max-mb", type=float, required=True)
    args = parser.parse_args(argv)
    if args.cmd == "inspect":
        out = inspect(args.directory)
    elif args.cmd == "verify":
        out = verify(args.directory, remove=args.remove)
    else:
        out = gc(args.directory, args.max_mb)
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
