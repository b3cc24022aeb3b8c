"""The port's compile cache (``mxnet_tpu_torch/compile/``) against the JAX
package's (``mxnet_tpu/compile/``), and through the port's two compile
steps on a host without a card.

- The store: entries written by either package's store are read by the
  other's (both directions), and ``make_key`` gives the same hex for the
  same parts; damage and version skew are quarantined misses; LRU GC; a
  commit killed at its rename leaves no torn entry (faults injected into
  the port's ``checkpoint.manager._open_for_write``/``_rename`` seams).
- The distributor over the LocalBus: rank 1 pulls rank 0's entries,
  ``attach_kvstore`` prefetches, the bus drops oldest, the entry bound
  holds, shared-filesystem mode attaches nothing.
- The nvcc seam (``_native.build``) with a stand-in ``nvcc`` script that
  writes its output and records each call, and the NVRTC seam
  (``_nvrtc.compile_program``) with a stand-in for the ctypes library:
  cold, warm with no compile, a peer with no compile; the key follows
  nvcc's ``--version``; ``build_log`` is the same after a hit.
- ``mxnet_tpu_torch.tools.compile_cache`` on a store of either package,
  its results equal to the repo's ``tools/compile_cache.py``'s.
"""
import collections
import ctypes
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.compile import store as jstore

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native, _nvrtc
from mxnet_tpu_torch import compile as cc
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.checkpoint import manager as ckpt
from mxnet_tpu_torch.compile import store as tstore
from mxnet_tpu_torch.compile.distribute import CacheDistributor
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.telemetry.aggregate import LocalBus
from mxnet_tpu_torch.tools import compile_cache as ttool

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cc_isolated():
    """Every test starts and ends with the cache off and no distributor."""
    cc.reset()
    yield
    cc.reset()


def _counter(name, **labels):
    fam = tmetrics.REGISTRY.get(name)
    return 0 if fam is None else fam.labels(**labels).value


def _errors():
    fam = tmetrics.REGISTRY.get("mx_compile_cache_errors_total")
    return {} if fam is None else {k: c.value
                                   for k, c in fam._children.items()}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_compile_cache_tool", os.path.join(ROOT, "tools",
                                               "compile_cache.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the store -------------------------------------------------------------------

PARTS = [["site"], "fingerprint", {"torch": "2.11", "nvcc": "V12.8.93"}]


def test_make_key_is_the_jax_packages():
    assert tstore.make_key(PARTS) == jstore.make_key(PARTS)
    assert tstore.make_key(["nvrtc", "src", [1, 2]]) == \
        jstore.make_key(["nvrtc", "src", [1, 2]])
    assert tstore.ENTRY_FORMAT == jstore.ENTRY_FORMAT
    assert tstore.entry_name("ab") == jstore.entry_name("ab")
    assert tstore.make_key(PARTS) != tstore.make_key(PARTS + ["x"])


@pytest.mark.parametrize("writer,reader", [(jstore, tstore),
                                           (tstore, jstore)],
                         ids=["jax_to_port", "port_to_jax"])
def test_entries_cross_between_the_packages(tmp_path, writer, reader):
    payload = bytes(np.random.RandomState(0).randint(0, 256, 4096,
                                                     dtype=np.uint8))
    key = writer.make_key(PARTS)
    path = writer.CompileCacheStore(str(tmp_path)).put(
        key, payload, {"site": "nvcc", "name": "detection"})
    assert os.path.basename(path) == "cc.%s.bin" % key
    other = reader.CompileCacheStore(str(tmp_path))
    assert other.keys() == [key]
    meta, got = other.get(key)
    assert got == payload and meta == {"site": "nvcc", "name": "detection"}
    assert other.verify() == ([key], [])
    # The bytes on disk are the same whichever package wrote them.
    with open(path, "rb") as f:
        written = f.read()
    reader.CompileCacheStore(str(tmp_path / "again")).put(
        key, payload, {"site": "nvcc", "name": "detection"})
    with open(str(tmp_path / "again" / os.path.basename(path)), "rb") as f:
        assert f.read() == written


def _damage(path, truncate_to=None, flip_byte_at=None):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if truncate_to is not None:
        data = data[:truncate_to]
    if flip_byte_at is not None:
        data[flip_byte_at] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("damage", [{"truncate_to": 30},
                                    {"flip_byte_at": -3}],
                         ids=["truncated", "crc"])
def test_damaged_entry_is_quarantined_and_a_miss(tmp_path, damage):
    store = tstore.CompileCacheStore(str(tmp_path))
    key = tstore.make_key(["a"])
    store.put(key, b"p" * 64, {})
    _damage(store.path_for(key), **damage)
    assert store.get(key, quarantine=False) is None
    assert os.path.exists(store.path_for(key))      # evidence kept
    assert store.get(key) is None
    assert not os.path.exists(store.path_for(key))  # quarantined


def test_version_skew_and_key_mismatch_are_misses(tmp_path):
    store = tstore.CompileCacheStore(str(tmp_path))
    key, other = tstore.make_key(["v"]), tstore.make_key(["w"])
    store.put(key, b"payload", {})
    path = store.path_for(key)
    with open(path, "rb") as f:
        header, payload = f.readline(), f.read()
    rec = json.loads(header)
    rec["format"] = "mxnet_tpu.compile_cache/999"
    with open(path, "wb") as f:
        f.write(json.dumps(rec).encode() + b"\n" + payload)
    assert store.get(key) is None and not os.path.exists(path)
    # An entry renamed under another key never serves that key.
    store.put(key, b"payload", {})
    os.rename(store.path_for(key), store.path_for(other))
    assert store.get(other) is None
    assert not os.path.exists(store.path_for(other))


def test_lru_gc_by_mtime(tmp_path):
    store = tstore.CompileCacheStore(str(tmp_path))
    now = time.time()
    for i in range(4):
        key = tstore.make_key(["entry", i])
        store.put(key, b"x" * 100, {"i": i})
        os.utime(store.path_for(key), (now - 100 + i, now - 100 + i))
    # A hit re-touches its entry: the oldest one, read now, survives.
    oldest = tstore.make_key(["entry", 0])
    assert store.get(oldest) is not None
    size = store.entries()[0][2]
    removed = store.gc(max_bytes=2 * size)
    assert len(removed) == 2
    left = {store.get(k, touch=False)[0]["i"] for k in store.keys()}
    assert left == {0, 3}
    # The budget given to the store applies on every commit.
    small = tstore.CompileCacheStore(str(tmp_path / "small"),
                                     max_bytes=size + 10)
    for i in range(3):
        small.put(tstore.make_key(["s", i]), b"y" * 100, {})
    assert small.total_bytes() <= size + 10 and len(small.keys()) == 1


def test_kill_mid_commit_leaves_no_torn_entry(tmp_path, monkeypatch):
    """A commit that dies at its rename (a kill between write and rename)
    leaves no entry and no staging file; the next commit is clean."""
    store = tstore.CompileCacheStore(str(tmp_path))
    key = tstore.make_key(["torn"])
    real = ckpt._rename
    calls = []

    def dying_rename(src, dst):
        calls.append(dst)
        if len(calls) == 1:
            raise OSError("killed before the rename")
        return real(src, dst)

    monkeypatch.setattr(ckpt, "_rename", dying_rename)
    with pytest.raises(OSError):
        store.put(key, b"payload", {})
    assert os.listdir(str(tmp_path)) == []
    assert store.get(key) is None
    store.put(key, b"payload", {})
    assert store.get(key)[1] == b"payload"
    assert len(calls) == 2


def test_short_write_is_caught_by_the_next_read(tmp_path, monkeypatch):
    """A write that loses its tail behind the commit's back (a torn
    page): the entry commits, and the next read's size/CRC check
    quarantines it."""
    store = tstore.CompileCacheStore(str(tmp_path))
    key = tstore.make_key(["short"])
    real = ckpt._open_for_write

    class Short:
        def __init__(self, f):
            self._f = f

        def write(self, data):
            return self._f.write(data[:-5])

        def __getattr__(self, name):
            return getattr(self._f, name)

    monkeypatch.setattr(ckpt, "_open_for_write",
                        lambda path: Short(real(path)))
    store.put(key, b"z" * 100, {})
    monkeypatch.setattr(ckpt, "_open_for_write", real)
    assert store.get(key) is None
    assert store.keys() == []


# -- the distributor ---------------------------------------------------------------

def test_localbus_rank1_pulls_rank0_entries(tmp_path):
    bus = LocalBus(num_workers=2)
    key = cc.make_key(["k"])
    cc.configure(str(tmp_path / "rank0"))
    cc.set_distributor(CacheDistributor(bus.endpoint(0)))
    assert cc.fetch("t", key) is None                       # cold miss
    cc.commit("t", key, {"log": "L"}, b"blob", 1.5)
    assert list(bus._cc) == [key]                           # published
    meta, payload = bus.cc_pull(key)
    assert meta["site"] == "t" and meta["compile_seconds"] == 1.5
    assert meta["backend"] == cc.backend_fingerprint()
    # Rank 1, empty store: pulls, counts a remote hit, commits locally.
    cc.reset()
    cc.configure(str(tmp_path / "rank1"))
    dist1 = cc.set_distributor(CacheDistributor(bus.endpoint(1)))
    assert not dist1.publishes and dist1.pulls
    hits0 = _counter("mx_compile_cache_hits_total", site="t",
                     source="remote")
    pulled0 = _counter("mx_compile_cache_pulled_total")
    assert cc.fetch("t", key) == ({"log": "L"}, b"blob")
    assert _counter("mx_compile_cache_hits_total", site="t",
                    source="remote") == hits0 + 1
    assert _counter("mx_compile_cache_pulled_total") == pulled0 + 1
    # The next start needs no peer.
    cc.set_distributor(None)
    local0 = _counter("mx_compile_cache_hits_total", site="t",
                      source="local")
    assert cc.fetch("t", key) == ({"log": "L"}, b"blob")
    assert _counter("mx_compile_cache_hits_total", site="t",
                    source="local") == local0 + 1
    # A rank that is not rank 0 does not publish what it compiles.
    cc.set_distributor(dist1)
    cc.commit("t", cc.make_key(["other"]), {}, b"x", 0.1)
    assert list(bus._cc) == [key]


def test_attach_kvstore_prefetches_and_is_idempotent(tmp_path):
    bus = LocalBus(num_workers=2)
    cc.configure(str(tmp_path / "rank0"))
    cc.set_distributor(CacheDistributor(bus.endpoint(0)))
    keys = [cc.make_key(["pf", i]) for i in range(3)]
    for k in keys:
        cc.commit("pf", k, {}, k.encode(), 0.2)
    assert sorted(bus.cc_probe(None)) == sorted(keys)
    cc.reset()
    cc.configure(str(tmp_path / "rank1"))
    pre0 = _counter("mx_compile_cache_prefetched_total")
    dist = cc.attach_kvstore(bus.endpoint(1))
    assert dist is not None and dist.rank == 1
    assert _counter("mx_compile_cache_prefetched_total") == pre0 + 3
    assert sorted(cc.active_store().keys()) == sorted(keys)
    cc.attach_kvstore(bus.endpoint(1))      # everything already local
    assert _counter("mx_compile_cache_prefetched_total") == pre0 + 3
    # With the cache off, attaching is a no-op.
    cc.reset()
    assert cc.attach_kvstore(bus.endpoint(1)) is None


def test_shared_filesystem_mode_attaches_nothing(tmp_path, monkeypatch):
    bus = LocalBus(num_workers=2)
    cc.configure(str(tmp_path / "shared"))
    monkeypatch.setenv("MXNET_COMPILE_CACHE_SHARED", "1")
    assert cc.shared_filesystem()
    assert cc.attach_kvstore(bus.endpoint(0)) is None
    assert cc._active_distributor() is None
    cc.commit("shared", cc.make_key(["s"]), {}, b"x", 0.1)
    assert bus._cc == {}
    # Another rank on the same directory hits it.
    cc.reset()
    cc.configure(str(tmp_path / "shared"))
    assert cc.fetch("shared", cc.make_key(["s"])) == ({}, b"x")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_SHARED", "0")
    assert cc.attach_kvstore(bus.endpoint(0)) is not None


def test_entry_bound_and_drop_oldest(monkeypatch):
    bus = LocalBus(num_workers=2)
    dist = CacheDistributor(bus.endpoint(0), max_entry_bytes=64)
    assert not dist.publish("k" * 32, {}, b"x" * 100)   # over the bound
    assert bus._cc == {}
    assert dist.publish("k" * 32, {}, b"x" * 10)
    assert dist.fetch("k" * 32)[1] == b"x" * 10
    assert dist.fetch("absent") is None
    monkeypatch.setenv("MXNET_PS_CC_ENTRY_MB", "3")
    assert CacheDistributor(bus.endpoint(0)).max_entry_bytes == 3 << 20
    monkeypatch.setattr(LocalBus, "MAX_CC_BYTES", 250)
    small = LocalBus(num_workers=1)
    for i in range(4):
        small.cc_push("key%d" % i, {}, b"x" * 100)
    assert list(small._cc) == ["key2", "key3"]
    assert small.cc_probe(["key0", "key3"]) == ["key3"]


def test_failures_are_counted_and_never_raised(tmp_path, monkeypatch):
    """A commit that cannot write, a peer that cannot answer and a
    payload that does not unpack each count an error and leave the
    caller to compile."""
    cc.configure(str(tmp_path))

    class Broken:
        rank = 1

        def cc_probe(self, keys=None):
            raise ConnectionError("server gone")

        cc_pull = cc_push = cc_probe

    cc.set_distributor(CacheDistributor(Broken()))
    before = _errors()
    assert cc.fetch("f", cc.make_key(["gone"])) is None
    monkeypatch.setattr(ckpt, "_rename", lambda s, d: (_ for _ in ()).throw(
        OSError("disk full")))
    cc.commit("f", cc.make_key(["io"]), {}, b"x", 0.1)
    monkeypatch.undo()
    cc.set_distributor(None)
    key = cc.make_key(["raw"])
    cc.active_store().put(key, b"no header line", {})
    assert cc.fetch("f", key) is None
    assert cc.active_store().keys() == []            # quarantined
    assert cc.attach_kvstore(Broken()) is not None   # prefetch fails soft
    after = _errors()
    grew = {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
    assert grew == {("f", "distribute"): 1, ("f", "io"): 1,
                    ("f", "corrupt"): 1, ("prefetch", "distribute"): 1}


def test_knobs_are_catalogued(monkeypatch, tmp_path):
    names = {k.name for k in tenv.CATALOGUE}
    assert {"MXNET_COMPILE_CACHE", "MXNET_COMPILE_CACHE_MB",
            "MXNET_COMPILE_CACHE_SHARED", "MXNET_PS_CC_ENTRY_MB",
            "MXNET_PS_CC_BUFFER_MB"} <= names
    assert not cc.enabled()
    monkeypatch.setenv("MXNET_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MB", "7")
    cc.reset()
    assert cc.enabled()
    assert cc.active_store().directory == str(tmp_path)
    assert cc.active_store().max_bytes == 7 << 20


def test_maybe_cached_jit_counts_signatures_and_writes_nothing(tmp_path):
    def f(x, scale=2.0):
        return x * scale

    assert cc.maybe_cached_jit(f, "fused_apply") is f       # cache off
    cc.configure(str(tmp_path))
    cf = cc.maybe_cached_jit(f, "fused_apply")
    assert isinstance(cf, cc.CachedFunction) and cf.site == "fused_apply"
    x = torch.ones(3)
    assert torch.equal(cf(x), x * 2)
    cf(torch.zeros(3))
    cf(torch.ones(4))
    cf(mx.nd.array(np.ones((2, 2)), ctx=mx.cpu()))
    cf(x, 3.0)
    cf(x, 4.0)                  # a Python scalar is keyed by its type
    assert cf.num_traces == 4
    assert os.listdir(str(tmp_path)) == []
    assert cc.cached_compile(f, "fused_apply")(x).equal(x * 2)


def test_backend_fingerprint_names_the_stack():
    fp = cc.backend_fingerprint()
    assert set(fp) == {"platform", "device_kind", "capability",
                       "num_devices", "world_size", "torch", "cuda",
                       "nvrtc", "nvcc", "driver"}
    assert fp["platform"] == "gpu" and fp["torch"] == torch.__version__
    assert fp["world_size"] == 1


# -- the nvcc seam -----------------------------------------------------------------

FAKE_NVCC = """#!%s
import hashlib, os, sys
here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "calls.txt"), "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if sys.argv[1:] == ["--version"]:
    with open(os.path.join(here, "version.txt")) as f:
        print("nvcc: NVIDIA (R) Cuda compiler driver")
        print(f.read().strip())
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
with open(src, "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()
with open(out, "wb") as f:
    f.write(("library of %%s %%s" %% (os.path.basename(src), digest)).encode())
print("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'")
print("ptxas info    : Used 40 registers, %%s" %% os.path.basename(src))
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc first on PATH; each test builds into its own
    BUILD. Returns a helper with the call counts and the version."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC % sys.executable)
    nvcc.chmod(0o755)
    (bindir / "version.txt").write_text("Build cuda_12.8.r12.8/compiler.1")
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.setattr(_native, "_versions", {})
    monkeypatch.setattr(_native, "STATS", dict.fromkeys(_native.STATS, 0))
    monkeypatch.setattr(cc, "_backend_fp", None)   # read with this nvcc

    class Fake:
        path = str(nvcc)

        @staticmethod
        def compiles():
            calls = bindir / "calls.txt"
            if not calls.exists():
                return 0
            return sum(1 for ln in calls.read_text().splitlines()
                       if ln != "--version")

        @staticmethod
        def set_version(line):
            (bindir / "version.txt").write_text(line)
            _native._versions.clear()     # a new process reads it anew

        @staticmethod
        def fresh_build(name):
            d = tmp_path / name
            monkeypatch.setattr(_native, "BUILD", str(d))
            return d

    return Fake


NAMES = ["detection", "rtc_launch"]


def _metas(store):
    return [store.get(k)[0] for k in store.keys()]


def _sites(store):
    return collections.Counter(m["site"] for m in _metas(store))


def _libraries(targets):
    out = {}
    for n, p in targets.items():
        with open(p, "rb") as f:
            out[n] = f.read()
    return out


def test_nvcc_cold_then_warm_compiles_nothing(tmp_path, fake_nvcc):
    cc.configure(str(tmp_path / "store"))
    fake_nvcc.fresh_build("build_cold")
    miss0 = _counter("mx_compile_cache_misses_total", site="nvcc")
    cold = _native.build(NAMES)
    assert fake_nvcc.compiles() == 2
    assert _native.STATS["nvcc_runs"] == 2
    assert _counter("mx_compile_cache_misses_total", site="nvcc") == \
        miss0 + 2
    logs = {n: _native.build_log(n) for n in NAMES}
    assert all("Used 40 registers" in log for log in logs.values())
    assert _sites(cc.active_store()) == {"nvcc": 2, "nvcc_toolkit": 2}
    # A built library is not built again in the same BUILD.
    _native.build(NAMES)
    assert fake_nvcc.compiles() == 2
    # Warm: a fresh BUILD, the same store.
    fake_nvcc.fresh_build("build_warm")
    hit0 = _counter("mx_compile_cache_hits_total", site="nvcc",
                    source="local")
    warm = _native.build(NAMES)
    assert fake_nvcc.compiles() == 2                 # nvcc built nothing
    assert _native.STATS == {"nvcc_runs": 2,
                             "build_seconds": _native.STATS["build_seconds"],
                             "cache_hits": 2}
    assert _counter("mx_compile_cache_hits_total", site="nvcc",
                    source="local") == hit0 + 2
    assert [os.path.basename(p) for p in warm.values()] == \
        [os.path.basename(p) for p in cold.values()]
    assert _libraries(warm) == _libraries(cold)
    assert {n: _native.build_log(n) for n in NAMES} == logs
    for meta in _metas(cc.active_store()):
        assert meta["site"] in ("nvcc", "nvcc_toolkit")
        assert meta["name"] in NAMES
        assert meta["backend"]["nvcc"] == "Build cuda_12.8.r12.8/compiler.1"


def test_nvcc_key_follows_the_toolkit(tmp_path, fake_nvcc):
    cc.configure(str(tmp_path / "store"))
    fake_nvcc.fresh_build("build_a")
    first = _native.build(["detection"])["detection"]
    fake_nvcc.set_version("Build cuda_12.9.r12.9/compiler.2")
    again = _native.build(["detection"])["detection"]
    # Another toolkit: another library name and another key, so nvcc
    # builds again even with the old library and entry at hand.
    assert os.path.basename(again) != os.path.basename(first)
    assert fake_nvcc.compiles() == 2
    # The toolkit record of the same sources names the newer toolkit.
    assert _sites(cc.active_store()) == {"nvcc": 2, "nvcc_toolkit": 1}


def test_nvcc_peer_pulls_and_compiles_nothing(tmp_path, fake_nvcc):
    bus = LocalBus(num_workers=2)
    cc.configure(str(tmp_path / "rank0"))
    cc.set_distributor(CacheDistributor(bus.endpoint(0)))
    fake_nvcc.fresh_build("build0")
    cold = _native.build(NAMES)
    logs = {n: _native.build_log(n) for n in NAMES}
    assert fake_nvcc.compiles() == 2 and len(bus._cc) == 4
    # Rank 1 misses locally and pulls each library from the pod.
    cc.reset()
    cc.configure(str(tmp_path / "rank1"))
    cc.attach_kvstore(bus.endpoint(1), prefetch=False)
    fake_nvcc.fresh_build("build1")
    hit0 = _counter("mx_compile_cache_hits_total", site="nvcc",
                    source="remote")
    peer = _native.build(NAMES)
    assert fake_nvcc.compiles() == 2
    assert _counter("mx_compile_cache_hits_total", site="nvcc",
                    source="remote") == hit0 + 2
    assert _libraries(peer) == _libraries(cold)
    assert {n: _native.build_log(n) for n in NAMES} == logs
    # A third rank prefetches at attach: its builds hit its own disk.
    cc.reset()
    cc.configure(str(tmp_path / "rank2"))
    pre0 = _counter("mx_compile_cache_prefetched_total")
    cc.attach_kvstore(bus.endpoint(1))
    assert _counter("mx_compile_cache_prefetched_total") == pre0 + 4
    fake_nvcc.fresh_build("build2")
    local0 = _counter("mx_compile_cache_hits_total", site="nvcc",
                      source="local")
    assert _libraries(_native.build(NAMES)) == _libraries(cold)
    assert _counter("mx_compile_cache_hits_total", site="nvcc",
                    source="local") == local0 + 2
    assert fake_nvcc.compiles() == 2


def test_nvcc_absent_loads_what_was_built(tmp_path, fake_nvcc,
                                          monkeypatch):
    """Without nvcc, a library built from the same sources is found: in
    BUILD through its toolkit record, else in the store or from a peer
    through the record committed beside it. With none, build raises."""
    bus = LocalBus(num_workers=2)
    cc.configure(str(tmp_path / "rank0"))
    cc.set_distributor(CacheDistributor(bus.endpoint(0)))
    fake_nvcc.fresh_build("build0")
    cold = _native.build(NAMES)
    logs = {n: _native.build_log(n) for n in NAMES}
    monkeypatch.setattr(_native, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_native, "_versions", {})
    assert _native.build(NAMES) == cold
    assert {n: _native.build_log(n) for n in NAMES} == logs
    for store, source in (("rank0", "local"), ("rank1", "remote")):
        cc.reset()
        cc.configure(str(tmp_path / store))
        cc.attach_kvstore(bus.endpoint(1), prefetch=False)
        fake_nvcc.fresh_build("build_" + store)
        hit0 = _counter("mx_compile_cache_hits_total", site="nvcc_toolkit",
                        source=source)
        got = _native.build(NAMES)
        assert _counter("mx_compile_cache_hits_total", site="nvcc_toolkit",
                        source=source) == hit0 + 2
        assert [os.path.basename(p) for p in got.values()] == \
            [os.path.basename(p) for p in cold.values()]
        assert _libraries(got) == _libraries(cold)
        assert {n: _native.build_log(n) for n in NAMES} == logs
    assert fake_nvcc.compiles() == 2
    cc.reset()
    fake_nvcc.fresh_build("build_none")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build(NAMES)


def test_nvcc_damaged_entry_recompiles_and_heals(tmp_path, fake_nvcc):
    cc.configure(str(tmp_path / "store"))
    fake_nvcc.fresh_build("build_a")
    _native.build(["detection"])
    store = cc.active_store()
    (key,) = [k for k in store.keys() if store.get(k)[0]["site"] == "nvcc"]
    _damage(store.path_for(key), flip_byte_at=-2)
    fake_nvcc.fresh_build("build_b")
    _native.build(["detection"])
    assert fake_nvcc.compiles() == 2
    assert key in store.keys() and store.get(key) is not None


def test_nvcc_without_the_cache_builds_as_before(tmp_path, fake_nvcc):
    fake_nvcc.fresh_build("build")
    lib = _native.build(["detection"])["detection"]
    assert os.path.exists(lib) and fake_nvcc.compiles() == 1
    assert "Used 40 registers" in _native.build_log("detection")
    fake_nvcc.fresh_build("build_again")
    _native.build(["detection"])
    assert fake_nvcc.compiles() == 2


# -- the NVRTC seam ----------------------------------------------------------------

class FakeNVRTC:
    """Stand-in for libnvrtc's ctypes library: each call writes through
    the ctypes arguments as NVRTC does, and compiles are counted."""

    def __init__(self, version=(12, 8)):
        self.version = version
        self.compiles = 0
        self._programs = {}

    def _prog(self, handle):
        return self._programs[handle.value if hasattr(handle, "value")
                              else handle]

    def nvrtcGetErrorString(self, res):
        return b"NVRTC_ERROR %d" % res

    def nvrtcVersion(self, major, minor):
        major._obj.value, minor._obj.value = self.version
        return 0

    def nvrtcCreateProgram(self, handle, src, name, n, headers, includes):
        h = len(self._programs) + 1
        self._programs[h] = {"src": src, "names": []}
        handle._obj.value = h
        return 0

    def nvrtcAddNameExpression(self, handle, name):
        self._prog(handle)["names"].append(name)
        return 0

    def nvrtcCompileProgram(self, handle, n, opts):
        self.compiles += 1
        p = self._prog(handle)
        p["cubin"] = b"CUBIN:" + p["src"] + b"|" + b" ".join(
            opts[i] for i in range(n))
        p["log"] = b"warning: fake log"
        return 0

    def nvrtcGetProgramLogSize(self, handle, size):
        size._obj.value = len(self._prog(handle)["log"]) + 1
        return 0

    def nvrtcGetProgramLog(self, handle, buf):
        log = self._prog(handle)["log"]
        ctypes.memmove(buf, log + b"\0", len(log) + 1)
        return 0

    def nvrtcGetCUBINSize(self, handle, size):
        size._obj.value = len(self._prog(handle)["cubin"])
        return 0

    def nvrtcGetCUBIN(self, handle, buf):
        cubin = self._prog(handle)["cubin"]
        ctypes.memmove(buf, cubin, len(cubin))
        return 0

    def nvrtcGetLoweredName(self, handle, name, out):
        self._keep = ctypes.c_char_p(b"_Z5lowered" + name)
        out._obj.value = self._keep.value
        return 0

    def nvrtcDestroyProgram(self, handle):
        return 0


@pytest.fixture
def fake_nvrtc(monkeypatch):
    lib = FakeNVRTC()
    monkeypatch.setitem(_nvrtc._libs, "nvrtc", lib)
    monkeypatch.setattr(_nvrtc, "_capability", lambda: [9, 0])
    monkeypatch.setattr(_nvrtc, "_programs", {})
    monkeypatch.setattr(_nvrtc, "STATS", dict.fromkeys(_nvrtc.STATS, 0))

    def new_process():
        monkeypatch.setattr(_nvrtc, "_programs", {})

    lib.new_process = new_process
    return lib


SRC = 'extern "C" __global__ void k(float *x) { x[0] = 1; }'
OPTS = ("--gpu-architecture=sm_90a", "-default-device")


def test_nvrtc_compiles_without_the_cache(fake_nvrtc, tmp_path):
    prog = _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert prog.cubin.startswith(b"CUBIN:" + SRC.encode())
    assert prog.lowered == {"k": "_Z5loweredk"}
    assert prog.log == "warning: fake log"
    assert _nvrtc.compile_program(SRC, OPTS, ["k"]) is prog
    assert (fake_nvrtc.compiles, _nvrtc.STATS["compiles"],
            _nvrtc.STATS["cache_hits"], _nvrtc.STATS["store_hits"]) == \
        (1, 1, 1, 0)
    assert _nvrtc.nvrtc_version() == "12.8"


def test_nvrtc_cold_warm_and_peer(fake_nvrtc, tmp_path, monkeypatch):
    bus = LocalBus(num_workers=2)
    cc.configure(str(tmp_path / "rank0"))
    cc.set_distributor(CacheDistributor(bus.endpoint(0)))
    cold = _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 1 and len(bus._cc) == 1
    assert _nvrtc.STATS["compiles"] == 1
    # Warm: a new process on the same store loads the program.
    fake_nvrtc.new_process()
    warm = _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 1
    assert (warm.cubin, warm.lowered, warm.log) == \
        (cold.cubin, cold.lowered, cold.log)
    assert _nvrtc.STATS["store_hits"] == 1
    _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert _nvrtc.STATS["cache_hits"] == 1           # the process's dict
    # A peer with an empty store pulls it.
    cc.reset()
    cc.configure(str(tmp_path / "rank1"))
    cc.attach_kvstore(bus.endpoint(1), prefetch=False)
    fake_nvrtc.new_process()
    peer = _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 1 and peer.cubin == cold.cubin
    assert _nvrtc.STATS["store_hits"] == 2
    # Another option, another name, another NVRTC or another card is
    # another key: compiled.
    fake_nvrtc.new_process()
    _nvrtc.compile_program(SRC, OPTS + ("-lineinfo",), ["k"])
    _nvrtc.compile_program(SRC, OPTS, [])
    fake_nvrtc.version = (12, 9)
    _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 4
    fake_nvrtc.new_process()
    fake_nvrtc.version = (12, 8)
    _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 4
    monkeypatch.setattr(_nvrtc, "_capability", lambda: [10, 0])
    fake_nvrtc.new_process()
    _nvrtc.compile_program(SRC, OPTS, ["k"])
    assert fake_nvrtc.compiles == 5


def test_nvrtc_key_is_what_the_docstring_names():
    parts = ["nvrtc", SRC, list(OPTS), ["k"], "12.8", [9, 0]]
    assert cc.make_key(parts) == jstore.make_key(parts)


# -- the tool ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tool_inspects_verifies_and_gcs(tmp_path, writer):
    store_cls = (tstore if writer == "port" else jstore).CompileCacheStore
    store = store_cls(str(tmp_path))
    now = time.time()
    for i in range(3):
        key = tstore.make_key(["tool", i])
        backend = {"platform": "gpu", "device_kind": "NVIDIA H100",
                   "num_devices": 1, "torch": "2.11", "nvcc": "V12.8"} \
            if writer == "port" else {"platform": "cpu",
                                      "device_kind": "cpu",
                                      "num_devices": 8, "jax": "0.4",
                                      "jaxlib": "0.4"}
        store.put(key, bytes(200 + i), {"site": "nvcc", "name": "lib%d" % i,
                                        "backend": backend,
                                        "compile_seconds": 1.5})
        os.utime(store.path_for(key), (now - 10 + i, now - 10 + i))
    info = ttool.inspect(str(tmp_path))
    assert info["entries"] == 3
    assert info["by_site"] == {"nvcc": {"entries": 3,
                                        "bytes": info["total_bytes"],
                                        "compile_seconds": 4.5}}
    assert info["warm_restart_saves_seconds"] == 4.5
    d0 = info["detail"][0]
    assert d0["name"] == "lib2" and not d0["damaged"]
    assert d0["versions"] == ({"torch": "2.11", "nvcc": "V12.8"}
                              if writer == "port"
                              else {"jax": "0.4", "jaxlib": "0.4"})
    jtool = _jax_tool()
    jinfo = jtool.inspect(str(tmp_path))
    for k in ("entries", "total_bytes", "by_site",
              "warm_restart_saves_seconds"):
        assert info[k] == jinfo[k]
    victim = tstore.CompileCacheStore(str(tmp_path)).keys()[0]
    _damage(os.path.join(str(tmp_path), tstore.entry_name(victim)),
            flip_byte_at=-10)
    info = ttool.inspect(str(tmp_path))
    assert sum(1 for e in info["detail"] if e["damaged"]) == 1
    assert ttool.verify(str(tmp_path)) == jtool.verify(str(tmp_path))
    rep = ttool.verify(str(tmp_path), remove=True)
    assert rep["valid"] == 2 and rep["damaged_keys"] == [victim]
    assert len(tstore.CompileCacheStore(str(tmp_path)).keys()) == 2
    out = ttool.gc(str(tmp_path), max_mb=0)
    assert out["bytes_after"] == 0 and out["removed_entries"] == 2


def test_tool_command_line(tmp_path, capsys):
    tstore.CompileCacheStore(str(tmp_path)).put(
        tstore.make_key(["cli"]), b"x" * 10, {"site": "nvrtc"})
    assert ttool.main(["inspect", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 1
    assert ttool.main(["verify", str(tmp_path), "--remove"]) == 0
    assert json.loads(capsys.readouterr().out)["valid"] == 1
    assert ttool.main(["gc", str(tmp_path), "--max-mb", "0"]) == 0
    assert json.loads(capsys.readouterr().out)["removed_entries"] == 1
