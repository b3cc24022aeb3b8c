"""mxnet_tpu_torch.checkpoint against the JAX package's checkpoint tests
and format.

The cases of tests/test_checkpoint.py, on the port: atomic commit,
bounded retry, checksum-verified restore that skips torn and corrupt
commits, retention, sharded saves with manifest stitching, backlog
drops, a SIGKILL mid-save, the preemption hook and its retry, and the
state adapters of every training front end. Then the format across
packages: a directory committed by either package restores in the other
with equal values, and for the same state both write the same manifest
and shard bytes (bfloat16 only from the port: the JAX package cannot
write a bfloat16 leaf, ROADMAP Queue 3). Then the two faults the port
repairs: a SIGTERM inside an update loop (TrainStep, Trainer, Module)
commits the whole pre- or post-step state under its own label, and a
bfloat16 Trainer resumes with bfloat16 weights from bfloat16 bytes.

All on the host (``mx.cpu()``); the comparisons are exact unless a test
states a tolerance.
"""
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.checkpoint import (CheckpointCorruptError,
                                        CheckpointManager,
                                        CheckpointNotFoundError,
                                        PreemptionHook, Shard,
                                        StepInProgressError, block_state,
                                        load_block_state, load_state_dict,
                                        load_trainer_state, module_state,
                                        state_dict, trainer_state)
from mxnet_tpu_torch.checkpoint import manager as ckpt_manager
from mxnet_tpu_torch.parallel import TrainStep, make_mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _state(step=0):
    rng = np.random.RandomState(42 + step)
    return {"params": {"w": rng.rand(8, 4).astype(np.float32),
                       "b": rng.rand(4).astype(np.float32)},
            "meta": {"step": step, "lr": 0.1, "tag": "run-a",
                     "blob": b"\x00pickled\xff", "ok": True}}


# -- fault injection on the port's seams --------------------------------------

class _Faults:
    """The JAX suite's FaultInjector over ``_open_for_write``/``_rename``
    of the port's manager: fail the next n writes or renames, truncate
    the next file opened for writing at close, or damage a file."""

    def __init__(self):
        self.fail_writes = 0
        self.fail_renames = 0
        self.truncate_keep = None
        self.writes_failed = 0
        self.renames_failed = 0
        self.files_truncated = 0

    def fail_next_writes(self, n):
        self.fail_writes = int(n)

    def fail_next_renames(self, n):
        self.fail_renames = int(n)

    def truncate_next_file(self, keep_bytes):
        self.truncate_keep = int(keep_bytes)

    @staticmethod
    def corrupt(path, flip_byte_at):
        with open(path, "r+b") as f:
            f.seek(flip_byte_at)
            b = f.read(1)
            f.seek(flip_byte_at)
            f.write(bytes([b[0] ^ 0xFF]))


class _FaultyFile:
    def __init__(self, f, faults, path):
        self._f = f
        self._faults = faults
        self._path = path
        self._truncate = faults.truncate_keep
        faults.truncate_keep = None

    def write(self, data):
        if self._faults.fail_writes > 0:
            self._faults.fail_writes -= 1
            self._faults.writes_failed += 1
            raise OSError("injected write failure")
        return self._f.write(data)

    def close(self):
        self._f.close()
        if self._truncate is not None:
            with open(self._path, "r+b") as f:
                f.truncate(self._truncate)
            self._faults.files_truncated += 1

    def __getattr__(self, name):
        return getattr(self._f, name)


@pytest.fixture
def fault_fs(monkeypatch):
    faults = _Faults()
    real_open, real_rename = ckpt_manager._open_for_write, \
        ckpt_manager._rename

    def faulty_open(path):
        return _FaultyFile(real_open(path), faults, path)

    def faulty_rename(src, dst):
        if faults.fail_renames > 0:
            faults.fail_renames -= 1
            faults.renames_failed += 1
            raise OSError("injected rename failure")
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt_manager, "_open_for_write", faulty_open)
    monkeypatch.setattr(ckpt_manager, "_rename", faulty_rename)
    yield faults


# -- core save/restore --------------------------------------------------------

def test_save_restore_roundtrip_kinds(tmp_path):
    m = CheckpointManager(str(tmp_path))
    st = _state(3)
    m.save(3, st, sync=True)
    step, out = m.restore()
    assert step == 3
    np.testing.assert_array_equal(out["params"]["w"], st["params"]["w"])
    np.testing.assert_array_equal(out["params"]["b"], st["params"]["b"])
    assert out["meta"] == st["meta"]
    assert isinstance(out["meta"]["step"], int)
    assert isinstance(out["meta"]["lr"], float)
    assert isinstance(out["meta"]["blob"], bytes)
    assert isinstance(out["meta"]["ok"], bool)


@pytest.mark.parametrize("kind", ["tensor", "ndarray", "bf16_tensor",
                                  "bf16_ndarray", "int64_tensor"])
def test_roundtrip_torch_leaves_keep_dtype(tmp_path, kind):
    """Torch tensors and NDArrays are leaves too, saved in their own
    dtype: bfloat16 as its 16-bit words (never widened to float32)."""
    rng = np.random.RandomState(1)
    base = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    value = {"tensor": base,
             "ndarray": mx.nd.NDArray(base.clone()),
             "bf16_tensor": base.to(torch.bfloat16),
             "bf16_ndarray": mx.nd.NDArray(base.to(torch.bfloat16)),
             "int64_tensor": torch.arange(7)}[kind]
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"x": value}, sync=True)
    _, out = m.restore()
    want = value._data if isinstance(value, mx.nd.NDArray) else value
    got = out["x"]
    if want.dtype == torch.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    else:
        np.testing.assert_array_equal(got, want.numpy())
        assert got.dtype == want.numpy().dtype
    with open(tmp_path / "step-00000001" / "manifest.json") as f:
        entry = json.load(f)["arrays"]["x"]
    itemsize = torch.empty((), dtype=want.dtype).element_size()
    assert entry["dtype"] == ("bfloat16" if want.dtype == torch.bfloat16
                              else str(want.numpy().dtype))
    assert entry["chunks"][0]["nbytes"] == want.numel() * itemsize


def test_async_saves_commit_in_order(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=10, max_pending=10)
    for s in range(1, 6):
        m.save(s, _state(s))
    m.wait()
    assert m.pending == 0
    assert m.all_steps() == [1, 2, 3, 4, 5]
    assert m.latest_step() == 5
    step, out = m.restore()
    assert step == 5 and out["meta"]["step"] == 5
    m.close()


def test_restore_specific_step(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    for s in (1, 2, 3):
        m.save(s, _state(s), sync=True)
    step, out = m.restore(step=2)
    assert step == 2 and out["meta"]["step"] == 2


def test_restore_empty_dir_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    assert m.latest_step() is None
    with pytest.raises(CheckpointNotFoundError):
        m.restore()


def test_retention_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=2, keep_every=4)
    for s in range(1, 9):
        m.save(s, _state(s), sync=True)
    assert m.all_steps() == [4, 7, 8]


def test_uncommitted_dirs_invisible(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    m.save(1, _state(1), sync=True)
    os.makedirs(str(tmp_path / "step-00000099"))          # no manifest
    os.makedirs(str(tmp_path / "tmp.step-00000098.123"))  # torn staging
    assert m.latest_step() == 1
    step, _ = m.restore()
    assert step == 1


# -- fault injection: retries, atomicity, corruption --------------------------

def test_transient_write_failure_retried(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), max_retries=3, retry_backoff=0.001)
    fault_fs.fail_next_writes(2)
    m.save(1, _state(1), sync=True)
    assert fault_fs.writes_failed == 2
    step, out = m.restore()
    assert step == 1
    np.testing.assert_array_equal(out["params"]["w"],
                                  _state(1)["params"]["w"])


def test_retry_budget_exhausted(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), max_retries=2, retry_backoff=0.001)
    fault_fs.fail_next_writes(100)
    with pytest.raises(OSError):
        m.save(1, _state(1), sync=True)
    assert m.latest_step() is None
    assert isinstance(m.last_error, OSError)


def test_async_failure_keeps_trainer_alive(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), max_retries=1, retry_backoff=0.001)
    fault_fs.fail_next_writes(100)
    m.save(1, _state(1))
    m.wait()
    assert m.latest_step() is None
    assert isinstance(m.last_error, OSError)
    fault_fs.fail_next_writes(0)
    m.save(2, _state(2))
    m.wait()
    assert m.latest_step() == 2
    m.close()


def test_failed_commit_rename_is_invisible(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), max_retries=0)
    m.save(1, _state(1), sync=True)
    fault_fs.fail_next_renames(1)
    with pytest.raises(OSError):
        m.save(2, _state(2), sync=True)
    assert m.all_steps() == [1]
    step, _ = m.restore()
    assert step == 1


def test_torn_write_detected_and_skipped(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    m.save(1, _state(1), sync=True)
    fault_fs.truncate_next_file(10)       # next opened file = step 2 shard
    m.save(2, _state(2), sync=True)
    assert fault_fs.files_truncated == 1
    assert m.latest_step() == 2
    step, out = m.restore()
    assert step == 1
    assert out["meta"]["step"] == 1


def test_corrupt_committed_checkpoint_skipped(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    m.save(1, _state(1), sync=True)
    m.save(2, _state(2), sync=True)
    shard = str(tmp_path / "step-00000002" / "shard-00000-of-00001.bin")
    fault_fs.corrupt(shard, flip_byte_at=8)
    step, _ = m.restore()
    assert step == 1
    with pytest.raises(CheckpointCorruptError):
        m.restore(step=2)


def test_torn_commit_can_be_resaved(tmp_path, fault_fs):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    fault_fs.truncate_next_file(10)
    m.save(3, _state(3), sync=True)
    with pytest.raises(Exception):
        m.restore(step=3)
    m.save(3, _state(3), sync=True)
    step, out = m.restore()
    assert step == 3
    np.testing.assert_array_equal(out["params"]["w"],
                                  _state(3)["params"]["w"])


# -- sharded saves ------------------------------------------------------------

def test_sharded_save_manifest_stitching(tmp_path):
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    scalar_meta = {"step": 5, "note": "spmd"}
    m1 = CheckpointManager(str(tmp_path), process_index=1, process_count=2)
    m1.save(5, {"w": Shard(full.shape, full.dtype,
                           [(((4, 8), (0, 8)), full[4:8])])}, sync=True)
    m0 = CheckpointManager(str(tmp_path), process_index=0, process_count=2)
    m0.save(5, {"w": Shard(full.shape, full.dtype,
                           [(((0, 4), (0, 8)), torch.from_numpy(full[0:4]))]),
                "meta": scalar_meta}, sync=True)
    step, out = m0.restore()
    assert step == 5
    np.testing.assert_array_equal(out["w"], full)
    assert out["meta"] == scalar_meta
    names = sorted(os.listdir(str(tmp_path / "step-00000005")))
    assert "shard-00000-of-00002.bin" in names
    assert "shard-00001-of-00002.bin" in names
    assert "manifest.json" in names


def test_sharded_bf16_chunks(tmp_path):
    """A bfloat16 Shard stitched from two processes restores as the same
    16-bit words."""
    full = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    m1 = CheckpointManager(str(tmp_path), process_index=1, process_count=2)
    m1.save(1, {"w": Shard(full.shape, torch.bfloat16,
                           [(((2, 4), (0, 6)), full[2:4])])}, sync=True)
    m0 = CheckpointManager(str(tmp_path), process_index=0, process_count=2)
    m0.save(1, {"w": Shard(full.shape, "bfloat16",
                           [(((0, 2), (0, 6)), full[0:2])])}, sync=True)
    _, out = m0.restore()
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), full.view(torch.int16))


def test_sharded_incomplete_coverage_detected(tmp_path):
    full = np.ones((4, 4), np.float32)
    m1 = CheckpointManager(str(tmp_path), process_index=1, process_count=2)
    m1.save(1, {"w": Shard(full.shape, full.dtype, [])}, sync=True)
    m0 = CheckpointManager(str(tmp_path), process_index=0, process_count=2)
    m0.save(1, {"w": Shard(full.shape, full.dtype,
                           [(((0, 2), (0, 4)), full[0:2])])}, sync=True)
    with pytest.raises(CheckpointCorruptError):
        m0.restore(step=1)


def test_stitch_timeout_fails_save(tmp_path):
    m0 = CheckpointManager(str(tmp_path), process_index=0, process_count=2,
                           stitch_timeout=0.05, max_retries=0)
    with pytest.raises(OSError):
        m0.save(1, {"w": np.ones(3, np.float32)}, sync=True)
    assert m0.latest_step() is None


def test_multiproc_retry_preserves_peer_shards(tmp_path, fault_fs):
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    m1 = CheckpointManager(str(tmp_path), process_index=1, process_count=2)
    m1.save(1, {"w": Shard(full.shape, full.dtype,
                           [(((2, 4), (0, 4)), full[2:4])])}, sync=True)
    m0 = CheckpointManager(str(tmp_path), process_index=0, process_count=2,
                           max_retries=2, retry_backoff=0.001)
    fault_fs.fail_next_writes(1)
    m0.save(1, {"w": Shard(full.shape, full.dtype,
                           [(((0, 2), (0, 4)), full[0:2])])}, sync=True)
    step, out = m0.restore()
    assert step == 1
    np.testing.assert_array_equal(out["w"], full)


# -- async copies and backpressure --------------------------------------------

def test_async_backlog_drops_oldest(tmp_path, monkeypatch):
    gate = threading.Event()
    real_open = ckpt_manager._open_for_write

    def slow_open(path):
        gate.wait(timeout=10)
        return real_open(path)

    m = CheckpointManager(str(tmp_path), keep_last=100, max_pending=2)
    monkeypatch.setattr(ckpt_manager, "_open_for_write", slow_open)
    try:
        for s in range(1, 8):
            m.save(s, _state(s))
        assert m.pending <= 3           # 1 in-flight + max_pending queued
        assert m.dropped_saves > 0
    finally:
        monkeypatch.setattr(ckpt_manager, "_open_for_write", real_open)
        gate.set()
    m.wait()
    assert m.latest_step() == 7
    m.close()


@pytest.mark.parametrize("kind", ["numpy", "tensor", "ndarray"])
def test_async_save_copies_leaves(tmp_path, monkeypatch, kind):
    """save() copies every leaf: a caller writing it in place afterwards
    (the next step does) must not reach the queued save."""
    gate = threading.Event()
    real_open = ckpt_manager._open_for_write

    def gated_open(path):
        gate.wait(timeout=10)
        return real_open(path)

    w = {"numpy": np.zeros(64, np.float32),
         "tensor": torch.zeros(64),
         "ndarray": mx.nd.zeros((64,))}[kind]
    m = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(ckpt_manager, "_open_for_write", gated_open)
    try:
        m.save(1, {"w": w})               # queued; writer blocked
        w[:] = 999.0                      # caller mutates AFTER save()
    finally:
        monkeypatch.setattr(ckpt_manager, "_open_for_write", real_open)
        gate.set()
    m.wait()
    _, st = m.restore()
    np.testing.assert_array_equal(st["w"], np.zeros(64, np.float32))
    m.close()


# -- kill-during-save ---------------------------------------------------------

def test_sigkill_mid_save_never_corrupts(tmp_path):
    """A hard kill at any byte of a save leaves the store restorable at
    the last fully committed step."""
    prog = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from mxnet_tpu_torch.checkpoint import CheckpointManager\n"
        "m = CheckpointManager(sys.argv[1], keep_last=10000)\n"
        "s = 0\n"
        "while True:\n"
        "    s += 1\n"
        "    state = {'step': s,\n"
        "             'w': torch.full((500_000,), float(s))}\n"
        "    m.save(s, state, sync=True)\n"
        "    print(s, flush=True)\n" % ROOT)
    child = subprocess.Popen([sys.executable, "-c", prog, str(tmp_path)],
                             stdout=subprocess.PIPE, text=True, bufsize=1)
    try:
        for line in child.stdout:
            if int(line) >= 3:
                break
        time.sleep(0.005)
        child.kill()
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    m = CheckpointManager(str(tmp_path))
    step, st = m.restore()
    assert step >= 3
    assert st["step"] == step
    np.testing.assert_array_equal(
        st["w"], np.full(500_000, step, dtype=np.float32))
    for s in m.all_steps():
        _, got = m.restore(step=s)
        assert got["step"] == s
        np.testing.assert_array_equal(
            got["w"], np.full(500_000, s, dtype=np.float32))


# -- preemption hook ----------------------------------------------------------

def test_preemption_hook_final_save(tmp_path):
    calls = {"n": 0}

    def state_fn():
        calls["n"] += 1
        return _state(7)

    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=state_fn, step_fn=lambda: 7,
                          exit=False)
    with hook:
        os.kill(os.getpid(), signal.SIGTERM)
    assert hook.preempted and hook.saved_step == 7
    assert calls["n"] == 1
    step, out = m.restore()
    assert step == 7 and out["meta"]["step"] == 7


def test_preemption_hook_flushes_pending_async(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=10)
    m.save(1, _state(1))
    hook = PreemptionHook(m, state_fn=lambda: _state(2),
                          step_fn=lambda: 2, exit=False)
    with hook:
        os.kill(os.getpid(), signal.SIGTERM)
    assert m.all_steps() == [1, 2]


def test_preemption_snapshot_race_retried(tmp_path):
    calls = {"n": 0}

    def flaky_state_fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise StepInProgressError("inside the update loop")
        return _state(9)

    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=flaky_state_fn, step_fn=lambda: 9,
                          exit=False, snapshot_retry_delay=0.05)
    with hook:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while hook.saved_step is None and time.monotonic() < deadline:
            time.sleep(0.02)
    assert calls["n"] == 2
    assert hook.saved_step == 9
    step, out = m.restore()
    assert step == 9 and out["meta"]["step"] == 9


def test_preemption_hook_exit_false_swallows_sigint(tmp_path):
    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=lambda: _state(1),
                          step_fn=lambda: 1, exit=False,
                          signals=(signal.SIGINT,))
    with hook:
        os.kill(os.getpid(), signal.SIGINT)   # must NOT raise
    assert hook.preempted and hook.saved_step == 1


def test_preemption_hook_exit_chains_to_previous(tmp_path):
    """exit=True: after the final save the previous handler runs."""
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        m = CheckpointManager(str(tmp_path))
        hook = PreemptionHook(m, state_fn=lambda: _state(4),
                              step_fn=lambda: 4, signals=(signal.SIGUSR1,))
        with hook:
            os.kill(os.getpid(), signal.SIGUSR1)
        assert seen == [signal.SIGUSR1] and hook.saved_step == 4
        assert m.restore()[0] == 4
    finally:
        signal.signal(signal.SIGUSR1, prev)


# -- telemetry ----------------------------------------------------------------

def test_profiler_counters(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _state(1), sync=True)
    counters = json.loads(mx.profiler.dumps(format="json"))["counters"]
    assert counters["checkpoint::bytes"] > 0
    assert counters["checkpoint::save_seconds"] > 0
    assert counters["checkpoint::pending"] >= 0
    assert m.pending == 0
    assert m.total_bytes > 0 and m.total_save_seconds > 0
    assert "checkpoint::bytes" in mx.profiler.dumps()
    assert 'mx_profiler_counter{name="checkpoint::bytes"}' in \
        mx.telemetry.render_prometheus()


def test_profiler_user_objects(tmp_path):
    domain = mx.profiler.Domain("ckpt_test")
    c = domain.new_counter("items", 5)
    c += 3
    c -= 1
    assert json.loads(mx.profiler.dumps(format="json"))["counters"][
        "ckpt_test::items"] == 7
    # The device trace runs now: a Task while profiling lands in the
    # dispatch table, and dump() writes the session's chrome trace.
    mx.profiler.set_config(filename=str(tmp_path / "prof"))
    mx.profiler.set_state("run")
    with domain.new_task("work"):
        pass
    domain.new_frame("frame").start()
    domain.new_marker("mark").mark()
    path = mx.profiler.dump()
    assert path == str(tmp_path / "prof.json")
    assert "traceEvents" in json.loads(open(path).read())
    assert "ckpt_test::work" in json.loads(
        mx.profiler.dumps(format="json", reset=True))["ops"]


# -- adapters: Module, Block + Trainer, TrainStep -----------------------------

def _toy_symbol():
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _toy_module(init_optimizer=True):
    from mxnet_tpu_torch.module import Module

    mod = Module(_toy_symbol(), context=mx.cpu())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(initializer=mx.init.Uniform(0.1))
    if init_optimizer:
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
    return mod


def _module_train_steps(mod, n, seed=1):
    from mxnet_tpu_torch.io import DataBatch

    rng = np.random.RandomState(seed)
    for _ in range(n):
        x = mx.nd.array(rng.rand(8, 6).astype(np.float32))
        y = mx.nd.array(rng.randint(0, 2, 8).astype(np.float32))
        mod.forward(DataBatch(data=[x], label=[y]), is_train=True)
        mod.backward()
        mod.update()


def _same_module_params(mod_a, mod_b):
    a1, x1 = mod_a.get_params()
    a2, x2 = mod_b.get_params()
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(a1[k].asnumpy(), a2[k].asnumpy())
    for k in x1:
        np.testing.assert_array_equal(x1[k].asnumpy(), x2[k].asnumpy())


def test_module_adapter_roundtrip(tmp_path):
    mod = _toy_module()
    _module_train_steps(mod, 3)
    m = CheckpointManager(str(tmp_path))
    m.save(3, state_dict(mod), sync=True)
    _, st = m.restore()
    mod2 = _toy_module()
    load_state_dict(mod2, st)
    _same_module_params(mod, mod2)
    _module_train_steps(mod, 1, seed=5)
    _module_train_steps(mod2, 1, seed=5)
    _same_module_params(mod, mod2)


def test_module_restore_before_init_optimizer(tmp_path):
    mod = _toy_module()
    _module_train_steps(mod, 3)
    m = CheckpointManager(str(tmp_path))
    m.save(3, state_dict(mod), sync=True)
    _, st = m.restore()
    mod2 = _toy_module(init_optimizer=False)
    load_state_dict(mod2, st)             # optimizer NOT initialized yet
    mod2.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5,
                                          "momentum": 0.9})
    _module_train_steps(mod, 1, seed=5)
    _module_train_steps(mod2, 1, seed=5)
    _same_module_params(mod, mod2)


def test_module_restore_before_bind(tmp_path):
    """A state restored onto an unbound Module lands at bind."""
    from mxnet_tpu_torch.module import Module

    mod = _toy_module()
    _module_train_steps(mod, 2)
    st = state_dict(mod)
    mod2 = Module(_toy_symbol(), context=mx.cpu())
    load_state_dict(mod2, st)
    mod2.bind(data_shapes=[("data", (8, 6))],
              label_shapes=[("softmax_label", (8,))])
    mod2.init_params()                    # keeps the restored values
    mod2.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5,
                                          "momentum": 0.9})
    _same_module_params(mod, mod2)
    _module_train_steps(mod, 1, seed=5)
    _module_train_steps(mod2, 1, seed=5)
    _same_module_params(mod, mod2)


def _dense_net(prefix, bf16=False, hidden=16, n_in=6, n_out=2):
    net = gluon.nn.HybridSequential(prefix=prefix)
    net.add(gluon.nn.Dense(hidden, activation="relu", in_units=n_in,
                           prefix="fc1_"))
    net.add(gluon.nn.Dense(n_out, in_units=hidden, prefix="fc2_"))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    if bf16:
        net.cast("bfloat16")
    return net


def _trainer(net, bf16=False, fused=None):
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    if bf16:
        opt["multi_precision"] = True
    return gluon.Trainer(net.collect_params(), "sgd", opt, fused=fused)


def _train(net, tr, n, seed, bf16=False, batch=8, n_in=6, classes=2):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(seed)
    for _ in range(n):
        x = mx.nd.array(rng.rand(batch, n_in).astype(np.float32))
        y = mx.nd.array(rng.randint(0, classes, batch))
        if bf16:
            x = x.astype("bfloat16")
        with autograd.record():
            out = net(x)
            if bf16:
                out = out.astype("float32")
            loss = loss_fn(out, y)
        loss.backward()
        tr.step(batch)


def _same_block(net1, net2):
    p1 = net1._collect_params_with_prefix()
    p2 = net2._collect_params_with_prefix()
    assert set(p1) == set(p2)
    for k in p1:
        a, b = p1[k].data()._data, p2[k].data()._data
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


@pytest.mark.parametrize("fused", [True, False])
def test_block_trainer_adapter_roundtrip(tmp_path, fused):
    mx.random.seed(4)
    net1 = _dense_net("ck_")
    tr1 = _trainer(net1, fused=fused)
    _train(net1, tr1, 3, seed=1)
    m = CheckpointManager(str(tmp_path))
    m.save(3, {"net": block_state(net1), "trainer": trainer_state(tr1)},
           sync=True)
    _, st = m.restore()
    mx.random.seed(11)
    net2 = _dense_net("ck2_")
    tr2 = _trainer(net2, fused=fused)
    _train(net2, tr2, 1, seed=2)          # diverge first, then restore
    load_block_state(net2, st["net"])
    load_trainer_state(tr2, st["trainer"])
    _train(net1, tr1, 1, seed=5)
    _train(net2, tr2, 1, seed=5)
    _same_block(net1, net2)


def test_restored_trainer_drops_stale_fused_chunks(tmp_path):
    """A Trainer that already stepped fused (weights and states flat)
    and then restores an older state steps from the restored values,
    exactly as a fresh Trainer restored from the same state."""
    mx.random.seed(4)
    net = _dense_net("st_")
    tr = _trainer(net)
    _train(net, tr, 2, seed=1)
    saved = {"net": block_state(net), "trainer": trainer_state(tr)}
    _train(net, tr, 3, seed=2)            # the live flat chunks move on
    assert tr._applier.num_compiles >= 1
    load_block_state(net, saved["net"])
    load_trainer_state(tr, saved["trainer"])
    mx.random.seed(5)
    fresh = _dense_net("st2_")
    tr2 = _trainer(fresh)
    load_block_state(fresh, saved["net"])
    load_trainer_state(tr2, saved["trainer"])
    _train(net, tr, 2, seed=7)
    _train(fresh, tr2, 2, seed=7)
    _same_block(net, fresh)


def test_bf16_trainer_resumes_with_bf16_weights(tmp_path):
    """A bf16 Trainer with multi_precision resumes with bfloat16 weights
    from bfloat16 bytes, bit for bit the uninterrupted run (the JAX
    package's asnumpy-based paths would widen them)."""
    mx.random.seed(3)
    ref = _dense_net("bf_", bf16=True)
    tr_ref = _trainer(ref, bf16=True)
    mx.random.seed(3)
    net = _dense_net("bf2_", bf16=True)
    tr = _trainer(net, bf16=True)
    _same_block(ref, net)
    _train(ref, tr_ref, 4, seed=1, bf16=True)
    _train(net, tr, 2, seed=1, bf16=True)
    m = CheckpointManager(str(tmp_path))
    m.save(2, {"net": state_dict(net), "trainer": state_dict(tr)},
           sync=True)
    with open(tmp_path / "step-00000002" / "manifest.json") as f:
        arrays = json.load(f)["arrays"]
    weights = [e for k, e in arrays.items() if k.startswith("net/params/")]
    assert weights and all(e["dtype"] == "bfloat16" for e in weights)
    for e in weights:
        assert e["chunks"][0]["nbytes"] == 2 * int(np.prod(e["shape"]))
    _, st = m.restore()
    mx.random.seed(9)
    net2 = _dense_net("bf3_", bf16=True)
    tr2 = _trainer(net2, bf16=True)
    load_state_dict(net2, st["net"])
    load_state_dict(tr2, st["trainer"])
    assert all(p.data()._data.dtype == torch.bfloat16
               for p in net2.collect_params().values())
    rng = np.random.RandomState(1)        # the same batches 3 and 4
    for _ in range(2):
        rng.rand(8, 6)
        rng.randint(0, 2, 8)
    _train_from(net2, tr2, rng)
    _same_block(ref, net2)


def _train_from(net, tr, rng, n=2):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(n):
        x = mx.nd.array(rng.rand(8, 6).astype(np.float32)).astype("bfloat16")
        y = mx.nd.array(rng.randint(0, 2, 8))
        with autograd.record():
            loss = loss_fn(net(x).astype("float32"), y)
        loss.backward()
        tr.step(8)


def _build_train_step(seed, lr=0.1, optimizer="sgd", extra=None):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = gluon.nn.HybridSequential(prefix="ts_")
    net.add(gluon.nn.Dense(32, activation="relu", in_units=16,
                           prefix="fc1_"))
    net.add(gluon.nn.Dense(4, in_units=32, prefix="fc2_"))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params = {"learning_rate": lr, "momentum": 0.9}
    params.update(extra or {})
    if optimizer != "sgd":
        params.pop("momentum")
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer=optimizer, optimizer_params=params,
                     mesh=make_mesh({"dp": 1}, devices=[mx.cpu()]))


def _ts_batch(s):
    rng = np.random.RandomState(1000 + s)
    return rng.rand(8, 16).astype(np.float32), rng.randint(0, 4, 8)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "sgld"])
def test_trainstep_bit_exact_resume(tmp_path, optimizer):
    """Kill/resume == uninterrupted: params, optimizer state, step
    counter and RNG position (SGLD draws noise every step) continue bit
    for bit through a checkpoint."""
    ts = _build_train_step(3, optimizer=optimizer)
    losses = [float(ts(*_ts_batch(s))) for s in range(6)]
    ts1 = _build_train_step(3, optimizer=optimizer)
    for s in range(3):
        ts1(*_ts_batch(s))
    m = CheckpointManager(str(tmp_path))
    m.save(3, ts1.state_dict(), sync=True)
    step, st = m.restore()
    ts2 = _build_train_step(99, optimizer=optimizer)   # other seed
    ts2.load_state_dict(st)
    assert ts2.num_update == 3
    tail = [float(ts2(*_ts_batch(s))) for s in range(3, 6)]
    assert tail == losses[3:]
    for n, v in ts._param_vals.items():
        assert torch.equal(v, ts2._param_vals[n]), n


def test_trainstep_state_dict_is_a_snapshot():
    ts = _build_train_step(3)
    ts(*_ts_batch(0))
    sd = ts.state_dict()
    before = {n: v.clone() for n, v in sd["params"].items()}
    ts(*_ts_batch(1))
    for n, v in sd["params"].items():
        assert torch.equal(v, before[n])
    assert sd["num_update"] == 1 and ts.num_update == 2


def test_trainstep_sharded_state_roundtrip(tmp_path):
    """state_dict(sharded=True) gives Shard leaves (one chunk, the whole
    array, on one device); the stitched restore equals the full state
    and resumes the same step."""
    ts = _build_train_step(5)
    for s in range(2):
        ts(*_ts_batch(s))
    sd = ts.state_dict(sharded=True)
    assert all(isinstance(v, Shard) for v in sd["params"].values())
    m = CheckpointManager(str(tmp_path))
    m.save(2, sd, sync=True)
    _, st = m.restore()
    full = ts.state_dict(sharded=False)
    for name in full["params"]:
        np.testing.assert_array_equal(st["params"][name],
                                      full["params"][name].numpy())
    ts2 = _build_train_step(6)
    ts2.load_state_dict(st)
    x, y = _ts_batch(2)
    assert float(ts(x, y)) == float(ts2(x, y))


def test_trainstep_params_file_resume(tmp_path):
    """save_checkpoint/load_checkpoint: the .params wire format resumes
    bit for bit, RNG position included."""
    ts = _build_train_step(3, optimizer="sgld")
    losses = [float(ts(*_ts_batch(s))) for s in range(4)]
    ts1 = _build_train_step(3, optimizer="sgld")
    for s in range(2):
        ts1(*_ts_batch(s))
    path = ts1.save_checkpoint(str(tmp_path / "ts.params"))
    ts2 = _build_train_step(8, optimizer="sgld")
    ts2.load_checkpoint(path)
    assert ts2.num_update == 2
    assert [float(ts2(*_ts_batch(s))) for s in (2, 3)] == losses[2:]


def test_trainstep_snapshot_raises_inside_update():
    ts = _build_train_step(3)
    ts(*_ts_batch(0))
    real = ts._opt_update
    seen = []

    def probe(*args):
        with pytest.raises(StepInProgressError):
            ts.state_dict()
        seen.append(1)
        return real(*args)

    ts._opt_update = probe
    ts(*_ts_batch(1))
    assert len(seen) == len(ts._param_vals)
    assert ts.state_dict()["num_update"] == 2


# -- a SIGTERM inside an update loop (port fault, repaired) -------------------

def _arrays(tree):
    """Flat {key: host numpy} of a state (bytes leaves as bytes)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            elif isinstance(v, torch.Tensor):
                t = v.detach()
                out[prefix + k] = (t.view(torch.int16) if t.dtype ==
                                   torch.bfloat16 else t).numpy().copy()
            elif isinstance(v, mx.nd.NDArray):
                out[prefix + k] = v._data.detach().numpy().copy()
            elif isinstance(v, np.ndarray):
                out[prefix + k] = v.copy()
            else:
                out[prefix + k] = v
    walk(tree, "")
    return out


def _equal_states(a, b):
    """Bit equality of two flat states; an optimizer-state pickle is
    compared by its arrays."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if k.endswith("opt_states"):
            sa, sb = pickle.loads(x), pickle.loads(y)
            if set(sa) != set(sb) or not all(
                    np.array_equal(u, w) for u, w in _state_pairs(sa, sb)):
                return False
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                return False
        elif x != y:
            return False
    return True


def _state_pairs(sa, sb):
    def flat(s):
        if isinstance(s, (list, tuple)):
            return [t for e in s for t in flat(e)]
        return [s]
    for k in sa:
        for u, w in zip(flat(sa[k]), flat(sb[k])):
            yield u, w


def _sigterm_on_call(k):
    """A counter that sends SIGTERM to this process on its k-th call."""
    calls = {"n": 0}

    def tick():
        calls["n"] += 1
        if calls["n"] == k:
            os.kill(os.getpid(), signal.SIGTERM)
    return tick


def _await_save(hook, timeout=10.0):
    deadline = time.monotonic() + timeout
    while hook.saved_step is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert hook.saved_step is not None, "the preemption save never landed"


def _committed(m, hook):
    step, st = m.restore()
    assert step == hook.saved_step
    return step, st


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sigterm_inside_trainstep_update_commits_whole_step(tmp_path, k):
    """The update loop writes one parameter at a time: a preemption
    snapshot there must wait for the step (k counts parameters)."""
    ts = _build_train_step(3)
    ts(*_ts_batch(0))
    pre = ts.state_dict()
    real = ts._opt_update
    tick = _sigterm_on_call(k)

    def update(*args):
        tick()
        return real(*args)

    ts._opt_update = update
    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=ts.state_dict,
                          step_fn=lambda: ts.num_update, exit=False,
                          snapshot_retry_delay=0.05)
    with hook:
        ts(*_ts_batch(1))
        _await_save(hook)
    post = ts.state_dict()
    step, st = _committed(m, hook)
    got = _arrays(st)
    whole = {1: _arrays(pre), 2: _arrays(post)}
    assert any(_equal_states(got, want) and step == n
               for n, want in whole.items()), \
        "the committed state mixes steps 1 and 2"


@pytest.mark.parametrize("fused", [False, True])
def test_sigterm_inside_trainer_update_commits_whole_step(tmp_path, fused,
                                                          monkeypatch):
    """gluon.Trainer: a signal between two parameters' updates (loop) or
    two chunks' applies (fused, chunks of 1 MB) commits the whole pre-
    or post-step state of net and trainer under its own step label."""
    from mxnet_tpu_torch import fused_update

    monkeypatch.setenv("MXNET_FUSED_BUCKET_MB", "1")
    mx.random.seed(2)
    net = _dense_net("sg_", hidden=512, n_in=512, n_out=512)
    tr = _trainer(net, fused=fused)
    _train(net, tr, 1, seed=1, n_in=512, classes=512)
    tick = _sigterm_on_call(2)
    if fused:
        real = fused_update._dispatch

        def dispatch(*args, **kwargs):
            out = real(*args, **kwargs)
            if args[0] == "trainer::fused_apply":
                tick()
            return out
        monkeypatch.setattr(fused_update, "_dispatch", dispatch)
    else:
        opt = tr._optimizer
        real = opt.update_multi_precision

        def update(*args):
            out = real(*args)
            tick()
            return out
        opt.update_multi_precision = update

    def state_fn():
        return {"net": block_state(net), "trainer": trainer_state(tr)}

    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=state_fn,
                          step_fn=lambda: tr._optimizer.num_update,
                          exit=False, snapshot_retry_delay=0.05)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(3)
    x = mx.nd.array(rng.rand(8, 512).astype(np.float32))
    y = mx.nd.array(rng.randint(0, 512, 8))
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    pre, pre_n = _arrays(state_fn()), tr._optimizer.num_update
    with hook:
        tr.step(8)
        _await_save(hook)
    if fused:
        assert len(tr._applier._plans) and tr._applier.num_compiles >= 1
    post, post_n = _arrays(state_fn()), tr._optimizer.num_update
    assert post_n > pre_n
    step, st = _committed(m, hook)
    got = _arrays(st)
    assert (_equal_states(got, pre) and step == pre_n) or \
        (_equal_states(got, post) and step == post_n), \
        "the committed state mixes two steps"


@pytest.mark.parametrize("fused", ["0", "1"])
def test_sigterm_inside_module_update_commits_whole_step(tmp_path, fused,
                                                         monkeypatch):
    from mxnet_tpu_torch import fused_update
    from mxnet_tpu_torch.io import DataBatch

    monkeypatch.setenv("MXNET_FUSED_UPDATE", fused)
    mod = _toy_module()
    _module_train_steps(mod, 1)
    tick = _sigterm_on_call(2)
    if fused == "1":
        # one chunk: the signal lands between the chunk's apply and the
        # end of the update
        real = fused_update._dispatch

        def dispatch(*args, **kwargs):
            out = real(*args, **kwargs)
            tick()
            tick()
            return out
        monkeypatch.setattr(fused_update, "_dispatch", dispatch)
    else:
        opt = mod._optimizer
        real = opt.update_multi_precision

        def update(*args):
            out = real(*args)
            tick()
            return out
        opt.update_multi_precision = update
    m = CheckpointManager(str(tmp_path))
    hook = PreemptionHook(m, state_fn=lambda: module_state(mod),
                          step_fn=lambda: mod._optimizer.num_update,
                          exit=False, snapshot_retry_delay=0.05)
    rng = np.random.RandomState(4)
    batch = DataBatch(data=[mx.nd.array(rng.rand(8, 6).astype(np.float32))],
                      label=[mx.nd.array(rng.randint(0, 2, 8)
                                         .astype(np.float32))])
    mod.forward(batch, is_train=True)
    mod.backward()
    pre, pre_n = _arrays(module_state(mod)), mod._optimizer.num_update
    with hook:
        mod.update()
        _await_save(hook)
    post, post_n = _arrays(module_state(mod)), mod._optimizer.num_update
    step, st = _committed(m, hook)
    got = _arrays(st)
    assert (_equal_states(got, pre) and step == pre_n) or \
        (_equal_states(got, post) and step == post_n), \
        "the committed state mixes two steps"


# -- callbacks ----------------------------------------------------------------

def test_do_checkpoint_manager_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sym = mx.sym.Variable("data") * 2
    arg = {"w": mx.nd.array([1.0, 2.0])}
    m = CheckpointManager(str(tmp_path / "ck"), keep_last=10)
    cb = mx.callback.do_checkpoint("unused-prefix", period=2, manager=m)
    for epoch in range(4):
        cb(epoch, sym, arg, {})
    m.wait()
    assert m.all_steps() == [2, 4]
    _, st = m.restore()
    assert "data" in st["symbol"]
    np.testing.assert_array_equal(st["arg"]["w"], [1.0, 2.0])
    assert not [f for f in os.listdir(".") if f.startswith("unused-prefix")]


def test_module_checkpoint_manager_path(tmp_path):
    mod = _toy_module()
    _module_train_steps(mod, 2)
    m = CheckpointManager(str(tmp_path), keep_last=10)
    cb = mx.callback.module_checkpoint(mod, "unused", period=1,
                                       save_optimizer_states=True,
                                       manager=m)
    cb(0)
    m.wait()
    step, st = m.restore()
    assert step == 1
    assert "opt_states" in st
    mod2 = _toy_module()
    load_state_dict(mod2, st)
    _same_module_params(mod, mod2)


def test_module_checkpoint_file_path(tmp_path):
    mod = _toy_module()
    _module_train_steps(mod, 2)
    prefix = str(tmp_path / "mc")
    cb = mx.callback.module_checkpoint(mod, prefix, period=1,
                                       save_optimizer_states=True)
    cb(0)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0001.params")
    assert os.path.exists(prefix + "-0001.states")


# -- across packages ----------------------------------------------------------

def _jax_ckpt():
    from mxnet_tpu import checkpoint as jck

    return jck


def _mixed_state():
    rng = np.random.RandomState(0)
    return {"a": {"f32": rng.rand(3, 4).astype(np.float32),
                  "i32": rng.randint(-5, 5, (5,)).astype(np.int32)},
            "meta": {"b": b"\x01\x02", "s": "hi", "i": 7, "f": 0.25,
                     "ok": False}}


def test_jax_directory_restores_in_port(tmp_path):
    st = _mixed_state()
    _jax_ckpt().CheckpointManager(str(tmp_path)).save(5, st, sync=True)
    step, out = CheckpointManager(str(tmp_path)).restore()
    assert step == 5
    for k in ("f32", "i32"):
        np.testing.assert_array_equal(out["a"][k], st["a"][k])
        assert out["a"][k].dtype == st["a"][k].dtype
    assert out["meta"] == st["meta"]


def test_port_directory_restores_in_jax(tmp_path):
    import ml_dtypes

    st = _mixed_state()
    bf = torch.randn(6, generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16)
    port = {"a": {"f32": torch.from_numpy(st["a"]["f32"]),
                  "i32": mx.nd.NDArray(torch.from_numpy(st["a"]["i32"])),
                  "bf": bf},
            "meta": st["meta"]}
    CheckpointManager(str(tmp_path)).save(5, port, sync=True)
    step, out = _jax_ckpt().CheckpointManager(str(tmp_path)).restore()
    assert step == 5
    for k in ("f32", "i32"):
        np.testing.assert_array_equal(out["a"][k], st["a"][k])
    assert out["a"]["bf"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(out["a"]["bf"].view(np.uint16),
                                  bf.view(torch.int16).numpy()
                                  .view(np.uint16))
    assert out["meta"] == st["meta"]


@pytest.mark.parametrize("sharded", [False, True])
def test_same_state_same_bytes(tmp_path, sharded):
    """For the same state both packages write the same manifest and shard
    bytes (sort_keys JSON, one format string, the same CRCs)."""
    st = _mixed_state()
    dirs = {}
    for tag, pkg in (("jax", _jax_ckpt()),
                     ("port", __import__("mxnet_tpu_torch.checkpoint",
                                         fromlist=["x"]))):
        state = dict(st)
        if sharded:
            w = st["a"]["f32"]
            state = {"w": pkg.Shard(w.shape, w.dtype,
                                    [(((0, 3), (0, 4)), w)]),
                     "meta": st["meta"]}
        d = tmp_path / tag
        pkg.CheckpointManager(str(d)).save(5, state, sync=True)
        dirs[tag] = d / "step-00000005"
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    for n in names:
        assert (dirs["jax"] / n).read_bytes() == \
            (dirs["port"] / n).read_bytes(), n


def _jax_train_step(seed):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu.parallel import TrainStep as JTrainStep
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    import jax

    jmx.random.seed(seed)
    net = jgluon.nn.HybridSequential(prefix="ts_")
    net.add(jgluon.nn.Dense(32, activation="relu", in_units=16,
                            prefix="fc1_"))
    net.add(jgluon.nn.Dense(4, in_units=32, prefix="fc2_"))
    net.initialize(jmx.init.Xavier())
    return JTrainStep(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                      optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1,
                                        "momentum": 0.9},
                      mesh=jmake_mesh({"dp": 1},
                                      devices=[jax.devices()[0]]))


def test_jax_trainstep_state_restores_in_port(tmp_path, caplog):
    """A JAX TrainStep's committed state restores the port's TrainStep:
    params, momentum and step counter equal; its RNG entry (a threefry
    counter) is ignored with a warning."""
    jts = _jax_train_step(3)
    for s in range(2):
        jts(*_ts_batch(s))
    _jax_ckpt().CheckpointManager(str(tmp_path)).save(
        2, jts.state_dict(), sync=True)
    _, st = CheckpointManager(str(tmp_path)).restore()
    ts = _build_train_step(8)
    ts(*_ts_batch(0))
    with caplog.at_level("WARNING"):
        ts.load_state_dict(st)
    assert "RNG entry" in caplog.text
    assert ts.num_update == 2
    jsd = jts.state_dict()
    for n, v in ts._param_vals.items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      np.asarray(jsd["params"][n]))
        np.testing.assert_array_equal(ts._opt_state[n][0].numpy(),
                                      np.asarray(jsd["opt"][n]["0"]))


def test_port_trainstep_state_restores_in_jax(tmp_path):
    ts = _build_train_step(3)
    for s in range(2):
        ts(*_ts_batch(s))
    CheckpointManager(str(tmp_path)).save(2, ts.state_dict(), sync=True)
    _, st = _jax_ckpt().CheckpointManager(str(tmp_path)).restore()
    jts = _jax_train_step(8)
    jts(*_ts_batch(0))
    jts.load_state_dict(st)
    assert jts.num_update == 2
    jsd = jts.state_dict()
    for n, v in ts._param_vals.items():
        np.testing.assert_array_equal(np.asarray(jsd["params"][n]),
                                      v.detach().numpy())


def test_trainstep_params_file_entries_match_jax(tmp_path):
    """save_checkpoint: every entry the JAX package's file holds is in
    the port's file with the same values and dtype (same weights, same
    step; the step counter is int64 in the port, int32 in the JAX
    package); the port adds its generator states. Each package loads the
    other's file."""
    from mxnet_tpu.ndarray import utils as jutils

    jts = _jax_train_step(3)
    for s in range(2):
        jts(*_ts_batch(s))
    jpath = jts.save_checkpoint(str(tmp_path / "jax.params"))
    ts = _build_train_step(8)
    ts(*_ts_batch(0))
    ts.load_checkpoint(jpath)               # RNG entry ignored
    assert ts.num_update == 2
    ppath = ts.save_checkpoint(str(tmp_path / "port.params"))
    jblob = {k: np.asarray(v.asnumpy()) for k, v in
             jutils.load(jpath).items()}
    pblob = {k: v.asnumpy() for k, v in
             mx.nd.load(ppath, ctx=mx.cpu()).items()}
    extra = set(pblob) - set(jblob)
    assert extra and all(k.startswith("step:rng_state:") for k in extra)
    for k in jblob:
        if k == "step:rng":
            continue                       # each package's own position
        np.testing.assert_array_equal(pblob[k], jblob[k])
        if jblob[k].dtype == np.int32 and k.startswith("step:"):
            # The JAX package narrows its int64 counter to int32 (x64
            # off, ROADMAP Queue 3); the port keeps int64.
            assert pblob[k].dtype == np.int64, k
        else:
            assert pblob[k].dtype == jblob[k].dtype, k
    jts2 = _jax_train_step(9)
    jts2(*_ts_batch(0))
    jts2.load_checkpoint(ppath)
    assert jts2.num_update == 2


# -- gluon save_parameters across packages ------------------------------------

def _pair_nets():
    import mxnet_tpu as jmx

    rng = np.random.RandomState(0)
    nets = []
    for pkg in (jmx, mx):
        net = pkg.gluon.nn.HybridSequential(prefix="sp_")
        net.add(pkg.gluon.nn.Dense(8, in_units=5, prefix="a_"))
        net.add(pkg.gluon.nn.BatchNorm(in_channels=8, prefix="bn_"))
        net.add(pkg.gluon.nn.Dense(3, in_units=8, prefix="b_"))
        if pkg is mx:
            net.initialize(ctx=mx.cpu())
        else:
            net.initialize()
        nets.append(net)
    values = {k: rng.randn(*p.shape).astype(np.float32)
              for k, p in nets[1]._collect_params_with_prefix().items()}
    for net in nets:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(net_array(net, values[k]))
    return nets, values


def net_array(net, value):
    import mxnet_tpu as jmx

    pkg = mx if type(net).__module__.startswith("mxnet_tpu_torch") else jmx
    return pkg.nd.array(value)


def test_save_parameters_byte_identical(tmp_path):
    (jnet, net), _ = _pair_nets()
    jnet.save_parameters(str(tmp_path / "jax.params"))
    net.save_parameters(str(tmp_path / "port.params"))
    assert (tmp_path / "jax.params").read_bytes() == \
        (tmp_path / "port.params").read_bytes()
    net.save_params(str(tmp_path / "legacy.params"))
    assert (tmp_path / "legacy.params").read_bytes() == \
        (tmp_path / "port.params").read_bytes()


def test_load_parameters_of_jax_file(tmp_path):
    (jnet, net), values = _pair_nets()
    jnet.save_parameters(str(tmp_path / "jax.params"))
    mx.random.seed(1)
    fresh = _pair_nets()[0][1]
    for p in fresh.collect_params().values():
        p.set_data(mx.nd.zeros(p.shape))
    fresh.load_parameters(str(tmp_path / "jax.params"))
    for k, p in fresh._collect_params_with_prefix().items():
        np.testing.assert_array_equal(p.data().asnumpy(), values[k])
    fresh.load_params(str(tmp_path / "jax.params"))


def test_load_parameters_missing_extra_and_cast(tmp_path):
    (_, net), values = _pair_nets()
    path = str(tmp_path / "p.params")
    net.save_parameters(path)
    small = gluon.nn.HybridSequential(prefix="sm_")
    small.add(gluon.nn.Dense(8, in_units=5, prefix="a_"))
    small.initialize(ctx=mx.cpu())
    with pytest.raises(ValueError, match="Extra parameters"):
        small.load_parameters(path)
    small.load_parameters(path, ignore_extra=True)
    np.testing.assert_array_equal(
        small._collect_params_with_prefix()["0.weight"].data().asnumpy(),
        values["0.weight"])
    big = gluon.nn.HybridSequential(prefix="bg_")
    for _ in range(4):
        big.add(gluon.nn.Dense(8, in_units=8))
    big.initialize(ctx=mx.cpu())
    with pytest.raises(ValueError, match="missing"):
        big.load_parameters(path, ignore_extra=True)
    bf = gluon.nn.HybridSequential(prefix="cbf_")
    bf.add(gluon.nn.Dense(8, in_units=5, prefix="a_"))
    bf.initialize(ctx=mx.cpu())
    bf.cast("bfloat16")
    bf.load_parameters(path, ignore_extra=True, cast_dtype=True)
    w = bf._collect_params_with_prefix()["0.weight"].data()._data
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, torch.from_numpy(values["0.weight"])
                       .to(torch.bfloat16))
