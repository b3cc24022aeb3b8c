"""The port's telemetry on the card (``cuda``-marked; they skip on a host
without one). No JAX here: the references are PyTorch's own readings.

- memstats' in-use and peak figures are ``torch.cuda.memory_allocated``
  and ``max_memory_allocated``, its limit the card's memory, and
  ``reset_peak`` resets the allocator's peak;
- the device trace (``profiler.set_state('run')`` ... ``dump()``) holds
  the kernels a matrix product launched, and a health-plane capture
  taken on another thread holds the kernels this thread launches;
- the numeric guard halts a Trainer on the card at a NaN gradient.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.telemetry as tel
from mxnet_tpu_torch.telemetry import healthplane as hp
from mxnet_tpu_torch.telemetry import memstats as ms

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _kernels(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


@pytest.mark.cuda
def test_memstats_reads_the_cuda_allocator():
    _card()
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    torch.empty(256 << 20, dtype=torch.uint8, device="cuda")   # freed
    sample = ms.sample_device_memory()["cuda:0"]
    assert sample["bytes"] == torch.cuda.memory_allocated(0)
    assert sample["peak_bytes"] == torch.cuda.max_memory_allocated(0)
    assert sample["peak_bytes"] >= sample["bytes"] + (256 << 20)
    assert sample["limit_bytes"] == \
        torch.cuda.get_device_properties(0).total_memory
    ms.reset_peak()
    after = ms.sample_device_memory()["cuda:0"]
    assert after["peak_bytes"] == torch.cuda.max_memory_allocated(0) \
        == torch.cuda.memory_allocated(0)
    assert keep.numel() == 64 << 20


@pytest.mark.cuda
def test_device_trace_names_the_launched_kernels(tmp_path):
    _card()
    a = torch.randn(1024, 1024, device="cuda")
    mx.profiler.set_config(filename=str(tmp_path / "card"))
    mx.profiler.set_state("run")
    (a @ a).sum().item()
    path = mx.profiler.dump()
    kernels = _kernels(path)
    assert kernels, "no kernel events in %s" % path
    assert any("gemm" in k["name"].lower() or "sgemm" in k["name"].lower()
               or "cutlass" in k["name"].lower() for k in kernels), \
        sorted({k["name"] for k in kernels})


@pytest.mark.cuda
def test_xprof_on_another_thread_holds_this_threads_kernels(tmp_path):
    _card()
    plane = hp.HealthPlane(xprof_dir=str(tmp_path))
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    result = []
    t = threading.Thread(target=lambda: result.append(
        plane.handle("POST", "/debug/xprof?seconds=0.5")))
    t.start()
    while t.is_alive():
        (a @ a).sum()
    t.join(timeout=60)
    status, body = result[0]
    assert status == 200, body
    kernels = _kernels(os.path.join(body["dir"], hp.XPROF_TRACE))
    assert kernels


@pytest.mark.cuda
def test_numeric_guard_halts_a_trainer_on_the_card():
    _card()
    ctx = mx.gpu(0)
    with ctx:
        net = mx.gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam")
    guard = tel.NumericGuard(halt=True)
    guard.install(trainer._applier)
    x = mx.nd.array(np.random.RandomState(0).rand(4, 8), ctx=ctx)
    for step in (1, 2):
        guard.observe_batch(step=step)
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        if step == 2:
            g = net.weight.grad().asnumpy()
            g[1, 2] = np.inf
            net.weight.grad()[:] = mx.nd.array(g, ctx=ctx)
            with pytest.raises(tel.NonFiniteError, match="at step 2"):
                trainer.step(4)
        else:
            trainer.step(4)
    assert [v[:2] for v in guard.violations] == [("grad", 2)]
