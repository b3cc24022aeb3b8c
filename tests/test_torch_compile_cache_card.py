"""The compile cache with the real nvcc and NVRTC on a card (``cuda``-
marked; they skip on a host without one). No JAX here.

- The detection library built by nvcc into an empty ``_native.BUILD``
  with the cache on, then served into another empty ``BUILD`` from the
  store with no nvcc run: the same bytes and the same ptxas report, and
  D1 from the served library equal to its plain version.
- An rtc program compiled by NVRTC, then loaded from the store by a
  fresh per-process dict with no NVRTC compile: the same cubin, and its
  kernel's launch equal to its plain version.
"""
import os

import pytest
import torch

from mxnet_tpu_torch import _native, _nvrtc, rtc
from mxnet_tpu_torch import compile as cc
from mxnet_tpu_torch.examples import rtc_kernels
from mxnet_tpu_torch.ops import detection_ops as det

torch.set_num_threads(2)


@pytest.fixture
def card_cache(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cc.reset()
    cc.configure(str(tmp_path / "store"))
    yield tmp_path
    cc.reset()


def _boxes(b=4, n=300, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.rand((b, n, 2), generator=gen, device="cuda") * 200
    size = torch.rand((b, n, 2), generator=gen, device="cuda") * 60 + 4
    return torch.cat([lo, lo + size], dim=2)


@pytest.mark.cuda
def test_nvcc_library_served_from_the_store(card_cache, monkeypatch):
    monkeypatch.setattr(_native, "BUILD", str(card_cache / "cold"))
    monkeypatch.setattr(_native, "_libs", {})
    runs0 = _native.STATS["nvcc_runs"]
    cold = _native.build(["detection"])["detection"]
    log = _native.build_log("detection")
    assert _native.STATS["nvcc_runs"] == runs0 + 1 and "registers" in log
    monkeypatch.setattr(_native, "BUILD", str(card_cache / "warm"))
    monkeypatch.setattr(_native, "_libs", {})
    hits0 = _native.STATS["cache_hits"]
    warm = _native.build(["detection"])["detection"]
    assert _native.STATS["nvcc_runs"] == runs0 + 1
    assert _native.STATS["cache_hits"] == hits0 + 1
    assert os.path.basename(warm) == os.path.basename(cold)
    with open(cold, "rb") as f, open(warm, "rb") as g:
        assert f.read() == g.read()
    assert _native.build_log("detection") == log
    boxes = _boxes()
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device="cuda")
    launches = det.NMS_LAUNCHES
    got = det.nms_sorted(boxes, valid, None, 0.45)
    want = det.nms_sorted_reference(boxes, valid, None, 0.45,
                                    det.IOU_CORNER, boxes.shape[1])
    assert det.NMS_LAUNCHES == launches + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_nvrtc_program_served_from_the_store(card_cache, monkeypatch):
    monkeypatch.setattr(_nvrtc, "_programs", {})
    src = os.path.join(os.path.dirname(rtc.__file__), "csrc", "rtc",
                       "elementwise.cu")
    with open(src) as f:
        source = f.read()
    compiles0 = _nvrtc.STATS["compiles"]
    cold = rtc.CudaModule(source)
    assert _nvrtc.STATS["compiles"] == compiles0 + 1
    monkeypatch.setattr(_nvrtc, "_programs", {})
    hits0 = _nvrtc.STATS["store_hits"]
    warm = rtc.CudaModule(source)
    assert _nvrtc.STATS["compiles"] == compiles0 + 1
    assert _nvrtc.STATS["store_hits"] == hits0 + 1
    assert warm._program.cubin == cold._program.cubin
    assert warm._program.lowered == cold._program.lowered
    x = torch.randn(4096, device="cuda")
    y = torch.empty_like(x)
    relu = warm.get_kernel("relu", "const float *x, float *y, int64_t n")
    rtc_kernels.launch_elementwise(relu, (x, y), x.numel())
    torch.cuda.synchronize()
    assert torch.equal(y, torch.relu(x))
