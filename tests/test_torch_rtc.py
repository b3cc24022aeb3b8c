"""mxnet_tpu_torch.rtc (CudaModule over NVRTC) and its kernels.

On the host: the signature parser over every type of the reference,
the checks a launch makes before it reaches the driver, the error when
NVRTC is missing (no fallback), the Pallas stubs, and the plain versions
of the rtc kernels against the JAX package (scale_add against its Pallas
fixture in interpret mode, exactly; fused BatchNorm+ReLU against the JAX
BatchNorm op in eval mode and relu, fp32 within rtol 1e-6 / atol 1e-6).

On the card (marker ``cuda``, skipped elsewhere): axpy and scale_add
compile and launch, also from a worker thread; a template kernel through
``exports``; a dtype mismatch and a compile error raise, the latter with
NVRTC's log; the fused kernels (BatchNorm+ReLU, and the variant that
also writes the BatchNorm output) match their plain versions.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _nvrtc, rtc
from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

torch.set_num_threads(2)


@pytest.mark.parametrize("ctype,dtype", [
    ("float", "float32"), ("double", "float64"), ("__half", "float16"),
    ("uint8_t", "uint8"), ("int", "int32"), ("int32_t", "int32"),
    ("int8_t", "int8"), ("char", "int8"), ("int64_t", "int64")])
def test_signature_parser_covers_the_reference_types(ctype, dtype):
    sig = "const %s *a, %s* b, %s c,%s   *  d" % ((ctype,) * 4)
    assert rtc.parse_signature(sig) == [(dtype, True, True),
                                        (dtype, True, False),
                                        (dtype, False, False),
                                        (dtype, True, False)]


def test_signature_parser_rejects_bad_prototypes():
    with pytest.raises(ValueError, match="prototype"):
        rtc.parse_signature("const *x")
    with pytest.raises(TypeError, match="Unsupported"):
        rtc.parse_signature("float *x, bool flag")
    with pytest.raises(ValueError, match="prototype"):
        rtc.parse_signature("float **x")


def _fake_module(monkeypatch, signature):
    """A CudaModule whose compile is stubbed and whose driver calls
    fail the test: what a launch checks before it reaches the driver."""
    prog = _nvrtc._Program(("k",), b"", {}, "")
    monkeypatch.setattr(_nvrtc, "compile_program", lambda *a: prog)

    def no_driver(*a, **k):
        raise AssertionError("reached the driver")

    monkeypatch.setattr(_nvrtc, "load_function", no_driver)
    monkeypatch.setattr(_nvrtc, "launch", no_driver)
    return rtc.CudaModule("unused").get_kernel("k", signature)


def test_launch_on_host_arrays_raises(monkeypatch):
    k = _fake_module(monkeypatch, "const float *x, float *y, float a")
    with mx.cpu():
        x, y = mx.nd.ones((4,)), mx.nd.zeros((4,))
    with pytest.raises(ValueError, match="GPU context"):
        k.launch([x, y, 1.0], mx.cpu(), (1,), (4,))
    # A GPU context over host arrays: no card here (RuntimeError from the
    # context) or a device mismatch on a machine with one (ValueError).
    with pytest.raises((RuntimeError, ValueError)):
        k.launch([x, y, 1.0], mx.gpu(0), (1,), (4,))
    with pytest.raises(ValueError, match="takes 3 arguments"):
        k.launch([x, y], mx.gpu(0), (1,), (4,))
    assert x.version == y.version == 0


def test_cuda_module_without_nvrtc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "search_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(_nvrtc, "_libs", {})
    monkeypatch.setattr(_nvrtc, "_programs", {})
    with pytest.raises(_nvrtc.CudaError, match="libnvrtc.so not found") as e:
        rtc.CudaModule('extern "C" __global__ void k() {}')
    assert str(tmp_path) in str(e.value)


def test_pallas_module_raises():
    with pytest.raises(NotImplementedError, match="CudaModule"):
        rtc.PallasModule(scale_add=lambda x_ref, o_ref: None)
    with pytest.raises(NotImplementedError, match="CudaModule"):
        rtc.PallasKernel(lambda x_ref, o_ref: None)


def test_scale_add_plain_matches_pallas_fixture():
    def scale_add(x_ref, y_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0 + y_ref[:]

    a = np.arange(8, dtype=np.float32).reshape(1, 8)
    b = np.ones((1, 8), np.float32)
    k = jmx.rtc.PallasModule(scale_add=scale_add).get_kernel("scale_add")
    want = k.launch([jmx.nd.array(a), jmx.nd.array(b)]).asnumpy()
    before = dict(rtc_kernels.LAUNCHES)
    got = rtc_kernels.scale_add(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rtc_kernels.relu(torch.from_numpy(a - 3)).numpy(),
        np.maximum(a - 3, 0))
    assert rtc_kernels.LAUNCHES == before  # the host ran the plain versions


@pytest.mark.parametrize("fix_gamma,axis", [(False, 1), (True, 1),
                                            (False, -1)])
def test_bn_relu_plain_matches_jax_batchnorm_relu(fix_gamma, axis):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    c = x.shape[axis]
    gamma, beta, mean = (rng.uniform(-1, 1, c).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    out = jmx.nd.BatchNorm(*[jmx.nd.array(a) for a in
                             (x, gamma, beta, mean, var)],
                           eps=1e-5, fix_gamma=fix_gamma, axis=axis,
                           training=False)
    want = np.maximum(out[0].asnumpy(), 0)
    before = fused_bn_relu.LAUNCHES
    got = fused_bn_relu.bn_relu(*[torch.from_numpy(a) for a in
                                  (x, gamma, beta, mean, var)],
                                eps=1e-5, fix_gamma=fix_gamma, axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert fused_bn_relu.LAUNCHES == before


def test_bn_and_relu_plain_matches_jax_batchnorm():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    gamma, beta, mean = (rng.uniform(-1, 1, 3).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    out = jmx.nd.BatchNorm(*[jmx.nd.array(a) for a in
                             (x, gamma, beta, mean, var)],
                           eps=1e-5, fix_gamma=False, training=False)
    want = out[0].asnumpy()
    z, y = fused_bn_relu.bn_and_relu(*[torch.from_numpy(a) for a in
                                       (x, gamma, beta, mean, var)],
                                     eps=1e-5, fix_gamma=False)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.maximum(want, 0), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fn", [fused_bn_relu.bn_relu,
                                fused_bn_relu.bn_and_relu])
def test_bn_relu_checks_channel_vectors_before_launching(monkeypatch, fn):
    """The kernel reads gamma/beta/mean/var at every channel of x, so a
    vector of another length raises before a launch (the launch is faked:
    `meta` tensors take the device path)."""
    launched = []
    monkeypatch.setattr(fused_bn_relu, "_get_kernel", lambda name: name)
    monkeypatch.setattr(fused_bn_relu, "launch_1d",
                        lambda k, tensors, scalars, n:
                        launched.append((k, len(tensors), scalars, n)))
    x = torch.empty(2, 6, 4, 5, device="meta")
    ok = torch.empty(6, device="meta")
    for bad in (torch.empty(5, device="meta"), torch.empty(6, 1,
                                                           device="meta")):
        for k in range(4):
            vectors = [ok] * 4
            vectors[k] = bad
            with pytest.raises(ValueError, match="not \\(6,\\)"):
                fn(x, *vectors, 1e-5, False, 1)
    with pytest.raises(ValueError, match="not \\(6,\\)"):  # host too
        fn(torch.zeros(2, 6, 3), *[torch.zeros(4)] * 4)
    assert launched == []
    fn(x, ok, ok, ok, ok, 1e-5, True, 1)
    if fn is fused_bn_relu.bn_relu:
        want = ("bn_relu_forward", 6)
    else:
        want = ("bn_relu_forward_both", 7)
    assert launched == [want + ([240, 6, 20, 1e-5, 1], 240)]


def test_scale_add_needs_one_shape():
    with pytest.raises(ValueError, match="differ in shape"):
        rtc_kernels.scale_add(torch.zeros(2, 8), torch.zeros(1, 8))


# -- on the card ----------------------------------------------------------------

AXPY = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
'''


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_axpy_and_scale_add_on_card():
    _card()
    mod = rtc.CudaModule(AXPY)
    func = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    before = rtc.LAUNCHES
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), np.full(10, 3.0, np.float32))
    assert rtc.LAUNCHES == before + 1
    assert y.version == 1 and x.version == 0  # only the written array

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(1000, 37, generator=gen, device="cuda")
            for _ in range(2))
    n0 = rtc_kernels.LAUNCHES["scale_add"]
    got = rtc_kernels.scale_add(a, b)
    torch.testing.assert_close(got, rtc_kernels.scale_add_reference(a, b),
                               rtol=0, atol=0)
    assert rtc_kernels.LAUNCHES["scale_add"] == n0 + 1


@pytest.mark.cuda
def test_launch_from_a_worker_thread():
    _card()
    mod = rtc.CudaModule(AXPY)
    func = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((64,), ctx=mx.gpu(0))
    y = mx.nd.zeros((64,), ctx=mx.gpu(0))
    errors = []

    def work():
        try:
            func.launch([x, y, 2.0], mx.gpu(0), (2,), (32,))
            rtc_kernels.relu(torch.full((5,), -1.0, device="cuda"))
            torch.cuda.synchronize()
        except Exception as e:  # reported on the main thread
            errors.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(y.asnumpy(), np.full(64, 2.0, np.float32))


@pytest.mark.cuda
def test_template_kernel_through_exports():
    _card()
    src = r'''
    template <typename T>
    __global__ void axpy(const T *x, T *y, T alpha, int n) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        if (i < n) y[i] += alpha * x[i];
    }
    '''
    mod = rtc.CudaModule(src, exports=("axpy<float>", "axpy<double>"))
    x = mx.nd.array(np.arange(5, dtype=np.float64), ctx=mx.gpu(0),
                    dtype="float64")
    y = mx.nd.ones((5,), ctx=mx.gpu(0), dtype="float64")
    mod.get_kernel("axpy<double>",
                   "const double *x, double *y, double alpha, int n"
                   ).launch([x, y, 0.5, 5], mx.gpu(0), (1,), (8,))
    np.testing.assert_array_equal(y.asnumpy(), 1 + 0.5 * np.arange(5))


@pytest.mark.cuda
def test_half_kernel_with_cuda_fp16_header():
    _card()
    src = r'''
    #include <cuda_fp16.h>
    extern "C" __global__ void scale(const __half *x, __half *y, __half a,
                                     int n) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        if (i < n) y[i] = __hmul(x[i], a);
    }
    '''
    k = rtc.CudaModule(src).get_kernel(
        "scale", "const __half *x, __half *y, __half a, int n")
    x = mx.nd.array(np.arange(6, dtype=np.float16), ctx=mx.gpu(0),
                    dtype="float16")
    y = mx.nd.zeros((6,), ctx=mx.gpu(0), dtype="float16")
    k.launch([x, y, 1.5, 6], mx.gpu(0), (1,), (32,))
    np.testing.assert_array_equal(y.asnumpy(),
                                  np.arange(6, dtype=np.float16) * 1.5)


@pytest.mark.cuda
def test_dtype_mismatch_and_compile_error_raise():
    _card()
    func = rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((4,), ctx=mx.gpu(0), dtype="float64")
    y = mx.nd.zeros((4,), ctx=mx.gpu(0))
    with pytest.raises(TypeError, match="float32"):
        func.launch([x, y, 1.0], mx.gpu(0), (1,), (4,))
    with pytest.raises(_nvrtc.CudaError, match="undefined_thing"):
        rtc.CudaModule('extern "C" __global__ void bad(float *y) '
                       '{ y[0] = undefined_thing; }')


@pytest.mark.cuda
@pytest.mark.parametrize("fix_gamma,axis", [(False, 1), (True, 1),
                                            (False, 3)])
def test_fused_kernels_match_plain_on_card(fix_gamma, axis):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 16, 9, 7, generator=gen, device="cuda")
    c = x.shape[axis]
    gamma, beta, mean = (torch.rand(c, generator=gen, device="cuda") - 0.5
                         for _ in range(3))
    var = torch.rand(c, generator=gen, device="cuda") + 0.5
    n0 = fused_bn_relu.LAUNCHES
    got = fused_bn_relu.bn_relu(x, gamma, beta, mean, var, 1e-5, fix_gamma,
                                axis)
    torch.cuda.synchronize()
    assert fused_bn_relu.LAUNCHES == n0 + 1
    want = fused_bn_relu.bn_relu_reference(x, gamma, beta, mean, var, 1e-5,
                                           fix_gamma, axis)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    z, y = fused_bn_relu.bn_and_relu(x, gamma, beta, mean, var, 1e-5,
                                     fix_gamma, axis)
    torch.cuda.synchronize()
    assert fused_bn_relu.LAUNCHES == n0 + 2
    want_z, want_y = fused_bn_relu.bn_and_relu_reference(
        x, gamma, beta, mean, var, 1e-5, fix_gamma, axis)
    torch.testing.assert_close(y, want_y, rtol=1e-5,
                               atol=1e-6 * float(want_y.abs().max()))
    torch.testing.assert_close(z, want_z, rtol=1e-5,
                               atol=1e-6 * float(want_z.abs().max()))
    r0 = rtc_kernels.LAUNCHES["relu"]
    torch.testing.assert_close(rtc_kernels.relu(x), torch.relu(x), rtol=0,
                               atol=0)
    assert rtc_kernels.LAUNCHES["relu"] == r0 + 1
