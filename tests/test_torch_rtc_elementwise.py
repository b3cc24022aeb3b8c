"""The rtc elementwise kernels (csrc/rtc/elementwise.cu) and the launch
path they share (rtc.CudaKernel, csrc/rtc_launch.cu).

On the host: ``launch_plan`` (the head/vector/tail split and the grid)
over odd sizes and offsets, and a Python model of the kernels' loops
that every element is written exactly once for any grid and block; the
plain versions against the JAX package on the same numpy inputs, NaN,
±inf and ±0 included, exactly (scale_add against its Pallas fixture in
interpret mode, relu against ``nd.relu``); every check of
``launch_tensors`` raising on host tensors before the driver; the launch
buffer's layout against the C ABI (a ctypes Structure).

On the card (marker ``cuda``, skipped elsewhere): both kernels bit for
bit against their plain versions (NaN, ±inf, ±0, overflowing 2x and
denormals among the inputs) at 32x4096 and 4096x4096, on views at
element offsets 1-3, at n 0, 1, 3, 5 and 1023, and launched through
``CudaKernel.launch`` with caller-chosen grids and blocks.
"""
import ctypes
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _nvrtc, rtc
from mxnet_tpu_torch.examples import rtc_kernels
from mxnet_tpu_torch.ndarray.ndarray import NDArray

torch.set_num_threads(2)

SIZES = (0, 1, 3, 4, 5, 1023, 2 ** 31 + 3)


def _check_plan(n, offset):
    head, vectors, tail, blocks = rtc_kernels.launch_plan(n, offset)
    assert head + 4 * vectors + tail == n
    assert min(head, vectors, tail) >= 0
    if offset is None:
        assert (head, vectors, tail) == (n, 0, 0)
    else:
        assert head <= 3 and tail <= 3
        assert head == min(n, (4 - offset) % 4)
        if vectors:
            assert (offset + head) % 4 == 0  # vectors start on 16 bytes
    # One float4 (or SCALARS scalars) a thread covers the work, with no
    # block past it.
    units = max(vectors, -(-(head + tail) // rtc_kernels.SCALARS), 1)
    assert blocks == -(-units // 256) >= 1


@pytest.mark.parametrize("offset", [0, 1, 2, 3, None])
@pytest.mark.parametrize("n", SIZES)
def test_launch_plan_splits_every_element(n, offset):
    _check_plan(n, offset)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, 2 ** 40), offset=st.sampled_from([0, 1, 2, 3, None]))
def test_launch_plan_any_size(n, offset):
    _check_plan(n, offset)


def _kernel_writes(n, mis, grid, block):
    """The element indices the kernels of elementwise.cu write, in the
    order of their loops, for pointers at byte offsets `mis` (mod 16;
    output last) and a launch of `grid` x `block` threads: a model of the
    device code in Python."""
    vec = rtc_kernels.VECTORS
    out = mis[-1]
    if out % 4 == 0 and all(m == out for m in mis):
        head = min(n, ((16 - out) % 16) // 4)
    else:
        head = n
    vectors = (n - head) // 4
    tail = head + 4 * vectors
    stride = grid * block
    scalars = head + n - tail
    written = []
    for tid in range(stride):
        i = tid
        while i + (vec - 1) * stride < vectors:  # whole trips
            for k in range(vec):
                written.extend(head + 4 * (i + k * stride) + e
                               for e in range(4))
            i += vec * stride
        while i < vectors:
            written.extend(head + 4 * i + e for e in range(4))
            i += stride
        s = tid
        while s + 3 * stride < scalars:
            written.extend(t if t < head else tail + t - head
                           for t in range(s, s + 4 * stride, stride))
            s += 4 * stride
        while s < scalars:
            written.append(s if s < head else tail + s - head)
            s += stride
    return head, vectors, written


@pytest.mark.parametrize("grid,block", [(1, 1), (1, 32), (7, 96), (3, 5)])
@pytest.mark.parametrize("mis", [(0, 0), (4, 4), (8, 8), (12, 12), (4, 0),
                                 (0, 8, 0), (12, 12, 12), (12, 4, 12)])
def test_kernel_loops_write_each_element_once(mis, grid, block):
    for n in (0, 1, 2, 3, 4, 5, 17, 64, 1023):
        head, vectors, written = _kernel_writes(n, mis, grid, block)
        assert sorted(written) == list(range(n))
        aligned = all(m == mis[0] for m in mis)
        plan = rtc_kernels.launch_plan(n, mis[0] // 4 if aligned else None)
        assert plan[:2] == (head, vectors)


def _special(rng, shape, extremes=True):
    """Seeded normal floats with NaN, ±inf and ±0 sprinkled in and, with
    `extremes`, values whose double overflows and the least denormal."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 48), replace=False)
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    if extremes:
        special += [3e38, -3e38, 1e-45]
    special = np.array(special, np.float32)
    flat[picks] = special[np.arange(picks.size) % special.size]
    return x


@pytest.mark.parametrize("shape", [(1, 8), (4, 1023), (16, 128)])
def test_scale_add_plain_matches_pallas_fixture_with_specials(shape):
    def scale_add(x_ref, y_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0 + y_ref[:]

    # No extremes: XLA on the host flushes denormals to zero and contracts
    # x * 2 + y into one FMA, so where 2x overflows or the sum is
    # denormal it differs from IEEE float32 (torch, and the kernel; the
    # card tests hold those cases against the plain version).
    rng = np.random.default_rng(7)
    a, b = _special(rng, shape, False), _special(rng, shape, False)
    k = jmx.rtc.PallasModule(scale_add=scale_add).get_kernel("scale_add")
    want = k.launch([jmx.nd.array(a), jmx.nd.array(b)]).asnumpy()
    got = rtc_kernels.scale_add(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)  # exact, NaN at NaN


@pytest.mark.parametrize("shape", [(1, 8), (32, 64), (3, 1023)])
def test_relu_plain_matches_jax_relu(shape):
    rng = np.random.default_rng(8)
    x = _special(rng, shape, False)  # no denormals: XLA flushes them
    want = jmx.nd.relu(jmx.nd.array(x)).asnumpy()
    before = dict(rtc_kernels.LAUNCHES)
    got = rtc_kernels.relu(torch.from_numpy(x)).numpy()
    # Exact in value: NaN at NaN. The port keeps -0.0 as torch.relu does,
    # the JAX package gives +0.0; they compare equal.
    np.testing.assert_array_equal(got, want)
    assert rtc_kernels.LAUNCHES == before


def _fake_kernel(monkeypatch, signature):
    prog = _nvrtc._Program(("k",), b"", {}, "")
    monkeypatch.setattr(_nvrtc, "compile_program", lambda *a: prog)

    def no_driver(*a, **k):
        raise AssertionError("reached the driver")

    monkeypatch.setattr(_nvrtc, "load_function", no_driver)
    monkeypatch.setattr(_nvrtc, "primary_context", no_driver)
    monkeypatch.setattr(_nvrtc, "launch", no_driver)
    return rtc.CudaModule("unused").get_kernel("k", signature)


SIG = "const float *x, float *y, int64_t n"


@pytest.mark.parametrize("case", ["count", "dtype", "device", "layout",
                                  "host", "device_arg"])
def test_launch_tensors_checks_raise_on_host_tensors(monkeypatch, case):
    k = _fake_kernel(monkeypatch, SIG)
    x, y = torch.zeros(8), torch.zeros(8)
    args, kwargs = [x, y, 8], {}
    err, match = ValueError, None
    if case == "count":
        args, match = [x, y], "takes 3 arguments"
    elif case == "dtype":
        args, err, match = [x.double(), y, 8], TypeError, "float32"
    elif case == "device":
        args, match = [x, torch.zeros(8, device="meta"), 8], "lies on"
    elif case == "layout":
        args, match = [x, torch.zeros(8, 2)[:, 0], 8], "not contiguous"
    elif case == "host":
        match = "launches on a CUDA device"
    else:
        kwargs, match = {"device": torch.device("cuda", 0)}, "lies on cpu"
    with pytest.raises(err, match=match):
        k.launch_tensors(args, (1,), (32,), **kwargs)


def test_wrappers_check_dtype_before_launching(monkeypatch):
    monkeypatch.setattr(rtc_kernels, "launch_elementwise",
                        lambda *a: pytest.fail("launched"))
    x = torch.empty(4, 8, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="float32"):
        rtc_kernels.relu(x)
    with pytest.raises(TypeError, match="float32"):
        rtc_kernels.scale_add(x, x)


def test_too_many_parameters_raise_at_get_kernel(monkeypatch):
    sig = ", ".join("int a%d" % i for i in range(_nvrtc.MAX_PARAMS + 1))
    with pytest.raises(ValueError, match="at most %d" % _nvrtc.MAX_PARAMS):
        _fake_kernel(monkeypatch, sig)


_CTYPES = {"P": ctypes.c_void_p, "f": ctypes.c_float, "d": ctypes.c_double,
           "H": ctypes.c_uint16, "B": ctypes.c_uint8, "b": ctypes.c_int8,
           "i": ctypes.c_int32, "q": ctypes.c_int64}


@pytest.mark.parametrize("signature", [
    SIG, "const float *x, const float *y, float *out, int64_t n",
    "const float *x, const float *g, const float *b, const float *m, "
    "const float *v, float *y, int64_t n, int32_t c, int64_t inner, "
    "float eps, int32_t fix_gamma",
    "uint8_t a, double b, __half c, int8_t d, float *e, char f, int g",
    "__half h"])
def test_launch_buffer_has_the_c_layout(monkeypatch, signature):
    """Each parameter sits where a C struct of the header and the
    parameters puts it (the kernel's own parameter layout), and the
    header where csrc/rtc_launch.cu reads it."""
    k = _fake_kernel(monkeypatch, signature)
    codes = ["P" if is_ptr else rtc._STRUCT[d] for d, is_ptr, _ in
             k._params]
    header = [("function", ctypes.c_void_p), ("context", ctypes.c_void_p),
              ("stream", ctypes.c_void_p),
              ("dims", ctypes.c_uint32 * 8)]
    fields = header + [("p%d" % i, _CTYPES[c]) for i, c in enumerate(codes)]
    layout = type("Layout", (ctypes.Structure,), {"_fields_": fields})
    assert struct.calcsize(_nvrtc.HEADER) == layout.p0.offset
    assert list(k._offsets)[:len(codes)] == [
        getattr(layout, "p%d" % i).offset for i in range(len(codes))]
    values = [1] * len(codes)
    buf = k._pack(11, 12, 13, 1, 2, 3, 4, 5, 6, 7, len(codes), *values)
    got = layout.from_buffer_copy(buf.ljust(ctypes.sizeof(layout), b"\0"))
    assert (got.function, got.context, got.stream) == (11, 12, 13)
    assert list(got.dims) == [1, 2, 3, 4, 5, 6, 7, len(codes)]
    assert [getattr(got, "p%d" % i) for i in range(len(codes))] == values


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same_bits(got, want):
    """Bit for bit where the result is a number; NaN where it is NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _special_cuda(shape, seed):
    return torch.from_numpy(_special(np.random.default_rng(seed),
                                     shape)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4096), (4096, 4096)])
def test_kernels_bit_exact_on_card(shape):
    _card()
    x, y = _special_cuda(shape, 1), _special_cuda(shape, 2)
    r0, s0 = rtc_kernels.LAUNCHES["relu"], rtc_kernels.LAUNCHES["scale_add"]
    _same_bits(rtc_kernels.relu(x), rtc_kernels.relu_reference(x))
    _same_bits(rtc_kernels.scale_add(x, y),
               rtc_kernels.scale_add_reference(x, y))
    torch.cuda.synchronize()
    assert rtc_kernels.LAUNCHES["relu"] == r0 + 1
    assert rtc_kernels.LAUNCHES["scale_add"] == s0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 5, 1023, 4096 * 33 + 3])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                                     (3, 3, 3), (1, 2, 0), (0, 0, 3)])
def test_views_at_element_offsets_on_card(n, offsets):
    """Contiguous views whose pointers are not 16-byte aligned: the same
    offset everywhere (a scalar head, then vectors), or offsets that
    differ (the scalar path); through the wrappers, whose outputs are
    aligned, and through CudaKernel.launch with the output at its own
    offset."""
    _card()
    bases = [_special_cuda((n + 3,), 10 + i) for i in range(3)]
    x, y, out = (b[o:o + n] for b, o in zip(bases, offsets))
    _same_bits(rtc_kernels.relu(x), rtc_kernels.relu_reference(x))
    _same_bits(rtc_kernels.scale_add(x, y),
               rtc_kernels.scale_add_reference(x, y))
    ctx = mx.gpu(0)
    for name, ins in (("relu", [x]), ("scale_add", [x, y])):
        k = rtc_kernels._kernel(name, SIGNATURES[name])
        ptrs = [t.data_ptr() % 16 for t in ins + [out]]
        plan = rtc_kernels.launch_plan(
            n, ptrs[0] // 4 if len(set(ptrs)) == 1 else None)
        k.launch([NDArray(t) for t in ins + [out]] + [n], ctx,
                 (plan[3],), (256,))
        want = rtc_kernels.relu_reference(x) if name == "relu" else \
            rtc_kernels.scale_add_reference(x, y)
        _same_bits(out, want)


SIGNATURES = {"relu": "const float *x, float *y, int64_t n",
              "scale_add": "const float *x, const float *y, float *out, "
                           "int64_t n"}


@pytest.mark.cuda
@pytest.mark.parametrize("grid,block", [((1,), (1,)), ((1,), (32,)),
                                        ((7,), (96,))])
@pytest.mark.parametrize("n,offset", [(1023, 0), (1023, 1), (4096 * 33 + 3,
                                                             2)])
def test_caller_chosen_launch_dims_on_card(grid, block, n, offset):
    """The grid-stride contract: any grid and block a caller passes
    covers every element."""
    _card()
    bases = [_special_cuda((n + 3,), 20 + i) for i in range(3)]
    x, y, out = (b[offset:offset + n] for b in bases)
    ctx = mx.gpu(0)
    before = rtc.LAUNCHES
    for name, ins in (("relu", [x]), ("scale_add", [x, y])):
        out.fill_(7.0)
        k = rtc_kernels._kernel(name, SIGNATURES[name])
        k.launch([NDArray(t) for t in ins + [out]] + [n], ctx, grid,
                 block)
        want = rtc_kernels.relu_reference(x) if name == "relu" else \
            rtc_kernels.scale_add_reference(x, y)
        _same_bits(out, want)
    assert rtc.LAUNCHES == before + 2
