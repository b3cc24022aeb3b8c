// Elementwise fp32 kernels compiled at runtime by NVRTC through
// mxnet_tpu_torch.rtc.CudaModule (examples/rtc_kernels.py): the
// counterparts of the JAX package's rtc fixtures, user kernels launched
// through mxnet_tpu/rtc.py (PallasKernel.launch -> pl.pallas_call,
// rtc.py:87).
//
// Bound on the card: bytes (one read per input and one write per
// output element, no arithmetic to speak of). One thread per element,
// a grid-stride loop.

// out = 2 * x + y  (the scale_add fixture, tests/test_contrib.py:201-211)
extern "C" __global__ void scale_add(const float *x, const float *y,
                                     float *out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = 2.0f * x[i] + y[i];
  }
}

// y = max(x, 0) over the output of a matmul (the fused relu of
// tests/test_subgraph_nce.py:109-142); NaN passes through.
extern "C" __global__ void relu(const float *x, float *y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = x[i];
    y[i] = v < 0.0f ? 0.0f : v;
  }
}
