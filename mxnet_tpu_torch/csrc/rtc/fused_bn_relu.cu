// BatchNorm (inference) + ReLU, fused; compiled at runtime by NVRTC
// through mxnet_tpu_torch.rtc.CudaModule (examples/fused_bn_relu.py).
//
// Replaces: the kernel a fragment of subgraph.partition runs in the JAX
// package, a user kernel launched through mxnet_tpu/rtc.py
// (PallasKernel.launch -> pl.pallas_call, rtc.py:87).
//
//   z = (x - mean[c]) * rsqrt(var[c] + eps) * gamma[c] + beta[c]
//   y = max(0, z)
//
// x is (outer, channels, inner) in row-major order (NCHW with axis 1:
// outer = N, inner = H*W), fp32. fix_gamma != 0 takes gamma as 1.
// bn_relu_forward writes y; bn_relu_forward_both also writes z, for a
// fragment whose BatchNorm output is read outside the pair as well.
//
// Bound on the card: bytes. Each element is read once and written once
// (8 bytes; 12 with z); the four per-channel vectors are a few KB. No
// arithmetic unit comes near its limit. This first version is one thread
// per element with a grid-stride loop: coalesced 4-byte loads and
// stores, the per-channel values from the L1/L2 caches. Vector loads and
// a per-plane block shape are later work.
template <bool kWriteZ>
__device__ __forceinline__ void bn_relu_body(
    const float *x, const float *gamma, const float *beta,
    const float *mean, const float *var, float *z, float *y, long long n,
    int channels, long long inner, float eps, int fix_gamma) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int c = (int)((i / inner) % channels);
    const float g = fix_gamma ? 1.0f : gamma[c];
    const float v = (x[i] - mean[c]) * rsqrtf(var[c] + eps) * g + beta[c];
    if (kWriteZ) z[i] = v;
    y[i] = v < 0.0f ? 0.0f : v;  // NaN passes through, as torch.relu
  }
}

extern "C" __global__ void bn_relu_forward(
    const float *x, const float *gamma, const float *beta,
    const float *mean, const float *var, float *y, long long n,
    int channels, long long inner, float eps, int fix_gamma) {
  bn_relu_body<false>(x, gamma, beta, mean, var, nullptr, y, n, channels,
                      inner, eps, fix_gamma);
}

extern "C" __global__ void bn_relu_forward_both(
    const float *x, const float *gamma, const float *beta,
    const float *mean, const float *var, float *z, float *y, long long n,
    int channels, long long inner, float eps, int fix_gamma) {
  bn_relu_body<true>(x, gamma, beta, mean, var, z, y, n, channels, inner,
                     eps, fix_gamma);
}
