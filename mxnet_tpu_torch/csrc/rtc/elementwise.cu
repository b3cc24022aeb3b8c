// Elementwise fp32 kernels compiled at runtime by NVRTC through
// mxnet_tpu_torch.rtc.CudaModule (examples/rtc_kernels.py): the
// counterparts of the JAX package's rtc fixtures, user kernels launched
// through mxnet_tpu/rtc.py (PallasKernel.launch -> pl.pallas_call,
// rtc.py:87).
//
// Bound on the card: bytes (one read per input and one write per
// output element, no arithmetic to speak of). What the design does
// about it, for the H100:
// - 16-byte vectors, read through the non-coherent path (__ldg, inputs
//   const __restrict__).
// - One float4 a thread where the grid covers the work, as the port's
//   own launches do (examples/rtc_kernels.launch_plan): 16 bytes of
//   each input in flight per thread, 4x the scalar loop's.
// - Where a caller's grid is smaller than the work, whole trips of
//   ELEMENTWISE_VECTORS float4 of every input a thread, all loaded
//   before any is stored, while a trip fits; then single vectors.
// - A scalar head up to the first 16-byte boundary and a scalar tail of
//   fewer than 4 elements. A contiguous view may start at any element,
//   so the pointers need not be 16-byte aligned; where they differ from
//   each other mod 16 no head aligns them all, and every element takes
//   the scalar path (whole trips of 4 loads a thread there).
// - Grid-stride loops: right for any grid and block a caller passes
//   through CudaKernel.launch.
// The results are those of the plain versions on the card bit for bit:
// relu is F.relu (NaN passes through, -0.0 becomes +0.0, as in the JAX
// package's relu); scale_add rounds 2x (exact) and then the sum, with
// no FMA, so where 2x overflows the result is inf or NaN as in torch.

#ifndef ELEMENTWISE_VECTORS
#define ELEMENTWISE_VECTORS 4
#endif

struct ScaleAdd {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fadd_rn(__fmul_rn(2.0f, a), b);
  }
};

struct Relu {
  __device__ __forceinline__ float operator()(float a, float) const {
    return a <= 0.0f ? 0.0f : a;
  }
};

// out[i] = Op(x[i], y[i]) for i < n; y is read only if kBinary.
template <bool kBinary, class Op>
__device__ __forceinline__ void elementwise(const float *__restrict__ x,
                                            const float *__restrict__ y,
                                            float *__restrict__ out,
                                            long long n) {
  constexpr int kVec = ELEMENTWISE_VECTORS;
  const Op op;
  const unsigned long long mis = (unsigned long long)out & 15;
  const bool aligned = (mis & 3) == 0 &&
                       ((unsigned long long)x & 15) == mis &&
                       (!kBinary || ((unsigned long long)y & 15) == mis);
  long long head = n;  // scalar elements before the vectors
  if (aligned) {
    const long long to_boundary = (long long)(((16 - mis) & 15) >> 2);
    head = to_boundary < n ? to_boundary : n;
  }
  const long long vectors = (n - head) >> 2;
  const long long tail = head + 4 * vectors;  // first scalar after them
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  // Thread tid takes vectors tid + j * stride, j = 0, 1, ...
  const float4 *xv = reinterpret_cast<const float4 *>(x + head);
  const float4 *yv =
      kBinary ? reinterpret_cast<const float4 *>(y + head) : nullptr;
  float4 *ov = reinterpret_cast<float4 *>(out + head);
  long long i = tid;
  for (; i + (kVec - 1) * stride < vectors; i += kVec * stride) {
    float4 a[kVec], b[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      a[k] = __ldg(xv + i + k * stride);
      b[k] = kBinary ? __ldg(yv + i + k * stride) : a[k];
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      ov[i + k * stride] =
          make_float4(op(a[k].x, b[k].x), op(a[k].y, b[k].y),
                      op(a[k].z, b[k].z), op(a[k].w, b[k].w));
  }
  for (; i < vectors; i += stride) {
    const float4 a = __ldg(xv + i);
    const float4 b = kBinary ? __ldg(yv + i) : a;
    ov[i] = make_float4(op(a.x, b.x), op(a.y, b.y), op(a.z, b.z),
                        op(a.w, b.w));
  }

  // The head and the tail, or every element: scalar s < head is element
  // s, the others follow the vectors.
  const long long scalars = head + (n - tail);
  long long s = tid;
  for (; s + 3 * stride < scalars; s += 4 * stride) {
    float a[4], b[4];
    long long j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long t = s + k * stride;
      j[k] = t < head ? t : tail + (t - head);
      a[k] = __ldg(x + j[k]);
      b[k] = kBinary ? __ldg(y + j[k]) : a[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[j[k]] = op(a[k], b[k]);
  }
  for (; s < scalars; s += stride) {
    const long long j = s < head ? s : tail + (s - head);
    out[j] = op(__ldg(x + j), kBinary ? __ldg(y + j) : 0.0f);
  }
}

// out = 2 * x + y  (the scale_add fixture, tests/test_contrib.py:201-211)
extern "C" __global__ void scale_add(const float *__restrict__ x,
                                     const float *__restrict__ y,
                                     float *__restrict__ out, long long n) {
  elementwise<true, ScaleAdd>(x, y, out, n);
}

// y = max(x, 0) over the output of a matmul (the fused relu of
// tests/test_subgraph_nce.py:109-142); NaN passes through, -0.0 gives
// +0.0.
extern "C" __global__ void relu(const float *__restrict__ x,
                                float *__restrict__ y, long long n) {
  elementwise<false, Relu>(x, nullptr, y, n);
}
