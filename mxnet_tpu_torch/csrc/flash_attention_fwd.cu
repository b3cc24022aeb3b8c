// Flash-attention forward for Hopper (sm_90a), exact attention with an
// online softmax.
//
// Replaces the TPU kernel `_kernel`, launched by `_flash_forward`, in
// mxnet_tpu/ops/pallas_attention.py (the forward half of the op
// `_contrib_flash_attention`). It computes the same function:
//   S = scale * Q K^T, causal mask top-left aligned on absolute
//   positions (q_pos >= k_pos), masked scores -1e30 and their
//   probabilities zeroed; a running max m, sum l and accumulator in fp32
//   across key tiles; O = acc / max(l, 1e-30) in the input dtype and
//   LSE = m + log(max(l, 1e-30)) in fp32.
//
// What bounds it on this card. For the serving shape (B 8, H 16,
// T 2048, D 64, causal, bf16) the work is 4*B*H*T*T*D / 2 = 68.7 GFLOP
// against 134 MB of Q, K, V, O and LSE: about 510 FLOP per byte, above
// the H100's ridge point, so the least time is set by arithmetic
// (0.070 ms at the 989 TFLOP/s bf16 tensor-core peak). This first
// version does its arithmetic as IEEE fp32 FFMA on the CUDA cores (67
// TFLOP/s peak), for every input dtype: fp32 inputs must match the JAX
// package to rtol 2e-4 / atol 2e-5, which TF32 tensor cores cannot, and
// bf16/fp16 inputs are widened to fp32 on load. Its own floor is thus
// about 1 ms at that shape; tensor cores (mma.sync / wgmma), TMA and
// warp specialisation are the later steps toward the real bound.
//
// What the design does about it:
// - One thread block per (batch*head, 64-row query tile); four threads
//   share a query row, each holding a quarter of the row's q and of its
//   fp32 accumulator in registers, so D = 128 fits without spilling.
// - Keys and values stream through shared memory in 32-row tiles,
//   converted to fp32 once on load; the four lanes of a row read
//   neighbouring 16-byte chunks (no bank conflicts) and every other row
//   of the warp reads the same chunks (broadcast).
// - Each lane forms partial dot products over its quarter of D; two
//   butterfly shuffles give all four lanes the full score, so the
//   online-softmax bookkeeping needs no further communication.
// - Key tiles wholly above the diagonal are never visited: for causal
//   attention the loop bound stops at the tile of the block's last
//   query. Blocks are launched longest-first so the tail is short.
// - The kernel's tile sizes are independent of the op's block_q/block_k
//   arguments, which keep only their divisibility contract; ragged
//   edges (T not a multiple of the tile) are masked here.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;       // query rows per thread block
constexpr int kBlockN = 32;       // keys per shared-memory tile
constexpr int kLanesPerRow = 4;   // threads sharing one query row
constexpr int kThreads = kBlockM * kLanesPerRow;
constexpr float kNeg = -1e30f;    // masked score, as in the TPU kernel

// Four consecutive elements of T <-> one float4.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale) {
  constexpr int kVecPerRow = D / 4;                      // float4s in a row
  constexpr int kChunks = kVecPerRow / kLanesPerRow;     // float4s per lane
  static_assert(kChunks * kLanesPerRow == kVecPerRow, "D % 16 != 0");
  __shared__ float4 ks[kBlockN * kVecPerRow];
  __shared__ float4 vs[kBlockN * kVecPerRow];

  const int n_qtiles = (tq + kBlockM - 1) / kBlockM;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const size_t bh = blockIdx.y;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const int q_pos = qtile * kBlockM + row;
  const bool row_valid = q_pos < tq;

  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + kLanesPerRow * i;
    qr[i] = row_valid ? load4(q + (bh * tq + q_pos) * D + 4 * c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg;
  float l = 0.f;

  int n_ktiles = (tk + kBlockN - 1) / kBlockN;
  if (causal) {
    const int last_query = qtile * kBlockM + kBlockM - 1;
    n_ktiles = min(n_ktiles, last_query / kBlockN + 1);
  }

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // every lane is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockN * kVecPerRow; idx += kThreads) {
      const int j = idx / kVecPerRow;
      const int c = idx % kVecPerRow;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + j < tk) {
        kv = load4(kb + (size_t)(k0 + j) * D + 4 * c);
        vv = load4(vb + (size_t)(k0 + j) * D + 4 * c);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();

    float s[kBlockN];
    float m_tile = kNeg;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = ks[j * kVecPerRow + lane + kLanesPerRow * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool live = key < tk && !(causal && key > q_pos);
      s[j] = live ? part * scale : kNeg;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const int key = k0 + j;
      const bool live = key < tk && !(causal && key > q_pos);
      s[j] = live ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = l * corr + p_sum;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vs[j * kVecPerRow + lane + kLanesPerRow * i];
        acc[i].x = fmaf(s[j], vv.x, acc[i].x);
        acc[i].y = fmaf(s[j], vv.y, acc[i].y);
        acc[i].z = fmaf(s[j], vv.z, acc[i].z);
        acc[i].w = fmaf(s[j], vv.w, acc[i].w);
      }
    }
    m = m_new;
  }

  if (!row_valid) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + (bh * tq + q_pos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + kLanesPerRow * i;
    store4(orow + 4 * c, make_float4(acc[i].x / denom, acc[i].y / denom,
                                     acc[i].z / denom, acc[i].w / denom));
  }
  if (lane == 0) lse[bh * tq + q_pos] = m + logf(denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int tq, int tk, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((tq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int tq, int tk, int d, int causal,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: (bh, tq|tk, d) contiguous, 8-byte aligned; o like q; lse
// (bh, tq) fp32. dtype: 0 float32, 1 bfloat16, 2 float16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int bh, int tq, int tk, int d, int dtype,
                                   int causal, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
    case 2: return dispatch_d<__half>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
