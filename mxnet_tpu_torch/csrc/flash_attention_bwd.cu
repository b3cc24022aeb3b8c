// Flash-attention backward for Hopper (sm_90a): the dK/dV pass and the
// dQ pass, each regenerating the attention probabilities from the
// forward's saved log-sum-exp.
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (K2) and `_bwd_dq_kernel`
// (K3), launched by `_flash_backward` in mxnet_tpu/ops/pallas_attention.py
// (pallas_call at :262 and :281, shared recompute `_regen` at :143-167).
// They compute the same function. For a query row i and a key row j:
//   s_ij  = scale * q_i . k_j            (fp32; causal: live iff i >= j,
//                                          top-left aligned on absolute
//                                          positions, as in the forward)
//   p_ij  = exp(s_ij - lse_i)            (0 where masked: the TPU kernel's
//                                          exp(-1e30 - lse) underflows to 0)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale,  delta_i = rowsum(dO_i * O_i)
//   K2: dV_j = sum_i p_ij dO_i,  dK_j = sum_i ds_ij q_i
//   K3: dQ_i = sum_j ds_ij k_j
// delta is computed by the caller (in fp32), as the TPU version leaves it
// to XLA. dQ, dK and dV are written in the input dtype. Nothing of size
// Tq x Tk reaches device memory.
//
// What bounds it on this card. At the training shape (B 8, H 16,
// T 2048, D 64, causal, bf16), K2 does 8*B*H*T*T*D/2 = 137 GFLOP and K3
// 6*B*H*T*T*D/2 = 103 GFLOP against about 170 MB and 130 MB of
// inputs/outputs: far above the H100's ridge point, so arithmetic sets
// the least time (0.139 ms and 0.104 ms at the 989 TFLOP/s bf16
// tensor-core peak). Like the forward, this first version does its
// arithmetic as IEEE fp32 FFMA on the CUDA cores (67 TFLOP/s) for every
// input dtype, because fp32 inputs must match the JAX package to rtol
// 2e-4 / atol 2e-5, which TF32 cannot; its own floor is thus about 2 ms
// (K2) and 1.5 ms (K3). mma.sync/wgmma for bf16/fp16, TMA and warp
// specialisation are the later steps.
//
// What the design does about it:
// - No atomics, so dQ is deterministic: two passes, as on the TPU. K2
//   owns a tile of keys, K3 a tile of queries; the loop over the other
//   side runs inside the block (the TPU's sequential grid axis).
// - K3 has the forward's shape: one block per (batch*head, query tile),
//   L = D/16 lanes per query row, each holding a quarter-to-eighth of q,
//   dO and the fp32 dQ accumulator (16 floats each) in registers. Keys
//   and values stream through shared memory in 32-row tiles, widened to
//   fp32 once on load; L-lane butterfly shuffles complete q.k and dO.v.
// - K2 is its transpose: one block per (batch*head, key tile), L lanes
//   per key row holding k, v and the dK/dV accumulators (64 floats per
//   lane at every D, so D 128 does not spill). Queries, dO, lse and delta
//   stream through shared memory in 16-row tiles.
// - 256 threads per block at every D: 128/64/32 rows for D 32/64/128.
// - Causal skips are loop bounds: K3 stops at the key tile of its last
//   query, K2 starts at the first query tile that reaches its first key.
//   K3 blocks launch longest-first; K2's longest block is key tile 0,
//   which is launched first already.
// - Ragged edges (T not a multiple of a tile) are masked here; the op's
//   block_q/block_k keep only their divisibility contract.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;  // K3: keys per shared-memory tile
constexpr int kTileQ = 16;  // K2: queries per shared-memory tile

template <int D>
struct Geo {
  static constexpr int kLanes = D / 16;              // threads per row
  static constexpr int kRows = kThreads / kLanes;    // rows per block
  static constexpr int kVec = D / 4;                 // float4s per row
  static constexpr int kChunks = kVec / kLanes;      // float4s per lane
  static_assert(kChunks == 4, "each lane holds 16 floats of a row");
};

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

// Sum over the L lanes that share a row (neighbouring lanes of a warp).
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K3: dQ for one (batch*head, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  using G = Geo<D>;
  constexpr int L = G::kLanes;
  constexpr int C = G::kChunks;
  __shared__ float4 ks[kTileK * G::kVec];
  __shared__ float4 vs[kTileK * G::kVec];

  const int n_qtiles = (tq + G::kRows - 1) / G::kRows;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const size_t bh = blockIdx.y;
  const int row = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int q_pos = qtile * G::kRows + row;
  const bool row_valid = q_pos < tq;

  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  float4 qr[C], dor[C], acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = lane + L * i;
    const size_t off = (bh * tq + q_pos) * D + 4 * c;
    qr[i] = row_valid ? load4(q + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    dor[i] = row_valid ? load4(dout + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse_i = row_valid ? lse[bh * tq + q_pos] : 0.f;
  const float delta_i = row_valid ? delta[bh * tq + q_pos] : 0.f;

  int n_ktiles = (tk + kTileK - 1) / kTileK;
  if (causal) {
    const int last_query = qtile * G::kRows + G::kRows - 1;
    n_ktiles = min(n_ktiles, last_query / kTileK + 1);
  }

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // every lane is done with the previous tile
    for (int idx = threadIdx.x; idx < kTileK * G::kVec; idx += kThreads) {
      const int j = idx / G::kVec;
      const int c = idx % G::kVec;
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

    // One key at a time: its k and v chunks are read from shared memory
    // once, for the two dot products and for the dQ update. Unrolled by
    // two for overlap; a full unroll would hoist every load of the tile
    // into registers and spill.
#pragma unroll 2
    for (int j = 0; j < kTileK; ++j) {
      float4 kk[C], vv[C];
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = j * G::kVec + lane + L * i;
        kk[i] = ks[c];
        vv[i] = vs[c];
        s = dot4(qr[i], kk[i], s);
        dp = dot4(dor[i], vv[i], dp);
      }
      s = row_sum<L>(s);
      dp = row_sum<L>(dp);
      const int key = k0 + j;
      const bool live = key < tk && !(causal && key > q_pos);
      const float p = live ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int i = 0; i < C; ++i) axpy4(ds, kk[i], acc[i]);
    }
  }

  if (!row_valid) return;
  T* dqrow = dq + (bh * tq + q_pos) * D;
#pragma unroll
  for (int i = 0; i < C; ++i) store4(dqrow + 4 * (lane + L * i), acc[i]);
}

// K2: dK and dV for one (batch*head, key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int causal,
                     float scale) {
  using G = Geo<D>;
  constexpr int L = G::kLanes;
  constexpr int C = G::kChunks;
  __shared__ float4 qs[kTileQ * G::kVec];
  __shared__ float4 dos[kTileQ * G::kVec];
  __shared__ float lses[kTileQ];
  __shared__ float dels[kTileQ];

  const int ktile = blockIdx.x;  // tile 0 sees the most queries: first
  const size_t bh = blockIdx.y;
  const int row = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int k_pos = ktile * G::kRows + row;
  const bool row_valid = k_pos < tk;

  const T* qb = q + bh * tq * D;
  const T* dob = dout + bh * tq * D;

  float4 kr[C], vr[C], dk_acc[C], dv_acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = lane + L * i;
    const size_t off = (bh * tk + k_pos) * D + 4 * c;
    kr[i] = row_valid ? load4(k + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    vr[i] = row_valid ? load4(v + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_qtiles = (tq + kTileQ - 1) / kTileQ;
  // Causal: the first query tile whose last query reaches this block's
  // first key; every earlier one is wholly above the diagonal.
  const int qt0 = causal ? (ktile * G::kRows) / kTileQ : 0;

  for (int qt = qt0; qt < n_qtiles; ++qt) {
    const int q0 = qt * kTileQ;
    __syncthreads();  // every lane is done with the previous tile
    for (int idx = threadIdx.x; idx < kTileQ * G::kVec; idx += kThreads) {
      const int i = idx / G::kVec;
      const int c = idx % G::kVec;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dv4 = qv;
      if (q0 + i < tq) {
        qv = load4(qb + (size_t)(q0 + i) * D + 4 * c);
        dv4 = load4(dob + (size_t)(q0 + i) * D + 4 * c);
      }
      qs[idx] = qv;
      dos[idx] = dv4;
    }
    if (threadIdx.x < kTileQ) {
      const int r = threadIdx.x;
      const bool in = q0 + r < tq;
      lses[r] = in ? lse[bh * tq + q0 + r] : 0.f;
      dels[r] = in ? delta[bh * tq + q0 + r] : 0.f;
    }
    __syncthreads();

    // One query at a time: its q and dO chunks are read from shared
    // memory once, for the two dot products and for the dK/dV updates
    // (unrolled by two; a full unroll spills, see K3).
#pragma unroll 2
    for (int r = 0; r < kTileQ; ++r) {
      float4 qq[C], dd[C];
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = r * G::kVec + lane + L * i;
        qq[i] = qs[c];
        dd[i] = dos[c];
        s = dot4(qq[i], kr[i], s);
        dp = dot4(dd[i], vr[i], dp);
      }
      s = row_sum<L>(s);
      dp = row_sum<L>(dp);
      const int qpos = q0 + r;
      const bool live = qpos < tq && !(causal && k_pos > qpos);
      const float p = live ? expf(s * scale - lses[r]) : 0.f;
      const float ds = p * (dp - dels[r]) * scale;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        axpy4(p, dd[i], dv_acc[i]);
        axpy4(ds, qq[i], dk_acc[i]);
      }
    }
  }

  if (!row_valid) return;
  const size_t base = (bh * tk + k_pos) * D;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = lane + L * i;
    store4(dk + base + 4 * c, dk_acc[i]);
    store4(dv + base + 4 * c, dv_acc[i]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  const int n_qtiles = (a.tq + Geo<D>::kRows - 1) / Geo<D>::kRows;
  flash_bwd_dq_kernel<T, D><<<dim3(n_qtiles, a.bh), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.tq, a.tk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const int n_ktiles = (a.tk + Geo<D>::kRows - 1) / Geo<D>::kRows;
  flash_bwd_dkv_kernel<T, D><<<dim3(n_ktiles, a.bh), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.tq, a.tk,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn.template operator()<T, D>() for the runtime dtype and head_dim.
template <typename Fn>
int dispatch(int dtype, int d, Fn fn) {
  switch (dtype * 1000 + d) {
    case 32: return fn.template run<float, 32>();
    case 64: return fn.template run<float, 64>();
    case 128: return fn.template run<float, 128>();
    case 1032: return fn.template run<__nv_bfloat16, 32>();
    case 1064: return fn.template run<__nv_bfloat16, 64>();
    case 1128: return fn.template run<__nv_bfloat16, 128>();
    case 2032: return fn.template run<__half, 32>();
    case 2064: return fn.template run<__half, 64>();
    case 2128: return fn.template run<__half, 128>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct DqLauncher {
  const Args& a;
  void* dq;
  template <typename T, int D>
  int run() const { return launch_dq<T, D>(a, dq); }
};

struct DkvLauncher {
  const Args& a;
  void* dk;
  void* dv;
  template <typename T, int D>
  int run() const { return launch_dkv<T, D>(a, dk, dv); }
};

bool bad_shape(int bh, int tq, int tk) {
  return bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0;
}

}  // namespace

// q, dout, dq: (bh, tq, d); k, v, dk, dv: (bh, tk, d); all contiguous,
// 16-byte aligned, in one dtype (0 float32, 1 bfloat16, 2 float16). lse
// and delta: (bh, tq) fp32. Each returns the cudaError_t of its launch
// (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int tq,
                                       int tk, int d, int dtype, int causal,
                                       float scale, void* stream) {
  if (bad_shape(bh, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, DkvLauncher{a, dk, dv});
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int tq, int tk,
                                      int d, int dtype, int causal,
                                      float scale, void* stream) {
  if (bad_shape(bh, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, DqLauncher{a, dq});
}
