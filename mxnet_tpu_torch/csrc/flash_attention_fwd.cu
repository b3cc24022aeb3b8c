// Flash-attention forward for Hopper (sm_90a), exact attention with an
// online softmax.
//
// Replaces the TPU kernel `_kernel`, launched by `_flash_forward`, in
// mxnet_tpu/ops/pallas_attention.py (the forward half of the op
// `_contrib_flash_attention`). It computes the same function:
//   S = scale * Q K^T, causal mask top-left aligned on absolute
//   positions (q_pos >= k_pos), masked probabilities zero; a running max
//   m, sum l and accumulator in fp32 across key tiles; O = acc / max(l,
//   1e-30) in the input dtype and LSE = m + log(max(l, 1e-30)) in fp32.
//
// What bounds it on this card. For the serving shape (B 8, H 16,
// T 2048, D 64, causal, bf16) the work is 4*B*H*T*T*D / 2 = 68.7 GFLOP
// against 134 MB of Q, K, V, O and LSE: about 510 FLOP per byte, above
// the H100's ridge point, so arithmetic sets the least time (0.070 ms
// at the 989 TFLOP/s bf16 tensor-core peak).
//
// Two kernels, chosen by dtype:
//
// bf16/fp16: `flash_fwd_wgmma_kernel`, on the tensor cores.
// - One block of three warpgroups owns 128 query rows of one
//   (batch*head). Warpgroups 0 and 1 each compute 64 rows; warpgroup 2
//   is the producer: one thread issues every TMA load, and the group
//   gives its registers to the others (setmaxnreg 24 / 240).
// - Q is loaded once. K and V tiles of 128 keys go through a two-stage
//   ring of shared-memory buffers, with a full and an empty mbarrier per
//   stage, so the next tile loads while this one is computed.
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major, as the TMA wrote them (128-byte swizzle; 64-byte at D 32;
//   D 128 as two 64-column panels).
// - The online softmax runs in fp32 registers on the accumulator, in
//   base 2 (scale * log2 e folded into one multiply). P is rounded to
//   the input dtype and packed in place: the accumulator fragment of
//   S's columns 16j..16j+15 is the register A fragment of k-step j of
//   O += P V, so no shuffle or shared-memory trip is needed. V is the B
//   operand, MN-major from the same swizzled tiles.
// - Only tiles that cross the diagonal or the ragged end are masked;
//   tiles wholly above the diagonal are never loaded; blocks launch
//   longest-first. Rows past tq are zero-filled by the TMA (the 3-D map
//   stops a box at its head's end) and never stored.
// P in the input dtype is the one rounding the fp32 plain version does
// not make; ops/flash_attention.py's kernel_tolerance() accounts for it.
//
// float32: `flash_fwd_kernel`, IEEE fp32 FFMA on the CUDA cores (67
// TFLOP/s peak): fp32 inputs must match the JAX package to rtol 2e-4 /
// atol 2e-5, which TF32 tensor cores cannot. Four threads share a query
// row, each holding a quarter of q and of the fp32 accumulator in
// registers; keys and values stream through shared memory in 32-row
// tiles; two butterfly shuffles complete each score.
//
// Both kernels' tiles are independent of the op's block_q/block_k
// arguments, which keep only their divisibility contract.
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as in the TPU kernel
constexpr float kLn2 = 0.6931471805599453f;

// -- float32: FFMA ---------------------------------------------------------------

constexpr int kBlockM = 64;       // query rows per thread block
constexpr int kBlockN = 32;       // keys per shared-memory tile
constexpr int kLanesPerRow = 4;   // threads sharing one query row
constexpr int kThreads = kBlockM * kLanesPerRow;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* kb = k + bh * tk * D;
  const float* vb = v + bh * tk * D;

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
  float* orow = o + (bh * tq + q_pos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + kLanesPerRow * i;
    *reinterpret_cast<float4*>(orow + 4 * c) =
        make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                    acc[i].w / denom);
  }
  if (lane == 0) lse[bh * tq + q_pos] = m + logf(denom);
}

template <int D>
int launch_ffma(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int tq, int tk, int causal, float scale,
                cudaStream_t stream) {
  const dim3 grid((tq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16/fp16: wgmma + TMA ---------------------------------------------------------

constexpr int kTcRows = 128;     // query rows per block, and keys per tile
constexpr int kTcStages = 2;     // K/V ring depth
constexpr int kTcConsumers = 2;  // warpgroups of 64 query rows each
constexpr int kTcThreads = 128 * (kTcConsumers + 1);

template <int D>
struct FwdGeo : hopper::Panels<D> {
  using P = hopper::Panels<D>;
  static constexpr int kPanelBytes = kTcRows * P::kSW;
  static constexpr int kTile = kTcRows * D * 2;  // Q, K or V tile bytes
  static constexpr int kBarOffset = kTile * (1 + 2 * kTcStages);
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kTcStages + 1);
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       T* __restrict__ o, float* __restrict__ lse, int tq,
                       int tk, int causal, float scale_log2) {
  using G = FwdGeo<D>;
  using hopper::Wgmma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + G::kTile;  // stage s: K at 2s, V at 2s + 1 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + kTcStages;
  uint64_t* q_bar = empty + kTcStages;

  const int n_qtiles = (tq + kTcRows - 1) / kTcRows;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  int n_ktiles = (tk + kTcRows - 1) / kTcRows;
  if (causal) n_ktiles = min(n_ktiles, qtile + 1);  // tiles are square

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * kTcConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTcConsumers) {
    // Producer: one thread issues every load.
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 128 * kTcConsumers) {
      hopper::mbar_arrive_tx(q_bar, G::kTile);
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::tma_load_3d(q_s + p * G::kPanelBytes, &qmap, q_bar,
                            p * G::kPanelElems, qtile * kTcRows, bh);
      }
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % kTcStages;
        hopper::mbar_wait(&empty[s], ((kt / kTcStages) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], 2 * G::kTile);
        uint8_t* k_dst = kv_s + 2 * s * G::kTile;
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(k_dst + p * G::kPanelBytes, &kmap, &full[s],
                              p * G::kPanelElems, kt * kTcRows, bh);
          hopper::tma_load_3d(k_dst + G::kTile + p * G::kPanelBytes, &vmap,
                              &full[s], p * G::kPanelElems, kt * kTcRows, bh);
        }
      }
    }
  } else {
    hopper::regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_row = qtile * kTcRows + wg * 64;
    const int row0 = first_row + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = hopper::smem_u32(q_s) + wg * 64 * G::kSW;

    float s[kTcRows / 2];
    float acc[G::kPanels][G::kPanelElems / 2];
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; ++i) acc[p][i] = 0.f;
    }
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

    hopper::mbar_wait(q_bar, 0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int st = kt % kTcStages;
      hopper::mbar_wait(&full[st], (kt / kTcStages) & 1);
      const uint32_t k_base = hopper::smem_u32(kv_s + 2 * st * G::kTile);
      const uint32_t v_base = k_base + G::kTile;

      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int off = (k / G::kStepsPerPanel) * G::kPanelBytes +
                        (k % G::kStepsPerPanel) * 32;
        Wgmma<T, kTcRows>::ss(s, hopper::smem_desc(q_base + off, G::kSW),
                              hopper::smem_desc(k_base + off, G::kSW), k > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);

      const int key0 = kt * kTcRows + col0;
      const bool masked = kt * kTcRows + kTcRows > tk ||
                          (causal && kt * kTcRows + kTcRows - 1 > first_row);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kTcRows / 2; ++i) {
          const int key = key0 + hopper::acc_col(i);
          const int row = row0 + hopper::acc_row(i);
          s[i] = key < tk && !(causal && key > row) ? s[i] * scale_log2
                                                    : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kTcRows / 2; ++i) s[i] *= scale_log2;
      }
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTcRows / 2; ++i) {
        m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s[i]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
        corr[r] = exp2f(m[r] - m_new[r]);
        m[r] = m_new[r];
        l[r] *= corr[r];
      }
      // P, rounded to T, as the A fragments of O += P V.
      uint32_t pa[kTcRows / 16][4];
#pragma unroll
      for (int j = 0; j < kTcRows / 16; ++j) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int i = 8 * j + 2 * h;
          const float p0 = exp2f(s[i] - m[h & 1]);
          const float p1 = exp2f(s[i + 1] - m[h & 1]);
          l[h & 1] += p0 + p1;
          pa[j][h] = hopper::pack2(p0, p1, T());
        }
      }
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
        for (int i = 0; i < G::kPanelElems / 2; ++i) acc[p][i] *= corr[(i >> 1) & 1];
        hopper::fence_regs(acc[p]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcRows / 16; ++j) {
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          Wgmma<T, G::kPanelElems>::rs_mn(
              acc[p], pa[j],
              hopper::smem_desc(v_base + p * G::kPanelBytes + j * 16 * G::kSW,
                                G::kSW));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) hopper::fence_regs(acc[p]);
      hopper::mbar_arrive(&empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / denom;
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < tq) {
        lse[static_cast<size_t>(bh) * tq + row] = m[r] * kLn2 + logf(denom);
      }
    }
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; i += 2) {
        const int row = row0 + hopper::acc_row(i);
        if (row < tq) {
          const int r = (i >> 1) & 1;
          const int col = p * G::kPanelElems + hopper::acc_col(i) + col0;
          *reinterpret_cast<uint32_t*>(
              o + (static_cast<size_t>(bh) * tq + row) * D + col) =
              hopper::pack2(acc[p][i] * inv[r], acc[p][i + 1] * inv[r], T());
        }
      }
    }
  }
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int tq, int tk, int causal, float scale,
                 cudaStream_t stream) {
  using G = FwdGeo<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::make_panel_map<T>(&qmap, q, bh, tq, D, kTcRows, G::kSW) ||
      !hopper::make_panel_map<T>(&kmap, k, bh, tk, D, kTcRows, G::kSW) ||
      !hopper::make_panel_map<T>(&vmap, v, bh, tk, D, kTcRows, G::kSW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_wgmma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + kTcRows - 1) / kTcRows, bh);
  kernel<<<grid, kTcThreads, G::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(o), static_cast<float*>(lse), tq, tk,
      causal, scale * hopper::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int tq, int tk, int d, int causal,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_wgmma<T, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 64: return launch_wgmma<T, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 128: return launch_wgmma<T, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <>
int dispatch_d<float>(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int tq, int tk, int d, int causal,
                      float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_ffma<32>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 64: return launch_ffma<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 128: return launch_ffma<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: (bh, tq|tk, d) contiguous, 16-byte aligned; o like q; lse
// (bh, tq) fp32. dtype: 0 float32 (FFMA kernel), 1 bfloat16, 2 float16
// (wgmma kernel). Returns the cudaError_t of the launch (0 on success).
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
