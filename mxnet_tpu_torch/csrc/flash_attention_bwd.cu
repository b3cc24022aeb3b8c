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
// tensor-core peak).
//
// No atomics, so every gradient is deterministic: two passes, as on the
// TPU. K2 owns a tile of keys, K3 a tile of queries; the loop over the
// other side runs inside the block (the TPU's sequential grid axis).
// Causal skips are loop bounds: K3 stops at the key tile of its last
// query, K2 starts at the first query tile that reaches its first key.
// Ragged edges (T not a multiple of a tile) are masked here; the op's
// block_q/block_k keep only their divisibility contract.
//
// K2 and K3 for bf16/fp16 run on the tensor cores, each a block of three
// warpgroups: consumers 0 and 1 each own 64 rows of the block's 128,
// warpgroup 2 is the producer (setmaxnreg 24 / 240), whose one thread
// issues every TMA load. The block's own 128 rows are loaded once and
// stay in shared memory; tiles of 64 rows of the other side stream
// through a two-stage ring (full and empty mbarriers). Every product
// puts the block's own rows along M, so no fragment is ever transposed
// in registers: the fp32 accumulator of the first two products,
// regenerated into P and dS in registers and rounded to the input
// dtype, is the register A fragment of the updates, whose B is read
// MN-major from the streamed tile that the first products read K-major
// (shared memory as the TMA's 128-byte swizzle, 64-byte at D 32, wrote
// it). The accumulators are fp32 and written once, in the input dtype.
// - K2 (`flash_bwd_dkv_wgmma_kernel`) owns 128 keys; Q and dO stream,
//   with the fp32 lse and delta of each tile staged beside them by the
//   producer warp's lanes. S^T = K Q^T and dP^T = V dO^T by wgmma
//   m64n64k16; P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta)
//   scale; dV += P^T dO and dK += dS^T Q.
// - K3 (`flash_bwd_dq_wgmma_kernel`) owns 128 queries; K and V stream in
//   tiles of 64 keys at every D (128 would need about 224 accumulator
//   and fragment registers a thread at D 128; 64 need about 144). Each
//   thread's two accumulator rows are fixed queries, so it holds their
//   lse and delta in registers for the whole block. S = Q K^T and
//   dP = dO V^T by wgmma m64n64k16; P = exp(scale S - lse),
//   dS = P (dP - delta) scale; dQ += dS K. Causal: the loop stops at the
//   key tile of the block's last query, a warpgroup skips the tiles
//   wholly above its diagonal, and only tiles that cross the diagonal or
//   the sequence's end pay for the mask. Blocks launch longest-first.
// P and dS in the input dtype are the roundings the fp32 plain versions
// do not make; ops/flash_attention.py's kernel_tolerance() accounts for
// them.
//
// K2 and K3 for float32: IEEE fp32 FFMA on the CUDA cores (67 TFLOP/s),
// because fp32 inputs must match the JAX package to rtol 2e-4 / atol
// 2e-5, which TF32 cannot. K3 has the forward's FFMA shape: one block
// per (batch*head, query tile), L = D/16 lanes per query row, each
// holding 16 floats of q, dO and the dQ accumulator in registers; keys
// and values stream through shared memory in 32-row tiles; L-lane
// butterfly shuffles complete q.k and dO.v. The fp32 K2 is its
// transpose: L lanes per key row holding k, v and the dK/dV
// accumulators, queries, dO, lse and delta streaming through shared
// memory in 16-row tiles. 256 threads per block at every D. K3 blocks
// launch longest-first.
#include <type_traits>

#include "hopper.cuh"

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// K3 for float32: dQ for one (batch*head, query tile) on FFMA.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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

  const float* kb = k + bh * tk * D;
  const float* vb = v + bh * tk * D;

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
  float* dqrow = dq + (bh * tq + q_pos) * D;
#pragma unroll
  for (int i = 0; i < C; ++i) store4(dqrow + 4 * (lane + L * i), acc[i]);
}

// K2 for float32: dK and dV for one (batch*head, key tile) on FFMA.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, int causal,
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

  const float* qb = q + bh * tq * D;
  const float* dob = dout + bh * tq * D;

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

// -- K2 for bf16/fp16: wgmma + TMA ----------------------------------------------

constexpr int kTcKeys = 128;     // keys per block (64 per consumer)
constexpr int kTcQueries = 64;   // queries per streamed tile
constexpr int kTcStages = 2;     // ring depth (K2: Q/dO, K3: K/V)
constexpr int kTcConsumers = 2;  // warpgroups of 64 rows each
constexpr int kTcThreads = 128 * (kTcConsumers + 1);

template <int D>
struct DkvGeo : hopper::Panels<D> {
  using P = hopper::Panels<D>;
  static constexpr int kKPanel = kTcKeys * P::kSW;     // one panel of K or V
  static constexpr int kKTile = kTcKeys * D * 2;
  static constexpr int kQPanel = kTcQueries * P::kSW;  // one panel of Q or dO
  static constexpr int kQTile = kTcQueries * D * 2;
  static constexpr int kStatOffset = 2 * kKTile + 2 * kTcStages * kQTile;
  static constexpr int kBarOffset = kStatOffset + kTcStages * 2 * kTcQueries * 4;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kTcStages + 1);
};

// One block owns 128 keys of one (batch*head); each consumer warpgroup
// computes the transposed products for its 64 keys, so every product's
// M is keys: S^T = K Q^T and dP^T = V dO^T (both operands K-major in
// shared memory), then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// rounded to T as register A fragments and dO, Q as MN-major B.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int tq,
                           int tk, int causal, float scale) {
  using G = DkvGeo<D>;
  using hopper::Wgmma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + G::kKTile;
  uint8_t* qdo_s = smem + 2 * G::kKTile;  // stage s: Q at 2s, dO at 2s + 1
  // stage s: lse * log2(e) at 2s, delta at 2s + 1 (kTcQueries floats each)
  float* stat_s = reinterpret_cast<float*>(smem + G::kStatOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + kTcStages;
  uint64_t* kv_bar = empty + kTcStages;

  const int ktile = blockIdx.x;  // tile 0 sees the most queries: first
  const int bh = blockIdx.y;
  const int n_qtiles = (tq + kTcQueries - 1) / kTcQueries;
  // Causal: the first query tile whose last query reaches this block's
  // first key; every earlier one is wholly above the diagonal.
  const int qt0 = causal ? min(ktile * kTcKeys / kTcQueries, n_qtiles) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], 128 * kTcConsumers);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTcConsumers) {
    // Producer: one warp. Its lanes stage lse and delta; lane 0 issues
    // the TMA loads.
    hopper::regs_dealloc<24>();
    if (threadIdx.x / 32 == 4 * kTcConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_arrive_tx(kv_bar, 2 * G::kKTile);
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(k_s + p * G::kKPanel, &kmap, kv_bar,
                              p * G::kPanelElems, ktile * kTcKeys, bh);
          hopper::tma_load_3d(v_s + p * G::kKPanel, &vmap, kv_bar,
                              p * G::kPanelElems, ktile * kTcKeys, bh);
        }
      }
      for (int qt = qt0; qt < n_qtiles; ++qt) {
        const int it = qt - qt0;
        const int s = it % kTcStages;
        hopper::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        float* stat = stat_s + 2 * s * kTcQueries;
        for (int r = lane; r < kTcQueries; r += 32) {
          const int q = qt * kTcQueries + r;
          const size_t at = static_cast<size_t>(bh) * tq + q;
          stat[r] = q < tq ? lse[at] * hopper::kLog2e : 0.f;
          stat[kTcQueries + r] = q < tq ? delta[at] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_tx(&full[s], 2 * G::kQTile);
          uint8_t* dst = qdo_s + 2 * s * G::kQTile;
          for (int p = 0; p < G::kPanels; ++p) {
            hopper::tma_load_3d(dst + p * G::kQPanel, &qmap, &full[s],
                                p * G::kPanelElems, qt * kTcQueries, bh);
            hopper::tma_load_3d(dst + G::kQTile + p * G::kQPanel, &domap,
                                &full[s], p * G::kPanelElems,
                                qt * kTcQueries, bh);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    hopper::regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_key = ktile * kTcKeys + wg * 64;
    const int key0 = first_key + 16 * warp + lane / 4;  // and key0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t k_base = hopper::smem_u32(k_s) + wg * 64 * G::kSW;
    const uint32_t v_base = hopper::smem_u32(v_s) + wg * 64 * G::kSW;
    const float scale_log2 = scale * hopper::kLog2e;

    float dk_acc[G::kPanels][G::kPanelElems / 2];
    float dv_acc[G::kPanels][G::kPanelElems / 2];
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;
    }

    hopper::mbar_wait(kv_bar, 0);
    for (int qt = qt0; qt < n_qtiles; ++qt) {
      const int it = qt - qt0;
      const int st = it % kTcStages;
      const int q_first = qt * kTcQueries;
      hopper::mbar_wait(&full[st], (it / kTcStages) & 1);
      if (causal && q_first + kTcQueries - 1 < first_key) {
        hopper::mbar_arrive(&empty[st]);  // above this warpgroup's diagonal
        continue;
      }
      const uint32_t q_base = hopper::smem_u32(qdo_s + 2 * st * G::kQTile);
      const uint32_t do_base = q_base + G::kQTile;

      float s[kTcQueries / 2];
      float dp[kTcQueries / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / G::kStepsPerPanel;
        const int off = (k % G::kStepsPerPanel) * 32;
        Wgmma<T, kTcQueries>::ss(
            s, hopper::smem_desc(k_base + p * G::kKPanel + off, G::kSW),
            hopper::smem_desc(q_base + p * G::kQPanel + off, G::kSW), k > 0);
      }
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / G::kStepsPerPanel;
        const int off = (k % G::kStepsPerPanel) * 32;
        Wgmma<T, kTcQueries>::ss(
            dp, hopper::smem_desc(v_base + p * G::kKPanel + off, G::kSW),
            hopper::smem_desc(do_base + p * G::kQPanel + off, G::kSW), k > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T = exp(scale s - lse[query]) and dS^T = P^T (dP^T - delta)
      // scale, each rounded to T as the A fragments of the updates.
      const float* lse_l2 = stat_s + 2 * st * kTcQueries;
      const float* dl = lse_l2 + kTcQueries;
      const bool masked = q_first + kTcQueries > tq ||
                          (causal && q_first < first_key + 63);
      uint32_t pa[kTcQueries / 16][4];
      uint32_t dsa[kTcQueries / 16][4];
#pragma unroll
      for (int j = 0; j < kTcQueries / 16; ++j) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * j + 2 * h + e;
            const int c = hopper::acc_col(i) + col0;
            float pr = exp2f(fmaf(s[i], scale_log2, -lse_l2[c]));
            if (masked) {
              const int q = q_first + c;
              const int key = key0 + hopper::acc_row(i);
              if (q >= tq || (causal && key > q)) pr = 0.f;
            }
            pv[e] = pr;
            dsv[e] = pr * (dp[i] - dl[c]) * scale;
          }
          pa[j][h] = hopper::pack2(pv[0], pv[1], T());
          dsa[j][h] = hopper::pack2(dsv[0], dsv[1], T());
        }
      }

#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::fence_regs(dk_acc[p]);
        hopper::fence_regs(dv_acc[p]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcQueries / 16; ++j) {
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          const int off = p * G::kQPanel + j * 16 * G::kSW;
          Wgmma<T, G::kPanelElems>::rs_mn(dv_acc[p], pa[j],
                                 hopper::smem_desc(do_base + off, G::kSW));
          Wgmma<T, G::kPanelElems>::rs_mn(dk_acc[p], dsa[j],
                                 hopper::smem_desc(q_base + off, G::kSW));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::fence_regs(dk_acc[p]);
        hopper::fence_regs(dv_acc[p]);
      }
      hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; i += 2) {
        const int key = key0 + hopper::acc_row(i);
        if (key < tk) {
          const size_t at = (static_cast<size_t>(bh) * tk + key) * D +
                            p * G::kPanelElems + hopper::acc_col(i) + col0;
          *reinterpret_cast<uint32_t*>(dk + at) =
              hopper::pack2(dk_acc[p][i], dk_acc[p][i + 1], T());
          *reinterpret_cast<uint32_t*>(dv + at) =
              hopper::pack2(dv_acc[p][i], dv_acc[p][i + 1], T());
        }
      }
    }
  }
}

// -- K3 for bf16/fp16: wgmma + TMA ----------------------------------------------

constexpr int kDqQueries = 128;  // queries per block (64 per consumer)
constexpr int kDqKeys = 64;      // keys per streamed tile

template <int D>
struct DqGeo : hopper::Panels<D> {
  using P = hopper::Panels<D>;
  static constexpr int kQPanel = kDqQueries * P::kSW;  // one panel of Q or dO
  static constexpr int kQTile = kDqQueries * D * 2;
  static constexpr int kKPanel = kDqKeys * P::kSW;     // one panel of K or V
  static constexpr int kKTile = kDqKeys * D * 2;
  static constexpr int kBarOffset = 2 * kQTile + 2 * kTcStages * kKTile;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kTcStages + 1);
};

// One block owns 128 queries of one (batch*head); each consumer
// warpgroup computes, for its 64 queries, S = Q K^T and dP = dO V^T (both
// operands K-major in shared memory), then dQ += dS K with dS rounded to
// T as the register A fragment and K read MN-major from the same tile.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, int tq, int tk, int causal,
                          float scale) {
  using G = DqGeo<D>;
  using hopper::Wgmma;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + G::kQTile;
  uint8_t* kv_s = smem + 2 * G::kQTile;  // stage s: K at 2s, V at 2s + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + kTcStages;
  uint64_t* qdo_bar = empty + kTcStages;

  const int n_qtiles = (tq + kDqQueries - 1) / kDqQueries;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  int n_ktiles = (tk + kDqKeys - 1) / kDqKeys;
  if (causal) {
    // Up to the key tile of the block's last query; later keys are
    // above every row's diagonal.
    const int last_query = min(qtile * kDqQueries + kDqQueries, tq) - 1;
    n_ktiles = min(n_ktiles, last_query / kDqKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * kTcConsumers);
    }
    hopper::mbar_init(qdo_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTcConsumers) {
    // Producer: one thread issues the TMA loads.
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 128 * kTcConsumers) {
      hopper::mbar_arrive_tx(qdo_bar, 2 * G::kQTile);
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::tma_load_3d(q_s + p * G::kQPanel, &qmap, qdo_bar,
                            p * G::kPanelElems, qtile * kDqQueries, bh);
        hopper::tma_load_3d(do_s + p * G::kQPanel, &domap, qdo_bar,
                            p * G::kPanelElems, qtile * kDqQueries, bh);
      }
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % kTcStages;
        hopper::mbar_wait(&empty[s], ((kt / kTcStages) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], 2 * G::kKTile);
        uint8_t* dst = kv_s + 2 * s * G::kKTile;
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(dst + p * G::kKPanel, &kmap, &full[s],
                              p * G::kPanelElems, kt * kDqKeys, bh);
          hopper::tma_load_3d(dst + G::kKTile + p * G::kKPanel, &vmap,
                              &full[s], p * G::kPanelElems, kt * kDqKeys, bh);
        }
      }
    }
  } else {
    hopper::regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_q = qtile * kDqQueries + wg * 64;
    const int q0 = first_q + 16 * warp + lane / 4;  // and q0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = hopper::smem_u32(q_s) + wg * 64 * G::kSW;
    const uint32_t do_base = hopper::smem_u32(do_s) + wg * 64 * G::kSW;
    const float scale_log2 = scale * hopper::kLog2e;
    // This warpgroup's rows are all past the sequence's end: it only
    // keeps the ring turning.
    const bool idle = first_q >= tq;

    // lse * log2(e) and delta of the thread's two rows, q0 and q0 + 8
    // (accumulator register i is in the second iff acc_row(i) is 8).
    float lse_l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 8 * r;
      const size_t at = static_cast<size_t>(bh) * tq + q;
      lse_l2[r] = q < tq ? lse[at] * hopper::kLog2e : 0.f;
      dl[r] = q < tq ? delta[at] : 0.f;
    }

    float dq_acc[G::kPanels][G::kPanelElems / 2];
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; ++i) dq_acc[p][i] = 0.f;
    }

    hopper::mbar_wait(qdo_bar, 0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int st = kt % kTcStages;
      const int k_first = kt * kDqKeys;
      hopper::mbar_wait(&full[st], (kt / kTcStages) & 1);
      if (idle || (causal && k_first > first_q + 63)) {
        hopper::mbar_arrive(&empty[st]);  // above this warpgroup's diagonal
        continue;
      }
      const uint32_t k_base = hopper::smem_u32(kv_s + 2 * st * G::kKTile);
      const uint32_t v_base = k_base + G::kKTile;

      float s[kDqKeys / 2];
      float dp[kDqKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / G::kStepsPerPanel;
        const int off = (k % G::kStepsPerPanel) * 32;
        Wgmma<T, kDqKeys>::ss(
            s, hopper::smem_desc(q_base + p * G::kQPanel + off, G::kSW),
            hopper::smem_desc(k_base + p * G::kKPanel + off, G::kSW), k > 0);
      }
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / G::kStepsPerPanel;
        const int off = (k % G::kStepsPerPanel) * 32;
        Wgmma<T, kDqKeys>::ss(
            dp, hopper::smem_desc(do_base + p * G::kQPanel + off, G::kSW),
            hopper::smem_desc(v_base + p * G::kKPanel + off, G::kSW), k > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P = exp(scale s - lse[query]) and dS = P (dP - delta) scale,
      // rounded to T as the A fragments of dQ += dS K: keys run along
      // the accumulator's columns, the K of that product.
      const bool masked = k_first + kDqKeys > tk ||
                          (causal && k_first + kDqKeys - 1 > first_q);
      uint32_t dsa[kDqKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * j + 2 * h + e;
            const int r = (i >> 1) & 1;
            float pr = exp2f(fmaf(s[i], scale_log2, -lse_l2[r]));
            if (masked) {
              const int key = k_first + hopper::acc_col(i) + col0;
              const int q = q0 + hopper::acc_row(i);
              if (key >= tk || (causal && key > q)) pr = 0.f;
            }
            dsv[e] = pr * (dp[i] - dl[r]) * scale;
          }
          dsa[j][h] = hopper::pack2(dsv[0], dsv[1], T());
        }
      }

#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) hopper::fence_regs(dq_acc[p]);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqKeys / 16; ++j) {
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          Wgmma<T, G::kPanelElems>::rs_mn(
              dq_acc[p], dsa[j],
              hopper::smem_desc(k_base + p * G::kKPanel + j * 16 * G::kSW,
                                G::kSW));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) hopper::fence_regs(dq_acc[p]);
      hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < G::kPanelElems / 2; i += 2) {
        const int q = q0 + hopper::acc_row(i);
        if (q < tq) {
          const size_t at = (static_cast<size_t>(bh) * tq + q) * D +
                            p * G::kPanelElems + hopper::acc_col(i) + col0;
          *reinterpret_cast<uint32_t*>(dq + at) =
              hopper::pack2(dq_acc[p][i], dq_acc[p][i + 1], T());
        }
      }
    }
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

template <int D>
int launch_dq_ffma(const Args& a, void* dq) {
  const int n_qtiles = (a.tq + Geo<D>::kRows - 1) / Geo<D>::kRows;
  flash_bwd_dq_kernel<D><<<dim3(n_qtiles, a.bh), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.tq, a.tk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq_wgmma(const Args& a, void* dq) {
  using G = DqGeo<D>;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!hopper::make_panel_map<T>(&qmap, a.q, a.bh, a.tq, D, kDqQueries, G::kSW) ||
      !hopper::make_panel_map<T>(&domap, a.dout, a.bh, a.tq, D, kDqQueries, G::kSW) ||
      !hopper::make_panel_map<T>(&kmap, a.k, a.bh, a.tk, D, kDqKeys, G::kSW) ||
      !hopper::make_panel_map<T>(&vmap, a.v, a.bh, a.tk, D, kDqKeys, G::kSW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_wgmma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (a.tq + kDqQueries - 1) / kDqQueries;
  kernel<<<dim3(n_qtiles, a.bh), kTcThreads, G::kSmem, a.stream>>>(
      qmap, kmap, vmap, domap, a.lse, a.delta, static_cast<T*>(dq), a.tq,
      a.tk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K3 by dtype: fp32 on FFMA, bf16/fp16 on the tensor cores.
template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_dq_ffma<D>(a, dq);
  } else {
    return launch_dq_wgmma<T, D>(a, dq);
  }
}

template <int D>
int launch_dkv_ffma(const Args& a, void* dk, void* dv) {
  const int n_ktiles = (a.tk + Geo<D>::kRows - 1) / Geo<D>::kRows;
  flash_bwd_dkv_kernel<D><<<dim3(n_ktiles, a.bh), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.tq,
      a.tk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  using G = DkvGeo<D>;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!hopper::make_panel_map<T>(&qmap, a.q, a.bh, a.tq, D, kTcQueries, G::kSW) ||
      !hopper::make_panel_map<T>(&domap, a.dout, a.bh, a.tq, D, kTcQueries, G::kSW) ||
      !hopper::make_panel_map<T>(&kmap, a.k, a.bh, a.tk, D, kTcKeys, G::kSW) ||
      !hopper::make_panel_map<T>(&vmap, a.v, a.bh, a.tk, D, kTcKeys, G::kSW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_wgmma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (a.tk + kTcKeys - 1) / kTcKeys;
  kernel<<<dim3(n_ktiles, a.bh), kTcThreads, G::kSmem, a.stream>>>(
      qmap, kmap, vmap, domap, a.lse, a.delta, static_cast<T*>(dk),
      static_cast<T*>(dv), a.tq, a.tk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K2 by dtype: fp32 on FFMA, bf16/fp16 on the tensor cores.
template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_dkv_ffma<D>(a, dk, dv);
  } else {
    return launch_dkv_wgmma<T, D>(a, dk, dv);
  }
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
