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
// T 2048, D 64, causal) the work is 4*B*H*T*T*D / 2 = 68.7 GFLOP against
// 134 MB of Q, K, V, O and LSE in bf16 (268 MB in fp32): hundreds of
// FLOP per byte, above the H100's ridge point, so arithmetic sets the
// least time: 0.070 ms at the 989 TFLOP/s bf16 tensor-core peak; in fp32
// 1.026 ms at the 67 TFLOP/s FFMA peak, or 0.416 ms for three TF32 passes
// at 495 TFLOP/s.
//
// Two kernels, chosen by dtype, both on the tensor cores:
//
// bf16/fp16: `flash_fwd_wgmma_kernel`.
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
// float32: `flash_fwd_3xtf32_kernel`, split TF32 ("3xTF32"). fp32 inputs
// are held to the JAX package's rtol 2e-4 / atol 2e-5, which one TF32
// pass (10 mantissa bits) misses. Each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), both truncations (hopper.cuh,
// tf32_split), and a.b = ah.bh + ah.bl + al.bh with fp32 accumulation:
// the dropped al.bl and lo's own truncation leave about 2^-20 of |a.b|
// per product, against fp32's 2^-24 and the tolerance's 2^-12. Three
// m64nNk8 TF32 passes at 495 TFLOP/s are still 2.5x the FFMA rate.
// - tf32 wgmma reads both shared-memory operands K-major only (the
//   transpose bits exist for 16-bit types alone), and the TMA cannot
//   transpose 4-byte elements. So a pre-pass (`flash_split_tf32_kernel`,
//   hopper.cuh) writes, once per call, V^T as hi and lo (bh, D, keys)
//   into a workspace the wrapper allocates: 2x the bytes of V moved
//   before the kernel starts. Q and K need no transpose and are split in
//   shared memory: Q once per block by the consumers, each K tile by
//   three warps of the producer warpgroup (hi in place, lo beside it),
//   one tile ahead of the consumers, who wait for a third mbarrier per
//   stage (`ready`).
// - S = Qh Kl + Ql Kh + Qh Kh is wgmma ss (m64n64k8; m64n32k8 at D 128),
//   and O += Pl Vh + Ph Vl + Ph Vh is wgmma rs (m64nDk8) with P split in
//   registers per tile. A k8 step's accumulator registers hold keys
//   2t, 2t+1 of each group of 8 where the tf32 A fragment wants columns
//   t, t+4: taking them in the order {0, 2, 1, 3} reorders the keys
//   within the group, and the pre-pass writes V^T's keys in the same
//   order (tf32_perm), so the product is unchanged and P never leaves
//   its registers.
// - Shared memory: Q hi/lo for the block plus a two-stage ring of K
//   hi/lo (the TMA writes K raw) and V^T hi/lo; tiles of 64 keys, 192 KB
//   at D 64 (one block an SM, two consumer warpgroups of 64 rows and a
//   producer). At D 128 one consumer warpgroup of 64 rows and tiles of 32
//   keys keep it at 192 KB; D 32 takes 96 KB. Causal skipping, masking,
//   the longest-first order and the softmax are the bf16 kernel's.
//
// Both kernels' tiles are independent of the op's block_q/block_k
// arguments, which keep only their divisibility contract.
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as in the TPU kernel
constexpr float kLn2 = 0.6931471805599453f;

// -- float32: split-TF32 wgmma + TMA ------------------------------------------------

template <int D>
struct F32FwdGeo {
  static constexpr int kConsumers = D == 128 ? 1 : 2;  // 64 query rows each
  static constexpr int kRows = 64 * kConsumers;         // query rows per block
  static constexpr int kKeys = D == 128 ? 32 : 64;      // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 32;                // 128-byte panels a row
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kQTile = kRows * D * 4;          // Q hi or lo
  static constexpr int kKPanel = kKeys * 128;
  static constexpr int kKTile = kKeys * D * 4;          // K hi/lo, V^T hi/lo
  static constexpr int kVtPanel = D * 128;              // 32 keys of V^T
  static constexpr int kStage = 4 * kKTile;             // K hi, lo, V^T hi, lo
  static constexpr int kBarOffset = 2 * kQTile + kStages * kStage;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (3 * kStages + 1);
};

// K1 for float32. The block's query rows are split once in shared
// memory and each K tile as it lands; V^T (hi, lo, keys in tf32_perm
// order) comes from the pre-pass. S = Qh Kl + Ql Kh + Qh Kh and O += Pl Vh
// + Ph Vl + Ph Vh, P split in registers per tile.
template <int D>
__global__ void __launch_bounds__(F32FwdGeo<D>::kThreads, 1)
flash_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vthmap,
                        const __grid_constant__ CUtensorMap vtlmap,
                        float* __restrict__ o, float* __restrict__ lse,
                        int tq, int tk, int causal, float scale_log2) {
  using G = F32FwdGeo<D>;
  using W = hopper::WgmmaTf32<G::kKeys>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qh_s = smem;
  uint8_t* ql_s = smem + G::kQTile;
  uint8_t* kv_s = smem + 2 * G::kQTile;  // stage s at s * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + G::kStages;
  uint64_t* ready = empty + G::kStages;  // the K tile is split
  uint64_t* q_bar = ready + G::kStages;

  const int n_qtiles = (tq + G::kRows - 1) / G::kRows;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  int n_ktiles = (tk + G::kKeys - 1) / G::kKeys;
  if (causal) {
    n_ktiles = min(n_ktiles, (qtile * G::kRows + G::kRows - 1) / G::kKeys + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * G::kConsumers);
      hopper::mbar_init(&ready[s], 96);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {
    // Producer: one thread issues every load; warps 1-3 split each K
    // tile once it lands, while the consumers compute the tile before.
    if constexpr (G::kConsumers > 1) hopper::regs_dealloc<40>();
    const int ptid = threadIdx.x - 128 * G::kConsumers;
    if (ptid == 0) {
      hopper::mbar_arrive_tx(q_bar, G::kQTile);
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::tma_load_3d(qh_s + p * G::kQPanel, &qmap, q_bar, p * 32,
                            qtile * G::kRows, bh);
      }
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % G::kStages;
        hopper::mbar_wait(&empty[s], ((kt / G::kStages) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], 3 * G::kKTile);
        uint8_t* dst = kv_s + s * G::kStage;
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(dst + p * G::kKPanel, &kmap, &full[s], p * 32,
                              kt * G::kKeys, bh);
        }
        for (int p = 0; p < G::kKeys / 32; ++p) {
          hopper::tma_load_3d(dst + 2 * G::kKTile + p * G::kVtPanel, &vthmap,
                              &full[s], kt * G::kKeys + p * 32, 0, bh);
          hopper::tma_load_3d(dst + 3 * G::kKTile + p * G::kVtPanel, &vtlmap,
                              &full[s], kt * G::kKeys + p * 32, 0, bh);
        }
      }
    } else if (ptid >= 32) {
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % G::kStages;
        hopper::mbar_wait(&full[s], (kt / G::kStages) & 1);
        uint4* h = reinterpret_cast<uint4*>(kv_s + s * G::kStage);
        uint4* l = reinterpret_cast<uint4*>(kv_s + s * G::kStage + G::kKTile);
        for (int i = ptid - 32; i < G::kKTile / 16; i += 96) {
          hopper::tf32_split4(h + i, l + i);
        }
        hopper::fence_proxy_async();  // the wgmma reads what was written
        hopper::mbar_arrive(&ready[s]);
      }
    }
  } else {
    if constexpr (G::kConsumers > 1) hopper::regs_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_row = qtile * G::kRows + wg * 64;
    const int row0 = first_row + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t qh_base = hopper::smem_u32(qh_s) + wg * 64 * 128;
    const uint32_t ql_base = hopper::smem_u32(ql_s) + wg * 64 * 128;

    float s[G::kKeys / 2];
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

    hopper::mbar_wait(q_bar, 0);
    hopper::split_rows<G::kPanels, G::kQPanel>(qh_s, ql_s, wg, tid);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int st = kt % G::kStages;
      const int k_first = kt * G::kKeys;
      hopper::mbar_wait(&full[st], (kt / G::kStages) & 1);
      hopper::mbar_wait(&ready[st], (kt / G::kStages) & 1);
      if (causal && k_first > first_row + 63) {
        hopper::mbar_arrive(&empty[st]);  // above this warpgroup's diagonal
        continue;
      }
      const uint32_t kh_base = hopper::smem_u32(kv_s + st * G::kStage);
      const uint32_t kl_base = kh_base + G::kKTile;
      const uint32_t vh_base = kh_base + 2 * G::kKTile;
      const uint32_t vl_base = kh_base + 3 * G::kKTile;

      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const int qoff = (k / 4) * G::kQPanel + (k % 4) * 32;
        const int koff = (k / 4) * G::kKPanel + (k % 4) * 32;
        const uint64_t qh = hopper::smem_desc(qh_base + qoff, 128);
        const uint64_t kh = hopper::smem_desc(kh_base + koff, 128);
        W::ss(s, qh, hopper::smem_desc(kl_base + koff, 128), k > 0);
        W::ss(s, hopper::smem_desc(ql_base + qoff, 128), kh, 1);
        W::ss(s, qh, kh, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);

      const bool masked = k_first + G::kKeys > tk ||
                          (causal && k_first + G::kKeys - 1 > first_row);
      if (masked) {
#pragma unroll
        for (int i = 0; i < G::kKeys / 2; ++i) {
          const int key = k_first + col0 + hopper::acc_col(i);
          const int row = row0 + hopper::acc_row(i);
          s[i] = key < tk && !(causal && key > row) ? s[i] * scale_log2
                                                    : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < G::kKeys / 2; ++i) s[i] *= scale_log2;
      }
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < G::kKeys / 2; ++i) {
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
      // P, split, as the A fragments of O += P V: accumulator registers
      // 4j..4j+3 taken in the order {0, 2, 1, 3} (hopper.cuh, tf32_perm).
      uint32_t ph[G::kKeys / 8][4], pl[G::kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < G::kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + ((e & 1) << 1) + (e >> 1);
          const float p = exp2f(s[i] - m[(i >> 1) & 1]);
          l[(i >> 1) & 1] += p;
          hopper::tf32_split(p, ph[j][e], pl[j][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < G::kKeys / 8; ++j) {
        const int off = (j / 4) * G::kVtPanel + (j % 4) * 32;
        const uint64_t vh = hopper::smem_desc(vh_base + off, 128);
        hopper::WgmmaTf32<D>::rs(acc, pl[j], vh);
        hopper::WgmmaTf32<D>::rs(acc, ph[j],
                                 hopper::smem_desc(vl_base + off, 128));
        hopper::WgmmaTf32<D>::rs(acc, ph[j], vh);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
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
    for (int i = 0; i < D / 2; i += 2) {
      const int row = row0 + hopper::acc_row(i);
      if (row < tq) {
        const int r = (i >> 1) & 1;
        *reinterpret_cast<float2*>(
            o + (static_cast<size_t>(bh) * tq + row) * D + hopper::acc_col(i) +
            col0) = make_float2(acc[i] * inv[r], acc[i + 1] * inv[r]);
      }
    }
  }
}

// Workspace of the fp32 route in floats: V^T hi and lo, (bh, D, tk
// rounded up to 8).
size_t f32_workspace(int bh, int tk, int d) {
  return 2 * static_cast<size_t>(bh) * d * hopper::split_pad(tk);
}

template <int D>
int launch_3xtf32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int tq, int tk, int causal, float scale,
                  void* workspace, cudaStream_t stream) {
  using G = F32FwdGeo<D>;
  const int tk_pad = hopper::split_pad(tk);
  float* vth = static_cast<float*>(workspace);
  float* vtl = vth + static_cast<size_t>(bh) * D * tk_pad;
  int err = hopper::launch_split_tf32<D>(v, nullptr, nullptr, vth, vtl, bh, tk,
                                         stream);
  if (err != 0) return err;
  CUtensorMap qmap, kmap, vthmap, vtlmap;
  if (!hopper::make_panel_map<float>(&qmap, q, bh, tq, D, G::kRows, 128) ||
      !hopper::make_panel_map<float>(&kmap, k, bh, tk, D, G::kKeys, 128) ||
      !hopper::make_panel_map<float>(&vthmap, vth, bh, D, tk_pad, D, 128) ||
      !hopper::make_panel_map<float>(&vtlmap, vtl, bh, D, tk_pad, D, 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_3xtf32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((tq + G::kRows - 1) / G::kRows, bh);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      qmap, kmap, vthmap, vtlmap, static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale * hopper::kLog2e);
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
               float scale, void*, cudaStream_t stream) {
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
                      float scale, void* ws, cudaStream_t stream) {
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 32: return launch_3xtf32<32>(q, k, v, o, lse, bh, tq, tk, causal, scale, ws, stream);
    case 64: return launch_3xtf32<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, ws, stream);
    case 128: return launch_3xtf32<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, ws, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of scratch that flash_attention_fwd needs for these arguments:
// the fp32 route's split V^T (0 for bf16/fp16).
extern "C" size_t flash_attention_fwd_workspace(int bh, int tq, int tk, int d,
                                                int dtype) {
  (void)tq;
  return dtype == 0 ? 4 * f32_workspace(bh, tk, d) : 0;
}

// q, k, v: (bh, tq|tk, d) contiguous, 16-byte aligned; o like q; lse
// (bh, tq) fp32. dtype: 0 float32 (split-TF32 kernel, after its pre-pass
// into `workspace`, flash_attention_fwd_workspace bytes, 16-byte aligned),
// 1 bfloat16, 2 float16 (wgmma kernel; workspace unused). Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int bh, int tq, int tk, int d, int dtype,
                                   int causal, float scale, void* workspace,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, workspace, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, workspace, s);
    case 2: return dispatch_d<__half>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, workspace, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
