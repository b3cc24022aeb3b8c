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
// T 2048, D 64, causal), K2 does 8*B*H*T*T*D/2 = 137 GFLOP and K3
// 6*B*H*T*T*D/2 = 103 GFLOP against about 170 MB and 130 MB of
// inputs/outputs in bf16 (twice that in fp32): far above the H100's
// ridge point, so arithmetic sets the least time: 0.139 ms and 0.104 ms
// at the 989 TFLOP/s bf16 tensor-core peak; in fp32 2.05 and 1.54 ms at
// the 67 TFLOP/s FFMA peak, or 0.833 and 0.625 ms for three TF32 passes
// at 495 TFLOP/s.
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
// K2 for float32 (`flash_bwd_dkv_3xtf32_kernel`) is K2's structure in
// split TF32 ("3xTF32", flash_attention_fwd.cu and hopper.cuh give the
// error argument: about 2^-20 of |a.b| per product against the
// tolerance's 2^-12). Every product is three TF32 passes: S^T = K Q^T
// and dP^T = V dO^T as Kh Ql + Kl Qh + Kh Qh, the updates as
// dV += Pl^T dO_h + Ph^T dO_l + Ph^T dO_h and likewise dK.
// - tf32 wgmma takes its shared-memory operands K-major only, so the
//   updates need dO^T and Q^T (D rows, queries contiguous) where the
//   first products need Q and dO as rows. The pre-pass
//   (`flash_split_tf32_kernel`) writes both forms of Q and dO, hi and lo,
//   once per call into a workspace the wrapper allocates: it reads Q
//   and dO once and writes each four times (about 0.24 ms of a 2.0 ms
//   call at the training shape on an H100, PERF.md). The transposed
//   forms hold their queries in tf32_perm order within each group of 8,
//   so the accumulator registers of S^T and dP^T, taken in the order
//   {0, 2, 1, 3}, are the A fragments of the updates (as P in the
//   forward). V is split once per block in shared memory.
// - What bounds it: the N of S^T and dP^T is the query tile. An ss
//   m64nNk8 re-reads its 2 KB A tile (64 keys x 8) from shared memory
//   for 64*N*8*2 FLOP, and shared memory holds K and V hi/lo (128 KB for
//   128 keys at D 64) besides the stages of eight tiles. So up to D 64
//   the block's K lives in registers as S^T's A fragments (hi and lo,
//   64 a thread; S^T is wgmma rs and reads only Q from shared memory).
//   K is staged raw in the first stage's buffer, split into registers,
//   and released (mbarrier k_free) before the ring starts. That leaves
//   room for 32-query tiles: 128 keys (two consumer warpgroups of 64),
//   V hi/lo resident (64 KB at D 64), two stages of 64 KB, 192 KB, one
//   block an SM; D 32 takes 96 KB. dP^T still reads V from shared
//   memory (V in registers too would need more than 240 registers a
//   thread). At D 128 K stays in shared memory (its fragments would
//   take 128 registers): 64 keys (one consumer warpgroup), K and V
//   hi/lo resident (128 KB), one stage of 16 queries (64 KB), 192 KB.
//   Overlapping a tile's updates with the next tile's first products
//   was tried and is slower (the stage is released a tile later).
//
// K3 for float32 (`flash_bwd_dq_3xtf32_kernel`) is K3's structure in
// split TF32, as K2's is: S = Q K^T as Qh Kl + Ql Kh + Qh Kh, dP = dO V^T
// likewise, and dQ += dSl Kh + dSh Kl + dSh Kh with dS split in
// registers per tile, all accumulated in fp32 and dQ written once.
// - The B operand of dQ += dS K is K with the keys (that product's K)
//   contiguous: K^T, which tf32 wgmma cannot read from K's rows and the
//   TMA cannot transpose. The pre-pass (`flash_split_tf32_kernel`) writes
//   K^T hi and lo once per call (bh, D, keys), the keys in tf32_perm
//   order within each group of 8, so the accumulator registers of S and
//   dP taken {0, 2, 1, 3} are dS's A fragments: it reads K once and
//   writes it twice. K and V rows need no transpose: three warps of the
//   producer warpgroup split each K and V tile in shared memory as it
//   lands (hi in place, lo beside it), while the consumers compute the
//   tile before, behind a third mbarrier per stage (`ready`), as K1
//   splits K.
// - What bounds it: 6*B*H*T*T*D/2 = 103 GFLOP at the training shape, in
//   three TF32 passes 0.625 ms at 495 TFLOP/s (1.54 ms for one FFMA pass
//   at 67). An ss m64nNk8 re-reads its 2 KB A tile from shared memory for
//   64*N*8*2 FLOP, so with 32-key tiles S and dP as ss would ask shared
//   memory for more bytes a cycle than it gives. Up to D 64 the block's Q
//   and dO therefore live in registers as the A fragments of S and dP
//   (hi and lo, 2*D registers a thread; both are wgmma rs, and shared
//   memory serves only B operands), split once from the raw rows the TMA
//   staged. Two consumer warpgroups of 64 queries (128 a block), tiles of
//   32 keys (S and dP 16 accumulator registers each, dQ D/2), three
//   stages of K, V and K^T, each hi and lo (48 KB at D 64), beside the
//   64 KB of staged Q and dO: 208 KB, one block an SM; D 32 takes half.
//   With dO hi/lo resident in shared memory and dP as ss instead, the
//   kernel was slower at the training shape (PERF.md). At D 128 the
//   fragments of Q alone would take 128 registers beside the 64 of the
//   dQ accumulator: one consumer warpgroup of 64 queries, Q and dO hi/lo
//   resident in shared memory (128 KB, both products ss), two stages of
//   16 keys (48 KB each): 224 KB.
// - Causal skipping, the longest-first order, the lse and delta of the
//   thread's rows held in registers, masking as selects and the ragged
//   ends (rows past T zero-filled by the TMA, masked here) are the bf16
//   K3's. It takes the split-TF32 forward's LSE and delta as they are.
#include <type_traits>

#include "hopper.cuh"

namespace {

// -- K2 for float32: split-TF32 wgmma + TMA ---------------------------------------

template <int D>
struct F32DkvGeo {
  static constexpr int kConsumers = D == 128 ? 1 : 2;  // 64 keys each
  static constexpr int kKeys = 64 * kConsumers;         // keys per block
  // Up to D 64 K's A fragments live in registers, K is only staged in
  // shared memory (in the first stage, before the ring starts), and the
  // room goes to 32-query tiles.
  static constexpr bool kKRegs = D <= 64;
  static constexpr int kQueries = kKRegs ? 32 : 16;     // queries per tile
  static constexpr int kStages = kKRegs ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 32;                // 128-byte panels a row
  static constexpr int kKPanel = kKeys * 128;
  static constexpr int kKTile = kKeys * D * 4;          // K or V, hi or lo
  static constexpr int kQPanel = kQueries * 128;
  static constexpr int kQTile = kQueries * D * 4;       // one streamed operand
  static constexpr int kTSW = kQueries * 4;  // a transposed tile's row bytes
  // A stage: Q hi, Q lo, dO hi, dO lo (rows of D), then Q^T hi, Q^T lo,
  // dO^T hi, dO^T lo (D rows of kQueries), kQTile bytes each.
  static constexpr int kStage = 8 * kQTile;
  // Resident: V hi and lo, and K hi and lo where K stays in shared memory.
  static constexpr int kResident = (kKRegs ? 2 : 4) * kKTile;
  static constexpr int kStatOffset = kResident + kStages * kStage;
  static constexpr int kBarOffset = kStatOffset + kStages * 2 * kQueries * 4;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 2);
};

// K2 for float32. The block's V is split once in shared memory, its K
// in registers (up to D 64) or in shared memory (D 128); Q
// and dO arrive from the pre-pass split (hi, lo) both as rows (the B of
// S^T = K Q^T and dP^T = V dO^T) and transposed with queries in tf32_perm
// order (the B of dV += P^T dO and dK += dS^T Q); P^T and dS^T are split
// in registers.
template <int D>
__global__ void __launch_bounds__(F32DkvGeo<D>::kThreads, 1)
flash_bwd_dkv_3xtf32_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap qhmap,
                            const __grid_constant__ CUtensorMap qlmap,
                            const __grid_constant__ CUtensorMap dohmap,
                            const __grid_constant__ CUtensorMap dolmap,
                            const __grid_constant__ CUtensorMap qthmap,
                            const __grid_constant__ CUtensorMap qtlmap,
                            const __grid_constant__ CUtensorMap dothmap,
                            const __grid_constant__ CUtensorMap dotlmap,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int tq, int tk, int causal, float scale) {
  using G = F32DkvGeo<D>;
  using W = hopper::WgmmaTf32<G::kQueries>;
  using U = hopper::WgmmaTf32<D>;
  constexpr int kQ = G::kQueries;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* v_s = smem;  // V hi, V lo, then K hi, K lo: kKTile each
  uint8_t* st_s = smem + G::kResident;  // stage s at s * kStage
  uint8_t* k_s = G::kKRegs ? st_s : smem + 2 * G::kKTile;
  // stage s: lse * log2(e) at 2s, delta at 2s + 1 (kQueries floats each)
  float* stat_s = reinterpret_cast<float*>(smem + G::kStatOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + G::kStages;
  uint64_t* kv_bar = empty + G::kStages;
  uint64_t* k_free = kv_bar + 1;  // K's staging area may be refilled

  const int ktile = blockIdx.x;  // tile 0 sees the most queries: first
  const int bh = blockIdx.y;
  const int n_qtiles = (tq + kQ - 1) / kQ;
  // Causal: the first query tile whose last query reaches this block's
  // first key; every earlier one is wholly above the diagonal.
  const int qt0 = causal ? min(ktile * G::kKeys / kQ, n_qtiles) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], 128 * G::kConsumers);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init(k_free, 128 * G::kConsumers);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {
    // Producer: one warp. Its lanes stage lse and delta; lane 0 issues
    // the TMA loads.
    if constexpr (G::kConsumers > 1) hopper::regs_dealloc<24>();
    if (threadIdx.x / 32 == 4 * G::kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_arrive_tx(kv_bar, 2 * G::kKTile);
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(k_s + p * G::kKPanel, &kmap, kv_bar, p * 32,
                              ktile * G::kKeys, bh);
          hopper::tma_load_3d(v_s + p * G::kKPanel, &vmap, kv_bar, p * 32,
                              ktile * G::kKeys, bh);
        }
      }
      if constexpr (G::kKRegs) hopper::mbar_wait(k_free, 0);
      for (int qt = qt0; qt < n_qtiles; ++qt) {
        const int it = qt - qt0;
        const int s = it % G::kStages;
        hopper::mbar_wait(&empty[s], ((it / G::kStages) & 1) ^ 1);
        float* stat = stat_s + 2 * s * kQ;
        if (lane < kQ) {
          const int q = qt * kQ + lane;
          const size_t at = static_cast<size_t>(bh) * tq + q;
          stat[lane] = q < tq ? lse[at] * hopper::kLog2e : 0.f;
          stat[kQ + lane] = q < tq ? delta[at] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_tx(&full[s], G::kStage);
          uint8_t* dst = st_s + s * G::kStage;
          const int q0 = qt * kQ;
          for (int p = 0; p < G::kPanels; ++p) {
            const int off = p * G::kQPanel;
            hopper::tma_load_3d(dst + off, &qhmap, &full[s], p * 32, q0, bh);
            hopper::tma_load_3d(dst + G::kQTile + off, &qlmap, &full[s],
                                p * 32, q0, bh);
            hopper::tma_load_3d(dst + 2 * G::kQTile + off, &dohmap, &full[s],
                                p * 32, q0, bh);
            hopper::tma_load_3d(dst + 3 * G::kQTile + off, &dolmap, &full[s],
                                p * 32, q0, bh);
          }
          hopper::tma_load_3d(dst + 4 * G::kQTile, &qthmap, &full[s], q0, 0,
                              bh);
          hopper::tma_load_3d(dst + 5 * G::kQTile, &qtlmap, &full[s], q0, 0,
                              bh);
          hopper::tma_load_3d(dst + 6 * G::kQTile, &dothmap, &full[s], q0, 0,
                              bh);
          hopper::tma_load_3d(dst + 7 * G::kQTile, &dotlmap, &full[s], q0, 0,
                              bh);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    if constexpr (G::kConsumers > 1) hopper::regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_key = ktile * G::kKeys + wg * 64;
    const int key0 = first_key + 16 * warp + lane / 4;  // and key0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t kh_base = hopper::smem_u32(k_s) + wg * 64 * 128;
    const uint32_t kl_base = kh_base + G::kKTile;
    const uint32_t vh_base = hopper::smem_u32(v_s) + wg * 64 * 128;
    const uint32_t vl_base = vh_base + G::kKTile;
    const float scale_log2 = scale * hopper::kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hopper::mbar_wait(kv_bar, 0);
    hopper::split_rows<G::kPanels, G::kKPanel>(v_s, v_s + G::kKTile, wg, tid);
    // Up to D 64, K's hi and lo stay in registers as the A fragments of
    // S^T = K Q^T, split from the raw K staged in the first stage's
    // buffer, which is then released to the producer.
    constexpr bool kKRegs = G::kKRegs;
    constexpr int kKSteps = kKRegs ? D / 8 : 1;
    uint32_t kfh[kKSteps][4], kfl[kKSteps][4];
    if constexpr (!kKRegs) {
      hopper::split_rows<G::kPanels, G::kKPanel>(k_s, k_s + G::kKTile, wg,
                                                 tid);
    } else {
#pragma unroll
      for (int k = 0; k < kKSteps; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wg * 64 + 16 * warp + lane / 4 + 8 * (e & 1);
          const int col = 8 * k + lane % 4 + 4 * (e >> 1);
          const int at = (col / 32) * G::kKPanel + row * 128 +
                         ((((col % 32) / 4) ^ (row & 7)) << 4) + (col % 4) * 4;
          hopper::tf32_split(*reinterpret_cast<const float*>(k_s + at),
                             kfh[k][e], kfl[k][e]);
        }
      }
      hopper::mbar_arrive(k_free);
    }
    for (int qt = qt0; qt < n_qtiles; ++qt) {
      const int it = qt - qt0;
      const int st = it % G::kStages;
      const int q_first = qt * kQ;
      hopper::mbar_wait(&full[st], (it / G::kStages) & 1);
      if (causal && q_first + kQ - 1 < first_key) {
        hopper::mbar_arrive(&empty[st]);  // above this warpgroup's diagonal
        continue;
      }
      const uint32_t qh_base = hopper::smem_u32(st_s + st * G::kStage);
      const uint32_t ql_base = qh_base + G::kQTile;
      const uint32_t doh_base = qh_base + 2 * G::kQTile;
      const uint32_t dol_base = qh_base + 3 * G::kQTile;
      const uint32_t qth_base = qh_base + 4 * G::kQTile;
      const uint32_t qtl_base = qh_base + 5 * G::kQTile;
      const uint32_t doth_base = qh_base + 6 * G::kQTile;
      const uint32_t dotl_base = qh_base + 7 * G::kQTile;

      float s[kQ / 2], dp[kQ / 2];
      if constexpr (kKRegs) {
#pragma unroll
        for (int i = 0; i < kQ / 2; ++i) s[i] = 0.f;
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const int boff = (k / 4) * G::kQPanel + (k % 4) * 32;
        const uint64_t qh = hopper::smem_desc(qh_base + boff, 128);
        const uint64_t ql = hopper::smem_desc(ql_base + boff, 128);
        if constexpr (kKRegs) {
          W::rs(s, kfh[k], ql);
          W::rs(s, kfl[k], qh);
          W::rs(s, kfh[k], qh);
        } else {
          const int aoff = (k / 4) * G::kKPanel + (k % 4) * 32;
          const uint64_t kh = hopper::smem_desc(kh_base + aoff, 128);
          W::ss(s, kh, ql, k > 0);
          W::ss(s, hopper::smem_desc(kl_base + aoff, 128), qh, 1);
          W::ss(s, kh, qh, 1);
        }
      }
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const int aoff = (k / 4) * G::kKPanel + (k % 4) * 32;
        const int boff = (k / 4) * G::kQPanel + (k % 4) * 32;
        const uint64_t vh = hopper::smem_desc(vh_base + aoff, 128);
        const uint64_t doh = hopper::smem_desc(doh_base + boff, 128);
        W::ss(dp, vh, hopper::smem_desc(dol_base + boff, 128), k > 0);
        W::ss(dp, hopper::smem_desc(vl_base + aoff, 128), doh, 1);
        W::ss(dp, vh, doh, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T = exp(scale s - lse[query]) and dS^T = P^T (dP^T - delta)
      // scale, split as the A fragments of the updates: accumulator
      // registers 4j..4j+3 in the order {0, 2, 1, 3} (hopper.cuh).
      const float* lse_l2 = stat_s + 2 * st * kQ;
      const float* dl = lse_l2 + kQ;
      const bool masked = q_first + kQ > tq ||
                          (causal && q_first < first_key + 63);
      uint32_t ph[kQ / 8][4], pl[kQ / 8][4], dsh[kQ / 8][4], dsl[kQ / 8][4];
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + ((e & 1) << 1) + (e >> 1);
          const int c = hopper::acc_col(i) + col0;
          const int q = q_first + c;
          const int key = key0 + hopper::acc_row(i);
          // A select, not a branch: the A fragments below must not be
          // written on a divergent path, or ptxas serializes the wgmmas.
          const bool live = !masked || (q < tq && !(causal && key > q));
          const float pr =
              live ? exp2f(fmaf(s[i], scale_log2, -lse_l2[c])) : 0.f;
          hopper::tf32_split(pr, ph[j][e], pl[j][e]);
          hopper::tf32_split(pr * (dp[i] - dl[c]) * scale, dsh[j][e],
                             dsl[j][e]);
        }
      }

      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        const uint64_t doth = hopper::smem_desc(doth_base + j * 32, G::kTSW);
        const uint64_t qth = hopper::smem_desc(qth_base + j * 32, G::kTSW);
        U::rs(dv_acc, pl[j], doth);
        U::rs(dv_acc, ph[j], hopper::smem_desc(dotl_base + j * 32, G::kTSW));
        U::rs(dv_acc, ph[j], doth);
        U::rs(dk_acc, dsl[j], qth);
        U::rs(dk_acc, dsh[j], hopper::smem_desc(qtl_base + j * 32, G::kTSW));
        U::rs(dk_acc, dsh[j], qth);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int key = key0 + hopper::acc_row(i);
      if (key < tk) {
        const size_t at = (static_cast<size_t>(bh) * tk + key) * D +
                          hopper::acc_col(i) + col0;
        *reinterpret_cast<float2*>(dk + at) = make_float2(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<float2*>(dv + at) = make_float2(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// -- K3 for float32: split-TF32 wgmma + TMA ---------------------------------------

template <int D>
struct F32DqGeo {
  // Up to D 64 the block's Q and dO live in registers as the A fragments
  // of S and dP; at D 128 they stay in shared memory.
  static constexpr bool kQRegs = D <= 64;
  static constexpr int kConsumers = kQRegs ? 2 : 1;     // 64 queries each
  static constexpr int kRows = 64 * kConsumers;         // queries per block
  static constexpr int kKeys = kQRegs ? 32 : 16;        // keys per tile
  static constexpr int kStages = kQRegs ? 3 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kPanels = D / 32;                // 128-byte panels a row
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kQTile = kRows * D * 4;          // Q or dO, hi or lo
  static constexpr int kKPanel = kKeys * 128;
  static constexpr int kKTile = kKeys * D * 4;          // one operand of a stage
  static constexpr int kTSW = kKeys * 4;  // a K^T row's bytes (its swizzle)
  // A stage: K hi, K lo, V hi, V lo (rows of D), then K^T hi, K^T lo (D
  // rows of kKeys), kKTile bytes each.
  static constexpr int kStage = 6 * kKTile;
  // Resident: dO and Q as the TMA writes them, split into registers
  // once (up to D 64); or dO hi, dO lo, Q hi, Q lo (D 128).
  static constexpr int kResident = (kQRegs ? 2 : 4) * kQTile;
  static constexpr int kBarOffset = kResident + kStages * kStage;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (3 * kStages + 1);
};

// K3 for float32. The block's Q and dO are split once, into registers
// (up to D 64) or in shared memory (D 128); each K and V tile is split in
// shared memory as it lands, by the producer's split warps; K^T (hi, lo,
// keys in tf32_perm order) comes from the pre-pass. S = Q K^T and
// dP = dO V^T, then dQ += dS K with dS split in registers.
template <int D>
__global__ void __launch_bounds__(F32DqGeo<D>::kThreads, 1)
flash_bwd_dq_3xtf32_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap kthmap,
                           const __grid_constant__ CUtensorMap ktlmap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int tq, int tk, int causal,
                           float scale) {
  using G = F32DqGeo<D>;
  using W = hopper::WgmmaTf32<G::kKeys>;
  using U = hopper::WgmmaTf32<D>;
  constexpr int kK = G::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* do_s = smem;  // dO (hi, then lo at D 128): kQTile each
  uint8_t* q_s = smem + (G::kQRegs ? 1 : 2) * G::kQTile;  // Q likewise
  uint8_t* st_s = smem + G::kResident;  // stage s at s * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + G::kStages;
  uint64_t* ready = empty + G::kStages;  // the K and V tiles are split
  uint64_t* qdo_bar = ready + G::kStages;

  const int n_qtiles = (tq + G::kRows - 1) / G::kRows;
  const int qtile = n_qtiles - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  int n_ktiles = (tk + kK - 1) / kK;
  if (causal) {
    // Up to the key tile of the block's last query; later keys are
    // above every row's diagonal.
    const int last_query = min(qtile * G::kRows + G::kRows, tq) - 1;
    n_ktiles = min(n_ktiles, last_query / kK + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * G::kConsumers);
      hopper::mbar_init(&ready[s], 96);
    }
    hopper::mbar_init(qdo_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {
    // Producer: one thread starts every load; warps 1-3 split each K and
    // V tile once it lands, while the consumers compute the tile before.
    if constexpr (G::kConsumers > 1) hopper::regs_dealloc<40>();
    const int ptid = threadIdx.x - 128 * G::kConsumers;
    if (ptid == 0) {
      hopper::mbar_arrive_tx(qdo_bar, 2 * G::kQTile);
      for (int p = 0; p < G::kPanels; ++p) {
        hopper::tma_load_3d(do_s + p * G::kQPanel, &domap, qdo_bar, p * 32,
                            qtile * G::kRows, bh);
        hopper::tma_load_3d(q_s + p * G::kQPanel, &qmap, qdo_bar, p * 32,
                            qtile * G::kRows, bh);
      }
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % G::kStages;
        hopper::mbar_wait(&empty[s], ((kt / G::kStages) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], 4 * G::kKTile);
        uint8_t* dst = st_s + s * G::kStage;
        for (int p = 0; p < G::kPanels; ++p) {
          hopper::tma_load_3d(dst + p * G::kKPanel, &kmap, &full[s], p * 32,
                              kt * kK, bh);
          hopper::tma_load_3d(dst + 2 * G::kKTile + p * G::kKPanel, &vmap,
                              &full[s], p * 32, kt * kK, bh);
        }
        hopper::tma_load_3d(dst + 4 * G::kKTile, &kthmap, &full[s], kt * kK,
                            0, bh);
        hopper::tma_load_3d(dst + 5 * G::kKTile, &ktlmap, &full[s], kt * kK,
                            0, bh);
      }
    } else if (ptid >= 32) {
      constexpr int kVecs = G::kKTile / 16;  // uint4s of one operand
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % G::kStages;
        hopper::mbar_wait(&full[s], (kt / G::kStages) & 1);
        uint4* kv = reinterpret_cast<uint4*>(st_s + s * G::kStage);
        for (int i = ptid - 32; i < kVecs; i += 96) {
          hopper::tf32_split4(kv + i, kv + kVecs + i);                // K
          hopper::tf32_split4(kv + 2 * kVecs + i, kv + 3 * kVecs + i);  // V
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
    const int first_q = qtile * G::kRows + wg * 64;
    const int q0 = first_q + 16 * warp + lane / 4;  // and q0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t doh_base = hopper::smem_u32(do_s) + wg * 64 * 128;
    const uint32_t dol_base = doh_base + G::kQTile;
    const uint32_t qh_base = hopper::smem_u32(q_s) + wg * 64 * 128;
    const uint32_t ql_base = qh_base + G::kQTile;
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

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    hopper::mbar_wait(qdo_bar, 0);
    // Up to D 64, Q's and dO's hi and lo stay in registers as the A
    // fragments of S = Q K^T and dP = dO V^T, split from the raw rows.
    constexpr bool kQRegs = G::kQRegs;
    constexpr int kQSteps = kQRegs ? D / 8 : 1;
    uint32_t qfh[kQSteps][4], qfl[kQSteps][4];
    uint32_t dofh[kQSteps][4], dofl[kQSteps][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int k = 0; k < kQSteps; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wg * 64 + 16 * warp + lane / 4 + 8 * (e & 1);
          const int col = 8 * k + lane % 4 + 4 * (e >> 1);
          const int at = (col / 32) * G::kQPanel + row * 128 +
                         ((((col % 32) / 4) ^ (row & 7)) << 4) + (col % 4) * 4;
          hopper::tf32_split(*reinterpret_cast<const float*>(q_s + at),
                             qfh[k][e], qfl[k][e]);
          hopper::tf32_split(*reinterpret_cast<const float*>(do_s + at),
                             dofh[k][e], dofl[k][e]);
        }
      }
    } else {
      hopper::split_rows<G::kPanels, G::kQPanel>(q_s, q_s + G::kQTile, wg,
                                                 tid);
      hopper::split_rows<G::kPanels, G::kQPanel>(do_s, do_s + G::kQTile, wg,
                                                 tid);
    }

    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int st = kt % G::kStages;
      const int k_first = kt * kK;
      hopper::mbar_wait(&full[st], (kt / G::kStages) & 1);
      hopper::mbar_wait(&ready[st], (kt / G::kStages) & 1);
      if (idle || (causal && k_first > first_q + 63)) {
        hopper::mbar_arrive(&empty[st]);  // above this warpgroup's diagonal
        continue;
      }
      const uint32_t kh_base = hopper::smem_u32(st_s + st * G::kStage);
      const uint32_t kl_base = kh_base + G::kKTile;
      const uint32_t vh_base = kh_base + 2 * G::kKTile;
      const uint32_t vl_base = kh_base + 3 * G::kKTile;
      const uint32_t kth_base = kh_base + 4 * G::kKTile;
      const uint32_t ktl_base = kh_base + 5 * G::kKTile;

      float s[kK / 2], dp[kK / 2];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < kK / 2; ++i) s[i] = dp[i] = 0.f;
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const int koff = (k / 4) * G::kKPanel + (k % 4) * 32;
        const uint64_t kh = hopper::smem_desc(kh_base + koff, 128);
        const uint64_t kl = hopper::smem_desc(kl_base + koff, 128);
        if constexpr (kQRegs) {
          W::rs(s, qfh[k], kl);
          W::rs(s, qfl[k], kh);
          W::rs(s, qfh[k], kh);
        } else {
          const int qoff = (k / 4) * G::kQPanel + (k % 4) * 32;
          const uint64_t qh = hopper::smem_desc(qh_base + qoff, 128);
          W::ss(s, qh, kl, k > 0);
          W::ss(s, hopper::smem_desc(ql_base + qoff, 128), kh, 1);
          W::ss(s, qh, kh, 1);
        }
      }
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const int qoff = (k / 4) * G::kQPanel + (k % 4) * 32;
        const int koff = (k / 4) * G::kKPanel + (k % 4) * 32;
        const uint64_t vh = hopper::smem_desc(vh_base + koff, 128);
        if constexpr (kQRegs) {
          W::rs(dp, dofh[k], hopper::smem_desc(vl_base + koff, 128));
          W::rs(dp, dofl[k], vh);
          W::rs(dp, dofh[k], vh);
        } else {
          const uint64_t doh = hopper::smem_desc(doh_base + qoff, 128);
          W::ss(dp, doh, hopper::smem_desc(vl_base + koff, 128), k > 0);
          W::ss(dp, hopper::smem_desc(dol_base + qoff, 128), vh, 1);
          W::ss(dp, doh, vh, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P = exp(scale s - lse[query]) and dS = P (dP - delta) scale,
      // split as the A fragments of dQ += dS K: accumulator registers
      // 4j..4j+3 in the order {0, 2, 1, 3} (hopper.cuh, tf32_perm).
      const bool masked = k_first + kK > tk ||
                          (causal && k_first + kK - 1 > first_q);
      uint32_t dsh[kK / 8][4], dsl[kK / 8][4];
#pragma unroll
      for (int j = 0; j < kK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + ((e & 1) << 1) + (e >> 1);
          const int r = (i >> 1) & 1;
          const int key = k_first + hopper::acc_col(i) + col0;
          const int q = q0 + hopper::acc_row(i);
          // A select, not a branch: the A fragments below must not be
          // written on a divergent path, or ptxas serializes the wgmmas.
          const bool live = !masked || (key < tk && !(causal && key > q));
          const float pr =
              live ? exp2f(fmaf(s[i], scale_log2, -lse_l2[r])) : 0.f;
          hopper::tf32_split(pr * (dp[i] - dl[r]) * scale, dsh[j][e],
                             dsl[j][e]);
        }
      }

      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kK / 8; ++j) {
        const uint64_t kth = hopper::smem_desc(kth_base + j * 32, G::kTSW);
        U::rs(dq_acc, dsl[j], kth);
        U::rs(dq_acc, dsh[j], hopper::smem_desc(ktl_base + j * 32, G::kTSW));
        U::rs(dq_acc, dsh[j], kth);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(dq_acc);
      hopper::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int q = q0 + hopper::acc_row(i);
      if (q < tq) {
        const size_t at = (static_cast<size_t>(bh) * tq + q) * D +
                          hopper::acc_col(i) + col0;
        *reinterpret_cast<float2*>(dq + at) =
            make_float2(dq_acc[i], dq_acc[i + 1]);
      }
    }
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
  void* workspace;  // the fp32 routes' pre-pass only
  cudaStream_t stream;
};

// Workspace of K3's fp32 route in floats: K^T hi and lo, (bh, D, tk
// rounded up to 8).
size_t f32_dq_workspace(int bh, int tk, int d) {
  return 2 * static_cast<size_t>(bh) * d * hopper::split_pad(tk);
}

template <int D>
int launch_dq_3xtf32(const Args& a, void* dq) {
  using G = F32DqGeo<D>;
  const int tk_pad = hopper::split_pad(a.tk);
  float* kth = static_cast<float*>(a.workspace);
  float* ktl = kth + static_cast<size_t>(a.bh) * D * tk_pad;
  const int err = hopper::launch_split_tf32<D>(a.k, nullptr, nullptr, kth,
                                               ktl, a.bh, a.tk, a.stream);
  if (err != 0) return err;
  CUtensorMap qmap, domap, kmap, vmap, kthmap, ktlmap;
  if (!hopper::make_panel_map<float>(&qmap, a.q, a.bh, a.tq, D, G::kRows, 128) ||
      !hopper::make_panel_map<float>(&domap, a.dout, a.bh, a.tq, D, G::kRows, 128) ||
      !hopper::make_panel_map<float>(&kmap, a.k, a.bh, a.tk, D, G::kKeys, 128) ||
      !hopper::make_panel_map<float>(&vmap, a.v, a.bh, a.tk, D, G::kKeys, 128) ||
      !hopper::make_panel_map<float>(&kthmap, kth, a.bh, D, tk_pad, D, G::kTSW) ||
      !hopper::make_panel_map<float>(&ktlmap, ktl, a.bh, D, tk_pad, D, G::kTSW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dq_3xtf32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (a.tq + G::kRows - 1) / G::kRows;
  kernel<<<dim3(n_qtiles, a.bh), G::kThreads, G::kSmem, a.stream>>>(
      qmap, domap, kmap, vmap, kthmap, ktlmap, a.lse, a.delta,
      static_cast<float*>(dq), a.tq, a.tk, a.causal, a.scale);
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

// K3 by dtype: fp32 split-TF32, bf16/fp16 one pass, all on the tensor
// cores.
template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_dq_3xtf32<D>(a, dq);
  } else {
    return launch_dq_wgmma<T, D>(a, dq);
  }
}

// Workspace of K2's fp32 route in floats: Q and dO, each split (hi, lo)
// as (bh, tq, D) and transposed as (bh, D, tq rounded up to 8).
size_t f32_dkv_workspace(int bh, int tq, int d) {
  return 4 * static_cast<size_t>(bh) * d *
         (tq + static_cast<size_t>(hopper::split_pad(tq)));
}

template <int D>
int launch_dkv_3xtf32(const Args& a, void* dk, void* dv) {
  using G = F32DkvGeo<D>;
  const int tq_pad = hopper::split_pad(a.tq);
  const size_t rows = static_cast<size_t>(a.bh) * a.tq * D;
  const size_t cols = static_cast<size_t>(a.bh) * D * tq_pad;
  float* qh = static_cast<float*>(a.workspace);
  float* ql = qh + rows;
  float* doh = ql + rows;
  float* dol = doh + rows;
  float* qth = dol + rows;
  float* qtl = qth + cols;
  float* doth = qtl + cols;
  float* dotl = doth + cols;
  int err = hopper::launch_split_tf32<D>(a.q, qh, ql, qth, qtl, a.bh, a.tq,
                                         a.stream);
  if (err == 0) {
    err = hopper::launch_split_tf32<D>(a.dout, doh, dol, doth, dotl, a.bh,
                                       a.tq, a.stream);
  }
  if (err != 0) return err;
  constexpr int kQ = G::kQueries;
  CUtensorMap kmap, vmap, qhmap, qlmap, dohmap, dolmap, qthmap, qtlmap,
      dothmap, dotlmap;
  if (!hopper::make_panel_map<float>(&kmap, a.k, a.bh, a.tk, D, G::kKeys, 128) ||
      !hopper::make_panel_map<float>(&vmap, a.v, a.bh, a.tk, D, G::kKeys, 128) ||
      !hopper::make_panel_map<float>(&qhmap, qh, a.bh, a.tq, D, kQ, 128) ||
      !hopper::make_panel_map<float>(&qlmap, ql, a.bh, a.tq, D, kQ, 128) ||
      !hopper::make_panel_map<float>(&dohmap, doh, a.bh, a.tq, D, kQ, 128) ||
      !hopper::make_panel_map<float>(&dolmap, dol, a.bh, a.tq, D, kQ, 128) ||
      !hopper::make_panel_map<float>(&qthmap, qth, a.bh, D, tq_pad, D, G::kTSW) ||
      !hopper::make_panel_map<float>(&qtlmap, qtl, a.bh, D, tq_pad, D, G::kTSW) ||
      !hopper::make_panel_map<float>(&dothmap, doth, a.bh, D, tq_pad, D, G::kTSW) ||
      !hopper::make_panel_map<float>(&dotlmap, dotl, a.bh, D, tq_pad, D, G::kTSW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_bwd_dkv_3xtf32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_ktiles = (a.tk + G::kKeys - 1) / G::kKeys;
  kernel<<<dim3(n_ktiles, a.bh), G::kThreads, G::kSmem, a.stream>>>(
      kmap, vmap, qhmap, qlmap, dohmap, dolmap, qthmap, qtlmap, dothmap,
      dotlmap, a.lse, a.delta, static_cast<float*>(dk),
      static_cast<float*>(dv), a.tq, a.tk, a.causal, a.scale);
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

// K2 by dtype: fp32 split-TF32, bf16/fp16 one pass, all on the tensor
// cores.
template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_dkv_3xtf32<D>(a, dk, dv);
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

// Bytes of scratch that flash_attention_bwd_dkv needs for these
// arguments: the fp32 route's split Q and dO (0 for bf16/fp16).
extern "C" size_t flash_attention_bwd_dkv_workspace(int bh, int tq, int tk,
                                                    int d, int dtype) {
  (void)tk;
  return dtype == 0 ? 4 * f32_dkv_workspace(bh, tq, d) : 0;
}

// Bytes of scratch that flash_attention_bwd_dq needs for these
// arguments: the fp32 route's split K^T (0 for bf16/fp16).
extern "C" size_t flash_attention_bwd_dq_workspace(int bh, int tq, int tk,
                                                   int d, int dtype) {
  (void)tq;
  return dtype == 0 ? 4 * f32_dq_workspace(bh, tk, d) : 0;
}

// q, dout, dq: (bh, tq, d); k, v, dk, dv: (bh, tk, d); all contiguous,
// 16-byte aligned, in one dtype (0 float32, 1 bfloat16, 2 float16). lse
// and delta: (bh, tq) fp32. In fp32 each runs its pre-pass into
// `workspace` (flash_attention_bwd_{dkv,dq}_workspace bytes, 16-byte
// aligned; unused otherwise). Each returns the cudaError_t of its
// launches (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int tq,
                                       int tk, int d, int dtype, int causal,
                                       float scale, void* workspace,
                                       void* stream) {
  if (bad_shape(bh, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, tq, tk, causal, scale,
               workspace, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, DkvLauncher{a, dk, dv});
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int tq, int tk,
                                      int d, int dtype, int causal,
                                      float scale, void* workspace,
                                      void* stream) {
  if (bad_shape(bh, tq, tk)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, tq, tk, causal, scale,
               workspace, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, d, DqLauncher{a, dq});
}
