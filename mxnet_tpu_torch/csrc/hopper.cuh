// Hopper (sm_90a) building blocks shared by the attention kernels that run
// on the tensor cores: mbarriers, TMA tile loads through a tensor map,
// wgmma shared-memory descriptors and the wgmma instructions themselves.
//
// Tiles live in shared memory as the TMA writes them with a 128-byte (or,
// for 64-byte rows, 64-byte) swizzle: a "panel" is R rows of SW bytes, a
// row holding SW/2 consecutive 16-bit elements of a head-dim slice. A
// head dim wider than one swizzle span (D 128: 256-byte rows) is stored
// as D*2/SW panels side by side, each loaded by its own TMA box. Every
// panel starts on a 1024-byte boundary, so the swizzle phase that the TMA
// applies (a function of the shared-memory address) is the one that the
// wgmma descriptor's layout type assumes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * kLog2e)

// The panel geometry of a 16-bit tile with head dim D (see above).
template <int D>
struct Panels {
  static constexpr int kSW = D * 2 >= 128 ? 128 : 64;  // swizzle bytes
  static constexpr int kPanels = D * 2 / kSW;          // panels per row
  static constexpr int kPanelElems = kSW / 2;  // head-dim slice; the n of a
                                               // product into one panel
  static constexpr int kStepsPerPanel = kPanelElems / 16;  // k16 steps
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// -- TMA ------------------------------------------------------------------------

// One box of a 3-D tensor map (d, t, bh) into shared memory; completion
// is reported to `bar` in bytes. Rows past the tensor's end read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d, int t,
                                            int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(t), "r"(bh)
      : "memory");
}

// -- warp specialisation --------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- wgmma ------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled panel (sw_bytes 128 or
// 64): start address, leading-byte offset 16 (unused: every operand this
// file issues fits one swizzle span along its contiguous dimension),
// stride-byte offset = 8 rows of the panel, layout type 1 (128B) or 2
// (64B). The same fields describe a K-major operand (rows along M/N) and
// an MN-major one (rows along K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int sw_bytes) {
  const uint64_t layout = sw_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * sw_bytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Two fp32 values as one 32-bit register of the 16-bit type (low half
// first), as the wgmma A fragment takes them.
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of m64nNk16 in a warpgroup: register i of thread t
// (warp w = t / 32, lane l) holds row 16w + l/4 + 8*((i/2)%2) and column
// 8*(i/4) + 2*(l%4) + i%2. Columns 16j..16j+15 of an accumulator, as
// registers 8j..8j+7 packed in pairs, are exactly the A fragment of the
// k-step j of a product whose K runs along those columns.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + (i & 1); }

template <typename T, int N>
struct Wgmma;

// Wgmma<T, N>, for T bf16 or fp16 (PTX type TY) and N 32, 64 or 128:
//   ss:    D(64xN, f32) (+)= A(64x16, smem desc, K-major)
//                            * B(16xN, smem desc, K-major);
//          `accumulate` 0 overwrites D.
//   rs_mn: D(64xN, f32) += A(64x16, registers: four b32 of two T each)
//                          * B(16xN, smem desc, MN-major).

#define HOPPER_WGMMA_N32(T, TY)                                                    \
  template <>                                                                      \
  struct Wgmma<T, 32> {                                                            \
    static __device__ __forceinline__ void ss(                                     \
        float* d, uint64_t a, uint64_t b, int accumulate) {                        \
      asm volatile(                                                                \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                             \
          "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY                  \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
          "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                       \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
          "+f"(d[15])                                                              \
          : "l"(a), "l"(b), "r"(accumulate));                                      \
    }                                                                              \
    static __device__ __forceinline__ void rs_mn(                                  \
        float* d, const uint32_t* a, uint64_t b) {                                 \
      asm volatile(                                                                \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                             \
          "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY                  \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
          "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                         \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
          "+f"(d[15])                                                              \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));           \
    }                                                                              \
  };

#define HOPPER_WGMMA_N64(T, TY)                                                          \
  template <>                                                                            \
  struct Wgmma<T, 64> {                                                                  \
    static __device__ __forceinline__ void ss(                                           \
        float* d, uint64_t a, uint64_t b, int accumulate) {                              \
      asm volatile(                                                                      \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                   \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY                        \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16," \
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"    \
          "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                             \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),                  \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),                    \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),               \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),               \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),               \
          "+f"(d[30]), "+f"(d[31])                                                       \
          : "l"(a), "l"(b), "r"(accumulate));                                            \
    }                                                                                    \
    static __device__ __forceinline__ void rs_mn(                                        \
        float* d, const uint32_t* a, uint64_t b) {                                       \
      asm volatile(                                                                      \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                   \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY                        \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16," \
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"    \
          "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),                  \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),                    \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),               \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),               \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),               \
          "+f"(d[30]), "+f"(d[31])                                                       \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                 \
    }                                                                                    \
  };

#define HOPPER_WGMMA_N128(T, TY)                                                         \
  template <>                                                                            \
  struct Wgmma<T, 128> {                                                                 \
    static __device__ __forceinline__ void ss(                                           \
        float* d, uint64_t a, uint64_t b, int accumulate) {                              \
      asm volatile(                                                                      \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                   \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY                       \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16," \
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"   \
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"   \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"   \
          "%62, %63"                                                                     \
          "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                             \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),                  \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),                    \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),               \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),               \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),               \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),               \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),               \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),               \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),               \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                             \
          : "l"(a), "l"(b), "r"(accumulate));                                            \
    }                                                                                    \
    static __device__ __forceinline__ void rs_mn(                                        \
        float* d, const uint32_t* a, uint64_t b) {                                       \
      asm volatile(                                                                      \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                   \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY                       \
          " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16," \
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"   \
          "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"   \
          "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"   \
          "%62, %63"                                                                     \
          "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                               \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),                  \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),                    \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),               \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),               \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),               \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),               \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),               \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),               \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),               \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                             \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                 \
    }                                                                                    \
  };

HOPPER_WGMMA_N32(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N64(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N128(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N32(__half, "f16")
HOPPER_WGMMA_N64(__half, "f16")
HOPPER_WGMMA_N128(__half, "f16")
#undef HOPPER_WGMMA_N32
#undef HOPPER_WGMMA_N64
#undef HOPPER_WGMMA_N128

// -- host -------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_dtype();
template <>
constexpr CUtensorMapDataType tma_dtype<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_dtype<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// Tensor map over a contiguous (bh, t, d) array of 16-bit T, read in
// boxes of (1, rows, sw_bytes / 2): one swizzled panel. The third
// dimension keeps a box at the end of one head from reading the next
// head's rows: rows past t are filled with zeros. Returns false if the
// driver refuses it.
template <typename T>
bool make_panel_map(CUtensorMap* map, const void* base, int bh, int t, int d,
                    int rows, int sw_bytes) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T),
                                 static_cast<cuuint64_t>(t) * d * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sw_bytes / sizeof(T)),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, tma_dtype<T>(), 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rounds a shared-memory address up to the 1024-byte swizzle atom.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

}  // namespace hopper
