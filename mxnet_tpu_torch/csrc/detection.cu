// Detection kernels: greedy non-maximum suppression (D1) and ROIPooling
// forward and backward (D2), for mxnet_tpu_torch/ops/detection_ops.py and
// mxnet_tpu_torch/ops/rcnn_ops.py.
//
// Replaces: no Pallas kernel. The JAX package writes both in XLA with
// shapes XLA can fix: greedy NMS is a lax.fori_loop with one trip per
// box (mxnet_tpu/ops/detection_ops.py:234 _nms_mask, serving box_nms and
// MultiBoxDetection; mxnet_tpu/ops/rcnn_ops.py:156 in Proposal and
// MultiProposal), and ROIPooling takes its max over a (C, ph, pw, H, W)
// mask per ROI (mxnet_tpu/ops/detection_ops.py:376). In PyTorch the
// first is thousands of launches per image and the second more memory
// than the card has at Faster R-CNN's widths, hence these kernels.
//
// D1 is two kernels. nms_mask_kernel: grid (column block, row block,
// image), 64 threads; thread t of row block rb sets bit k of
// mask[i][cb] (i = 64 rb + t, j = 64 cb + k) when j > i, the pair may
// suppress (same class, unless classes are ignored) and the IoU exceeds
// the threshold. Blocks below the diagonal write nothing: the scan never
// reads them. nms_scan_kernel: one block per image walks the sorted
// boxes in order with the `removed` bitset in shared memory, ORs each
// kept row's words into it across the block's threads, and stops when
// the quota is filled. It is bound by its sequential walk (two barriers
// and one row of words per kept box), not by bytes or operations.
//
// D2 forward: one thread per (roi, c, i, j), the max and the first
// argmax in row-major order over the bin's window. Backward: one thread
// per output adds its gradient at the argmax with atomicAdd. Both are
// bound by the bytes of the feature map they read or write.
//
// Built with --fmad=false (_native.EXTRA_FLAGS): every product and sum
// rounds on its own, as in the plain PyTorch versions, so the keep masks
// and the pooled maxima equal theirs bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNmsThreads = 64;     // one row of a 64-box block a thread
constexpr int kScanThreads = 128;
constexpr int kPoolThreads = 256;

template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T dmin(T a, T b) { return a < b ? a : b; }

// IoU of boxes a and b above `thresh`. mode 0: _pairwise_iou's formula
// (detection_ops.py:28; 0 where the union is not positive). mode 1:
// Proposal's legacy "+1" pixel areas (rcnn_ops.py:153-165).
template <typename T>
__device__ __forceinline__ bool iou_over(const T* a, const T* b, T thresh,
                                         int mode) {
  const T zero = T(0);
  if (mode == 0) {
    T iw = dmax(dmin(a[2], b[2]) - dmax(a[0], b[0]), zero);
    T ih = dmax(dmin(a[3], b[3]) - dmax(a[1], b[1]), zero);
    T inter = iw * ih;
    T area_a = dmax(a[2] - a[0], zero) * dmax(a[3] - a[1], zero);
    T area_b = dmax(b[2] - b[0], zero) * dmax(b[3] - b[1], zero);
    T uni = area_a + area_b - inter;
    T iou = uni > zero ? inter / uni : zero;
    return iou > thresh;
  }
  const T one = T(1);
  T xx1 = dmax(a[0], b[0]);
  T yy1 = dmax(a[1], b[1]);
  T xx2 = dmin(a[2], b[2]);
  T yy2 = dmin(a[3], b[3]);
  T inter = dmax(xx2 - xx1 + one, zero) * dmax(yy2 - yy1 + one, zero);
  T area_a = (a[2] - a[0] + one) * (a[3] - a[1] + one);
  T area_b = (b[2] - b[0] + one) * (b[3] - b[1] + one);
  return inter / (area_a + area_b - inter) > thresh;
}

template <typename T>
__global__ void __launch_bounds__(kNmsThreads)
nms_mask_kernel(const T* __restrict__ boxes, const T* __restrict__ cls,
                int n, int words, T thresh, int mode,
                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ T sbox[kNmsThreads * 4];
  __shared__ T scls[kNmsThreads];
  const int col0 = cb * kNmsThreads;
  const int ncol = min(kNmsThreads, n - col0);
  const T* bb = boxes + (size_t)b * n * 4;
  const int t = threadIdx.x;
  if (t < ncol) {
    for (int k = 0; k < 4; ++k) sbox[t * 4 + k] = bb[(size_t)(col0 + t) * 4 + k];
    if (cls != nullptr) scls[t] = cls[(size_t)b * n + col0 + t];
  }
  __syncthreads();
  const int i = rb * kNmsThreads + t;
  if (i >= n) return;
  T a[4];
  for (int k = 0; k < 4; ++k) a[k] = bb[(size_t)i * 4 + k];
  const T ci = cls != nullptr ? cls[(size_t)b * n + i] : T(0);
  unsigned long long bits = 0ull;
  for (int k = 0; k < ncol; ++k) {
    if (col0 + k <= i) continue;
    if (cls != nullptr && !(scls[k] == ci)) continue;
    if (iou_over(a, &sbox[k * 4], thresh, mode)) bits |= 1ull << k;
  }
  mask[((size_t)b * n + i) * words + cb] = bits;
}

// keep, kept_idx (the kept positions in order) and n_kept per image;
// keep and kept_idx come zeroed from the wrapper.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid, int n, int words,
                int quota, unsigned char* __restrict__ keep,
                long long* __restrict__ kept_idx,
                long long* __restrict__ n_kept) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * words;
  const unsigned char* v = valid + (size_t)b * n;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long bits = 0ull;
    for (int k = 0; k < 64; ++k) {
      const int j = w * 64 + k;
      if (j < n && !v[j]) bits |= 1ull << k;   // invalid: never kept
    }
    removed[w] = bits;
  }
  __syncthreads();
  int kept = 0;
  for (int i = 0; i < n && kept < quota; ++i) {
    // Every thread reads the same word: the branch is uniform.
    if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
    if (threadIdx.x == 0) {
      keep[(size_t)b * n + i] = 1;
      kept_idx[(size_t)b * n + kept] = i;
    }
    ++kept;
    __syncthreads();    // every thread has read word i >> 6
    const unsigned long long* row = m + (size_t)i * words;
    for (int w = (i >> 6) + threadIdx.x; w < words; w += blockDim.x) {
      removed[w] |= row[w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) n_kept[b] = kept;
}

template <typename T>
__device__ __forceinline__ T round_half_away(T x);
template <>
__device__ __forceinline__ float round_half_away<float>(float x) { return roundf(x); }
template <>
__device__ __forceinline__ double round_half_away<double>(double x) { return round(x); }

template <typename T>
__device__ __forceinline__ T dfloor(T x);
template <>
__device__ __forceinline__ float dfloor<float>(float x) { return floorf(x); }
template <>
__device__ __forceinline__ double dfloor<double>(double x) { return floor(x); }

template <typename T>
__device__ __forceinline__ T dceil(T x);
template <>
__device__ __forceinline__ float dceil<float>(float x) { return ceilf(x); }
template <>
__device__ __forceinline__ double dceil<double>(double x) { return ceil(x); }

// The bin's window [start, end) along one axis of `size` pixels: the
// JAX order, floor(lo + i * bin) and ceil(lo + (i + 1) * bin), each
// product and sum rounded on its own, clamped to the map.
template <typename T>
__device__ __forceinline__ void bin_window(T lo, T bin, int i, int size,
                                           int* start, int* end) {
  const T fi = T(i);
  T s = dfloor(lo + fi * bin);
  T e = dceil(lo + (fi + T(1)) * bin);
  s = dmin(dmax(s, T(0)), T(size));
  e = dmin(dmax(e, T(0)), T(size));
  *start = static_cast<int>(s);
  *end = static_cast<int>(e);
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
roi_pool_fwd_kernel(const T* __restrict__ data, const T* __restrict__ rois,
                    int N, int C, int H, int W, long long total, int ph,
                    int pw, T scale, T* __restrict__ out,
                    int* __restrict__ argmax) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % pw);
  const int i = (int)((idx / pw) % ph);
  const int c = (int)((idx / ((long long)pw * ph)) % C);
  const long long r = idx / ((long long)pw * ph * C);
  const T* roi = rois + r * 5;
  int bidx = static_cast<int>(roi[0]);
  bidx = bidx < 0 ? 0 : (bidx >= N ? N - 1 : bidx);
  const T x1 = round_half_away(roi[1] * scale);
  const T y1 = round_half_away(roi[2] * scale);
  const T x2 = round_half_away(roi[3] * scale);
  const T y2 = round_half_away(roi[4] * scale);
  const T rw = dmax(x2 - x1 + T(1), T(1));
  const T rh = dmax(y2 - y1 + T(1), T(1));
  const T bin_h = rh / T(ph);
  const T bin_w = rw / T(pw);
  int hs, he, ws, we;
  bin_window(y1, bin_h, i, H, &hs, &he);
  bin_window(x1, bin_w, j, W, &ws, &we);
  const long long base = ((long long)bidx * C + c) * H * W;
  const T* img = data + base;
  T best = -INFINITY;
  long long arg = -1;
  for (int y = hs; y < he; ++y) {
    for (int x = ws; x < we; ++x) {
      const T val = img[(long long)y * W + x];
      if (val > best) {
        best = val;
        arg = base + (long long)y * W + x;
      }
    }
  }
  out[idx] = arg < 0 ? T(0) : best;
  argmax[idx] = static_cast<int>(arg);
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
roi_pool_bwd_kernel(const T* __restrict__ grad_out,
                    const int* __restrict__ argmax, long long total,
                    T* __restrict__ grad_data) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int a = argmax[idx];
  if (a >= 0) atomicAdd(grad_data + a, grad_out[idx]);
}

inline unsigned blocks_for(long long total, int threads) {
  return static_cast<unsigned>((total + threads - 1) / threads);
}

}  // namespace

// boxes: (batch, n, 4) contiguous, sorted by score; cls: (batch, n) or
// null (every pair may suppress). dtype 0 float32, 1 float64. mask:
// (batch, n, words) uint64, words = ceil(n / 64). Returns the cudaError_t
// of the launch.
extern "C" int nms_mask(const void* boxes, const void* cls, int dtype,
                        int batch, int n, int words, double thresh,
                        int iou_mode, void* mask, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || words > 65535 ||
      words * 64 < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(words, words, batch);
  auto* m = static_cast<unsigned long long*>(mask);
  if (dtype == 0) {
    nms_mask_kernel<float><<<grid, kNmsThreads, 0, s>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(cls), n,
        words, static_cast<float>(thresh), iou_mode, m);
  } else if (dtype == 1) {
    nms_mask_kernel<double><<<grid, kNmsThreads, 0, s>>>(
        static_cast<const double*>(boxes), static_cast<const double*>(cls),
        n, words, thresh, iou_mode, m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask from nms_mask; valid: (batch, n) uint8; keep (batch, n) uint8 and
// kept_idx (batch, n) int64 zeroed by the caller; n_kept (batch,) int64.
extern "C" int nms_scan(const void* mask, const void* valid, int batch,
                        int n, int words, int quota, void* keep,
                        void* kept_idx, void* n_kept, void* stream) {
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (batch <= 0 || n <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, kScanThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(valid), n, words, quota,
      static_cast<unsigned char*>(keep), static_cast<long long*>(kept_idx),
      static_cast<long long*>(n_kept));
  return static_cast<int>(cudaGetLastError());
}

// data: (N, C, H, W) contiguous; rois: (R, 5) [batch, x1, y1, x2, y2];
// out (R, C, ph, pw) like data; argmax (R, C, ph, pw) int32, the flat
// index into data (fewer than 2^31 elements) of each bin's max, -1 for
// an empty bin.
extern "C" int roi_pool_fwd(const void* data, const void* rois, int dtype,
                            int N, int C, int H, int W, int R, int ph,
                            int pw, double scale, void* out, void* argmax,
                            void* stream) {
  const long long total = (long long)R * C * ph * pw;
  if (total <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(total, kPoolThreads);
  auto* am = static_cast<int*>(argmax);
  if (dtype == 0) {
    roi_pool_fwd_kernel<float><<<grid, kPoolThreads, 0, s>>>(
        static_cast<const float*>(data), static_cast<const float*>(rois), N,
        C, H, W, total, ph, pw, static_cast<float>(scale),
        static_cast<float*>(out), am);
  } else if (dtype == 1) {
    roi_pool_fwd_kernel<double><<<grid, kPoolThreads, 0, s>>>(
        static_cast<const double*>(data), static_cast<const double*>(rois),
        N, C, H, W, total, ph, pw, scale, static_cast<double*>(out), am);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_out, argmax: (R, C, ph, pw), `total` elements; grad_data zeroed
// by the caller, like data.
extern "C" int roi_pool_bwd(const void* grad_out, const void* argmax,
                            int dtype, long long total, void* grad_data,
                            void* stream) {
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(total, kPoolThreads);
  const auto* am = static_cast<const int*>(argmax);
  if (dtype == 0) {
    roi_pool_bwd_kernel<float><<<grid, kPoolThreads, 0, s>>>(
        static_cast<const float*>(grad_out), am, total,
        static_cast<float*>(grad_data));
  } else if (dtype == 1) {
    roi_pool_bwd_kernel<double><<<grid, kPoolThreads, 0, s>>>(
        static_cast<const double*>(grad_out), am, total,
        static_cast<double*>(grad_data));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
