// The host side of an rtc launch: one call from Python (ctypes) that
// makes the device's primary context current where it is not and calls
// the driver's cuLaunchKernel, for mxnet_tpu_torch/rtc.py.
//
// Replaces: nothing on the device. The JAX package launches its user
// kernels through pl.pallas_call (mxnet_tpu/rtc.py:87); the port
// launches NVRTC-compiled kernels through the driver API, and this file
// is the host code of that launch.
//
// Why native: through ctypes, a launch paid for the conversion of the
// eleven arguments of cuLaunchKernel, a pointer array built per launch
// and a cuCtxGetCurrent call of its own. Here Python packs everything
// into one buffer (struct.pack with native alignment, a format fixed
// per kernel) and crosses into C once.
//
// Buffer layout (struct format "@PPP8I" then the kernel's parameters):
//   void *function, *context, *stream;
//   uint32 grid[3], block[3], shared_mem, num_params;
//   the parameter values, each at params_offset[i] from the start.
// The driver copies each parameter's bytes at launch, so the buffer is
// free again when mx_rtc_launch returns.
//
// No CUDA header: the three driver entry points come from the caller
// (the addresses of the functions of libcuda.so.1 that ctypes loaded),
// so the library needs neither -lcuda nor the driver at link time.
#include <stdint.h>
#include <string.h>

typedef int CUresult;
typedef void *CUcontext;
typedef void *CUfunction;
typedef void *CUstream;
typedef CUresult (*LaunchKernel)(CUfunction, unsigned, unsigned, unsigned,
                                 unsigned, unsigned, unsigned, unsigned,
                                 CUstream, void **, void **);
typedef CUresult (*CtxGetCurrent)(CUcontext *);
typedef CUresult (*CtxSetCurrent)(CUcontext);

namespace {

LaunchKernel launch_kernel = nullptr;
CtxGetCurrent ctx_get_current = nullptr;
CtxSetCurrent ctx_set_current = nullptr;

struct Header {
  CUfunction function;
  CUcontext context;
  CUstream stream;
  uint32_t grid[3];
  uint32_t block[3];
  uint32_t shared_mem;
  uint32_t num_params;
};

}  // namespace

// The most parameters a launch takes (_nvrtc.MAX_PARAMS; rtc.py checks
// each kernel's signature against it).
#define MX_RTC_MAX_PARAMS 256

extern "C" void mx_rtc_init(void *launch, void *get_current,
                            void *set_current) {
  launch_kernel = reinterpret_cast<LaunchKernel>(launch);
  ctx_get_current = reinterpret_cast<CtxGetCurrent>(get_current);
  ctx_set_current = reinterpret_cast<CtxSetCurrent>(set_current);
}

// Returns the CUresult of the first driver call that failed, else 0.
extern "C" int mx_rtc_launch(const char *buffer,
                             const uint32_t *params_offset) {
  Header h;
  memcpy(&h, buffer, sizeof h);
  void *params[MX_RTC_MAX_PARAMS];
  for (uint32_t i = 0; i < h.num_params; ++i)
    params[i] = const_cast<char *>(buffer + params_offset[i]);
  // A worker thread may never have touched the driver API, or may have
  // another device's context current.
  CUcontext current = nullptr;
  CUresult res = ctx_get_current(&current);
  if (res != 0) return res;
  if (current != h.context) {
    res = ctx_set_current(h.context);
    if (res != 0) return res;
  }
  return launch_kernel(h.function, h.grid[0], h.grid[1], h.grid[2],
                       h.block[0], h.block[1], h.block[2], h.shared_mem,
                       h.stream, params, nullptr);
}
