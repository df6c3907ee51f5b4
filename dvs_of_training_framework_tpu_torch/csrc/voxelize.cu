// K1: event -> voxel-grid binning, forward and backward, for Hopper (sm_90a).
//
// Replaces dvs_of_training_framework_tpu/ops/voxel_pallas.py voxelize_pallas
// (_fwd_kernel and _bwd_kernel).  The TPU kernel needed events sorted by
// plane so that one plane's [H, C*W] accumulator could sit in VMEM, and it
// turned each chunk of events into one-hot MXU contractions.  On Hopper a
// 256x256x9 fp32 plane is 2.4 MB, ten times the 227 KB of shared memory a
// block may use, so no plane fits on chip.  What bounds the work here is
// memory traffic: at E = 2^17 events and C = 9 channels the forward reads
// 4.7 MB of weights and makes 1.18 M scattered 4-byte additions into an
// 18.9 MB grid, which fits in the 50 MB L2 cache.
//
// Design: one thread per (event, channel).  Neighbouring threads read
// neighbouring weights (coalesced), and the C channels of one event land in
// one 36-byte run of the grid.  The forward adds with fp32 atomicAdd into a
// grid the caller zeroed, so it needs no sorting and no plane offsets; the
// order of the additions, and so the last bits of a bin, vary from run to
// run.  The backward is a plain gather, dw[e, c] = g[plane_e, y_e, x_e, c],
// and writes an explicit zero for invalid rows (the TPU code had to mask
// uninitialised rows afterwards).  Events whose plane or pixel lies outside
// the grid are dropped in both directions, so a bad index cannot write out
// of bounds.  The weights are float32 or, in the bf16 recipe, bfloat16:
// the kernels are templates over the weight type, the grid and its
// gradient stay float32, and the backward rounds dw to the weights' type
// (round to nearest even, as the JAX kernel's final cast).
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long bin_index(int p, int y, int x, int c,
                                               int P, int H, int W, int C) {
  if (p < 0 || p >= P || y < 0 || y >= H || x < 0 || x >= W) return -1;
  return ((static_cast<long long>(p) * H + y) * W + x) * C + c;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
voxelize_fwd_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ plane,
                    const T* __restrict__ w,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out,
                    int n, int C, int P, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = i / C;
  int c = i - e * C;
  if (!valid[e]) return;
  long long bin = bin_index(plane[e], y[e], x[e], c, P, H, W, C);
  if (bin < 0) return;
  atomicAdd(out + bin, to_float(w[i]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
voxelize_bwd_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ plane,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ g,
                    T* __restrict__ dw,
                    int n, int C, int P, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = i / C;
  int c = i - e * C;
  float v = 0.0f;
  if (valid[e]) {
    long long bin = bin_index(plane[e], y[e], x[e], c, P, H, W, C);
    if (bin >= 0) v = g[bin];
  }
  dw[i] = from_float<T>(v);
}

unsigned int blocks_for(int n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// E * C as the kernels' 32-bit index range, or -1 if it does not fit.
int flat_size(long long E, int C) {
  if (E <= 0 || C <= 0 || E * C > INT_MAX) return -1;
  return static_cast<int>(E * C);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* y, const void* plane,
                       const void* w, const void* valid, void* out, int n,
                       int C, int P, int H, int W, cudaStream_t stream) {
  voxelize_fwd_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(plane), static_cast<const T*>(w),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), n, C, P,
      H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* y, const void* plane,
                       const void* valid, const void* g, void* dw, int n,
                       int C, int P, int H, int W, cudaStream_t stream) {
  voxelize_bwd_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(plane), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(g), static_cast<T*>(dw), n, C, P, H, W);
  return cudaGetLastError();
}

}  // namespace

// out: zeroed float32 [P, H, W, C]; w: [E, C], bfloat16 if w_bf16 else
// float32; x, y, plane: int32 [E]; valid: bool [E].  Returns the launch's
// cudaError_t.
extern "C" int voxelize_fwd(const void* x, const void* y, const void* plane,
                            const void* w, const void* valid, void* out,
                            long long E, int C, int P, int H, int W,
                            int w_bf16, void* stream) {
  int n = flat_size(E, C);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_bf16 ? launch_fwd<__nv_bfloat16>(x, y, plane, w, valid, out, n, C,
                                         P, H, W, s)
             : launch_fwd<float>(x, y, plane, w, valid, out, n, C, P, H, W,
                                 s));
}

// g: float32 [P, H, W, C]; dw: [E, C] in the weights' type (bfloat16 if
// w_bf16), fully written.
extern "C" int voxelize_bwd(const void* x, const void* y, const void* plane,
                            const void* valid, const void* g, void* dw,
                            long long E, int C, int P, int H, int W,
                            int w_bf16, void* stream) {
  int n = flat_size(E, C);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_bf16 ? launch_bwd<__nv_bfloat16>(x, y, plane, valid, g, dw, n, C, P,
                                         H, W, s)
             : launch_bwd<float>(x, y, plane, valid, g, dw, n, C, P, H, W,
                                 s));
}

// Message for a cudaError_t returned by any entry point of this library.
extern "C" const char* dvs_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
