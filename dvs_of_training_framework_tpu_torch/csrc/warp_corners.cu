// K3: the four bilinear corner values of the photometric warp, for Hopper
// (sm_90a).
//
// Replaces dvs_of_training_framework_tpu/ops/warp_pallas.py
// corner_values_pallas (_kernel).  For N single-channel frames [H, W] and
// P unnormalised points (iy, ix) per frame it writes
// V[a][b][n][p] = img[n][y0 + a][x0 + b] for a, b in {0, 1}, with
// y0 = floor(iy), x0 = floor(ix), and 0 for a corner outside the frame.
// The TPU has no fast gather, so its kernel kept the frames in VMEM and
// turned each chunk of points into one-hot row matrices contracted on the
// MXU (in bf16 hi+lo passes under the bf16x2 recipe), with the columns
// picked by masked reductions.  Hopper gathers directly, so the port reads
// each corner once and is exact in every precision mode.
//
// What bounds it: memory traffic and launch latency, not arithmetic.  At
// the bench shape (N = 8, four scales H = W = 32..256, P = H * W) the four
// calls of a step read the frames (2.8 MB in all) and the coordinates
// (5.6 MB) and write the corners (11.2 MB): ~19.5 MB, ~6 us at 3.35 TB/s,
// so the smaller scales are a few microseconds of launch each.
//
// Design: one thread per (n, p).  Threads of a warp read neighbouring
// coordinates and write neighbouring corners (coalesced, corner-major
// [4, N, P] rows, the layout the blend reads); their gathers land near one
// another because a flow moves neighbouring pixels alike, and a 256 KB
// frame stays in the 50 MB L2 cache.  The ragged end of the point axis is
// masked in the kernel, so no padding of the inputs is needed.  The range
// of each corner is tested on the float coordinate before any cast to
// int: a NaN or a flow of 1e4 px, which the reference sees when a
// training run diverges, fails the test and never wraps into the frame.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
corner_values_kernel(const float* __restrict__ img,
                     const float* __restrict__ iy,
                     const float* __restrict__ ix,
                     float* __restrict__ out, int N, int P, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int NP = N * P;
  if (i >= NP) return;
  int n = i / P;
  float fy = floorf(iy[i]);
  float fx = floorf(ix[i]);
  float hy = static_cast<float>(H - 1);
  float hx = static_cast<float>(W - 1);
  // every comparison with a NaN is false, so a NaN point has no corner
  bool y0_in = fy >= 0.0f && fy <= hy;
  bool y1_in = fy >= -1.0f && fy <= hy - 1.0f;
  bool x0_in = fx >= 0.0f && fx <= hx;
  bool x1_in = fx >= -1.0f && fx <= hx - 1.0f;
  // casts only of values inside [-1, H - 1] and [-1, W - 1]
  int y0 = (y0_in || y1_in) ? static_cast<int>(fy) : 0;
  int x0 = (x0_in || x1_in) ? static_cast<int>(fx) : 0;
  // an address is formed only for a corner inside the frame
  long long at = static_cast<long long>(n) * H * W + y0 * W + x0;
  out[i] = (y0_in && x0_in) ? __ldg(img + at) : 0.0f;
  out[NP + i] = (y0_in && x1_in) ? __ldg(img + at + 1) : 0.0f;
  out[2 * NP + i] = (y1_in && x0_in) ? __ldg(img + at + W) : 0.0f;
  out[3 * NP + i] = (y1_in && x1_in) ? __ldg(img + at + W + 1) : 0.0f;
}

}  // namespace

// img: float32 [N, H, W]; iy, ix: float32 [N, P]; out: float32 [4, N, P],
// fully written, corner (a, b) in row 2a + b.  Returns the launch's
// cudaError_t.
extern "C" int warp_corners(const void* img, const void* iy, const void* ix,
                            void* out, int N, int P, int H, int W,
                            void* stream) {
  if (N <= 0 || P <= 0 || H <= 0 || W <= 0 ||
      4LL * N * P > INT_MAX || static_cast<long long>(H) * W > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks = static_cast<unsigned int>(
      (static_cast<long long>(N) * P + kThreads - 1) / kThreads);
  corner_values_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(iy),
      static_cast<const float*>(ix), static_cast<float*>(out), N, P, H, W);
  return static_cast<int>(cudaGetLastError());
}
