// K3: the four bilinear corner values of the photometric warp, and the
// warp itself fused with them, forward and grid gradient, for Hopper
// (sm_90a).
//
// Replaces dvs_of_training_framework_tpu/ops/warp_pallas.py
// corner_values_pallas (_kernel) and, with it, the blend and the analytic
// grid VJP of dvs_of_training_framework_tpu/ops/warp.py
// grid_sample_onehot that consume its corners.  For N single-channel
// frames [H, W] and P unnormalised points (iy, ix) per frame the corners
// are V[a][b][n][p] = img[n][y0 + a][x0 + b] for a, b in {0, 1}, with
// y0 = floor(iy), x0 = floor(ix), and 0 for a corner outside the frame.
// The TPU has no fast gather, so its kernel kept the frames in VMEM and
// turned each chunk of points into one-hot row matrices contracted on the
// MXU (in bf16 hi+lo passes under the bf16x2 recipe), with the columns
// picked by masked reductions.  Hopper gathers directly, so the port reads
// each corner once and is exact in every precision mode.
//
// gather_corners is that gather, one __device__ function shared by the
// three kernels here: corner_values_kernel (the warp_corners entry point,
// which writes the [4, N, P] corners) and the fused pair the photometric
// loss runs, warp_fwd_kernel and warp_bwd_kernel.  The fused pair reads
// the sampling grid where the loss leaves it (a permuted [N, 2, Ho, Wo]
// view, through its strides), unnormalises each point in registers,
// gathers its corners and blends them (forward) or forms the grid
// gradient of the blend (backward), so no corner tensor is written,
// saved or read back, and the backward gathers again from frames that
// stay in the 50 MB L2 cache.  Each point's gradient is its own: no
// atomics.
//
// What bounds it: memory traffic and launch latency, not arithmetic.  At
// the bench shape (N = 8, four scales H = W = 32..256, P = H * W) the four
// forward calls of a step read the grid (5.6 MB) and the frames (2.8 MB)
// and write the warped frames (2.8 MB), ~3.3 us at 3.35 TB/s; the four
// backward calls also read the cotangent and write the grid gradient
// (5.6 MB), ~5.0 us; the smaller scales are a few microseconds of launch
// each.
//
// Design: one thread per point.  Threads of a warp read neighbouring grid
// entries and write neighbouring outputs (coalesced); their gathers land
// near one another because a flow moves neighbouring pixels alike.  (Two
// points a thread, their loads in flight together, took 5% less at 256^2
// on an H100 and up to 30% more at 32^2 and 64^2, where the launch
// dominates.)  The ragged end is masked in the kernel, so no padding is
// needed.  The range of each corner is tested on the float coordinate
// before any cast to int: a NaN or a flow of 1e6 px, which the reference
// sees when a training run diverges, fails the test and never wraps into
// the frame.
// The arithmetic repeats ops/warp.py's plain ops one rounding at a time
// (__fadd_rn and __fmul_rn: no fused multiply-adds), in the order of
// their expressions.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  float v00, v01, v10, v11;   // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), ...
};

// The corners of the point (iy, ix) of one frame img [H, W].
__device__ __forceinline__ Corners gather_corners(
    const float* __restrict__ img, float iy, float ix, int H, int W) {
  const float fy = floorf(iy);
  const float fx = floorf(ix);
  const float hy = static_cast<float>(H - 1);
  const float hx = static_cast<float>(W - 1);
  // every comparison with a NaN is false, so a NaN point has no corner
  const bool y0_in = fy >= 0.0f && fy <= hy;
  const bool y1_in = fy >= -1.0f && fy <= hy - 1.0f;
  const bool x0_in = fx >= 0.0f && fx <= hx;
  const bool x1_in = fx >= -1.0f && fx <= hx - 1.0f;
  // casts only of values inside [-1, H - 1] and [-1, W - 1]
  const int y0 = (y0_in || y1_in) ? static_cast<int>(fy) : 0;
  const int x0 = (x0_in || x1_in) ? static_cast<int>(fx) : 0;
  // an address is formed only for a corner inside the frame
  const long long at = static_cast<long long>(y0) * W + x0;
  Corners c;
  c.v00 = (y0_in && x0_in) ? __ldg(img + at) : 0.0f;
  c.v01 = (y0_in && x1_in) ? __ldg(img + at + 1) : 0.0f;
  c.v10 = (y1_in && x0_in) ? __ldg(img + at + W) : 0.0f;
  c.v11 = (y1_in && x1_in) ? __ldg(img + at + W + 1) : 0.0f;
  return c;
}

__global__ void __launch_bounds__(kThreads)
corner_values_kernel(const float* __restrict__ img,
                     const float* __restrict__ iy,
                     const float* __restrict__ ix,
                     float* __restrict__ out, int N, int P, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int NP = N * P;
  if (i >= NP) return;
  int n = i / P;
  Corners c = gather_corners(img + static_cast<long long>(n) * H * W, iy[i],
                             ix[i], H, W);
  out[i] = c.v00;
  out[NP + i] = c.v01;
  out[2 * NP + i] = c.v10;
  out[3 * NP + i] = c.v11;
}

// A point of the fused kernels: its frame, its unnormalised coordinates
// (ops/warp.py _unnormalize: ((g + 1) * 0.5) * (size - 1)) and the
// bilinear weights of its +1 row and column (_blend: i - floor(i)).
struct Point {
  int n;
  float iy, ix, wy1, wx1;
};

// grid: float32, element (n, yo, xo, k) at n * sn + yo * sy + xo * sx +
// k * sc, k = 0 for x and 1 for y in [-1, 1].
__device__ __forceinline__ Point load_point(const float* __restrict__ grid,
                                            int i, int Ho, int Wo, int H,
                                            int W, long long sn, long long sy,
                                            long long sx, long long sc) {
  Point p;
  const int per_frame = Ho * Wo;
  p.n = i / per_frame;
  const int r = i - p.n * per_frame;
  const int yo = r / Wo;
  const int xo = r - yo * Wo;
  const float* g = grid + p.n * sn + yo * sy + xo * sx;
  const float gx = __ldg(g);
  const float gy = __ldg(g + sc);
  p.ix = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.0f), 0.5f),
                   static_cast<float>(W - 1));
  p.iy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.0f), 0.5f),
                   static_cast<float>(H - 1));
  p.wy1 = __fsub_rn(p.iy, floorf(p.iy));
  p.wx1 = __fsub_rn(p.ix, floorf(p.ix));
  return p;
}

// out: float32 [N, 1, Ho, Wo], sum over a, b of (V_ab * wy_a) * wx_b.
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const float* __restrict__ img,
                const float* __restrict__ grid, float* __restrict__ out,
                int N, int H, int W, int Ho, int Wo, long long sn,
                long long sy, long long sx, long long sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * Ho * Wo) return;
  const Point p = load_point(grid, i, Ho, Wo, H, W, sn, sy, sx, sc);
  const Corners c = gather_corners(img + static_cast<long long>(p.n) * H * W,
                                   p.iy, p.ix, H, W);
  const float wy0 = __fsub_rn(1.0f, p.wy1);
  const float wx0 = __fsub_rn(1.0f, p.wx1);
  float v = __fmul_rn(__fmul_rn(c.v00, wy0), wx0);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(c.v01, wy0), p.wx1));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(c.v10, p.wy1), wx0));
  out[i] = __fadd_rn(v, __fmul_rn(__fmul_rn(c.v11, p.wy1), p.wx1));
}

// g: float32 [N, 1, Ho, Wo] contiguous; dgrid: float32 [N, Ho, Wo, 2],
// d out / d grid of the blend (ops/warp.py _GridSampleOnehot.backward).
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const float* __restrict__ img,
                const float* __restrict__ grid, const float* __restrict__ g,
                float2* __restrict__ dgrid, int N, int H, int W, int Ho,
                int Wo, long long sn, long long sy, long long sx,
                long long sc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * Ho * Wo) return;
  const Point p = load_point(grid, i, Ho, Wo, H, W, sn, sy, sx, sc);
  const Corners c = gather_corners(img + static_cast<long long>(p.n) * H * W,
                                   p.iy, p.ix, H, W);
  const float wy0 = __fsub_rn(1.0f, p.wy1);
  const float wx0 = __fsub_rn(1.0f, p.wx1);
  // d out / d ix = sum_a wy_a * (V_a1 - V_a0); likewise for iy
  const float dv_dx = __fadd_rn(__fmul_rn(wy0, __fsub_rn(c.v01, c.v00)),
                                __fmul_rn(p.wy1, __fsub_rn(c.v11, c.v10)));
  const float dv_dy = __fadd_rn(__fmul_rn(wx0, __fsub_rn(c.v10, c.v00)),
                                __fmul_rn(p.wx1, __fsub_rn(c.v11, c.v01)));
  const float cot = g[i];
  // chain through the [-1, 1] normalisation
  dgrid[i] = make_float2(
      __fmul_rn(__fmul_rn(cot, dv_dx), 0.5f * static_cast<float>(W - 1)),
      __fmul_rn(__fmul_rn(cot, dv_dy), 0.5f * static_cast<float>(H - 1)));
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

bool warp_sizes_fit(int N, int H, int W, int Ho, int Wo) {
  return N > 0 && H > 0 && W > 0 && Ho > 0 && Wo > 0 &&
         static_cast<long long>(N) * Ho * Wo <= INT_MAX &&
         static_cast<long long>(H) * W <= INT_MAX;
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
  corner_values_kernel<<<blocks_for(static_cast<long long>(N) * P), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(iy),
      static_cast<const float*>(ix), static_cast<float*>(out), N, P, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The warp's forward.  img: float32 [N, H, W]; grid: float32 (n, yo, xo,
// k) at the element strides sn, sy, sx, sc; out: float32 [N, Ho, Wo],
// fully written.
extern "C" int warp_fwd(const void* img, const void* grid, void* out, int N,
                        int H, int W, int Ho, int Wo, long long sn,
                        long long sy, long long sx, long long sc,
                        void* stream) {
  if (!warp_sizes_fit(N, H, W, Ho, Wo))
    return static_cast<int>(cudaErrorInvalidValue);
  warp_fwd_kernel<<<blocks_for(static_cast<long long>(N) * Ho * Wo),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(grid),
      static_cast<float*>(out), N, H, W, Ho, Wo, sn, sy, sx, sc);
  return static_cast<int>(cudaGetLastError());
}

// The warp's grid gradient.  img and grid as warp_fwd; g: float32
// [N, Ho, Wo], the cotangent of its output; dgrid: float32 [N, Ho, Wo, 2],
// fully written.
extern "C" int warp_bwd(const void* img, const void* grid, const void* g,
                        void* dgrid, int N, int H, int W, int Ho, int Wo,
                        long long sn, long long sy, long long sx,
                        long long sc, void* stream) {
  if (!warp_sizes_fit(N, H, W, Ho, Wo))
    return static_cast<int>(cudaErrorInvalidValue);
  warp_bwd_kernel<<<blocks_for(static_cast<long long>(N) * Ho * Wo),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(grid),
      static_cast<const float*>(g), static_cast<float2*>(dgrid), N, H, W,
      Ho, Wo, sn, sy, sx, sc);
  return static_cast<int>(cudaGetLastError());
}
