// K2: the per-(event, channel) temporal-kernel MLP, forward and backward,
// for Hopper (sm_90a), with its three 32x32 products on the tensor cores.
//
// Replaces dvs_of_training_framework_tpu/ops/kernel_mlp_pallas.py
// kernel_mlp_pallas (_fwd_kernel and _bwd_kernel).  Over every element d of
// delta it computes k = w3^T tanh(W2^T tanh(w1 d + b1) + b2) + b3 with a
// hidden size hd <= 32, and the backward returns d(delta) and the seven
// parameter gradients summed over all points.
//
// Bound at the bench shape (delta [9, 2^17], 1,179,648 points, hd 30):
// the forward does ~1,951 flop a point (2.30 GFLOP, 9.4 MB), the backward
// ~5,950 (7.0 GFLOP, 14.2 MB).  All in fp32 on the CUDA cores (67 TFLOP/s)
// that would be 0.034 ms and 0.105 ms, but this design runs the products
// (1,800 flop a point forward, 5,400 backward) on the tensor cores as
// 3xTF32, at a third of the 495 TFLOP/s TF32 peak: 0.0129 ms and 0.0386
// ms.  The 60 tanh a point need one special-function (MUFU) operation
// each at the least, 16 a clock an SM: 0.0169 ms both ways.  The rest of
// the vector work takes 0.0027 and 0.0095 ms on the CUDA cores, device
// memory (3.35 TB/s) 0.0028 and 0.0042 ms.  These units run side by side,
// so the bound is 0.0169 ms forward (MUFU) and 0.0386 ms backward
// (3xTF32).
//
// What holds this design above it: instruction issue on the CUDA cores,
// set by the 64 accurate tanhf a point (each ~15 instructions around two
// MUFU operations, the larger part of the forward's loop) and the
// per-point vector work of the backward; the products, which took 1,024
// scalar FMAs a point forward and three times that backward, run on the
// tensor cores beside them.  On an H100 SXM at 700 W the forward takes
// ~0.092 ms (18% of its bound) and the backward ~0.20 ms (19%), against
// 0.112 and 0.370 ms with scalar FMAs.  A cheaper tanh that keeps fp32
// accuracy is what the forward lacks: tanh.approx errs by ~2^-11.
//
// Why the tensor cores keep fp32 parity: each product runs as 3xTF32.  An
// fp32 operand x splits into x_hi = tf32(x) (11 significant bits, round to
// nearest) and x_lo = tf32(x - x_hi), which together carry x to ~2^-23 of
// its value, and a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi drops only
// a_lo b_lo (~2^-22 relative).  Each product is thus within a few ulp of
// fp32, and a 32-term sum errs by about as much as an fp32 FMA chain.
// The two small terms have an accumulator of their own, added to the
// hi * hi sum once per 8 output columns, so the tensor cores never add a
// small term to a large sum.  Their fp32 accumulation is used only within
// one 16-point tile; tile sums are added into fp32 registers with ordinary
// rounding, and the cross-warp and cross-block sums run in double.
//
// Design (mma.sync.m16n8k8 TF32, fp32 accumulators):
// - A warp owns 16 points a step.  In the accumulator layout a thread
//   holds points g and g+8 (g = lane / 4) and hidden units
//   J(t) = {8k + 2t, 8k + 2t + 1 : k = 0..3} (t = lane % 4).  The k index
//   of every product over the hidden axis is permuted so that an
//   A fragment takes exactly those units: an accumulator tile is the next
//   product's A operand with no data movement, and h1, z2, dz2, dh1 and
//   dz1 of a point stay in the registers of the threads that own it.
// - W2 is staged once per block, zero-padded to 32 x 32 and split into
//   hi and lo, as ready B fragments in shared memory (one 16-byte read a
//   thread per 8x8 block); padded units contribute exact zeros.
// - Forward: z2 = h1 W2 (48 MMAs a tile); tanh, the w3 dot product and a
//   reduction over the four threads of a point on the CUDA cores.
// - Backward: z2 again, dz2 = g w3 (1 - h2^2), dh1 = dz2 W2^T (48 MMAs),
//   dz1 and d(delta) in registers; h1 and dz2 go through a small per-warp
//   shared buffer to be read transposed for dW2 += h1^T dz2 (K = the
//   tile's 16 points, 48 MMAs), whose 32 x 32 sum stays in fp32
//   registers across the block's tiles.  db2, dw1, db1, dw3 and db3 are
//   per-thread fp32 sums over 8 tiles at a time, each then added into the
//   thread's double sum in shared memory, and reduced at the end with
//   warp shuffles in double.
// - Blocks run in no order: each block sums its warps in warp order and
//   writes one partial gradient vector, and a second kernel sums the
//   partials in a fixed order.  The gradients are deterministic.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHidden = 32;                 // padded hidden size
constexpr int kW2 = kHidden * kHidden;      // dW2 entries
// Layout of the gradient vector (floats):
constexpr int kOffDb2 = kW2;                // db2[i]
constexpr int kOffDw1 = kOffDb2 + kHidden;  // dw1[j]
constexpr int kOffDb1 = kOffDw1 + kHidden;  // db1[j]
constexpr int kOffDw3 = kOffDb1 + kHidden;  // dw3[i]
constexpr int kOffDb3 = kOffDw3 + kHidden;  // db3
constexpr int kGrads = kOffDb3 + 1;         // 1153

constexpr int kTile = 16;                   // points a warp takes a step
constexpr int kFrags = 4 * 4 * 32;          // (k step, n tile, lane) of W2
constexpr int kFwdThreads = 256;
constexpr int kFwdBlocksPerSm = 3;
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
// two blocks an SM leave the backward ~230 registers a thread and no
// spills; with three (at most 168) it spilled and ran slower on an H100
constexpr int kBwdBlocksPerSm = 2;
// A thread adds its points' terms of db2, dw1, db1, dw3 and db3 in fp32
// over kFlush tiles, then into its double sums in shared memory, so no
// fp32 sum runs longer than 2 kFlush terms.
constexpr int kFlush = 8;
constexpr int kSums = 4 * 8 + 1;            // a thread's vector sums
constexpr int kBwdDynamicSmem = kSums * kBwdThreads * sizeof(double);
constexpr int kReduceRows = 32;             // rows of the final tree sum
constexpr int kLdS = 40;                    // staging row stride (floats):
                                            // conflict-free both ways
constexpr int kStage = 2 * kTile * kLdS;    // h1 and dz2 of one warp
static_assert(kBwdWarps * kStage >= kBwdWarps * kGrads,
              "the block's reduction reuses the staging buffer");

struct SharedParams {
  float w1[kHidden], b1[kHidden], b2[kHidden], w3[kHidden], b3;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: c += a_hi b_hi and s += a_lo b_hi + a_hi b_lo.  The
// small terms keep an accumulator of their own, so the tensor cores add
// them to sums of their own size, and the two chains of dependent MMAs are
// shorter than one.  b holds the fragment's registers as (hi0, hi1, lo0,
// lo1).
__device__ __forceinline__ void mma3(float (&c)[4], float (&s)[4],
                                     const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint4 b) {
  mma(s, a_lo, b.x, b.y);
  mma(s, a_hi, b.z, b.w);
  mma(c, a_hi, b.x, b.y);
}

// w2 is [hd, hd] row-major with w2[j * hd + i] the weight from hidden unit
// j of layer 1 to unit i of layer 2 (flax's [in, out] kernel layout).
__device__ __forceinline__ float w2_at(const float* __restrict__ w2, int j,
                                       int i, int hd) {
  return (j < hd && i < hd) ? w2[j * hd + i] : 0.0f;
}

__device__ __forceinline__ uint4 fragment(float r0, float r1) {
  uint4 f;
  split(r0, f.x, f.z);
  split(r1, f.y, f.w);
  return f;
}

// Parameters, zero-padded to 32, and W2's B fragments for z2 = h1 W2
// (fwd) and, if bwd is not null, for dh1 = dz2 W2^T.  Fragment
// (ks, nt, lane) holds B[k][n] at k = 2t and 2t + 1 of k step ks (the
// permuted k order that matches J(t)) and n = g of n tile nt.
__device__ void stage_params(SharedParams& s, uint4* fwd, uint4* bwd,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             const float* __restrict__ w3,
                             const float* __restrict__ b3, int hd) {
  for (int f = threadIdx.x; f < kFrags; f += blockDim.x) {
    int ks = f / 128, nt = (f / 32) % 4, lane = f % 32;
    int g = lane / 4, t = lane % 4;
    int k = ks * 8 + 2 * t, n = nt * 8 + g;
    fwd[f] = fragment(w2_at(w2, k, n, hd), w2_at(w2, k + 1, n, hd));
    if (bwd != nullptr)
      bwd[f] = fragment(w2_at(w2, n, k, hd), w2_at(w2, n, k + 1, hd));
  }
  for (int k = threadIdx.x; k < kHidden; k += blockDim.x) {
    bool in = k < hd;
    s.w1[k] = in ? w1[k] : 0.0f;
    s.b1[k] = in ? b1[k] : 0.0f;
    s.b2[k] = in ? b2[k] : 0.0f;
    s.w3[k] = in ? w3[k] : 0.0f;
  }
  if (threadIdx.x == 0) s.b3 = b3[0];
  __syncthreads();
}

// hidden unit of a thread's k2-th register (k2 = 0..7): J(t)
__device__ __forceinline__ int unit(int k2, int t) {
  return 8 * (k2 >> 1) + 2 * t + (k2 & 1);
}

// sum over the four threads of a point (lanes that differ in t), fixed order
__device__ __forceinline__ float sum_over_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over the eight threads of a hidden unit (lanes that differ in g)
__device__ __forceinline__ double sum_over_g(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// sums[v * kBwdThreads] += the thread's fp32 sum v, which is cleared: v =
// 8 q + k2 for db2, dw1, db1 and dw3 (q = 0..3) at unit(k2, t), 32 for db3
__device__ __forceinline__ void flush(double* sums, float (&sdb2)[8],
                                      float (&sdw1)[8], float (&sdb1)[8],
                                      float (&sdw3)[8], float& sdb3) {
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    sums[k2 * kBwdThreads] += sdb2[k2];
    sums[(8 + k2) * kBwdThreads] += sdw1[k2];
    sums[(16 + k2) * kBwdThreads] += sdb1[k2];
    sums[(24 + k2) * kBwdThreads] += sdw3[k2];
    sdb2[k2] = sdw1[k2] = sdb1[k2] = sdw3[k2] = 0.0f;
  }
  sums[32 * kBwdThreads] += sdb3;
  sdb3 = 0.0f;
}

// h1 of points g (r = 0) and g + 8 (r = 1) at the thread's units, split
// into A fragments: a[ks][2e + r] is h1[r][unit(2ks + e)].
__device__ __forceinline__ void hidden1(const SharedParams& s, int t, float d0,
                                        float d1, float (&h1)[2][8],
                                        uint32_t (&a_hi)[4][4],
                                        uint32_t (&a_lo)[4][4]) {
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    int j = unit(k2, t);
    h1[0][k2] = tanhf(fmaf(s.w1[j], d0, s.b1[j]));
    h1[1][k2] = tanhf(fmaf(s.w1[j], d1, s.b1[j]));
    int ks = k2 >> 1, e = k2 & 1;
    split(h1[0][k2], a_hi[ks][2 * e], a_lo[ks][2 * e]);
    split(h1[1][k2], a_hi[ks][2 * e + 1], a_lo[ks][2 * e + 1]);
  }
}

// one n tile of a product over the hidden axis: c = A B[:, 8 nt .. 8 nt + 8]
__device__ __forceinline__ void product_tile(float (&c)[4], const uint4* frags,
                                             int nt, int lane,
                                             const uint32_t (&a_hi)[4][4],
                                             const uint32_t (&a_lo)[4][4]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mma3(c, s, a_hi[ks], a_lo[ks], frags[(ks * 4 + nt) * 32 + lane]);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += s[r];
}

__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
kernel_mlp_fwd_kernel(const float* __restrict__ delta,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ out,
                      long long n, int hd) {
  __shared__ SharedParams s;
  __shared__ uint4 frags[kFrags];
  stage_params(s, frags, nullptr, w1, b1, w2, b2, w3, b3, hd);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (kFwdThreads / 32);
  for (long long tile = blockIdx.x * (kFwdThreads / 32) + threadIdx.x / 32;
       tile < tiles; tile += warps) {
    long long p0 = tile * kTile + g, p1 = p0 + 8;
    float d0 = p0 < n ? delta[p0] : 0.0f;
    float d1 = p1 < n ? delta[p1] : 0.0f;
    float h1[2][8];
    uint32_t a_hi[4][4], a_lo[4][4];
    hidden1(s, t, d0, d1, h1, a_hi, a_lo);
    float k0 = 0.0f, k1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float c[4];   // z2 of (g, 2nt), (g, 2nt+1), (g+8, 2nt), (g+8, 2nt+1)
      product_tile(c, frags, nt, lane, a_hi, a_lo);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int i = unit(2 * nt + e, t);
        k0 = fmaf(s.w3[i], tanhf(c[e] + s.b2[i]), k0);
        k1 = fmaf(s.w3[i], tanhf(c[2 + e] + s.b2[i]), k1);
      }
    }
    k0 = sum_over_t(k0);
    k1 = sum_over_t(k1);
    if (t == 0) {
      if (p0 < n) out[p0] = k0 + s.b3;
      if (p1 < n) out[p1] = k1 + s.b3;
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
kernel_mlp_bwd_kernel(const float* __restrict__ delta,
                      const float* __restrict__ g,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3,
                      float* __restrict__ d_delta,   // may be null
                      float* __restrict__ partials,  // [gridDim.x, kGrads]
                      long long n, int hd) {
  __shared__ SharedParams s;
  __shared__ uint4 frags_fwd[kFrags];
  __shared__ uint4 frags_bwd[kFrags];
  __shared__ float stage[kBwdWarps * kStage];
  extern __shared__ double dynamic_smem[];   // [kSums][kBwdThreads]
  double* sums = dynamic_smem + threadIdx.x;
  for (int v = 0; v < kSums; ++v) sums[v * kBwdThreads] = 0.0;
  stage_params(s, frags_fwd, frags_bwd, w1, b1, w2, b2, w3, b3, hd);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  float* h1s = stage + warp * kStage;   // [16 points][kLdS], column = unit
  float* dz2s = h1s + kTile * kLdS;
  // dW2[j][i] for j = 16 mt + gq (+8 for c[2], c[3]), i = 8 nt + 2t (+1)
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;
  // sums at the thread's units J(t) over its points since the last flush
  float sdb2[8], sdw1[8], sdb1[8], sdw3[8];
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) sdb2[k2] = sdw1[k2] = sdb1[k2] = sdw3[k2] = 0;
  float sdb3 = 0.0f;

  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = static_cast<long long>(gridDim.x) * kBwdWarps;
  int unflushed = 0;
  for (long long tile = blockIdx.x * kBwdWarps + warp; tile < tiles;
       tile += warps) {
    // Points past n carry d = g = 0, so every term they add is an exact 0.
    long long p0 = tile * kTile + gq, p1 = p0 + 8;
    float d[2] = {p0 < n ? delta[p0] : 0.0f, p1 < n ? delta[p1] : 0.0f};
    float q[2] = {p0 < n ? g[p0] : 0.0f, p1 < n ? g[p1] : 0.0f};
    float h1[2][8];
    uint32_t a_hi[4][4], a_lo[4][4];
    hidden1(s, t, d[0], d[1], h1, a_hi, a_lo);

    // z2 = h1 W2, then dz2 = g w3 (1 - h2^2), as the next A fragments
    float dz2[2][8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float c[4];
      product_tile(c, frags_fwd, nt, lane, a_hi, a_lo);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int k2 = 2 * nt + e, i = unit(k2, t);
          float h2 = tanhf(c[2 * r + e] + s.b2[i]);
          float dz = q[r] * s.w3[i] * (1.0f - h2 * h2);
          dz2[r][k2] = dz;
          sdb2[k2] += dz;
          sdw3[k2] = fmaf(q[r], h2, sdw3[k2]);
        }
    }
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      int ks = k2 >> 1, e = k2 & 1;
      split(dz2[0][k2], a_hi[ks][2 * e], a_lo[ks][2 * e]);
      split(dz2[1][k2], a_hi[ks][2 * e + 1], a_lo[ks][2 * e + 1]);
    }

    // dh1 = dz2 W2^T, dz1 = dh1 (1 - h1^2), d(delta) = w1 . dz1
    float dd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float c[4];
      product_tile(c, frags_bwd, nt, lane, a_hi, a_lo);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int k2 = 2 * nt + e, j = unit(k2, t);
          float h = h1[r][k2];
          float dz1 = c[2 * r + e] * (1.0f - h * h);
          dd[r] = fmaf(s.w1[j], dz1, dd[r]);
          sdb1[k2] += dz1;
          sdw1[k2] = fmaf(dz1, d[r], sdw1[k2]);
        }
    }
    dd[0] = sum_over_t(dd[0]);
    dd[1] = sum_over_t(dd[1]);
    if (t == 0) {
      if (d_delta != nullptr) {
        if (p0 < n) d_delta[p0] = dd[0];
        if (p1 < n) d_delta[p1] = dd[1];
      }
      sdb3 += q[0] + q[1];
    }

    // dW2 += h1^T dz2 over the tile's 16 points: stage both by point
    // row, read them back transposed as fragments (K = points)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        int col = (gq + 8 * r) * kLdS + 8 * ks + 2 * t;
        *reinterpret_cast<float2*>(h1s + col) =
            make_float2(h1[r][2 * ks], h1[r][2 * ks + 1]);
        *reinterpret_cast<float2*>(dz2s + col) =
            make_float2(dz2[r][2 * ks], dz2[r][2 * ks + 1]);
      }
    __syncwarp();
    uint32_t ah[2][2][4], al[2][2][4];   // [mt][ks]: h1^T, rows j, cols p
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int p = ks * 8 + t + 4 * (r >> 1), j = mt * 16 + gq + 8 * (r & 1);
          split(h1s[p * kLdS + j], ah[mt][ks][r], al[mt][ks][r]);
        }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint4 bf[2];                       // [ks]: dz2, rows p, cols i
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        int p = ks * 8 + t, i = nt * 8 + gq;
        split(dz2s[p * kLdS + i], bf[ks].x, bf[ks].z);
        split(dz2s[(p + 4) * kLdS + i], bf[ks].y, bf[ks].w);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma3(c, s, ah[mt][ks], al[mt][ks], bf[ks]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] += c[r] + s[r];
      }
    }
    __syncwarp();   // the next tile overwrites the staged values
    if (++unflushed == kFlush) {
      flush(sums, sdb2, sdw1, sdb1, sdw3, sdb3);
      unflushed = 0;
    }
  }
  flush(sums, sdb2, sdw1, sdb1, sdw3, sdb3);

  // Reduce the vectors over the threads of a unit in double, then the
  // warps of the block in warp order, into this block's partial.
  __syncthreads();                      // every warp is done with staging
  float* red = stage + warp * kGrads;   // [kBwdWarps][kGrads]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int j = mt * 16 + gq + 8 * (r >> 1), i = nt * 8 + 2 * t + (r & 1);
        red[j * kHidden + i] = acc[mt][nt][r];
      }
  // db2, dw1, db1 and dw3 lie in that order from kOffDb2, 32 each
  for (int v = 0; v < kSums - 1; ++v) {
    double sum = sum_over_g(sums[v * kBwdThreads]);
    if (gq == 0)
      red[kOffDb2 + 32 * (v / 8) + unit(v % 8, t)] = static_cast<float>(sum);
  }
  double sum_db3 = sum_over_g(sums[(kSums - 1) * kBwdThreads]);
  if (lane == 0) red[kOffDb3] = static_cast<float>(sum_db3);
  __syncthreads();
  float* part = partials + static_cast<long long>(blockIdx.x) * kGrads;
  for (int k = threadIdx.x; k < kGrads; k += kBwdThreads) {
    double sum = stage[k];   // the warps in order, rounded once
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) sum += stage[w * kGrads + k];
    part[k] = static_cast<float>(sum);
  }
}

// grads[k] = sum over blocks b of partials[b, k] in a fixed order, in
// double and rounded once: row r of a block sums the blocks b = r mod 32
// in order (coalesced over 32 consecutive k), then the 32 rows are summed
// pairwise.
__global__ void __launch_bounds__(32 * kReduceRows)
kernel_mlp_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ grads, int blocks) {
  __shared__ double rows[kReduceRows][33];
  const int col = threadIdx.x % 32, row = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + col;
  double sum = 0.0;
  if (k < kGrads)
    for (int b = row; b < blocks; b += kReduceRows)
      sum += partials[static_cast<long long>(b) * kGrads + k];
  rows[row][col] = sum;
  __syncthreads();
#pragma unroll
  for (int half = kReduceRows / 2; half > 0; half /= 2) {
    if (row < half) rows[row][col] += rows[row + half][col];
    __syncthreads();
  }
  if (row == 0 && k < kGrads) grads[k] = static_cast<float>(rows[0][col]);
}

// Blocks of a persistent grid over `tiles` warp tiles: as many as fit on
// the card at once, and no more than there is work for.
template <typename Kernel>
int grid_size(Kernel kernel, int threads, int dynamic_smem, long long tiles,
              int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dynamic_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long wanted = (tiles + threads / 32 - 1) / (threads / 32);
  long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(wanted < most ? wanted : most);
  return 0;
}

// The backward's static arrays and double sums pass the 48 KB of shared
// memory a block gets without asking.
int allow_bwd_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdDynamicSmem));
}

}  // namespace

// Length of the gradient vector that kernel_mlp_bwd writes.
extern "C" int kernel_mlp_grad_size() { return kGrads; }

// Blocks of the backward's grid for n points on the current device (the
// rows of its partials), or a negative cudaError_t.
extern "C" int kernel_mlp_bwd_blocks(long long n) {
  if (n <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  int err = allow_bwd_smem();
  if (err == 0)
    err = grid_size(kernel_mlp_bwd_kernel, kBwdThreads, kBwdDynamicSmem,
                    (n + kTile - 1) / kTile, &blocks);
  return err != 0 ? -err : blocks;
}

// out: float32 shaped like delta.  Parameters float32 contiguous:
// w1 [1, hd], b1 [hd], w2 [hd, hd], b2 [hd], w3 [hd, 1], b3 [1].
extern "C" int kernel_mlp_fwd(const void* delta, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* w3, const void* b3, void* out,
                              long long n, int hd, void* stream) {
  if (n <= 0 || hd < 1 || hd > kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  int err = grid_size(kernel_mlp_fwd_kernel, kFwdThreads, 0,
                      (n + kTile - 1) / kTile, &blocks);
  if (err != 0) return err;
  kernel_mlp_fwd_kernel<<<blocks, kFwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n, hd);
  return static_cast<int>(cudaGetLastError());
}

// d_delta: float32 shaped like delta, or null to skip it.  partials:
// float32 [blocks, kernel_mlp_grad_size()] scratch, blocks from
// kernel_mlp_bwd_blocks(n).  grads: float32 [kernel_mlp_grad_size()] laid
// out as dW2 (32 x 32, padded), db2, dw1, db1, dw3 (32 each, padded) and
// db3.
extern "C" int kernel_mlp_bwd(const void* delta, const void* g,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              void* d_delta, void* partials, void* grads,
                              long long n, int hd, int blocks, void* stream) {
  if (n <= 0 || hd < 1 || hd > kHidden || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = allow_bwd_smem();
  if (status != 0) return status;
  kernel_mlp_bwd_kernel<<<blocks, kBwdThreads, kBwdDynamicSmem, st>>>(
      static_cast<const float*>(delta), static_cast<const float*>(g),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(d_delta), static_cast<float*>(partials), n, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_mlp_reduce_kernel<<<(kGrads + 31) / 32, 32 * kReduceRows, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(grads),
      blocks);
  return static_cast<int>(cudaGetLastError());
}
