// K2: the per-(event, channel) temporal-kernel MLP, forward and backward,
// for Hopper (sm_90a).
//
// Replaces dvs_of_training_framework_tpu/ops/kernel_mlp_pallas.py
// kernel_mlp_pallas (_fwd_kernel and _bwd_kernel).  Over every element d of
// delta it computes k = w3^T tanh(W2^T tanh(w1 d + b1) + b2) + b3 with a
// hidden size hd <= 32, and the backward returns d(delta) and the seven
// parameter gradients summed over all points.
//
// What bounds it on this card: arithmetic and shared-memory bandwidth, not
// device memory.  The TPU kernel packed four point groups block-diagonally
// so that its 30x30 product filled the MXU.  Here each point costs ~32 x 32
// fp32 FMAs and 64 tanhf forward (about three times that backward) for 8
// bytes of traffic, far above the card's byte-to-FLOP balance, so the
// design keeps every intermediate in registers or shared memory and
// touches device memory only for delta, the cotangent and the outputs.
// Tensor cores are not used: TF32 would break fp32 parity.
//
// Design:
// - Parameters are staged once per block into shared memory, zero-padded to
//   32 x 32, so every loop has a compile-time trip count and unrolls into
//   registers; padded units contribute exact zeros.  All threads of a warp
//   read the same parameter words at a time (broadcast, vectorised loads).
// - Forward: one thread per point; b3 is added in the kernel.
// - Backward: a block of 128 threads walks 128-point tiles (grid-stride).
//   Phase 1, one thread per point: recompute h1 and h2, form dz2 and dz1,
//   write d(delta), and stage h1, dz2, dz1 and g * h2 of the tile in
//   shared memory.  Phase 2 reduces the tile into the parameter gradients,
//   which are sums over all points: each thread owns 8 entries of dW2 (8
//   rows j, one column i = its lane) and accumulates h1[q, j] dz2[q, i]
//   over the tile's points q, reading h1 four points at a time (the staged
//   h1 is transposed so that those reads are aligned float4 broadcasts);
//   each warp also owns one 32-vector among db2, dw1, db1 and dw3, and
//   warp 0 the scalar db3.  The running sums stay in registers across
//   tiles.  Blocks run in no order, so each block writes its partial
//   gradient vector and a second small kernel sums the partials over
//   blocks in a fixed order: the gradients are deterministic.
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
// the backward's warps 0..3 write db2, dw1, db1, dw3 as one run
static_assert(kOffDw1 == kOffDb2 + kHidden && kOffDb1 == kOffDw1 + kHidden &&
              kOffDw3 == kOffDb1 + kHidden, "vector gradients must be "
              "consecutive");

constexpr int kFwdThreads = 256;
constexpr int kTile = 128;                  // points per tile = threads
constexpr int kWarps = kTile / 32;
constexpr int kRows = kHidden / kWarps;     // dW2 rows per thread (8)
constexpr int kLdB = kHidden + 1;           // dz2 tile row [q][i], padded
constexpr int kLdT = kTile + 1;             // transposed tile row [j][q]
// Dynamic shared memory of the backward, in floats:
//   h1t [32][128] (h1, transposed: aligned float4 reads along q)
//   dz2 [128][33], dz1t [32][129], gh2t [32][129], d [128], g [128]
constexpr int kBwdSmemFloats = kHidden * kTile + kTile * kLdB +
                               2 * kHidden * kLdT + 2 * kTile;
constexpr int kBwdSmemBytes = kBwdSmemFloats * 4;   // 67,328
constexpr int kBwdBlocksPerSm = 3;

struct SharedParams {
  float w1[kHidden], b1[kHidden], w2[kW2], b2[kHidden], w3[kHidden], b3;
};

// w2 is [hd, hd] row-major with w2[j * hd + i] the weight from hidden unit
// j of layer 1 to unit i of layer 2 (flax's [in, out] kernel layout).
__device__ void stage_params(SharedParams& s, const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             const float* __restrict__ w3,
                             const float* __restrict__ b3, int hd) {
  for (int k = threadIdx.x; k < kW2; k += blockDim.x) {
    int j = k / kHidden, i = k % kHidden;
    s.w2[k] = (j < hd && i < hd) ? w2[j * hd + i] : 0.0f;
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

__global__ void __launch_bounds__(kFwdThreads)
kernel_mlp_fwd_kernel(const float* __restrict__ delta,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ out,
                      long long n, int hd) {
  __shared__ SharedParams s;
  stage_params(s, w1, b1, w2, b2, w3, b3, hd);
  long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float d = delta[p];
  // z2[i] = sum_j h1[j] W2[j, i], row by row of W2 (float4 broadcasts)
  float z2[kHidden];
#pragma unroll
  for (int i = 0; i < kHidden; ++i) z2[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < kHidden; ++j) {
    float h1 = tanhf(fmaf(s.w1[j], d, s.b1[j]));
#pragma unroll
    for (int i = 0; i < kHidden; ++i)
      z2[i] = fmaf(h1, s.w2[j * kHidden + i], z2[i]);
  }
  float k = 0.0f;
#pragma unroll
  for (int i = 0; i < kHidden; ++i)
    k = fmaf(s.w3[i], tanhf(z2[i] + s.b2[i]), k);
  out[p] = k + s.b3;
}

__global__ void __launch_bounds__(kTile, kBwdBlocksPerSm)
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
  extern __shared__ float4 dynamic_smem[];
  float* h1t = reinterpret_cast<float*>(dynamic_smem);  // [32][kTile]
  float* dz2 = h1t + kHidden * kTile;                   // [kTile][kLdB]
  float* dz1t = dz2 + kTile * kLdB;                     // [32][kLdT]
  float* gh2t = dz1t + kHidden * kLdT;                  // [32][kLdT]
  float* dq = gh2t + kHidden * kLdT;                    // [kTile]
  float* gq = dq + kTile;                               // [kTile]
  stage_params(s, w1, b1, w2, b2, w3, b3, hd);

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int row0 = warp * kRows;     // this thread's dW2 rows, column lane
  float acc[kRows];                  // dW2[row0 + r, lane]
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  float vec = 0.0f;                  // warp 0 db2, 1 dw1, 2 db1, 3 dw3
  float g_sum = 0.0f;                // warp 0: partial of db3

  const long long tiles = (n + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Phase 1, one point per thread.  Points past n carry d = g = 0, so
    // every term they add below is an exact zero.
    long long p = tile * kTile + t;
    bool in = p < n;
    float d = in ? delta[p] : 0.0f;
    float gp = in ? g[p] : 0.0f;
    // Only z2 lives in registers across the loops; h1 goes to shared
    // memory as soon as it is made and is read back from there.
    float z2[kHidden];
#pragma unroll
    for (int i = 0; i < kHidden; ++i) z2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      float h1 = tanhf(fmaf(s.w1[j], d, s.b1[j]));
      h1t[j * kTile + t] = h1;
#pragma unroll
      for (int i = 0; i < kHidden; ++i)
        z2[i] = fmaf(h1, s.w2[j * kHidden + i], z2[i]);
    }
#pragma unroll
    for (int i = 0; i < kHidden; ++i) {
      float h2 = tanhf(z2[i] + s.b2[i]);
      z2[i] = gp * s.w3[i] * (1.0f - h2 * h2);                  // now dz2
      dz2[t * kLdB + i] = z2[i];
      gh2t[i * kLdT + t] = gp * h2;
    }
    // Both loops over W2 read the same 1,024 shared words.  Without this
    // compiler-only fence the compiler keeps the first loop's loads live
    // for the second (and across tiles), and spills them to local memory;
    // with it, each loop reads W2 as shared-memory broadcasts.
    asm volatile("" ::: "memory");
    float dd = 0.0f;
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      float dh1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kHidden; ++i)
        dh1 = fmaf(s.w2[j * kHidden + i], z2[i], dh1);
      float h1 = h1t[j * kTile + t];
      float dz1 = dh1 * (1.0f - h1 * h1);
      dz1t[j * kLdT + t] = dz1;
      dd = fmaf(s.w1[j], dz1, dd);
    }
    dq[t] = d;
    gq[t] = gp;
    if (in && d_delta != nullptr) d_delta[p] = dd;
    __syncthreads();

    // Phase 2: dW2[j, i] += sum_q h1[q, j] dz2[q, i], four points a step
    // (not unrolled further: 32 registers of h1 per step are enough).
#pragma unroll 1
    for (int q = 0; q < kTile; q += 4) {
      float b0 = dz2[(q + 0) * kLdB + lane];
      float b1v = dz2[(q + 1) * kLdB + lane];
      float b2v = dz2[(q + 2) * kLdB + lane];
      float b3v = dz2[(q + 3) * kLdB + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float4 a = *reinterpret_cast<const float4*>(
            h1t + (row0 + r) * kTile + q);
        acc[r] = fmaf(a.x, b0, acc[r]);
        acc[r] = fmaf(a.y, b1v, acc[r]);
        acc[r] = fmaf(a.z, b2v, acc[r]);
        acc[r] = fmaf(a.w, b3v, acc[r]);
      }
    }
    // One 32-vector per warp, entry = lane; warp 0 also sums g for db3.
    float sum = 0.0f;
    if (warp == 0) {
      for (int q = 0; q < kTile; ++q) sum += dz2[q * kLdB + lane];
      g_sum += gq[lane] + gq[lane + 32] + gq[lane + 64] + gq[lane + 96];
    } else if (warp == 1) {
      for (int q = 0; q < kTile; ++q)
        sum = fmaf(dz1t[lane * kLdT + q], dq[q], sum);
    } else if (warp == 2) {
      for (int q = 0; q < kTile; ++q) sum += dz1t[lane * kLdT + q];
    } else {
      for (int q = 0; q < kTile; ++q) sum += gh2t[lane * kLdT + q];
    }
    vec += sum;
    __syncthreads();   // the next tile overwrites the staged values
  }

  float* part = partials + static_cast<long long>(blockIdx.x) * kGrads;
#pragma unroll
  for (int r = 0; r < kRows; ++r) part[(row0 + r) * kHidden + lane] = acc[r];
  // warps 0..3 hold db2, dw1, db1, dw3: consecutive in the layout
  part[kOffDb2 + warp * kHidden + lane] = vec;
  if (warp == 0) {
#pragma unroll
    for (int offset = 16; offset > 0; offset /= 2)
      g_sum += __shfl_xor_sync(0xffffffffu, g_sum, offset);
    if (lane == 0) part[kOffDb3] = g_sum;
  }
}

// grads[k] = sum over blocks b of partials[b, k], in block order.
__global__ void kernel_mlp_reduce_kernel(const float* __restrict__ partials,
                                         float* __restrict__ grads,
                                         int blocks) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kGrads) return;
  float sum = 0.0f;
  for (int b = 0; b < blocks; ++b)
    sum += partials[static_cast<long long>(b) * kGrads + k];
  grads[k] = sum;
}

}  // namespace

// Length of the gradient vector that kernel_mlp_bwd writes.
extern "C" int kernel_mlp_grad_size() { return kGrads; }

// out: float32 shaped like delta.  Parameters float32 contiguous:
// w1 [1, hd], b1 [hd], w2 [hd, hd], b2 [hd], w3 [hd, 1], b3 [1].
extern "C" int kernel_mlp_fwd(const void* delta, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* w3, const void* b3, void* out,
                              long long n, int hd, void* stream) {
  if (n <= 0 || hd < 1 || hd > kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks =
      static_cast<unsigned int>((n + kFwdThreads - 1) / kFwdThreads);
  kernel_mlp_fwd_kernel<<<blocks, kFwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), n, hd);
  return static_cast<int>(cudaGetLastError());
}

// d_delta: float32 shaped like delta, or null to skip it.  partials:
// float32 [blocks, kernel_mlp_grad_size()] scratch.  grads: float32
// [kernel_mlp_grad_size()] laid out as dW2 (32 x 32, padded), db2, dw1, db1,
// dw3 (32 each, padded) and db3.
extern "C" int kernel_mlp_bwd(const void* delta, const void* g,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* w3, const void* b3,
                              void* d_delta, void* partials, void* grads,
                              long long n, int hd, int blocks, void* stream) {
  if (n <= 0 || hd < 1 || hd > kHidden || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_mlp_bwd_kernel<<<blocks, kTile, kBwdSmemBytes, st>>>(
      static_cast<const float*>(delta), static_cast<const float*>(g),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(d_delta), static_cast<float*>(partials), n, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_mlp_reduce_kernel<<<(kGrads + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(grads),
      blocks);
  return static_cast<int>(cudaGetLastError());
}
