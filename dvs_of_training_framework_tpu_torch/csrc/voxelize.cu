// K1: event -> voxel-grid binning, forward and backward, for Hopper (sm_90a).
//
// Replaces dvs_of_training_framework_tpu/ops/voxel_pallas.py voxelize_pallas
// (_fwd_kernel and _bwd_kernel).  The TPU kernel needed events sorted by
// plane so that one plane's [H, C*W] accumulator could sit in VMEM, and it
// turned each chunk of events into one-hot MXU contractions.  On Hopper a
// 256x256x9 fp32 plane is 2.4 MB, ten times the 227 KB of shared memory a
// block may use, so no plane fits on chip.  What bounds the work here is
// memory traffic: at E = 2^17 events and C = 9 channels the forward reads
// 6.4 MB (the weights and the event fields) and writes an 18.9 MB grid,
// 7.6 us at 3.35 TB/s.
//
// Forward, in a fixed order.  Each grid cell gets the fp32 sum of its
// valid events' weights in ascending event order, the order in which the
// plain twin's serial index_add adds them, so the grid is the same on
// every launch and equals the twin's bit for bit.  Four steps:
//   1. voxelize_count: an integer histogram of valid events per cell
//      (integer atomics are exact);
//   2. the wrapper's inclusive scan of the counts (index preparation,
//      exact), which gives each cell the end of its range;
//   3. a placement pass: each valid event takes a slot in its cell's
//      range by decrementing the cell's count, first come first placed;
//   4. one thread per cell puts its events (at most 8; the bench batches
//      hold at most 4) in ascending order with a sorting network in
//      registers, and the block then writes its cells' slab of the grid
//      with coalesced stores, each element the sum of its cell's events
//      in that order.  A hotter cell (a hot pixel may collect hundreds of
//      events) goes on a list, and a block per listed cell ranks its
//      events (each event's rank is the number of the cell's events below
//      it, counted against the cell's indices staged in shared memory),
//      stages their weights in that order and sums each channel over them
//      in turn.  Every cell is written, zeros included, so the grid needs
//      no separate fill.
// The backward is a plain gather, dw[e, c] = g[plane_e, y_e, x_e, c], and
// writes an explicit zero for invalid rows (the TPU code had to mask
// uninitialised rows afterwards).  Events whose plane or pixel lies
// outside the grid are dropped in both directions, so a bad index cannot
// write out of bounds.  The weights are float32 or, in the bf16 recipe,
// bfloat16: the kernels are templates over the weight type, the grid and
// its gradient stay float32, and the backward rounds dw to the weights'
// type (round to nearest even, as the JAX kernel's final cast).
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFew = 8;               // events a cell sorts in registers
constexpr int kHotBlocks = 264;       // grid of the hot-cell kernel
constexpr int kHotIndices = 2048;     // event indices it stages at a time
constexpr int kHotWeights = 4096;     // weights it stages at a time

// flat cell (p, y, x) of an event, or -1 if it lies outside the grid
__device__ __forceinline__ int cell_index(int p, int y, int x, int P, int H,
                                          int W) {
  if (p < 0 || p >= P || y < 0 || y >= H || x < 0 || x >= W) return -1;
  return (p * H + y) * W + x;
}

__device__ __forceinline__ int event_cell(const int32_t* __restrict__ x,
                                          const int32_t* __restrict__ y,
                                          const int32_t* __restrict__ plane,
                                          const uint8_t* __restrict__ valid,
                                          int e, int P, int H, int W) {
  return valid[e] ? cell_index(plane[e], y[e], x[e], P, H, W) : -1;
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

__global__ void __launch_bounds__(kThreads)
voxelize_count_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ y,
                      const int32_t* __restrict__ plane,
                      const uint8_t* __restrict__ valid,
                      int32_t* __restrict__ counts, int E, int P, int H,
                      int W) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int cell = event_cell(x, y, plane, valid, e, P, H, W);
  if (cell >= 0) atomicAdd(counts + cell, 1);
}

// counts: the histogram, counted down to 0 here; ends: its inclusive
// scan.  A cell's range is [ends[cell] - n, ends[cell]).
__global__ void __launch_bounds__(kThreads)
voxelize_place_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ y,
                      const int32_t* __restrict__ plane,
                      const uint8_t* __restrict__ valid,
                      int32_t* __restrict__ counts,
                      const int32_t* __restrict__ ends,
                      int32_t* __restrict__ order, int E, int P, int H,
                      int W) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int cell = event_cell(x, y, plane, valid, e, P, H, W);
  if (cell < 0) return;
  int left = atomicSub(counts + cell, 1);   // n for the first to arrive
  order[ends[cell] - left] = e;
}

// A block per kThreads consecutive cells.  Each thread puts the events
// of one cell of at most kFew events in ascending order with a sorting
// network in registers and leaves them in shared memory; a hotter cell
// goes on the hot list for voxelize_hot_kernel (hot_count counts the
// list's entries).  Then the block writes its cells' slab of the grid,
// [kThreads, C] contiguous floats, one element a thread in turn, so the
// stores are coalesced; each element sums its cell's events in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
voxelize_sum_kernel(const T* __restrict__ w,
                    const int32_t* __restrict__ ends,
                    const int32_t* __restrict__ order,
                    int32_t* __restrict__ hot_count,
                    int32_t* __restrict__ hot_list,
                    float* __restrict__ out, int cells, int C) {
  __shared__ int32_t sorted[kFew][kThreads];
  __shared__ int32_t count[kThreads];    // events of a cell, -1 if hot
  const int first = blockIdx.x * kThreads;
  const int cell = first + threadIdx.x;
  int n = 0;
  if (cell < cells) {
    int start = cell > 0 ? ends[cell - 1] : 0;
    n = ends[cell] - start;
    if (n > kFew) {
      hot_list[atomicAdd(hot_count, 1)] = cell;
      n = -1;
    } else {
      int32_t events[kFew];
#pragma unroll
      for (int k = 0; k < kFew; ++k)
        events[k] = k < n ? order[start + k] : INT_MAX;
      // a bubble-sort network: ascending event order
#pragma unroll
      for (int i = 0; i < kFew - 1; ++i)
#pragma unroll
        for (int k = 0; k < kFew - 1 - i; ++k) {
          int32_t a = events[k], b = events[k + 1];
          events[k] = min(a, b);
          events[k + 1] = max(a, b);
        }
#pragma unroll
      for (int k = 0; k < kFew; ++k) sorted[k][threadIdx.x] = events[k];
    }
  }
  count[threadIdx.x] = n;
  __syncthreads();
  const int slab = min(kThreads, cells - first) * C;
  float* dst = out + static_cast<long long>(first) * C;
  for (int i = threadIdx.x; i < slab; i += kThreads) {
    int local = i / C, c = i - local * C;
    int m = count[local];
    if (m < 0) continue;                  // the hot kernel writes it
    float sum = 0.0f;
    for (int k = 0; k < m; ++k)
      sum += to_float(w[static_cast<long long>(sorted[k][local]) * C + c]);
    dst[i] = sum;
  }
}

// One block per hot cell (grid-stride over the hot list).  Each event's
// rank in ascending order is the number of the cell's events below it,
// counted against the cell's indices staged kHotIndices at a time; the
// rank places the event in `sorted`.  Then the block stages the weights of
// the sorted events, kHotWeights / C events at a time, and one thread a
// channel (C <= kThreads) adds them in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads)
voxelize_hot_kernel(const T* __restrict__ w,
                    const int32_t* __restrict__ ends,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ hot_count,
                    const int32_t* __restrict__ hot_list,
                    int32_t* __restrict__ sorted,
                    float* __restrict__ out, int C) {
  __shared__ int32_t indices[kHotIndices];
  __shared__ float weights[kHotWeights];
  const int hot = *hot_count;
  for (int h = blockIdx.x; h < hot; h += gridDim.x) {
    const int cell = hot_list[h];
    const int end = ends[cell];
    const int start = cell > 0 ? ends[cell - 1] : 0;
    for (int base = start; base < end; base += kThreads) {
      const int i = base + threadIdx.x;
      const int32_t e = i < end ? order[i] : INT_MAX;
      int rank = 0;
      for (int from = start; from < end; from += kHotIndices) {
        const int m = min(kHotIndices, end - from);
        __syncthreads();
        for (int k = threadIdx.x; k < m; k += kThreads)
          indices[k] = order[from + k];
        __syncthreads();
        for (int k = 0; k < m; ++k) rank += indices[k] < e;
      }
      if (i < end) sorted[start + rank] = e;
    }
    float sum = 0.0f;
    const int run = kHotWeights / C;
    for (int from = start; from < end; from += run) {
      const int m = min(run, end - from);
      __syncthreads();   // `sorted` is complete; the last run is read
      for (int k = threadIdx.x; k < m * C; k += kThreads) {
        int j = k / C, c = k - j * C;
        weights[k] =
            to_float(w[static_cast<long long>(sorted[from + j]) * C + c]);
      }
      __syncthreads();
      if (threadIdx.x < C)
        for (int k = 0; k < m; ++k) sum += weights[k * C + threadIdx.x];
    }
    if (threadIdx.x < C)
      out[static_cast<long long>(cell) * C + threadIdx.x] = sum;
  }
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
  int cell = event_cell(x, y, plane, valid, e, P, H, W);
  float v = cell >= 0 ? g[static_cast<long long>(cell) * C + c] : 0.0f;
  dw[i] = from_float<T>(v);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// E * C and P * H * W as the kernels' 32-bit index range, or false if
// they do not fit.
bool sizes_fit(long long E, int C, int P, int H, int W) {
  return E > 0 && C > 0 && P > 0 && H > 0 && W > 0 && E * C <= INT_MAX &&
         static_cast<long long>(P) * H * W <= INT_MAX;
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

// Step 1 of the forward.  counts: zeroed int32 [P * H * W]; x, y, plane:
// int32 [E]; valid: bool [E].
extern "C" int voxelize_count(const void* x, const void* y, const void* plane,
                              const void* valid, void* counts, long long E,
                              int P, int H, int W, void* stream) {
  if (!sizes_fit(E, 1, P, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  voxelize_count_kernel<<<blocks_for(E), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(plane), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(counts), static_cast<int>(E), P, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Steps 3 and 4.  counts: int32 [P * H * W + 1], voxelize_count's
// histogram (left all zeros) and a zeroed hot-cell counter; ends: int32
// [P * H * W], the histogram's inclusive scan; scratch: int32 [3 * E];
// out: float32 [P, H, W, C], fully written; w: [E, C], bfloat16 if w_bf16
// else float32, C <= 256.  Returns the launches' cudaError_t.
extern "C" int voxelize_fwd(const void* x, const void* y, const void* plane,
                            const void* w, const void* valid, void* counts,
                            const void* ends, void* scratch, void* out,
                            long long E, int C, int P, int H, int W,
                            int w_bf16, void* stream) {
  if (!sizes_fit(E, C, P, H, W) || 3 * E > INT_MAX || C > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int cells = P * H * W;
  auto* count = static_cast<int32_t*>(counts);
  auto* end = static_cast<const int32_t*>(ends);
  auto* order = static_cast<int32_t*>(scratch);
  int32_t* sorted = order + E;
  int32_t* hot_list = sorted + E;
  int32_t* hot_count = count + cells;
  voxelize_place_kernel<<<blocks_for(E), kThreads, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(plane), static_cast<const uint8_t*>(valid),
      count, end, order, static_cast<int>(E), P, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* grid = static_cast<float*>(out);
  if (w_bf16) {
    auto* wt = static_cast<const __nv_bfloat16*>(w);
    voxelize_sum_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
        wt, end, order, hot_count, hot_list, grid, cells, C);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    voxelize_hot_kernel<<<kHotBlocks, kThreads, 0, s>>>(
        wt, end, order, hot_count, hot_list, sorted, grid, C);
  } else {
    auto* wt = static_cast<const float*>(w);
    voxelize_sum_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
        wt, end, order, hot_count, hot_list, grid, cells, C);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    voxelize_hot_kernel<<<kHotBlocks, kThreads, 0, s>>>(
        wt, end, order, hot_count, hot_list, sorted, grid, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: float32 [P, H, W, C]; dw: [E, C] in the weights' type (bfloat16 if
// w_bf16), fully written.
extern "C" int voxelize_bwd(const void* x, const void* y, const void* plane,
                            const void* valid, const void* g, void* dw,
                            long long E, int C, int P, int H, int W,
                            int w_bf16, void* stream) {
  if (!sizes_fit(E, C, P, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  int n = static_cast<int>(E * C);
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
