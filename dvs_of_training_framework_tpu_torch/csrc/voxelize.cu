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
// 7.3 us at 3.35 TB/s.
//
// Forward, in a fixed order, by tiles of cells.  A tile is up to 256
// cells of one image row of one plane: [256, C] floats, 9 KB at C = 9, so
// the bench grid has 2,048 tiles of ~55 events each.  Each grid cell gets
// the fp32 sum of its valid events' weights in ascending event order, the
// order in which the plain twin's serial index_add adds them, so the grid
// is the same on every launch and equals the twin's bit for bit.  Two
// kernels, no zero fill and no global atomics on the bench batch:
//   1. voxelize_bucket_kernel: each block takes a range of events and
//      puts each valid event's key (its cell in the tile, then its index:
//      8 + 17 bits at the bench shape, 64 bits where they do not fit 32)
//      into its own region, grouped by tile: it counts its events per
//      tile in shared memory, scans the counts into a row of group starts
//      (written out for step 2) and places each event at its tile's next
//      slot.
//   2. voxelize_tile_kernel, a block per tile, gathers the tile's groups
//      from every bucket block's region (a scan of the column of group
//      sizes) and sorts the keys, which puts each cell's events in
//      ascending order.  A thread per cell then sums its run of events in
//      that order into a shared-memory tile, all of an event's channels
//      loaded at once; a run longer than kLongRun (a hot pixel) is summed
//      by a thread per channel instead, from weights the block stages in
//      shared memory kStage events at a time.  The block writes the tile
//      once with 16-byte stores.  Any number of channels: the sort is done
//      once, and above kChannelGroup channels the sums and the write run
//      over groups of kChannelGroup, so the shared-memory tile stays
//      [256, 32] floats at most; that case is an instance of its own, and
//      up to kChannelGroup channels compile to the one pass with no group
//      arithmetic.  The sort ranks each run of 256 keys against each other and merges the runs pairwise by rank (a binary
//      search) in shared memory, up to kChunk keys; a larger tile is
//      sorted in chunks of kChunk, which are then merged in global
//      scratch, so a hot pixel costs a sort, not n^2 comparisons, and its
//      sum still runs in event order.  Every cell is
//      written, zeros included, so the grid needs no fill.
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
constexpr int kCellBits = 8;
constexpr int kTileCells = 1 << kCellBits;   // cells of a tile, one row
constexpr int kBlockEvents = 1024;    // events a bucket block takes, or more
constexpr int kMaxTiles = 49152;      // tile counters a bucket block holds
constexpr int kChunk = 2048;          // keys a tile block sorts on chip
constexpr int kLongRun = 16;          // a longer run is summed by channel
constexpr int kStage = kThreads;      // sorted events staged at a time
constexpr int kTileBlocksPerSM = 6;   // tile blocks an SM holds at once
constexpr int kGroup = 16;            // channels a thread loads at a time
constexpr int kChannelGroup = 32;     // channels a tile sums at a time
constexpr int kScanPer = 8;           // counts a thread scans at a time

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

// The tile of a valid event inside the grid, or -1; `local` gets its cell
// in the tile.  A row of W cells holds per_row tiles.
__device__ __forceinline__ int event_tile(const int32_t* __restrict__ x,
                                          const int32_t* __restrict__ y,
                                          const int32_t* __restrict__ plane,
                                          const uint8_t* __restrict__ valid,
                                          int e, int P, int H, int W,
                                          int per_row, int* local) {
  if (!valid[e]) return -1;
  const int p = plane[e], yy = y[e], xx = x[e];
  if (p < 0 || p >= P || yy < 0 || yy >= H || xx < 0 || xx >= W) return -1;
  *local = xx & (kTileCells - 1);
  return (p * H + yy) * per_row + (xx >> kCellBits);
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

// Exclusive scan over the block of one value a thread (every thread of
// the block calls it); *total gets the sum.  Ends with a barrier.
__device__ int block_scan(int v, int* total) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = v;   // inclusive scan over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, sum, d);
    if (lane >= d) sum += up;
  }
  if (lane == 31) warp_sums[warp] = sum;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) before += warp_sums[q];
    all += warp_sums[q];
  }
  __syncthreads();   // warp_sums is rewritten by the next call
  *total = all;
  return before + sum - v;
}

// Step 1, a bucket block per range of events: block b takes events
// [b * per, min(E, (b + 1) * per)) and puts the key of each valid one
// (its cell in its tile, then its index) into its own region of `region`,
// which begins at b * per, grouped by tile in any order within a tile.
// Row b of offsets, int32 [gridDim.x, T + 1], gets the start of each
// tile's group in the region and, last, the block's count.  The block
// counts its events per tile in shared memory, scans the counts, and
// places each event at its tile's next slot; no global atomics.  Block 0
// also zeroes *scratch_top for step 2.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
voxelize_bucket_kernel(const int32_t* __restrict__ x,
                       const int32_t* __restrict__ y,
                       const int32_t* __restrict__ plane,
                       const uint8_t* __restrict__ valid,
                       int32_t* __restrict__ offsets,
                       Key* __restrict__ region, int32_t* scratch_top, int E,
                       int per, int P, int H, int W, int per_row, int T,
                       int event_bits) {
  extern __shared__ int32_t hist[];   // [T]: counts, starts, then cursors
  if (blockIdx.x == 0 && threadIdx.x == 0) *scratch_top = 0;
  for (int t = threadIdx.x; t < T; t += kThreads) hist[t] = 0;
  __syncthreads();
  const int e0 = blockIdx.x * per, e1 = min(E, e0 + per);
  int local;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int t = event_tile(x, y, plane, valid, e, P, H, W, per_row, &local);
    if (t >= 0) atomicAdd(hist + t, 1);
  }
  __syncthreads();
  int32_t* row = offsets + static_cast<long long>(blockIdx.x) * (T + 1);
  int carry = 0;
  for (int base = 0; base < T; base += kThreads * kScanPer) {
    const int start = base + threadIdx.x * kScanPer;
    int own = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k)
      if (start + k < T) own += hist[start + k];
    int total;
    int at = carry + block_scan(own, &total);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k)
      if (start + k < T) {
        const int n = hist[start + k];
        hist[start + k] = row[start + k] = at;
        at += n;
      }
    carry += total;
  }
  if (threadIdx.x == 0) row[T] = carry;
  __syncthreads();
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int t = event_tile(x, y, plane, valid, e, P, H, W, per_row, &local);
    if (t >= 0)
      region[e0 + atomicAdd(hist + t, 1)] =
          (static_cast<Key>(local) << event_bits) | static_cast<Key>(e);
  }
}

// Merges the sorted runs of `width` keys of src (width a power of two)
// pairwise, doubling, between src and dst: each key goes to its rank in
// its own run plus its rank in the other (a binary search).  The keys are
// distinct (each holds its event index).  Returns the buffer that holds
// the sorted keys; global writes are visible to the block after each
// barrier.
template <typename Key>
__device__ Key* merge_runs(Key* src, Key* dst, int n, int width) {
  for (; width < n; width <<= 1) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int own = i / width * width;
      const int other = own ^ width;
      const Key k = src[i];
      int lo = min(other, n), hi = min(other + width, n);
      const int from = lo;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (src[mid] < k) lo = mid + 1;
        else hi = mid;
      }
      dst[min(own, other) + (i - own) + (lo - from)] = k;
    }
    __syncthreads();
    Key* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Sorts the n <= kChunk keys of a, with b as scratch of the same size:
// each run of kThreads keys is ranked (a key's rank is the number of keys
// below it in its run), then the runs are merged.  Returns the buffer that
// holds the sorted keys.
template <typename Key>
__device__ Key* sort_on_chip(Key* a, Key* b, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int run = i - threadIdx.x, m = min(kThreads, n - run);
    const Key own = a[i];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += a[run + j] < own;
    b[run + rank] = own;
  }
  __syncthreads();
  return merge_runs(b, a, n, kThreads);
}

// Sorts a bucket of n > kChunk keys: each chunk of kChunk on chip (in the
// shared buffers a and b) and written back in place, then the chunks
// merged between the bucket and scratch.  Returns where the sorted keys
// are.
template <typename Key>
__device__ const Key* sort_in_global(Key* bucket, Key* scratch, int n, Key* a,
                                     Key* b) {
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    for (int i = threadIdx.x; i < m; i += kThreads) a[i] = bucket[c0 + i];
    __syncthreads();
    const Key* sorted = sort_on_chip(a, b, m);
    for (int i = threadIdx.x; i < m; i += kThreads)
      bucket[c0 + i] = sorted[i];
    __syncthreads();
  }
  return merge_runs(bucket, scratch, n, kChunk);
}

// Calls f(c, w_c) for each channel c of an event's row of C weights, the
// loads kGroup channels at a time, in flight together.
template <typename T, typename F>
__device__ __forceinline__ void for_each_channel(const T* __restrict__ row,
                                                 int C, F f) {
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    float v[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      v[q] = c0 + q < C ? to_float(row[c0 + q]) : 0.0f;
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (c0 + q < C) f(c0 + q, v[q]);
  }
}

// Writes n floats of src (shared memory, 16-byte aligned), or zeros if
// src is null, to dst with 16-byte stores where dst is aligned.
__device__ void store_tile(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
    auto* d4 = reinterpret_cast<float4*>(dst);
    auto* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      d4[i] = src ? s4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[i] = src ? src[i] : 0.0f;
  }
}

// Writes a channel group of a tile: the cg floats of each of `cells`
// cells of src (shared memory, [cells, cg]) to dst, where a cell's
// channels lie C floats after the previous cell's.
__device__ void store_group(float* dst, const float* src, int cells, int cg,
                            int C) {
  for (int i = threadIdx.x; i < cells * cg; i += kThreads) {
    const int cell = i / cg;
    dst[static_cast<long long>(cell) * C + (i - cell * cg)] = src[i];
  }
}

// Bytes of each of voxelize_tile_kernel's two key buffers, which also
// stage a channel group's weights (`width` channels) once the keys are
// sorted.
template <typename Key> __host__ __device__ int tile_buffer_bytes(int width) {
  const int keys = kChunk * static_cast<int>(sizeof(Key));
  const int weights = kStage * width * static_cast<int>(sizeof(float));
  return keys > weights ? keys : weights;
}

// Dynamic shared memory of voxelize_tile_kernel for C channels.
template <typename Key> int tile_smem_bytes(int C) {
  const int width = C < kChannelGroup ? C : kChannelGroup;
  return kTileCells * width * static_cast<int>(sizeof(float)) +
         2 * tile_buffer_bytes<Key>(width);
}

// Step 2, a block per tile, a thread per cell (kThreads == kTileCells).
// offsets and region: step 1's, of `blocks` bucket blocks (<= kThreads);
// scratch: [2 * E] keys, where a tile of more than kChunk events takes
// 2 n keys at *scratch_top for its merge; out: float32 [P, H, W, C].
// kGrouped: C > kChannelGroup, summed and written a channel group at a
// time; the other instance (the bench's 9 channels) is the one pass over
// all C channels with no group arithmetic.
template <typename Key, typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads, kTileBlocksPerSM)
voxelize_tile_kernel(const T* __restrict__ w,
                     const int32_t* __restrict__ offsets,
                     const Key* __restrict__ region, Key* scratch,
                     int32_t* scratch_top, float* __restrict__ out, int W,
                     int C, int per_row, int tiles, int blocks, int per,
                     int event_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = kGrouped ? kChannelGroup : C;  // channels of a group
  float* acc = reinterpret_cast<float*>(smem);      // [cells, width]
  // two buffers of kChunk keys, or of kStage weights of a channel group
  Key* keys = reinterpret_cast<Key*>(acc + kTileCells * width);
  Key* other = reinterpret_cast<Key*>(reinterpret_cast<unsigned char*>(keys) +
                                      tile_buffer_bytes<Key>(width));
  __shared__ int32_t run_start[kTileCells], run_end[kTileCells];
  __shared__ int32_t long_cells[kTileCells];
  __shared__ int n_long, long_from, long_to;
  __shared__ int32_t group_at[kThreads + 1], group_from[kThreads];
  __shared__ Key* bucket;

  const int tile = blockIdx.x;
  const int row = tile / per_row;
  const int x0 = (tile - row * per_row) * kTileCells;
  const int cells = min(kTileCells, W - x0);
  const int n_out = cells * C;
  float* dst = out + (static_cast<long long>(row) * W + x0) * C;
  // the tile's group in each bucket block's region, laid end to end
  const int b = threadIdx.x;
  int count = 0;
  if (b < blocks) {
    const int32_t* at =
        offsets + static_cast<long long>(b) * (tiles + 1) + tile;
    group_from[b] = b * per + at[0];
    count = at[1] - at[0];
  }
  int n;
  group_at[b] = block_scan(count, &n);
  if (b == 0) group_at[kThreads] = n;
  if (n == 0) {
    store_tile(dst, nullptr, n_out);
    return;
  }
  if (b == 0)
    bucket = n <= kChunk ? keys : scratch + atomicAdd(scratch_top, 2 * n);
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    // the last group that starts at or before k holds it
    int lo = 0, hi = kThreads;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (group_at[mid] <= k) lo = mid;
      else hi = mid - 1;
    }
    bucket[k] = region[group_from[lo] + (k - group_at[lo])];
  }
  __syncthreads();
  const Key* sorted;
  float* stage;   // the shared buffer the sorted keys do not occupy
  if (n <= kChunk) {
    sorted = sort_on_chip(keys, other, n);
    stage = reinterpret_cast<float*>(sorted == keys ? other : keys);
  } else {
    sorted = sort_in_global(bucket, bucket + n, n, keys, other);
    stage = reinterpret_cast<float*>(keys);
  }

  // each cell's run [run_start, run_end) of the sorted keys
  const int l = threadIdx.x;
  run_start[l] = run_end[l] = 0;
  if (l == 0) {
    n_long = long_to = 0;
    long_from = n;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int cell = static_cast<int>(sorted[j] >> event_bits);
    if (j == 0 || static_cast<int>(sorted[j - 1] >> event_bits) != cell)
      run_start[cell] = j;
    if (j == n - 1 || static_cast<int>(sorted[j + 1] >> event_bits) != cell)
      run_end[cell] = j + 1;
  }
  __syncthreads();

  const Key mask = (static_cast<Key>(1) << event_bits) - 1;
  // Channels [c0, c0 + cg) of every cell at a time, summed into acc
  // ([cells, cg]) and written out; one pass unless kGrouped.
  for (int c0 = 0; c0 < (kGrouped ? C : 1); c0 += kChannelGroup) {
    const int cg = kGrouped ? min(kChannelGroup, C - c0) : C;
    const T* w_group = w + c0;
    // A thread sums its cell's run, event by event in ascending order.  A
    // long run (a hot pixel), listed in the first group, goes to the
    // pass by channel below.
    if (l < cells) {
      const int j0 = run_start[l], j1 = run_end[l];
      float* sum = acc + l * cg;
      for (int c = 0; c < cg; ++c) sum[c] = 0.0f;
      if (j1 - j0 > kLongRun) {
        if (c0 == 0) {
          long_cells[atomicAdd(&n_long, 1)] = l;
          atomicMin(&long_from, j0);
          atomicMax(&long_to, j1);
        }
      } else {
        for (int j = j0; j < j1; ++j)
          for_each_channel(
              w_group + static_cast<long long>(sorted[j] & mask) * C, cg,
              [&](int c, float v) { sum[c] += v; });
      }
    }
    __syncthreads();
    // The long runs, kStage sorted events at a time: the block stages
    // their weights in shared memory, a thread an event (kStage ==
    // kThreads), then a thread a (long run, channel) adds the part of its
    // run in the window, in ascending order.
    for (int s = long_from; s < long_to; s += kStage) {
      const int m = min(kStage, long_to - s);
      if (l < m) {
        float* row = stage + l * cg;
        for_each_channel(
            w_group + static_cast<long long>(sorted[s + l] & mask) * C, cg,
            [&](int c, float v) { row[c] = v; });
      }
      __syncthreads();
      for (int k = threadIdx.x; k < n_long * cg; k += kThreads) {
        const int cell = long_cells[k / cg], c = k - k / cg * cg;
        const int j1 = min(run_end[cell], s + m) - s;
        float a = acc[cell * cg + c];
#pragma unroll 8
        for (int j = max(run_start[cell], s) - s; j < j1; ++j)
          a += stage[j * cg + c];
        acc[cell * cg + c] = a;
      }
      __syncthreads();
    }
    if (kGrouped) {
      store_group(dst + c0, acc, cells, cg, C);
      __syncthreads();   // the next group rewrites acc and stage
    } else {
      store_tile(dst, acc, n_out);
    }
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

}  // namespace

// Bucket blocks of the forward for E events: one per kBlockEvents, at most
// kThreads (the tile kernel gathers a thread per bucket block).
extern "C" int voxelize_fwd_blocks(long long E) {
  const long long blocks = (E + kBlockEvents - 1) / kBlockEvents;
  return static_cast<int>(blocks < kThreads ? (blocks > 0 ? blocks : 1)
                                            : kThreads);
}

namespace {

// E * C and P * H * W as the kernels' 32-bit index range, or false if
// they do not fit.
bool sizes_fit(long long E, int C, int P, int H, int W) {
  return E > 0 && C > 0 && P > 0 && H > 0 && W > 0 && E * C <= INT_MAX &&
         static_cast<long long>(P) * H * W <= INT_MAX;
}

template <typename Key, typename T>
cudaError_t launch_fwd(const void* x, const void* y, const void* plane,
                       const void* w, const void* valid, int32_t* offsets,
                       Key* keys, int32_t* scratch_top, float* out, int E,
                       int C, int P, int H, int W, int per_row, int T_,
                       int blocks, int per, int event_bits, cudaStream_t s) {
  const int bucket_smem = T_ * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      voxelize_bucket_kernel<Key>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bucket_smem);
  if (err != cudaSuccess) return err;
  voxelize_bucket_kernel<Key><<<blocks, kThreads, bucket_smem, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(plane), static_cast<const uint8_t*>(valid),
      offsets, keys, scratch_top, E, per, P, H, W, per_row, T_, event_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem = tile_smem_bytes<Key>(C);
  auto tile_kernel = C > kChannelGroup ? voxelize_tile_kernel<Key, T, true>
                                       : voxelize_tile_kernel<Key, T, false>;
  err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_kernel<<<T_, kThreads, smem, s>>>(
      static_cast<const T*>(w), offsets, keys, keys + E, scratch_top, out, W,
      C, per_row, T_, blocks, per, event_bits);
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

// The forward.  x, y, plane: int32 [E]; valid: bool [E]; w: [E, C],
// bfloat16 if w_bf16 else float32, any C; T = P * H * ceil(W / 256)
// tiles, at most kMaxTiles; offsets: int32 [blocks, T + 1], blocks =
// voxelize_fwd_blocks(E); keys: [3 * E], int64 if key64 else int32 (the
// wrapper picks int64 where 8 bits of cell and the bits of E - 1 exceed
// 32); scratch_top: one int32; out: float32 [P, H, W, C], fully written.
// Returns the launches' cudaError_t.
extern "C" int voxelize_fwd(const void* x, const void* y, const void* plane,
                            const void* w, const void* valid, void* offsets,
                            void* keys, void* scratch_top, void* out,
                            long long E, int C, int P, int H, int W,
                            int w_bf16, int key64, void* stream) {
  if (!sizes_fit(E, C, P, H, W) || 3 * E > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int event_bits = 1;
  while ((1LL << event_bits) < E) ++event_bits;
  if (!key64 && kCellBits + event_bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = (W + kTileCells - 1) / kTileCells;
  const long long tiles = static_cast<long long>(P) * H * per_row;
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(E), T_ = static_cast<int>(tiles);
  const int blocks = voxelize_fwd_blocks(E);
  const int per = (n + blocks - 1) / blocks;
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(offsets);
  auto* top = static_cast<int32_t*>(scratch_top);
  auto* grid = static_cast<float*>(out);
  cudaError_t err;
  if (key64) {
    auto* k = static_cast<unsigned long long*>(keys);
    err = w_bf16 ? launch_fwd<unsigned long long, __nv_bfloat16>(
                       x, y, plane, w, valid, o, k, top, grid, n, C, P, H, W,
                       per_row, T_, blocks, per, event_bits, s)
                 : launch_fwd<unsigned long long, float>(
                       x, y, plane, w, valid, o, k, top, grid, n, C, P, H, W,
                       per_row, T_, blocks, per, event_bits, s);
  } else {
    auto* k = static_cast<uint32_t*>(keys);
    err = w_bf16 ? launch_fwd<uint32_t, __nv_bfloat16>(
                       x, y, plane, w, valid, o, k, top, grid, n, C, P, H, W,
                       per_row, T_, blocks, per, event_bits, s)
                 : launch_fwd<uint32_t, float>(
                       x, y, plane, w, valid, o, k, top, grid, n, C, P, H, W,
                       per_row, T_, blocks, per, event_bits, s);
  }
  return static_cast<int>(err);
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
