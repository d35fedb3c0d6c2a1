// The base redraw of the fused lean chain, float32, for Hopper (sm_90a):
// per spectrum, the normalized posterior CDF of its (S,) sample log
// likelihoods and the inverse CDF at grid quantiles, in a fixed order of
// additions.
//
// No TPU kernel: the JAX package computes this with XLA
// (gp_dla_detection_tpu/multi_dla.py, _posterior_cdf and
// device_inverse_cdf_grid).  The port's plain version
// (ops/redraw.py, inverse_cdf_grid_reference) runs torch.cumsum, whose
// CUDA scan groups a row's float32 additions by a thread count that
// depends on the number of rows, so a row's CDF, and at a knife edge its
// draws, depended on the batch.  Here every row's bits depend on that row
// alone.  For row b (one block per row):
//
//   x_i   = sll[b, i], NaN -> -inf
//   m     = max_i x_i, 0 when not finite
//   w_i   = exp(x_i - m), or 1 for every i when no x_i is finite
//   c_i   = (w_0 + ... + w_i) / (w_0 + ... + w_{S-1})   (float32 scan)
//   m_i   = #{k < s : (k + 0.5) / s <= c_i}               (grid cell)
//   g_k   = #{i : m_i <= k} = #{i : c_i < (k + 0.5) / s}, clipped to [0, S-1]
//   out[b, j] = g[kvec[j]]
//
// with s = grid_size.  m_i is the plain version's _grid_counts cell: a
// rounded guess floor(c s + 0.5) and two correction steps against
// (m -+ 0.5) / s computed in float32 with a correctly rounded division, so
// m_i is the exact count for the float32 grid whatever the guess.  The
// counts are therefore equal, bit for bit, to _grid_counts of this
// kernel's own CDF.
//
// Order of the scan: the row runs in tiles of 4,096 entries; within a
// tile, thread t adds its 16 contiguous entries in sequence from 0, the
// 256 thread totals are combined by a warp shuffle scan and a serial sum
// over the 8 warp totals, and each entry is (carry + exclusive prefix) +
// its thread's inclusive prefix.  The carry into the next tile is the tile's last
// entry.  Nothing in that order depends on the number of rows.  The row
// total, the divisor, is the scan's entry S - 1, as in the plain version
// (so c_{S-1} = 1 and no c_i exceeds it): a first sweep runs the same
// scan for it alone, a second one writes.
//
// What bounds it on the H100: bytes.  It reads sll once from device
// memory (4 B S per row; the second and third reads of a 40 KB row come
// from L2) and writes 8 B per output; at B = 1024, S = 10,000 that is
// 41 MB + 82 MB, ~37 us at 3.35 TB/s.  The histogram of cells lives in
// shared memory ((s + 1) ints; the threads of a row add to it with
// integer atomics, exact in any order, one per run of equal cells, since
// the cells of a thread's contiguous entries ascend), and its prefix sum
// is an integer scan.
//
// Entry points (C interface, loaded with ctypes):
//   gpdla_redraw_f32: the counts out (B, J) int64 and, when cdf is not
//     null, the CDF (B, S) float32 (the test entry; counts skipped when
//     out is null).
//   gpdla_redraw_max_grid: the largest grid_size whose histogram fits in
//     a block's shared memory on the current device.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;
// one padding float per 32: thread t reads entries 16 t .. 16 t + 15, and
// without the padding threads t and t + 2 would share a bank
constexpr int kTileSlots = kTile + kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float weight(float x, float rowmax, bool uniform) {
  if (uniform) return 1.0f;
  if (isnan(x)) x = -INFINITY;
  return expf(__fsub_rn(x, rowmax));
}

// The exclusive prefix of v over the block's threads, in a fixed order.
__device__ float block_exclusive_scan(float v, float* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = __fadd_rn(y, inc);
  }
  float prev = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) prev = 0.0f;
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  float off = 0.0f;
  for (int w = 0; w < warp; ++w) off = __fadd_rn(off, warp_total[w]);
  __syncthreads();
  return __fadd_rn(off, prev);
}

__device__ int block_exclusive_scan_int(int v, int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += warp_total[w];
  __syncthreads();
  return off + inc - v;
}

// The grid cell of a CDF value: #{k < s : (k + 0.5) / s <= c}, as
// _grid_counts computes it in float32.
__device__ __forceinline__ int grid_cell(float c, int s, float sf) {
  float guess = floorf(__fadd_rn(__fmul_rn(c, sf), 0.5f));
  int m = guess >= static_cast<float>(s) ? s : (guess > 0.0f ? static_cast<int>(guess) : 0);
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    float u_below = __fdiv_rn(__fsub_rn(static_cast<float>(m), 0.5f), sf);
    if (m > 0 && u_below > c) --m;
    float u_at = __fdiv_rn(__fadd_rn(static_cast<float>(m), 0.5f), sf);
    if (m < s && u_at <= c) ++m;
  }
  return m;
}

// One sweep over the row's tiles: returns the scan's last entry.  With
// kEmit, each entry is divided by ``total`` and written to cdf (if not
// null) and its grid cell counted in hist (if not null).
template <bool kEmit>
__device__ float scan_row(const float* row, int S, float rowmax, bool uniform, float total,
                          float* buf, float* warp_total, float* carry_slot, float* cdf,
                          int* hist, int s, float sf) {
  float carry = 0.0f;
  for (int base = 0; base < S; base += kTile) {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      const int i = v * kThreads + threadIdx.x;
      buf[pad(i)] = base + i < S ? weight(row[base + i], rowmax, uniform) : 0.0f;
    }
    __syncthreads();
    // the thread's inclusive prefix from 0, then its offset added once:
    // the small weights are summed among themselves before they meet the
    // running total
    float w[kPerThread];
    float local = 0.0f;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      local = __fadd_rn(local, buf[pad(threadIdx.x * kPerThread + v)]);
      w[v] = local;
    }
    const float offset = __fadd_rn(carry, block_exclusive_scan(local, warp_total));
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) w[v] = __fadd_rn(offset, w[v]);
    // the carry is the tile's last entry (the row's, in its last tile)
    const int first = base + int(threadIdx.x) * kPerThread;
    const int last = min(base + kTile, S) - 1;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (first + v == last) *carry_slot = w[v];
    if (kEmit) {
      int cur = -1, count = 0;
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        if (first + v < S) {
          const float c = __fdiv_rn(w[v], total);
          if (cdf) cdf[first + v] = c;
          if (hist) {
            const int m = grid_cell(c, s, sf);
            if (m != cur) {
              if (count) atomicAdd(&hist[cur], count);
              cur = m;
              count = 0;
            }
            ++count;
          }
        }
      }
      if (count) atomicAdd(&hist[cur], count);
    }
    __syncthreads();
    carry = *carry_slot;
    __syncthreads();
  }
  return carry;
}

__global__ void __launch_bounds__(kThreads)
redraw_kernel(const float* __restrict__ sll, const int64_t* __restrict__ kvec,
              int64_t* __restrict__ out, float* __restrict__ cdf, int S, int s, int J) {
  extern __shared__ float smem[];
  float* buf = smem;
  int* hist = reinterpret_cast<int*>(smem + kTileSlots);
  __shared__ float warp_total[kWarps];
  __shared__ int warp_total_int[kWarps];
  __shared__ float red[kWarps];
  __shared__ float carry_slot;

  const size_t b = blockIdx.x;
  const float* row = sll + b * S;
  const bool counts = out != nullptr;

  if (counts)
    for (int i = threadIdx.x; i <= s; i += kThreads) hist[i] = 0;

  // the row max, NaN as -inf
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float x = row[i];
    if (!isnan(x)) mx = fmaxf(mx, x);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  // no finite entry: the max is -inf and every weight is 0, so the plain
  // version's total is 0 and it takes uniform weights; otherwise the max
  // entry's weight is exp(0) = 1 and the total is not 0
  const bool uniform = mx == -INFINITY;
  const float rowmax = isfinite(mx) ? mx : 0.0f;

  const float total = scan_row<false>(row, S, rowmax, uniform, 0.0f, buf, warp_total,
                                      &carry_slot, nullptr, nullptr, s, 0.0f);
  scan_row<true>(row, S, rowmax, uniform, total, buf, warp_total, &carry_slot,
                 cdf ? cdf + b * S : nullptr, counts ? hist : nullptr, s,
                 static_cast<float>(s));
  if (!counts) return;

  // g_k = hist[0] + ... + hist[k] for k < s: each thread a contiguous
  // chunk, then the chunks' offsets (integers: exact in any order)
  const int chunk = (s + kThreads - 1) / kThreads;
  const int lo = min(s, int(threadIdx.x) * chunk), hi = min(s, lo + chunk);
  int acc = 0;
  for (int k = lo; k < hi; ++k) {
    acc += hist[k];
    hist[k] = acc;
  }
  const int off = block_exclusive_scan_int(acc, warp_total_int);
  for (int k = lo; k < hi; ++k) hist[k] += off;
  __syncthreads();

  int64_t* orow = out + b * J;
  for (int j = threadIdx.x; j < J; j += kThreads) {
    const int64_t k = kvec[j];
    if (k < 0 || k >= s) __trap();  // an index outside the grid, as torch's device assert
    const int g = hist[k];
    orow[j] = g < 0 ? 0 : (g > S - 1 ? S - 1 : g);
  }
}

size_t shared_bytes(int s, bool counts) {
  return sizeof(float) * kTileSlots + (counts ? sizeof(int) * (size_t(s) + 1) : 0);
}

}  // namespace

extern "C" {

const char* gpdla_redraw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest grid_size whose histogram fits in one block's shared memory
// on the current device (0 if the device cannot be queried).
int gpdla_redraw_max_grid() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  // the block's static shared memory: 2 x 8 warp totals, 8 maxima, the carry
  const long room = long(optin) - long(sizeof(float) * kTileSlots) - 128;
  return room > 0 ? int(room / sizeof(int)) - 1 : 0;
}

// sll: (B, S) float32, C-contiguous; kvec: (J,) int64 grid positions in
// [0, s); out: (B, J) int64 or null; cdf: (B, S) float32 or null.  All on
// the current device.  The caller keeps B <= 2^31 - 1, 1 <= S, s < 2^23
// and s <= gpdla_redraw_max_grid().  Returns a cudaError_t.
int gpdla_redraw_f32(const void* sll, const void* kvec, void* out, void* cdf, int B, int S,
                     int s, int J, void* stream) {
  const size_t bytes = shared_bytes(s, out != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      redraw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  redraw_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sll), static_cast<const int64_t*>(kvec),
      static_cast<int64_t*>(out), static_cast<float*>(cdf), S, s, J);
  return cudaGetLastError();
}

}  // extern "C"
