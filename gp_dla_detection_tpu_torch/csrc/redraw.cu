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
// with s = grid_size.  m_i is the plain version's cell
// (grid_cells_reference): a rounded guess floor(c s + 0.5) and two
// correction steps against u_{m-1} = (m - 0.5) / s and u_m = (m + 0.5) / s,
// each the correctly rounded float32 quotient, so m_i is the exact count
// for the float32 grid whatever the guess.  The s boundaries u_k depend on
// s alone: the block divides once per boundary into a table in shared
// memory and each cell looks them up (grid_cell_by_table), with no
// division; a grid whose table and histogram do not both fit in shared
// memory takes the same steps with the divisions (grid_cell).  (One
// table in device memory for every grid, read through L1, was measured
// on an H100: slower than the shared table at B = 1,024 and than the
// divisions at the largest grids; scripts/torch_redraw_ablation.py,
// variant global_table.)  The counts are therefore equal, bit for bit,
// to the plain version's grid counts of this kernel's own CDF.
//
// Order of the scan (posterior_cdf_in_kernel_order): the row runs in tiles
// of 4,096 entries; within a tile, thread t of 256 adds its 16 contiguous
// entries in sequence from 0, the 256 thread totals are combined by a
// 5-step warp shuffle scan and a serial sum over the 8 warp totals, and
// each entry is (carry + exclusive prefix) + its thread's inclusive
// prefix.  The carry into the next tile is the tile's last entry, and the
// row total, the divisor, is the scan's entry S - 1 (so c_{S-1} = 1).
// Nothing in that order depends on the number of rows.
//
// Design.  Within that order a tile's own work does not depend on the
// carry: only the last add does.  So a block holds up to 3 tiles at once,
// one group of 256 threads each (768 threads at S = 10,000): each group
// scans its tile, publishes the tile's last exclusive prefix and
// inclusive sum, and every thread then walks the short chain of carries
// (two adds a tile) to its own tile's carry and to the row total.  A row
// of at most 12,288 entries is read from device memory once into
// registers (16 a thread, 16-byte loads where the row is aligned), exp is
// computed once, and the total is that same scan's last entry, so the
// entries are emitted from the held prefixes; a longer row is streamed
// again, 3 tiles a round, in the same order: a sweep for the total, a
// sweep that emits.  The histogram of cells lives in shared memory ((s +
// 1) ints; the threads add to it with integer atomics, exact in any
// order, one per run of equal cells, since the cells of a thread's
// contiguous entries ascend; the lanes of a warp that share a cell add
// once), its prefix sum is an integer scan, and the draws go out as
// 16-byte pairs of int64.  Two blocks fit on an SM (40 registers a
// thread, a few spilled; at grids whose shared memory fits twice), so one
// row's chain of barriers overlaps another's at large batches.
//
// What bounds it on the H100: bytes.  It reads sll once (4 B S per row)
// and writes 8 B per output; at B = 1024, S = 10,000 that is 41 MB +
// 82 MB, ~37 us at 3.35 TB/s.  kvec (8 B J) is read by every row from L2.
// What holds it back (scripts/torch_redraw_ablation.py): the row's chain
// of phases in one block (load, max, scan, cells and histogram, prefix,
// the gather of the draws), at B = 128 one row an SM.
//
// Entry points (C interface, loaded with ctypes):
//   gpdla_redraw_f32: the counts out (B, J) int64 and, when cdf is not
//     null, the CDF (B, S) float32 (the test entry; counts skipped when
//     out is null).
//   gpdla_redraw_max_grid: the largest grid_size whose histogram fits in
//     a block's shared memory on the current device.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kTileThreads * kPerThread;
constexpr int kMaxGroups = 3;   // tiles a block holds at once
constexpr int kMaxThreads = kTileThreads * kMaxGroups;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  float red[kMaxWarps];           // the warps' maxima
  float warp_total[kMaxWarps];    // the warps' inclusive sums
  int warp_total_int[kMaxWarps];  // the histogram prefix's warp sums
  float end_excl[kMaxGroups];     // per tile of the round: its last entry's
  float end_incl[kMaxGroups];     // exclusive prefix and inclusive sum
};
// the static shared memory, rounded up for the dynamic part's alignment
constexpr long kStaticBytes = (long(sizeof(Shared)) + 127) / 128 * 128;

__device__ __forceinline__ float weight(float x, float rowmax, bool uniform) {
  if (uniform) return 1.0f;
  if (isnan(x)) x = -INFINITY;
  return expf(__fsub_rn(x, rowmax));
}

// The thread's 16 entries from row[first] on, -inf past the row's end.
__device__ __forceinline__ void load16(const float* __restrict__ row, int first, int S, bool vec,
                                       float (&x)[kPerThread]) {
  if (vec && first + kPerThread <= S) {
    const float4* p = reinterpret_cast<const float4*>(row + first);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const float4 f = __ldg(p + q);
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      x[v] = first + v < S ? __ldg(row + first + v) : -INFINITY;
  }
}

// The block's max of mx, in every thread.
__device__ float block_max(float mx, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kMaxWarps; ++w)
    if (w < warps) mx = fmaxf(mx, red[w]);
  return mx;
}

struct RoundScan {
  float offset;     // carry + exclusive prefix of the thread's tile
  float carry_out;  // the round's last entry
};

// One round of up to 3 tiles, tile0 the round's first: x holds the
// thread's raw entries of its tile and leaves with the inclusive prefixes
// of their weights from 0; each entry is then offset + x[v].
__device__ __forceinline__ RoundScan scan_round(float (&x)[kPerThread], int first, int S,
                                                float rowmax, bool uniform, float carry,
                                                int tile0, int n_tiles, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = threadIdx.x / kTileThreads;
  float local = 0.0f;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    local = __fadd_rn(local, first + v < S ? weight(x[v], rowmax, uniform) : 0.0f);
    x[v] = local;
  }
  float inc = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = __fadd_rn(y, inc);
  }
  float prev = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) prev = 0.0f;
  if (lane == 31) sh.warp_total[warp] = inc;
  __syncthreads();
  float off = 0.0f;
#pragma unroll
  for (int k = 0; k < kTileWarps; ++k)
    if (g * kTileWarps + k < warp) off = __fadd_rn(off, sh.warp_total[g * kTileWarps + k]);
  const float excl = __fadd_rn(off, prev);
  // the thread that holds the tile's last entry publishes it
  const int last = min((tile0 + g + 1) * kTile, S) - 1;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    if (first + v == last) {
      sh.end_excl[g] = excl;
      sh.end_incl[g] = x[v];
    }
  }
  __syncthreads();
  // the carries: each tile's last entry is (carry + its exclusive) + its
  // inclusive, as the tile's own entries are
  const int tiles = min(int(blockDim.x) / kTileThreads, n_tiles - tile0);
  float c = carry, carry_in = carry;
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    if (k < tiles) {
      if (k == g) carry_in = c;
      c = __fadd_rn(__fadd_rn(c, sh.end_excl[k]), sh.end_incl[k]);
    }
  }
  return {__fadd_rn(carry_in, excl), c};
}

// The grid cell of a CDF value: #{k < s : (k + 0.5) / s <= c}, as
// grid_cells_reference computes it in float32, the boundaries divided
// here (kTable false) or looked up in table[k] = (k + 0.5) / s.
template <bool kTable>
__device__ __forceinline__ int grid_cell(float c, int s, float sf, const float* table) {
  float guess = floorf(__fadd_rn(__fmul_rn(c, sf), 0.5f));
  int m = guess >= static_cast<float>(s) ? s : (guess > 0.0f ? static_cast<int>(guess) : 0);
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    if (m > 0) {
      const float u_below = kTable ? table[m - 1]
                                   : __fdiv_rn(__fsub_rn(static_cast<float>(m), 0.5f), sf);
      if (u_below > c) --m;
    }
    if (m < s) {
      const float u_at = kTable ? table[m] : __fdiv_rn(__fadd_rn(static_cast<float>(m), 0.5f), sf);
      if (u_at <= c) ++m;
    }
  }
  return m;
}

// Add count to hist[cell] for the warp's lanes with count > 0, one atomic
// per distinct cell: the lanes of a peaked row share a cell, and their
// atomics on one address would go one at a time.
__device__ __forceinline__ void warp_add(int* hist, int cell, int count) {
  const unsigned active = __ballot_sync(kFull, count > 0);
  if (count > 0) {
    const unsigned peers = __match_any_sync(active, cell);
    const int sum = __reduce_add_sync(peers, count);
    if (__ffs(peers) - 1 == int(threadIdx.x & 31)) atomicAdd(&hist[cell], sum);
  }
}

// The thread's entries offset + x[v] divided by the total: written to
// cdf_row (if not null) and their grid cells counted in hist (if not
// null).  The cells of the thread's 16 contiguous entries ascend, so they
// come in runs of equal cells: the first and the last run go through
// warp_add, the runs between (a broad posterior's) each through one
// atomic.
template <bool kTable>
__device__ __forceinline__ void emit(const float (&x)[kPerThread], int first, int S, float offset,
                                     float total, float* cdf_row, int* hist, const float* table,
                                     int s, float sf) {
  const bool counting = hist != nullptr;
  int head_cell = -1, head_count = 0, cur = -1, count = 0;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    if (first + v < S) {
      const float c = __fdiv_rn(__fadd_rn(offset, x[v]), total);
      if (cdf_row) cdf_row[first + v] = c;
      if (counting) {
        const int m = grid_cell<kTable>(c, s, sf, table);
        if (m != cur) {
          if (head_count == 0) {
            head_cell = cur;
            head_count = count;
          } else {
            atomicAdd(&hist[cur], count);
          }
          cur = m;
          count = 0;
        }
        ++count;
      }
    }
  }
  if (counting) {
    warp_add(hist, head_cell, head_count);
    warp_add(hist, cur, count);
  }
}

// The exclusive prefix of v over the block's threads (integers: exact in
// any order).
__device__ int block_exclusive_scan_int(int v, int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int off = 0;
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w)
    if (w < warp) off += warp_total[w];
  return off + inc - v;
}

// The draw at grid position k: g[k] clipped to the sample axis.
__device__ __forceinline__ long long draw(const int* g, long long k, int S, int s) {
  if (k < 0 || k >= s) __trap();  // an index outside the grid, as torch's device assert
  const int v = g[k];
  return v < 0 ? 0 : (v > S - 1 ? S - 1 : v);
}

template <bool kTable>
__global__ void __launch_bounds__(kMaxThreads, 2)
redraw_kernel(const float* __restrict__ sll, const int64_t* __restrict__ kvec,
              int64_t* __restrict__ out, float* __restrict__ cdf, int S, int s, int J) {
  extern __shared__ int smem[];
  int* hist = smem;                                        // s + 1 counts
  float* table = reinterpret_cast<float*>(smem + s + 1);   // s boundaries (kTable)
  __shared__ Shared sh;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int groups = nthreads / kTileThreads;
  const int g = tid / kTileThreads, t = tid % kTileThreads;
  const size_t b = blockIdx.x;
  const float* row = sll + b * S;
  const bool counts = out != nullptr;
  const float sf = static_cast<float>(s);

  const int n_tiles = (S + kTile - 1) / kTile;
  const int rounds = (n_tiles + groups - 1) / groups;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  // the first entry of the thread's 16 in round r
  const auto first_of = [&](int r) { return (r * groups + g) * kTile + t * kPerThread; };

  // the row's first round in flight while the histogram and the table
  // are set up; with one round x keeps the row
  float x[kPerThread];
  load16(row, first_of(0), S, vec, x);
  if (counts) {
    for (int i = tid; i <= s; i += nthreads) hist[i] = 0;
    if (kTable)
      for (int i = tid; i < s; i += nthreads)
        table[i] = __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), sf);
  }

  // the row max, NaN as -inf
  float mx = -INFINITY;
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) load16(row, first_of(r), S, vec, x);
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (!isnan(x[v])) mx = fmaxf(mx, x[v]);
  }
  mx = block_max(mx, sh.red);
  // no finite entry: the max is -inf and every weight is 0, so the plain
  // version's total is 0 and it takes uniform weights; otherwise the max
  // entry's weight is exp(0) = 1 and the total is not 0
  const bool uniform = mx == -INFINITY;
  const float rowmax = isfinite(mx) ? mx : 0.0f;

  float* cdf_row = cdf ? cdf + b * S : nullptr;
  int* counted = counts ? hist : nullptr;
  if (rounds == 1) {
    const RoundScan rs = scan_round(x, first_of(0), S, rowmax, uniform, 0.0f, 0, n_tiles, sh);
    emit<kTable>(x, first_of(0), S, rs.offset, rs.carry_out, cdf_row, counted, table, s, sf);
  } else {
    // a row longer than the block holds: the same order, streamed twice
    float carry = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      load16(row, first_of(r), S, vec, x);
      carry = scan_round(x, first_of(r), S, rowmax, uniform, carry, r * groups, n_tiles, sh)
                  .carry_out;
    }
    const float total = carry;
    carry = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      load16(row, first_of(r), S, vec, x);
      const RoundScan rs =
          scan_round(x, first_of(r), S, rowmax, uniform, carry, r * groups, n_tiles, sh);
      emit<kTable>(x, first_of(r), S, rs.offset, total, cdf_row, counted, table, s, sf);
      carry = rs.carry_out;
    }
  }
  if (!counts) return;
  __syncthreads();

  // g_k = hist[0] + ... + hist[k] for k < s: each thread a contiguous
  // chunk, then the chunks' offsets
  const int chunk = (s + nthreads - 1) / nthreads;
  const int lo = min(s, tid * chunk), hi = min(s, lo + chunk);
  int acc = 0;
  for (int k = lo; k < hi; ++k) {
    acc += hist[k];
    hist[k] = acc;
  }
  const int off = block_exclusive_scan_int(acc, sh.warp_total_int);
  for (int k = lo; k < hi; ++k) hist[k] += off;
  __syncthreads();

  // the draws, two int64 to a 16-byte store (one single ahead of them
  // when the row starts off a 16-byte boundary, one after an odd count)
  int64_t* orow = out + b * J;
  const int head = (reinterpret_cast<uintptr_t>(orow) & 15) ? 1 : 0;
  if (head && tid == 0) orow[0] = draw(hist, kvec[0], S, s);
  const int pairs = (J - head) / 2;
  const bool kvec_vec = (reinterpret_cast<uintptr_t>(kvec + head) & 15) == 0;
#pragma unroll 4
  for (int p = tid; p < pairs; p += nthreads) {
    const int j = head + 2 * p;
    longlong2 k;
    if (kvec_vec) {
      k = *reinterpret_cast<const longlong2*>(kvec + j);
    } else {
      k.x = kvec[j];
      k.y = kvec[j + 1];
    }
    *reinterpret_cast<longlong2*>(orow + j) = make_longlong2(draw(hist, k.x, S, s),
                                                              draw(hist, k.y, S, s));
  }
  if (((J - head) & 1) && tid == 0) orow[J - 1] = draw(hist, kvec[J - 1], S, s);
}

constexpr int kMaxDevices = 64;
// per device: the shared memory a block can use beyond the static part
// (0: not asked yet), and per kernel (<false>, <true>) the dynamic shared
// memory it is set up to take; asked of the driver once, not at every
// launch
std::atomic<long> g_room[kMaxDevices];
std::atomic<long> g_dynamic_bytes[2][kMaxDevices];

// The shared memory a block can use beyond the static part on device dev
// (0 if the device cannot be queried).
long shared_room(int dev) {
  const bool cached = dev >= 0 && dev < kMaxDevices;
  long room = cached ? g_room[dev].load() : 0;
  if (room > 0) return room;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  room = long(optin) - kStaticBytes;
  if (cached) g_room[dev].store(room);
  return room;
}

// Let redraw_kernel<kTable> take bytes of dynamic shared memory on device
// dev: the attribute is set only when bytes exceed what it was set to.
template <bool kTable>
cudaError_t allow_dynamic_bytes(int dev, long bytes) {
  const bool cached = dev >= 0 && dev < kMaxDevices;
  std::atomic<long>* set = cached ? &g_dynamic_bytes[kTable][dev] : nullptr;
  if (set && bytes <= set->load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      redraw_kernel<kTable>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess || !set) return err;
  long seen = set->load();
  while (seen < bytes && !set->compare_exchange_weak(seen, bytes)) {
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* gpdla_redraw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest grid_size whose histogram fits in one block's shared memory
// on the current device (0 if the device cannot be queried).
int gpdla_redraw_max_grid() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const long room = shared_room(dev);
  return room > 0 ? int(room / sizeof(int)) - 1 : 0;
}

// sll: (B, S) float32, C-contiguous; kvec: (J,) int64 grid positions in
// [0, s); out: (B, J) int64 or null; cdf: (B, S) float32 or null.  All on
// the current device.  The caller keeps B <= 2^31 - 1, 1 <= S, s < 2^23
// and s <= gpdla_redraw_max_grid().  Returns a cudaError_t.
int gpdla_redraw_f32(const void* sll, const void* kvec, void* out, void* cdf, int B, int S,
                     int s, int J, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool counts = out != nullptr;
  // the boundary table beside the histogram where both fit
  const bool table = counts && (8 * long(s) + 4 <= shared_room(dev));
  const long bytes =
      counts ? long(sizeof(int)) * (long(s) + 1) + (table ? long(sizeof(float)) * s : 0) : 0;
  void (*kernel)(const float*, const int64_t*, int64_t*, float*, int, int, int) =
      table ? redraw_kernel<true> : redraw_kernel<false>;
  err = table ? allow_dynamic_bytes<true>(dev, bytes) : allow_dynamic_bytes<false>(dev, bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int threads = kTileThreads * (n_tiles < kMaxGroups ? n_tiles : kMaxGroups);
  kernel<<<B, threads, size_t(bytes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sll), static_cast<const int64_t*>(kvec),
      static_cast<int64_t*>(out), static_cast<float*>(cdf), S, s, J);
  return cudaGetLastError();
}

}  // extern "C"
