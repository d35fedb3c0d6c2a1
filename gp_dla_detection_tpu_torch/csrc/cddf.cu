// The CDDF reduction's float64 sums for the fused lean chain, for Hopper
// (sm_90a): per spectrum, the second-DLA probabilities gathered onto
// their base samples, and the eight channels' masses binned on the
// (z, log N_HI) grids, each added in a fixed order.
//
// No TPU kernel: the JAX package computes this with XLA
// (gp_dla_detection_tpu/cddf_inputs.py, make_cddf_reducer: one
// ``acc.at[...].add`` and masked products per z bin).  The port's plain
// version (cddf_inputs.py, cddf_sums_reference) runs two float64
// ``scatter_add_``, whose CUDA atomics add in an order that changes from
// run to run.  For row b, with S samples:
//
//   acc[i]  = sum of p2s[c] over the pair columns c whose base[c] = i
//   hist[ch, bin(ch, i)] += value(ch, i) over the samples i, with
//     value = [ps, p, p nu, pvar, pvar nu2, ps, acc, acc][ch],
//     ps = p where p_min < p < p_switch (else 0), pvar = p max(1 - p, 0),
//     bin = zloc[i] (n_lnhi + 1) + lnhi_bin(ch, i) where 0 <= zloc < W,
//     else the dump slot W (n_lnhi + 1); channels 5 and 7 bin log N_HI on
//     grid B, the others on grid A.
//
// The work of a row is split into C chunks of L samples (the host's plan,
// cddf_inputs.cddf_chunk_plan: C <= 8 and L fixed by S alone, never by
// the batch), one block each, the C blocks of a row one thread block
// cluster.  Order of the additions:
// - acc: ``order`` lists the pair columns by ascending (grid position,
//   column), and acc[i] adds its columns in that order, from 0.  The
//   redraw's base column is g[kvec[c]] with g ascending in the grid
//   position, so along ``order`` equal bases stand in one run.  Chunk c
//   owns the runs that start at an ``order`` position in [c L, (c + 1) L)
//   (its boundaries moved to the next run start: a run never straddles two
//   chunks), and each run is summed in sequence, the same bits whatever
//   the chunking: each block stages its chunk's columns along ``order``
//   (base, p2s) in shared memory, and a run that goes on past its chunk's
//   end is handed on, with its sum so far, to the next chunk's block
//   through distributed shared memory, which goes on adding from its own
//   staged columns.  If the bases do not ascend along
//   ``order`` anywhere in the row (not a redraw's), one thread of the
//   row's first block sums the row column by column in that order into
//   device memory: the same bits for the same sums, more slowly.
// - hist: chunk c bins the samples i in [c L, (c + 1) L) into a partial
//   histogram in its shared memory, a tile of 320 samples at a time: the
//   tile's samples are put in ranges by bin (a counting sort, per log N_HI
//   grid), and each (grid, bin) is owned by one thread, which sorts its
//   range by position and adds its samples in ascending order to the
//   running partials of the grid's channels.  So every partial bin adds
//   its chunk's samples in ascending order from 0.  After
//   a cluster barrier, block c adds the C partials of its share of the
//   bins in chunk order, 0 to C - 1, through distributed shared memory.
// No floating-point atomics, no scratch in device memory, and every row's
// bits depend on that row alone, in every run.
//
// What bounds it on the H100: bytes at this size.  It reads p, p2s, base
// and zloc once (8 B each per (row, sample)) and writes acc (8 B) and
// hist (8 x (W (n_lnhi + 1) + 1) doubles per row): at B = 1024, S =
// 10,000 and the default grids, 434 MB, ~0.13 ms at 3.35 TB/s.  It is
// latency-bound instead: a row's sums are chains of dependent float64
// adds, so a row is spread over C blocks on C SMs, and each owner adds
// only its own bin's samples, gathered through the sort; a run of equal
// bases stays one chain of adds (up to S of them), handed from block to
// block (PERF.md).  The tile is small enough for 4 blocks an SM at the
// default grids (~52 KB of shared memory each), so that more rows' chains
// run at once.
//
// Entry points (C interface, loaded with ctypes):
//   gpdla_cddf_sums_f64: acc (B, S) and hist (B, 8, W (n_lnhi + 1) + 1).
//   gpdla_cddf_shared_bytes / gpdla_cddf_max_shared_bytes: a block's
//     shared memory for a grid, and what the current device allows.
//   gpdla_cddf_max_chunks: the most chunks (blocks of a cluster) a row
//     may take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 8;
constexpr int kTile = 320;     // samples binned at a time
constexpr int kMaxChunks = 8;  // blocks of one cluster, the portable size
// a chunk's pair columns staged in shared memory (base and p2s: 12 bytes a
// column in the tile's channel values)
constexpr int kStaged = kChannels * kTile * int(sizeof(double)) / 12 / 32 * 32;
constexpr int kAhead = 4;           // 32-column windows a warp adds at once in a run
static_assert(kStaged * 12 <= kChannels * kTile * int(sizeof(double)),
              "the staged columns in the tile's channel values");

size_t hist_doubles(int W, int nl) { return size_t(kChannels) * (size_t(W) * (nl + 1) + 1); }

// shared memory beyond the partial histogram: the tile's channel values
// (8 x kTile doubles; in the acc phase, the staged pair columns), its keys
// and sorted order on both grids (4 x kTile ints), the running sum
// handed on from the previous chunk (2 doubles), the two grids' bin
// counts (2 x NB ints), the row's "unsorted" flag and the hand-on's flag
size_t tile_bytes(int W, int nl) {
  const size_t nb = size_t(W) * (nl + 1) + 1;
  return size_t(kChannels) * kTile * sizeof(double) + 2 * sizeof(double) +
         size_t(4) * kTile * sizeof(int) + 2 * nb * sizeof(int) + 4 * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
cddf_sums_kernel(const double* __restrict__ p, const double* __restrict__ p2s,
                 const int64_t* __restrict__ base, const int64_t* __restrict__ zloc,
                 const int64_t* __restrict__ order, const int64_t* __restrict__ lh_a,
                 const int64_t* __restrict__ lh_b, const double* __restrict__ nu,
                 const double* __restrict__ nu2, double* __restrict__ acc,
                 double* __restrict__ hist, int S, int W, int nl, int L, double p_min,
                 double p_switch) {
  extern __shared__ __align__(16) double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = int(cluster.num_blocks());  // the row's chunks
  const int c = int(cluster.block_rank());  // this block's chunk
  const int NB = W * (nl + 1) + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* h = smem;                                            // (8, NB) partial
  double* vals = h + kChannels * NB;                           // (8, kTile)
  double* handed = vals + kChannels * kTile;                   // a run's sum so far
  int* key = reinterpret_cast<int*>(handed + 2);               // (2, kTile) bins
  int* perm = key + 2 * kTile;                                 // (2, kTile) by bin
  int* start = perm + 2 * kTile;                               // (2, NB)
  int* flag = start + 2 * NB;                                  // the row is not sorted
  int* handed_flag = flag + 1;                                 // ``handed`` is written

  const size_t rowi = blockIdx.x / C;
  const size_t row = rowi * S;
  const int64_t* brow = base + row;
  const double* xrow = p2s + row;
  double* arow = acc + row;
  const int lo = int(min((long long)S, (long long)c * L));
  const int hi = int(min((long long)S, (long long)lo + L));

  // ---- zero this chunk's acc entries and the partial histogram; stage
  // the chunk's first kStaged pair columns along ``order`` (base, p2s) in
  // shared memory, in the tile's space; check that the bases ascend along
  // ``order`` over the chunk's positions
  double* xst = vals;                                  // staged p2s
  int* kst = reinterpret_cast<int*>(vals + kStaged);   // staged bases
  for (int i = lo + tid; i < hi; i += kThreads) arow[i] = 0.0;
  for (int i = tid; i < kChannels * NB; i += kThreads) h[i] = 0.0;
  int unsorted = 0;
  for (int u0 = lo; u0 < hi; u0 += 4 * kThreads) {
    int64_t col[4], k[4];
    double x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = u0 + r * kThreads + tid;
      col[r] = u < hi ? order[u] : 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = u0 + r * kThreads + tid;
      k[r] = u < hi ? brow[col[r]] : 0;
      x[r] = u < hi ? xrow[col[r]] : 0.0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = u0 + r * kThreads + tid;
      if (u >= hi) continue;
      if (k[r] < 0 || k[r] >= S) __trap();  // a base outside the sample axis, as torch's device assert
      if (u - lo < kStaged) {
        kst[u - lo] = int(k[r]);
        xst[u - lo] = x[r];
      }
      // the previous column's base: staged, or (the chunk's first and the
      // columns past the staged ones) from device memory
      if (u > 0 && (u == lo || u - lo >= kStaged) && k[r] < brow[order[u - 1]]) unsorted = 1;
    }
  }
  __syncthreads();
  for (int u = lo + 1 + tid; u < min(hi, lo + kStaged); u += kThreads)
    if (kst[u - lo] < kst[u - lo - 1]) unsorted = 1;
  unsorted = __syncthreads_or(unsorted);
  if (tid == 0) {
    *flag = unsorted;
    *handed_flag = 0;
  }
  __threadfence();  // the zeroed acc entries, before any block's run sums
  cluster.sync();
  int any_unsorted = 0;
  for (int q = 0; q < C; ++q) any_unsorted |= *cluster.map_shared_rank(flag, q);

  // ---- acc: the chunk's positions in 8 ranges, one per warp; a warp owns
  // the runs of equal bases that start in its range and adds each run's
  // columns in order from 0, past the range's end if the run goes on.  It
  // reads its chunk's staged columns 32 at a time: a run that starts in
  // those 32 is added by its first lane, up to the 32's end; a run that
  // goes on past them is added by the whole warp, up to 128 columns at a
  // time, the run's length found by ballots.  A run that goes on past the
  // chunk's end is handed on with its sum so far to the next chunk's
  // block, whose first warp adds its part there and hands it on or ends
  // it: the same additions in the same order.
  if (!any_unsorted) {
    const int lim = min(hi, lo + kStaged);  // the staged columns end
    // the base and p2s of pair column ``order[v]`` of this chunk (base -2
    // past its end)
    auto key_at = [&](int v) -> int {
      if (v >= hi) return -2;
      return v < lim ? kst[v - lo] : int(brow[order[v]]);
    };
    auto x_at = [&](int v) -> double { return v < lim ? xst[v - lo] : xrow[order[v]]; };
    // the base of column ``order[v]`` of another chunk
    auto key_of = [&](int v) -> int {
      const int q = v / L, off = v - q * L;
      return off < kStaged ? cluster.map_shared_rank(kst, q)[off] : int(brow[order[v]]);
    };
    const int span = (hi - lo + kThreads / 32 - 1) / (kThreads / 32);
    const int a = min(hi, lo + warp * span), b = min(hi, a + span);
    int prev = a == 0 ? -1 : a > lo ? key_at(a - 1) : key_of(a - 1);  // the base before v0
    int cur = -1;          // the run being added, if ``owning``
    double sum = 0.0;      // its sum so far
    bool owning = false;
    if (a < b && a == lo && prev >= 0 && key_at(lo) == prev) {
      // the run goes on from the previous chunk: take its sum so far
      while (*reinterpret_cast<volatile int*>(handed_flag) == 0) {
      }
      __threadfence();
      sum = *reinterpret_cast<volatile double*>(handed);
      cur = prev;
      owning = true;
    }
    for (int v0 = a; a < b;) {
      if (owning) {
        // the run's columns from v0 on, up to 128 of them
        int len = 0;
#pragma unroll
        for (int w = 0; w < kAhead; ++w) {
          const unsigned in = __ballot_sync(0xffffffffu, key_at(v0 + 32 * w + lane) == cur);
          if (len == 32 * w) len += in == 0xffffffffu ? 32 : __ffs(~in) - 1;
        }
        const int staged = max(0, min(len, lim - v0));
        const double* xs = xst + (v0 - lo);
        if (staged == 32 * kAhead) {
#pragma unroll 32
          for (int i = 0; i < 32 * kAhead; ++i) sum = __dadd_rn(sum, xs[i]);
        } else {
          for (int i = 0; i < staged; ++i) sum = __dadd_rn(sum, xs[i]);
          for (int i = staged; i < len; ++i) sum = __dadd_rn(sum, x_at(v0 + i));
        }
        v0 += len;
        if (len == 32 * kAhead) continue;
        // the run ended before v0: its sum to acc, or on to the next chunk
        // if it goes on there
        if (lane == 0) {
          if (v0 == hi && hi < S && key_of(hi) == cur) {
            *reinterpret_cast<volatile double*>(cluster.map_shared_rank(handed, c + 1)) = sum;
            __threadfence();
            *reinterpret_cast<volatile int*>(cluster.map_shared_rank(handed_flag, c + 1)) = 1;
          } else {
            arow[cur] = sum;
          }
        }
        owning = false;
        prev = cur;
      }
      if (v0 >= b) break;  // no more runs start in the range
      // 32 columns from v0: each run that starts among them (in the range)
      // added by its first lane up to their end
      const int end = min(v0 + 32, hi);
      const int j = v0 + lane;
      const int kj = key_at(j);
      const int kb = __shfl_up_sync(0xffffffffu, kj, 1);
      const bool first = j < b && kj != (lane ? kb : prev);
      int p = j;
      double s = 0.0;
      if (first)
        for (; p < end && key_at(p) == kj; ++p) s = __dadd_rn(s, x_at(p));
      if (first && p < end) arow[kj] = s;  // ended among the 32
      const unsigned firsts = __ballot_sync(0xffffffffu, first);
      const int last = firsts ? 31 - __clz(firsts) : 0;
      const int last_p = __shfl_sync(0xffffffffu, p, last);
      if (firsts && last_p == end) {  // the last run reaches their end: the warp goes on with it
        owning = true;
        cur = __shfl_sync(0xffffffffu, kj, last);
        sum = __shfl_sync(0xffffffffu, s, last);
      }
      prev = __shfl_sync(0xffffffffu, kj, end - 1 - v0);
      v0 = end;
      if (!owning && v0 >= b) break;
    }
  } else if (c == 0 && tid == 0) {
    for (int u = 0; u < S; ++u) {
      const int64_t col = order[u];
      arow[brow[col]] = __dadd_rn(arow[brow[col]], xrow[col]);
    }
  }
  __threadfence();  // every acc entry of the row, before any block bins it
  cluster.sync();

  // ---- the partial histogram of samples [lo, hi), a tile at a time: each
  // sample's channel values and bin on both grids; the tile's samples by
  // bin (counts, their prefix sums, then each sample put in its bin's
  // range); one thread per (grid, bin), which sorts its bin's samples by
  // position and adds them in that order to each of the grid's channels
  const double* prow = p + row;
  const int64_t* zl = zloc + row;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    for (int i = tid; i < 2 * NB; i += kThreads) start[i] = 0;
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      const int i = t0 + j;
      const double pj = prow[i];
      const double ps = (pj > p_min && pj < p_switch) ? pj : 0.0;
      const double pvar = __dmul_rn(pj, fmax(__dsub_rn(1.0, pj), 0.0));
      const double a = arow[i];
      vals[0 * kTile + j] = ps;
      vals[1 * kTile + j] = pj;
      vals[2 * kTile + j] = __dmul_rn(pj, nu[i]);
      vals[3 * kTile + j] = pvar;
      vals[4 * kTile + j] = __dmul_rn(pvar, nu2[i]);
      vals[5 * kTile + j] = ps;
      vals[6 * kTile + j] = a;
      vals[7 * kTile + j] = a;
      const int64_t z = zl[i];
      const bool in = z >= 0 && z < W;
      const int ka = in ? int(z) * (nl + 1) + int(lh_a[i]) : NB - 1;
      const int kb = in ? int(z) * (nl + 1) + int(lh_b[i]) : NB - 1;
      key[j] = ka;
      key[kTile + j] = kb;
      atomicAdd(&start[ka], 1);
      atomicAdd(&start[NB + kb], 1);
    }
    __syncthreads();
    if (warp < 2) {
      // grid ``warp``: the counts to each bin's first position, lane by
      // lane over runs of bins
      int* cnt = start + warp * NB;
      const int per = (NB + 31) / 32;
      const int b0 = min(NB, lane * per), b1 = min(NB, b0 + per);
      int own = 0;
      for (int b = b0; b < b1; ++b) own += cnt[b];
      int incl = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      int at = incl - own;
      for (int b = b0; b < b1; ++b) {
        const int x = cnt[b];
        cnt[b] = at;
        at += x;
      }
    }
    __syncthreads();
    // each sample into its bin's range, one warp per grid, 32 samples at a
    // time in ascending order (so a range is in order but within each 32);
    // start[b] becomes the range's end
    if (warp < 2) {
      const int* kg = key + warp * kTile;
      int* cnt = start + warp * NB;
      int* pg = perm + warp * kTile;
      for (int j = lane; j < n; j += 32) pg[atomicAdd(&cnt[kg[j]], 1)] = j;
    }
    __syncthreads();
    for (int task = tid; task < 2 * NB; task += kThreads) {
      const int g = task >= NB, b = task - g * NB;  // grid B: channels 5 and 7
      const int* st = start + g * NB;
      const int s0 = b ? st[b - 1] : 0, s1 = st[b];
      if (s0 == s1) continue;
      int* pg = perm + g * kTile;
      for (int q = s0 + 1; q < s1; ++q) {  // by position: insertion, the range nearly in order
        const int x = pg[q];
        int r = q - 1;
        for (; r >= s0 && pg[r] > x; --r) pg[r + 1] = pg[r];
        pg[r + 1] = x;
      }
      if (g == 0) {
        double sum[6];  // channels 0-4 and 6
#pragma unroll
        for (int r = 0; r < 6; ++r) sum[r] = h[(r + (r == 5)) * NB + b];
        for (int q = s0; q < s1; ++q) {
          const int j = pg[q];
#pragma unroll
          for (int r = 0; r < 6; ++r) sum[r] = __dadd_rn(sum[r], vals[(r + (r == 5)) * kTile + j]);
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) h[(r + (r == 5)) * NB + b] = sum[r];
      } else {
        double sum[2];  // channels 5 and 7
#pragma unroll
        for (int r = 0; r < 2; ++r) sum[r] = h[(5 + 2 * r) * NB + b];
        for (int q = s0; q < s1; ++q) {
          const int j = pg[q];
#pragma unroll
          for (int r = 0; r < 2; ++r) sum[r] = __dadd_rn(sum[r], vals[(5 + 2 * r) * kTile + j]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) h[(5 + 2 * r) * NB + b] = sum[r];
      }
    }
    __syncthreads();
  }

  // ---- every chunk's partial in chunk order; block c writes its share
  cluster.sync();
  const int total = kChannels * NB;
  const int share = (total + C - 1) / C;
  const int e0 = min(total, c * share), e1 = min(total, e0 + share);
  double* hrow = hist + rowi * total;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    double s = cluster.map_shared_rank(h, 0)[e];
    for (int q = 1; q < C; ++q) s = __dadd_rn(s, cluster.map_shared_rank(h, q)[e]);
    hrow[e] = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace

extern "C" {

const char* gpdla_cddf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gpdla_cddf_max_chunks() { return kMaxChunks; }

// Dynamic shared memory of one block for W z rows of n_lnhi + 1 bins.
size_t gpdla_cddf_shared_bytes(int W, int nl) {
  return hist_doubles(W, nl) * sizeof(double) + tile_bytes(W, nl);
}

// What one block may take on the current device (0 if it cannot be queried).
int gpdla_cddf_max_shared_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

// p, p2s, acc: (B, S) float64; base, zloc: (B, S) int64; order, lh_a,
// lh_b: (S,) int64; nu, nu2: (S,) float64; hist: (B, 8, W (nl + 1) + 1)
// float64.  C-contiguous, on the current device.  base in [0, S); order
// a permutation of [0, S); lh_a, lh_b in [0, nl].  n_chunks chunks of
// chunk_len samples cover [0, S) (cddf_inputs.cddf_chunk_plan).  The
// caller keeps 1 <= B, 1 <= S, 1 <= n_chunks <= gpdla_cddf_max_chunks(),
// (n_chunks - 1) chunk_len < S <= n_chunks chunk_len, B n_chunks <=
// 2^31 - 1 and gpdla_cddf_shared_bytes(W, nl) <=
// gpdla_cddf_max_shared_bytes().  Returns a cudaError_t.
int gpdla_cddf_sums_f64(const void* p, const void* p2s, const void* base, const void* zloc,
                        const void* order, const void* lh_a, const void* lh_b, const void* nu,
                        const void* nu2, void* acc, void* hist, int B, int S, int W, int nl,
                        int n_chunks, int chunk_len, double p_min, double p_switch,
                        void* stream) {
  const size_t bytes = gpdla_cddf_shared_bytes(W, nl);
  cudaError_t err = cudaFuncSetAttribute(
      cddf_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(B) * unsigned(n_chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(n_chunks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, cddf_sums_kernel, static_cast<const double*>(p), static_cast<const double*>(p2s),
      static_cast<const int64_t*>(base), static_cast<const int64_t*>(zloc),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(lh_a),
      static_cast<const int64_t*>(lh_b), static_cast<const double*>(nu),
      static_cast<const double*>(nu2), static_cast<double*>(acc), static_cast<double*>(hist), S,
      W, nl, chunk_len, p_min, p_switch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
