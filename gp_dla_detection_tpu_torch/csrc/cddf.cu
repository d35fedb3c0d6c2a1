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
// run to run.  For row b (one block per row), with S samples:
//
//   acc[i]  = sum of p2s[c] over the pair columns c whose base[c] = i
//   hist[ch, bin(ch, i)] += value(ch, i) over the samples i, with
//     value = [ps, p, p nu, pvar, pvar nu2, ps, acc, acc][ch],
//     ps = p where p_min < p < p_switch (else 0), pvar = p max(1 - p, 0),
//     bin = zloc[i] (n_lnhi + 1) + lnhi_bin(ch, i) where 0 <= zloc < W,
//     else the dump slot W (n_lnhi + 1); channels 5 and 7 bin log N_HI on
//     grid B, the others on grid A.
//
// Order of the additions:
// - acc: ``order`` lists the pair columns by ascending (grid position,
//   column), and acc[i] adds its columns in that order, from 0.  The
//   redraw's base column is g[kvec[c]] with g ascending in the grid
//   position, so along ``order`` equal bases stand in one run: each run
//   is summed by one thread in sequence.  A row whose bases do not
//   ascend along ``order`` (not a redraw's) is summed by one thread in
//   the same order, column by column, into device memory: the same bits
//   for the same sums, more slowly.
// - hist: each of the 8 (W + 1) (channel, z row or dump) bin groups is
//   owned by one thread, which walks the samples in ascending order and
//   adds those that fall in its group.  No two threads add to one bin,
//   and no floating-point atomics are used.  The samples come a tile of
//   256 at a time, staged in shared memory with their eight channel
//   values, and a warp's 32 lanes are the 8 channels of 4 z rows: a
//   sample of one of those rows is added by 8 lanes at once, with no
//   branch on the channel.
// So every row's bits depend on that row alone, in every run.
//
// What bounds it on the H100: bytes at this size.  It reads p, p2s, base
// and zloc once (8 B each per (row, sample)) and writes acc (8 B) and
// hist (8 x (W (n_lnhi + 1) + 1) doubles per row): at B = 1024, S =
// 10,000 and the default grids, 434 MB, ~0.13 ms at 3.35 TB/s.  It is
// latency-bound instead: one block of 4 warps per row walks the samples
// (every owner compares each sample's z row, and adds its own with one
// shared-memory read-modify-write after another) and the runs of equal
// bases (gathers through ``order``), so at B = 128, one block per SM, it
// takes longer than the plain sums (PERF.md); several blocks per row,
// merged in a fixed order, are the way to fill the card.
//
// Entry points (C interface, loaded with ctypes):
//   gpdla_cddf_sums_f64: acc (B, S) and hist (B, 8, W (n_lnhi + 1) + 1).
//   gpdla_cddf_shared_bytes / gpdla_cddf_max_shared_bytes: the block's
//     shared memory for a grid, and what the current device allows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChannels = 8;
constexpr int kTile = 256;           // samples staged in shared memory at a time
constexpr int kTileRow = kTile + 1;  // a channel's staged values; the pad
                                     // puts the 8 channels on 8 bank pairs
constexpr int kAhead = 8;            // a run's columns read ahead of its sum

size_t hist_doubles(int W, int nl) { return size_t(kChannels) * (size_t(W) * (nl + 1) + 1); }

// shared memory beyond the bins: the staged values, z rows and log N_HI
// bins of a tile
size_t tile_bytes() {
  return size_t(kChannels) * kTileRow * sizeof(double) + size_t(3) * kTile * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
cddf_sums_kernel(const double* __restrict__ p, const double* __restrict__ p2s,
                 const int64_t* __restrict__ base, const int64_t* __restrict__ zloc,
                 const int64_t* __restrict__ order, const int64_t* __restrict__ lh_a,
                 const int64_t* __restrict__ lh_b, const double* __restrict__ nu,
                 const double* __restrict__ nu2, double* __restrict__ acc,
                 double* __restrict__ hist, int S, int W, int nl, double p_min,
                 double p_switch) {
  extern __shared__ double smem[];
  const int NB = W * (nl + 1) + 1;
  double* h = smem;                        // (8, NB)
  double* vals = h + kChannels * NB;       // (8, kTileRow): each sample's channel values
  int* zrow = reinterpret_cast<int*>(vals + kChannels * kTileRow);  // z row, W outside
  int* la = zrow + kTile;
  int* lb = la + kTile;

  const size_t row = size_t(blockIdx.x) * S;
  const int64_t* brow = base + row;
  const double* xrow = p2s + row;
  double* arow = acc + row;

  // ---- acc: zero, then check that the bases ascend along ``order``
  for (int i = threadIdx.x; i < S; i += kThreads) arow[i] = 0.0;
  for (int i = threadIdx.x; i < kChannels * NB; i += kThreads) h[i] = 0.0;
  int unsorted = 0;
  for (int u = threadIdx.x; u < S; u += kThreads) {
    const int64_t k = brow[order[u]];
    if (k < 0 || k >= S) __trap();  // a base outside the sample axis, as torch's device assert
    if (u > 0 && k < brow[order[u - 1]]) unsorted = 1;
  }
  if (!__syncthreads_or(unsorted)) {
    // one thread per run of equal bases, from its first column on
    for (int u = threadIdx.x; u < S; u += kThreads) {
      const int64_t key = brow[order[u]];
      if (u > 0 && brow[order[u - 1]] == key) continue;
      double sum = 0.0;
      bool going = true;
      for (int v = u; going && v < S; v += kAhead) {
        int64_t kk[kAhead];
        double xx[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          kk[q] = -1;
          xx[q] = 0.0;
          if (v + q < S) {
            const int64_t c = order[v + q];
            kk[q] = brow[c];
            xx[q] = xrow[c];
          }
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          going = going && kk[q] == key;
          if (going) sum = __dadd_rn(sum, xx[q]);
        }
      }
      arow[key] = sum;
    }
  } else if (threadIdx.x == 0) {
    for (int u = 0; u < S; ++u) {
      const int64_t c = order[u];
      arow[brow[c]] = __dadd_rn(arow[brow[c]], xrow[c]);
    }
  }
  __syncthreads();

  // ---- hist, a tile of samples at a time: stage each sample's eight
  // channel values; thread g owns channel g % 8 of z row g / 8 (row W: the
  // dump slot), so a warp's lanes are the 8 channels of 4 z rows, and adds
  // the tile's samples of its row in ascending order
  const double* prow = p + row;
  const int64_t* zl = zloc + row;
  for (int base_i = 0; base_i < S; base_i += kTile) {
    const int n = min(kTile, S - base_i);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int i = base_i + j;
      const double pj = prow[i];
      const double ps = (pj > p_min && pj < p_switch) ? pj : 0.0;
      const double pvar = __dmul_rn(pj, fmax(__dsub_rn(1.0, pj), 0.0));
      const double a = arow[i];
      vals[0 * kTileRow + j] = ps;
      vals[1 * kTileRow + j] = pj;
      vals[2 * kTileRow + j] = __dmul_rn(pj, nu[i]);
      vals[3 * kTileRow + j] = pvar;
      vals[4 * kTileRow + j] = __dmul_rn(pvar, nu2[i]);
      vals[5 * kTileRow + j] = ps;
      vals[6 * kTileRow + j] = a;
      vals[7 * kTileRow + j] = a;
      const int64_t z = zl[i];
      zrow[j] = (z >= 0 && z < W) ? int(z) : W;
      la[j] = int(lh_a[i]);
      lb[j] = int(lh_b[i]);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < kChannels * (W + 1); g += kThreads) {
      const int ch = g % kChannels, zr = g / kChannels;
      // channels 5 and 7 bin log N_HI on grid B, the others on grid A
      const int* lh = (ch == 5 || ch == 7) ? lb : la;
      const double* v = vals + ch * kTileRow;
      double* hg = h + ch * NB + zr * (nl + 1);  // the dump slot is z row W's first bin
      for (int j = 0; j < n; ++j) {
        if (zrow[j] != zr) continue;
        const int bin = zr == W ? 0 : lh[j];
        hg[bin] = __dadd_rn(hg[bin], v[j]);
      }
    }
    __syncthreads();
  }

  double* hrow = hist + size_t(blockIdx.x) * kChannels * NB;
  for (int i = threadIdx.x; i < kChannels * NB; i += kThreads) hrow[i] = h[i];
}

}  // namespace

extern "C" {

const char* gpdla_cddf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block for W z rows of n_lnhi + 1 bins.
size_t gpdla_cddf_shared_bytes(int W, int nl) {
  return hist_doubles(W, nl) * sizeof(double) + tile_bytes();
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
// a permutation of [0, S); lh_a, lh_b in [0, nl].  The caller keeps
// 1 <= B <= 2^31 - 1, 1 <= S and gpdla_cddf_shared_bytes(W, nl) <=
// gpdla_cddf_max_shared_bytes().  Returns a cudaError_t.
int gpdla_cddf_sums_f64(const void* p, const void* p2s, const void* base, const void* zloc,
                        const void* order, const void* lh_a, const void* lh_b, const void* nu,
                        const void* nu2, void* acc, void* hist, int B, int S, int W, int nl,
                        double p_min, double p_switch, void* stream) {
  const size_t bytes = gpdla_cddf_shared_bytes(W, nl);
  cudaError_t err = cudaFuncSetAttribute(
      cddf_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  cddf_sums_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(p), static_cast<const double*>(p2s),
      static_cast<const int64_t*>(base), static_cast<const int64_t*>(zloc),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(lh_a),
      static_cast<const int64_t*>(lh_b), static_cast<const double*>(nu),
      static_cast<const double*>(nu2), static_cast<double*>(acc), static_cast<double*>(hist),
      S, W, nl, p_min, p_switch);
  return cudaGetLastError();
}

}  // extern "C"
