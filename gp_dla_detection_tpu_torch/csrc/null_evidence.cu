// The null model's evidence, float32, for Hopper (sm_90a): per spectrum
// the masked low-rank normal log-density
//
//   log N(y; mu, M M' + diag(d)),   M: (P, k), pixels where mask is false left out,
//
// by the Woodbury identity with a k x k Cholesky factorisation of
// B = I + M' D^-1 M (log_mvnpdf_low_rank.m:5-33), in a fixed order of
// additions.
//
// No TPU kernel: the JAX package computes this with XLA
// (gp_dla_detection_tpu/ops/low_rank_mvn.py, log_mvnpdf_low_rank, called
// by inference._prepare_spectrum).  The port's plain version
// (ops/low_rank_mvn.log_mvnpdf_low_rank) runs two torch.sum over the
// pixels, whose order follows each row's address alignment (so a
// spectrum's value moved with its position in the batch), and two batched
// matrix products, for which cuBLAS picks another algorithm at some batch
// sizes (on an H100, b = u M at batches 256 and 512 differed from 128 and
// 1024).  Here every row's bits depend on that row alone.  For row b (one
// block per row):
//
//   v_p = mask, d_p -> 1 and y_p - mu_p -> 0 where not v_p
//   w_p = v_p / d_p,  z_p = (M_p1 .. M_pk, y_p - mu_p)
//   G_ij = sum_p (w_p z_pi) z_pj  for i <= j <= k: the Gram M' W M (i, j < k),
//     b = M' W (y - mu) (j = k) and quad0 = (y - mu)' W (y - mu) (i = j = k)
//   logdet_D = sum_p v_p log d_p,  n = sum_p v_p,  B = I + G[:k, :k]
//   (b' B^-1 b, log det B) by the lazy column Crout of the plain version
//   out = -(quad0 - b' B^-1 b + logdet_D + log det B + n log 2 pi) / 2
//
// Order of the sums: the pixels are split into n_slices slices of
// slice_len pixels (the host's plan, ops/low_rank_mvn.null_slice_plan:
// fixed by P alone), one warp each.  In a slice, lane l owns the 4 x 4
// block l of the upper triangle of G's (k + 1) x (k + 1) entries (padded
// to 24 x 24); it adds each run of 32 pixels in ascending order from 0,
// one fused multiply-add per entry, and adds the runs' sums in order to
// the slice's; lane 31 sums logdet_D and n the same way.  The slices'
// partials are then added in slice order.  The Cholesky runs
// on one warp, lane r holding row r of the current column, in the plain
// version's operation order.
//
// What bounds it on the H100: bytes.  It reads y, mu, d (4 B each), M
// (4 k B) and the mask (1 B) per pixel once and writes 4 B per row: at
// B = 1024, P = 1274, k = 20, 121 MB, ~36 us at 3.35 TB/s.  A warp stages
// 32 pixels at a time in shared memory, M with 16-byte loads from the
// first 16-byte boundary of the pixels' span of M on (a spectrum's span
// starts on one only when its offset is a multiple of 4 floats), and
// loads the next 32 pixels while it adds the current ones; each lane's 16
// products of a pixel take two 16-byte shared-memory reads.  The inputs
// are read where they lie, at their strides: the interpolated model's mu
// and M are columns of one (B, P, k + 2) tensor, whose gaps M's loads
// read over.
//
// Entry points (C interface, loaded with ctypes): gpdla_null_evidence_f32,
// gpdla_null_evidence_max_k, gpdla_null_evidence_max_slices,
// gpdla_null_evidence_max_pixel_stride.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                     // one pixel slice each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 21;                     // (k + 1) (k + 2) / 2 + 2 sums <= kThreads
constexpr int kRow = 24;                      // a pixel's z padded to 6 quads
constexpr int kQuads = kRow / 4;
constexpr int kBlocks = kQuads * (kQuads + 1) / 2;  // 21 quad blocks <= 31 lanes
constexpr int kSub = 32;                      // pixels a warp stages at a time
// 16-byte loads of M per lane: 32 pixels' rows at a pixel stride <= kRow
constexpr int kVec = (((kSub - 1) * kRow + kMaxK + 3) / 4 + 31) / 32;
constexpr int kPart = kBlocks * 16 + 2;       // a slice's sums
constexpr float kLog2Pi = 1.8378770664093454836f;

// One lane's share of 32 pixels' inputs, in registers until it is staged.
struct Loaded {
  float4 m[kVec];
  float head, tail;  // M's scalar entries before the first / after the last 16-byte load
  float y, mu, d;
  bool v;
};

// Strides in elements: a spectrum's (row, pixel) of y, mu, d and the mask,
// and of M, whose columns are contiguous.
struct Strides {
  long long y_b, y_p, mu_b, mu_p, d_b, d_p, v_b, v_p, m_b, m_p;
};

// the pixels [s0, s0 + n) of a spectrum: ``src`` its M from pixel s0 on,
// pixel p's row at p m_p (the span's last row ends at its k-th entry)
__device__ __forceinline__ void load(Loaded& in, const float* src, const float* yr,
                                    const float* mur, const float* dr, const uint8_t* vr,
                                    const Strides& st, int s0, int n, int k, int lane) {
  const int count = (n - 1) * int(st.m_p) + k;
  const int head = min(count, int(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2));
  const int nvec = (count - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(src + head);
  in.head = lane < head ? src[lane] : 0.0f;
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const int idx = lane + 32 * q;
    in.m[q] = idx < nvec ? body[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  in.tail = tail0 + lane < count ? src[tail0 + lane] : 0.0f;
  in.v = false;
  in.y = in.mu = 0.0f;
  in.d = 1.0f;
  if (lane < n) {
    const long long p = s0 + lane;
    in.v = vr[p * st.v_p] != 0;
    in.y = yr[p * st.y_p];
    in.mu = mur[p * st.mu_p];
    in.d = dr[p * st.d_p];
  }
}

// entry e of the pixels' span of M to z[e / m_p][e % m_p], if it is one
// of the row's k columns
__device__ __forceinline__ void put(float (*z)[kRow], int e, float x, int k, int m_p,
                                    float inv_m_p) {
  const int pix = int(__fmul_rn(float(e) + 0.5f, inv_m_p));
  const int col = e - pix * m_p;
  if (col < k) z[pix][col] = x;
}

__device__ __forceinline__ void stage(const Loaded& in, float (*z)[kRow], float* w, float* ld,
                                      float* vf, const float* src, int n, int k, int m_p,
                                      float inv_m_p, int lane) {
  const int count = (n - 1) * m_p + k;
  const int head = min(count, int(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2));
  const int nvec = (count - head) >> 2;
  const int tail0 = head + 4 * nvec;
  if (lane < head) put(z, lane, in.head, k, m_p, inv_m_p);
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const int idx = lane + 32 * q;
    if (idx < nvec) {
      const int e = head + 4 * idx;
      put(z, e, in.m[q].x, k, m_p, inv_m_p);
      put(z, e + 1, in.m[q].y, k, m_p, inv_m_p);
      put(z, e + 2, in.m[q].z, k, m_p, inv_m_p);
      put(z, e + 3, in.m[q].w, k, m_p, inv_m_p);
    }
  }
  if (tail0 + lane < count) put(z, tail0 + lane, in.tail, k, m_p, inv_m_p);
  if (lane < n) {
    const float d_safe = in.v ? in.d : 1.0f;
    w[lane] = in.v ? __fdiv_rn(1.0f, d_safe) : 0.0f;
    z[lane][k] = in.v ? __fsub_rn(in.y, in.mu) : 0.0f;
    ld[lane] = in.v ? logf(d_safe) : 0.0f;
    vf[lane] = in.v ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
null_evidence_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                     const float* __restrict__ M, const float* __restrict__ d,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, Strides st,
                     int P, int k, int slice_len, int n_slices) {
  __shared__ __align__(16) float zs[kWarps][kSub][kRow];  // each warp's staged z rows
  __shared__ float ws[kWarps][kSub];                       // w = v / d
  __shared__ float lds[kWarps][kSub];                      // v log d
  __shared__ float vs[kWarps][kSub];                       // v
  __shared__ float part[kWarps][kPart];                    // each slice's sums
  __shared__ float gram[kMaxK][kMaxK];
  __shared__ float proj[kMaxK];
  __shared__ float scal[3];                                // quad0, logdet_D, n
  __shared__ float chol[kMaxK][kMaxK];                     // column m of L in chol[m][.]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const float* yr = y + row * st.y_b;
  const float* mur = mu + row * st.mu_b;
  const float* dr = d + row * st.d_b;
  const uint8_t* vr = mask + row * st.v_b;
  const float* Mr = M + row * st.m_b;
  const int m_p = int(st.m_p);
  const int nq = (k + 1 + 3) / 4;          // quads of z
  const int nblk = nq * (nq + 1) / 2;
  const float inv_m_p = 1.0f / float(m_p);

  // this lane's quad block (qi <= qj), in the packed upper triangle's
  // row-major order
  int qi = 0, rest = lane;
  while (qi < nq && rest >= nq - qi) {
    rest -= nq - qi;
    ++qi;
  }
  const int qj = qi + rest;
  const bool owner = lane < nblk;

  float (*z)[kRow] = zs[warp];
  for (int e = lane; e < kSub * kRow; e += 32) z[e / kRow][e % kRow] = 0.0f;  // the pad columns
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  float sum_ld = 0.0f, sum_v = 0.0f;

  if (warp < n_slices) {
    const int p0 = warp * slice_len, p1 = min(P, p0 + slice_len);
    Loaded in;
    load(in, Mr + p0 * st.m_p, yr, mur, dr, vr, st, p0, min(kSub, p1 - p0), k, lane);
    for (int s0 = p0; s0 < p1; s0 += kSub) {
      const int n = min(kSub, p1 - s0);
      __syncwarp();  // the previous pixels' reads are done
      stage(in, z, ws[warp], lds[warp], vs[warp], Mr + s0 * st.m_p, n, k, m_p, inv_m_p, lane);
      __syncwarp();
      if (s0 + kSub < p1)
        load(in, Mr + (s0 + kSub) * st.m_p, yr, mur, dr, vr, st, s0 + kSub,
             min(kSub, p1 - s0 - kSub), k, lane);
      if (owner) {
        float sub[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sub[r][c] = 0.0f;
        for (int t = 0; t < n; ++t) {
          const float wt = ws[warp][t];
          const float4 zi = *reinterpret_cast<const float4*>(&z[t][4 * qi]);
          const float4 zj = *reinterpret_cast<const float4*>(&z[t][4 * qj]);
          const float a[4] = {__fmul_rn(wt, zi.x), __fmul_rn(wt, zi.y), __fmul_rn(wt, zi.z),
                              __fmul_rn(wt, zi.w)};
          const float b[4] = {zj.x, zj.y, zj.z, zj.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sub[r][c] = __fmaf_rn(a[r], b[c], sub[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], sub[r][c]);
      } else if (lane == 31) {
        float sub_ld = 0.0f, sub_v = 0.0f;
        for (int t = 0; t < n; ++t) {
          sub_ld = __fadd_rn(sub_ld, lds[warp][t]);
          sub_v = __fadd_rn(sub_v, vs[warp][t]);
        }
        sum_ld = __fadd_rn(sum_ld, sub_ld);
        sum_v = __fadd_rn(sum_v, sub_v);
      }
    }
    if (owner) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[warp][lane * 16 + r * 4 + c] = acc[r][c];
    } else if (lane == 31) {
      part[warp][kBlocks * 16] = sum_ld;
      part[warp][kBlocks * 16 + 1] = sum_v;
    }
  }
  __syncthreads();

  // the slices' partials in slice order: thread o owns entry (i, j), i <= j
  // <= k, of the packed upper triangle, or logdet_D or n
  const int n_tri = (k + 1) * (k + 2) / 2;
  if (tid < n_tri + 2) {
    int src;
    int i = 0, j = 0;
    if (tid < n_tri) {
      int r = tid;
      while (r >= k + 1 - i) {
        r -= k + 1 - i;
        ++i;
      }
      j = i + r;
      const int bi = i >> 2, bj = j >> 2;
      const int blk = bi * nq - bi * (bi - 1) / 2 + (bj - bi);
      src = blk * 16 + (i & 3) * 4 + (j & 3);
    } else {
      src = kBlocks * 16 + (tid - n_tri);
    }
    float total = part[0][src];
    for (int s = 1; s < n_slices; ++s) total = __fadd_rn(total, part[s][src]);
    if (tid >= n_tri) {
      scal[1 + tid - n_tri] = total;
    } else if (j < k) {
      const float g = i == j ? __fadd_rn(total, 1.0f) : total;
      gram[i][j] = g;
      gram[j][i] = g;
    } else if (i < k) {
      proj[i] = total;
    } else {
      scal[0] = total;
    }
  }
  __syncthreads();
  if (tid >= 32) return;

  // (b' B^-1 b, log det B): column j of L from B[:, j] less the earlier
  // columns, lane r holding row r (ops/low_rank_mvn.batched_spd_quad_logdet)
  const int r = tid;
  float quad = 0.0f, logdet = 0.0f;
  float ys[kMaxK];
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    float c = r < k ? gram[r][j] : 0.0f;
    float y_j = proj[j];
    for (int m = 0; m < j; ++m) {
      if (r < k) c = __fsub_rn(c, __fmul_rn(chol[m][r], chol[m][j]));
      y_j = __fsub_rn(y_j, __fmul_rn(chol[m][j], ys[m]));
    }
    const float djj = __shfl_sync(0xffffffffu, c, j);
    const float inv_sqrt = rsqrtf(djj);
    __syncwarp();
    if (r < k) chol[j][r] = __fmul_rn(c, inv_sqrt);
    __syncwarp();
    y_j = __fmul_rn(y_j, inv_sqrt);
    ys[j] = y_j;
    quad = __fadd_rn(quad, __fmul_rn(y_j, y_j));
    logdet = __fadd_rn(logdet, logf(djj));
  }
  if (r == 0) {
    float s = __fsub_rn(scal[0], quad);
    s = __fadd_rn(s, scal[1]);
    s = __fadd_rn(s, logdet);
    s = __fadd_rn(s, __fmul_rn(scal[2], kLog2Pi));
    out[row] = __fmul_rn(-0.5f, s);
  }
}

}  // namespace

extern "C" {

const char* gpdla_null_evidence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gpdla_null_evidence_max_k() { return kMaxK; }

int gpdla_null_evidence_max_slices() { return kWarps; }

int gpdla_null_evidence_max_pixel_stride() { return kRow; }

// y, mu, d: (B, P) float32; M: (B, P, k) float32; mask: (B, P) bool
// (one byte each); out: (B,) float32 contiguous; on the current device.
// strides: (row, pixel) in elements of y, mu, d, the mask and M, in that
// order; M's columns contiguous, its pixel stride in [k,
// gpdla_null_evidence_max_pixel_stride()].  n_slices slices of slice_len
// pixels cover [0, P) (ops/low_rank_mvn.null_slice_plan).  The caller
// keeps 1 <= B <= 2^31 - 1, P >= 1, 1 <= k <= gpdla_null_evidence_max_k()
// and 1 <= n_slices <= gpdla_null_evidence_max_slices(), (n_slices - 1)
// slice_len < P <= n_slices slice_len.  Returns a cudaError_t.
int gpdla_null_evidence_f32(const void* y, const void* mu, const void* M, const void* d,
                            const void* mask, void* out, const long long* strides, int B,
                            int P, int k, int slice_len, int n_slices, void* stream) {
  const Strides st = {strides[0], strides[1], strides[2], strides[3], strides[4],
                      strides[5], strides[6], strides[7], strides[8], strides[9]};
  null_evidence_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(mu), static_cast<const float*>(M),
      static_cast<const float*>(d), static_cast<const uint8_t*>(mask), static_cast<float*>(out), st,
      P, k, slice_len, n_slices);
  return cudaGetLastError();
}

}  // extern "C"
