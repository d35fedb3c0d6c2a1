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
//   w_p = v_p / d_p,  u_p = (y_p - mu_p) w_p
//   quad0 = sum_p (y_p - mu_p) u_p,  logdet_D = sum_p v_p log d_p,  n = sum_p v_p
//   B_ij = [i == j] + sum_p M_pi (M_pj w_p),  b_j = sum_p u_p M_pj
//   (b' B^-1 b, log det B) by the lazy column Crout of the plain version
//   out = -(quad0 - b' B^-1 b + logdet_D + log det B + n log 2 pi) / 2
//
// Order of the sums: each of the k (k + 1) / 2 + k + 3 sums is owned by
// one thread, which adds the pixels of a 64-pixel tile in ascending order
// from 0 and then adds the tile's sum to its running total.  The
// Cholesky runs on one warp, lane r holding row r of the current column,
// in the plain version's operation order.
//
// What bounds it on the H100: bytes.  It reads y, mu, d (4 B each), M
// (4 k B) and the mask (1 B) per pixel once and writes 4 B per row: at
// B = 1024, P = 1274, k = 20, 121 MB, ~36 us at 3.35 TB/s.  Each tile
// (M, w and u of 64 pixels) is staged in shared memory.
//
// Entry point (C interface, loaded with ctypes): gpdla_null_evidence_f32.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePixels = 64;
constexpr int kMaxK = 21;  // k (k + 1) / 2 + k + 3 sums <= kThreads
constexpr float kLog2Pi = 1.8378770664093454836f;

__global__ void __launch_bounds__(kThreads)
null_evidence_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                     const float* __restrict__ M, const float* __restrict__ d,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, int P, int k) {
  __shared__ float m_tile[kTilePixels][kMaxK];
  __shared__ float w_tile[kTilePixels];  // v / d
  __shared__ float u_tile[kTilePixels];  // (y - mu) v / d
  __shared__ float q_tile[kTilePixels];  // (y - mu) u
  __shared__ float l_tile[kTilePixels];  // v log d
  __shared__ float v_tile[kTilePixels];  // v
  __shared__ float gram[kMaxK][kMaxK];
  __shared__ float proj[kMaxK];
  __shared__ float scal[3];              // quad0, logdet_D, n
  __shared__ float chol[kMaxK][kMaxK];   // column m of L in chol[m][.]

  const size_t row = blockIdx.x;
  const float* yr = y + row * P;
  const float* mur = mu + row * P;
  const float* dr = d + row * P;
  const uint8_t* vr = mask + row * P;
  const float* Mr = M + row * size_t(P) * k;

  // this thread's sum: a Gram entry (i, j), i <= j, in the packed upper
  // triangle's row-major order, b_j, quad0, logdet_D or n
  const int n_tri = k * (k + 1) / 2;
  const int o = threadIdx.x;
  int kind = 5, gi = 0, gj = 0;  // 0 Gram, 1 b, 2 quad0, 3 logdet_D, 4 n, 5 none
  if (o < n_tri) {
    kind = 0;
    int rest = o;
    while (rest >= k - gi) {
      rest -= k - gi;
      ++gi;
    }
    gj = gi + rest;
  } else if (o < n_tri + k) {
    kind = 1;
    gj = o - n_tri;
  } else if (o < n_tri + k + 3) {
    kind = 2 + (o - n_tri - k);
  }

  float total = 0.0f;
  for (int base = 0; base < P; base += kTilePixels) {
    const int n = min(kTilePixels, P - base);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int p = base + t;
      const bool v = vr[p] != 0;
      const float d_safe = v ? dr[p] : 1.0f;
      const float w = v ? __fdiv_rn(1.0f, d_safe) : 0.0f;
      const float yc = v ? __fsub_rn(yr[p], mur[p]) : 0.0f;
      const float u = __fmul_rn(yc, w);
      w_tile[t] = w;
      u_tile[t] = u;
      q_tile[t] = __fmul_rn(yc, u);
      l_tile[t] = v ? logf(d_safe) : 0.0f;
      v_tile[t] = v ? 1.0f : 0.0f;
    }
    for (int e = threadIdx.x; e < n * k; e += kThreads) m_tile[e / k][e % k] = Mr[size_t(base) * k + e];
    __syncthreads();
    float sum = 0.0f;
    switch (kind) {
      case 0:
        for (int t = 0; t < n; ++t)
          sum = __fmaf_rn(m_tile[t][gi], __fmul_rn(m_tile[t][gj], w_tile[t]), sum);
        break;
      case 1:
        for (int t = 0; t < n; ++t) sum = __fmaf_rn(u_tile[t], m_tile[t][gj], sum);
        break;
      case 2:
        for (int t = 0; t < n; ++t) sum = __fadd_rn(sum, q_tile[t]);
        break;
      case 3:
        for (int t = 0; t < n; ++t) sum = __fadd_rn(sum, l_tile[t]);
        break;
      case 4:
        for (int t = 0; t < n; ++t) sum = __fadd_rn(sum, v_tile[t]);
        break;
      default:
        break;
    }
    total = __fadd_rn(total, sum);
    __syncthreads();
  }
  if (kind == 0) {
    const float g = gi == gj ? __fadd_rn(total, 1.0f) : total;
    gram[gi][gj] = g;
    gram[gj][gi] = g;
  } else if (kind == 1) {
    proj[gj] = total;
  } else if (kind <= 4) {
    scal[kind - 2] = total;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // (b' B^-1 b, log det B): column j of L from B[:, j] less the earlier
  // columns, lane r holding row r (ops/low_rank_mvn.batched_spd_quad_logdet)
  const int r = threadIdx.x;
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

// y, mu, d: (B, P) float32; M: (B, P, k) float32; mask: (B, P) bool
// (one byte each); out: (B,) float32.  C-contiguous, on the current
// device.  The caller keeps 1 <= B <= 2^31 - 1, P >= 1 and 1 <= k <=
// gpdla_null_evidence_max_k().  Returns a cudaError_t.
int gpdla_null_evidence_f32(const void* y, const void* mu, const void* M, const void* d,
                            const void* mask, void* out, int B, int P, int k, void* stream) {
  null_evidence_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(mu), static_cast<const float*>(M),
      static_cast<const float*>(d), static_cast<const uint8_t*>(mask), static_cast<float*>(out), P,
      k);
  return cudaGetLastError();
}

}  // extern "C"
