// Leave-one-out downdate in float64 for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_loocv_df64 (cvmatrix_tpu/ops/kernels.py,
// pallas_call in fused_loocv_df64). That kernel carries float64 as f32
// (hi, lo) pairs on padded 128-wide tiles; the H100 has native float64, so
// this one reads and writes float64 on the unpadded (K, C) shape, C = K + M.
//
// For fold f with validation row r = rows[f] and scalars
// scal[f] = (sw, 1/sw, 1/divisor) of the training set:
//
//   mean  = (g_sum - w_row) / sw
//   var   = (-2 mean (g_sum - w_row) + sw mean^2 + (g_sq - w_row u_row)) / div
//   r     = 1 / sqrt(max(var, 0)), or 1 where that std <= resolution
//   rc    = [r1 | r2]   (1 on a side that is not scaled)
//   u     = xw[r] r1                 v = [xu[r] r1 | yu[r] r2]
//   p     = sw mX r1 (0 if no centring)
//   q     = [mX r1 (0 unless centre XTX) | mY r2 (0 unless centre XTY)]
//   out[f] = total (.) (r1 (x) rc) - u (x) v - p (x) q        (K, C)
//
// What bounds it: every fold writes K*C*8 bytes (2.0 MB at K=500, M=10)
// and reads only one data row, so the sweep is bound by device-memory
// writes. The design follows: a vector phase (grid F) computes the five
// per-fold vectors once into a small scratch (F, 5, C); the tile phase
// (grid F x ceil(K/ROWS)) streams the output rows with threads running
// along columns, so each warp stores 256 contiguous bytes, and reads the
// (K, C) total from L2, where it stays (2 MB of 50 MB). Outputs are
// stored with an evict-first hint because nothing reads them back soon.
//
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/loocv.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kTileRows = 8;

constexpr int kCenterXTX = 1;
constexpr int kCenterXTY = 2;
constexpr int kScaleX = 4;
constexpr int kScaleY = 8;
constexpr int kWithY = 16;

// Downdated mean and clamped reciprocal std of one column.
__device__ __forceinline__ void column_stats(
    double g_sum, double g_sq, double w, double u, double sw, double rsw,
    double rdv, bool need_mean, bool need_std, double resolution,
    double* mean, double* recip) {
  double m = 0.0;
  double r = 1.0;
  if (need_mean || need_std) {
    const double st = g_sum - w;
    m = st * rsw;
    if (need_std) {
      const double ss = g_sq - w * u;
      const double var = (-2.0 * m * st + sw * (m * m) + ss) * rdv;
      // NaN propagates, as in torch.clamp and the JAX kernel.
      const double sd = sqrt(var < 0.0 ? 0.0 : var);
      r = sd <= resolution ? 1.0 : 1.0 / sd;
    }
  }
  *mean = m;
  *recip = r;
}

// Vector phase: one block per fold writes rc, u, v, p, q (rows 0..4 of
// vec[f], each C long; u and p use the first K entries).
__global__ void loocv_vectors_kernel(
    const int64_t* __restrict__ rows, const double* __restrict__ xw,
    const double* __restrict__ xu, const double* __restrict__ yu,
    const double* __restrict__ yw, const double* __restrict__ gx,
    const double* __restrict__ gy, const double* __restrict__ scal,
    double* __restrict__ vec, int64_t K, int64_t M, int flags,
    double resolution) {
  const int64_t f = blockIdx.x;
  const int64_t C = K + M;
  const int64_t r = rows[f];
  const double sw = scal[3 * f];
  const double rsw = scal[3 * f + 1];
  const double rdv = scal[3 * f + 2];
  const bool center_xtx = flags & kCenterXTX;
  const bool with_y = flags & kWithY;
  const bool center_xty = with_y && (flags & kCenterXTY);
  const bool scale_x = flags & kScaleX;
  const bool scale_y = with_y && (flags & kScaleY);
  const bool center = center_xtx || center_xty;
  const bool need_x_mean = center || scale_x;
  const bool need_y_mean = center_xty || scale_y;

  double* rc = vec + 5 * C * f;
  double* u = rc + C;
  double* v = rc + 2 * C;
  double* p = rc + 3 * C;
  double* q = rc + 4 * C;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    double m, ri;
    if (j < K) {
      const double a = xw[r * K + j];
      const double b = xu[r * K + j];
      column_stats(gx[j], gx[K + j], a, b, sw, rsw, rdv, need_x_mean,
                   scale_x, resolution, &m, &ri);
      const double mr = m * ri;
      rc[j] = ri;
      u[j] = a * ri;
      v[j] = b * ri;
      p[j] = center ? sw * mr : 0.0;
      q[j] = center_xtx ? mr : 0.0;
    } else {
      const int64_t jj = j - K;
      const double a = yw[r * M + jj];
      const double b = yu[r * M + jj];
      column_stats(gy[jj], gy[M + jj], a, b, sw, rsw, rdv, need_y_mean,
                   scale_y, resolution, &m, &ri);
      rc[j] = ri;
      v[j] = b * ri;
      q[j] = center_xty ? m * ri : 0.0;
    }
  }
}

// Tile phase: block (f, strip) writes rows [strip*ROWS, +ROWS) of out[f].
__global__ void loocv_tile_kernel(
    const double* __restrict__ total, const double* __restrict__ vec,
    double* __restrict__ out, int64_t K, int64_t C) {
  extern __shared__ double smem[];
  double* s_rc = smem;
  double* s_v = smem + C;
  double* s_q = smem + 2 * C;
  const int64_t f = blockIdx.x;
  const double* vf = vec + 5 * C * f;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    s_rc[j] = vf[j];
    s_v[j] = vf[2 * C + j];
    s_q[j] = vf[4 * C + j];
  }
  __syncthreads();

  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTileRows;
  const int64_t i1 = i0 + kTileRows < K ? i0 + kTileRows : K;
  double* of = out + K * C * f;
  for (int64_t i = i0; i < i1; ++i) {
    const double ri = s_rc[i];
    const double ui = vf[C + i];
    const double pi = vf[3 * C + i];
    const double* trow = total + i * C;
    double* orow = of + i * C;
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      const double val = trow[j] * (ri * s_rc[j]) - ui * s_v[j] - pi * s_q[j];
      __stcs(orow + j, val);
    }
  }
}

}  // namespace

// Launch both phases on `stream`. Pointers are device pointers; yu, yw and
// gy may be null when flags lacks kWithY (then M must be 0). vec is
// caller-allocated scratch of F*5*(K+M) doubles, out of F*K*(K+M).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int cvm_loocv_f64(
    const int64_t* rows, const double* total, const double* xw,
    const double* xu, const double* yu, const double* yw, const double* gx,
    const double* gy, const double* scal, double* vec, double* out,
    int64_t F, int64_t K, int64_t M, int flags, double resolution,
    int device, void* stream) {
  if (F <= 0 || K <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t C = K + M;
  loocv_vectors_kernel<<<static_cast<unsigned>(F), kVecThreads, 0, s>>>(
      rows, xw, xu, yu, yw, gx, gy, scal, vec, K, M, flags, resolution);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(F),
                  static_cast<unsigned>((K + kTileRows - 1) / kTileRows));
  const size_t smem = 3 * C * sizeof(double);
  loocv_tile_kernel<<<grid, kTileThreads, smem, s>>>(total, vec, out, K, C);
  return static_cast<int>(cudaGetLastError());
}
