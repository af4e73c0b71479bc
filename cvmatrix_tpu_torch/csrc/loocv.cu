// Leave-one-out downdate in float64 and float32 for Hopper (sm_90a).
//
// Replaces two TPU kernels of cvmatrix_tpu/ops/kernels.py:
//
//   cvm_loocv_f64  <- fused_loocv_df64 (float64 carried as f32 (hi, lo)
//                     pairs on padded 128-wide tiles)
//   cvm_loocv_f32  <- fused_loocv_f32 (the same math in plain f32)
//
// The H100 has native float64, so one body templated on the element type T
// serves both: it reads and writes T on the unpadded (K, C) shape, C = K + M.
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
// What bounds it: every fold writes K*C*sizeof(T) bytes (2.0 MB in float64,
// 1.0 MB in float32 at K=500, M=10) and reads only one data row, so the
// sweep is bound by device-memory writes. The design follows: a vector
// phase (grid F) computes the five per-fold vectors once into a small
// scratch (F, 5, C); the tile phase (grid F x ceil(K/ROWS)) streams the
// output rows with threads running along columns, so each warp stores 256
// (float64) or 128 (float32) contiguous bytes, and reads the (K, C) total
// from L2, where it stays (2 MB of 50 MB). Outputs are stored with an
// evict-first hint because nothing reads them back soon.
//
// Float32 is computed in float32 throughout, as the TPU kernel does:
// constants are T(...), and sqrt and 1/x are the correctly rounded float
// operations (the build uses no fast-math flags). The product runs on FP32
// FMA, never on TF32 tensor cores.
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

__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }

// Downdated mean and clamped reciprocal std of one column.
template <typename T>
__device__ __forceinline__ void column_stats(
    T g_sum, T g_sq, T w, T u, T sw, T rsw, T rdv, bool need_mean,
    bool need_std, T resolution, T* mean, T* recip) {
  T m = T(0);
  T r = T(1);
  if (need_mean || need_std) {
    const T st = g_sum - w;
    m = st * rsw;
    if (need_std) {
      const T ss = g_sq - w * u;
      const T var = (T(-2) * m * st + sw * (m * m) + ss) * rdv;
      // NaN propagates, as in torch.clamp and the JAX kernel.
      const T sd = sqrt_t(var < T(0) ? T(0) : var);
      r = sd <= resolution ? T(1) : T(1) / sd;
    }
  }
  *mean = m;
  *recip = r;
}

// Vector phase: one block per fold writes rc, u, v, p, q (rows 0..4 of
// vec[f], each C long; u and p use the first K entries).
template <typename T>
__global__ void loocv_vectors_kernel(
    const int64_t* __restrict__ rows, const T* __restrict__ xw,
    const T* __restrict__ xu, const T* __restrict__ yu,
    const T* __restrict__ yw, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ scal,
    T* __restrict__ vec, int64_t K, int64_t M, int flags, T resolution) {
  const int64_t f = blockIdx.x;
  const int64_t C = K + M;
  const int64_t r = rows[f];
  const T sw = scal[3 * f];
  const T rsw = scal[3 * f + 1];
  const T rdv = scal[3 * f + 2];
  const bool center_xtx = flags & kCenterXTX;
  const bool with_y = flags & kWithY;
  const bool center_xty = with_y && (flags & kCenterXTY);
  const bool scale_x = flags & kScaleX;
  const bool scale_y = with_y && (flags & kScaleY);
  const bool center = center_xtx || center_xty;
  const bool need_x_mean = center || scale_x;
  const bool need_y_mean = center_xty || scale_y;

  T* rc = vec + 5 * C * f;
  T* u = rc + C;
  T* v = rc + 2 * C;
  T* p = rc + 3 * C;
  T* q = rc + 4 * C;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    T m, ri;
    if (j < K) {
      const T a = xw[r * K + j];
      const T b = xu[r * K + j];
      column_stats(gx[j], gx[K + j], a, b, sw, rsw, rdv, need_x_mean,
                   scale_x, resolution, &m, &ri);
      const T mr = m * ri;
      rc[j] = ri;
      u[j] = a * ri;
      v[j] = b * ri;
      p[j] = center ? sw * mr : T(0);
      q[j] = center_xtx ? mr : T(0);
    } else {
      const int64_t jj = j - K;
      const T a = yw[r * M + jj];
      const T b = yu[r * M + jj];
      column_stats(gy[jj], gy[M + jj], a, b, sw, rsw, rdv, need_y_mean,
                   scale_y, resolution, &m, &ri);
      rc[j] = ri;
      v[j] = b * ri;
      q[j] = center_xty ? m * ri : T(0);
    }
  }
}

// Tile phase: block (f, strip) writes rows [strip*ROWS, +ROWS) of out[f].
template <typename T>
__global__ void loocv_tile_kernel(
    const T* __restrict__ total, const T* __restrict__ vec,
    T* __restrict__ out, int64_t K, int64_t C) {
  // One untyped buffer: extern shared arrays of two element types in one
  // translation unit would clash.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_rc = reinterpret_cast<T*>(smem_raw);
  T* s_v = s_rc + C;
  T* s_q = s_rc + 2 * C;
  const int64_t f = blockIdx.x;
  const T* vf = vec + 5 * C * f;
  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    s_rc[j] = vf[j];
    s_v[j] = vf[2 * C + j];
    s_q[j] = vf[4 * C + j];
  }
  __syncthreads();

  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTileRows;
  const int64_t i1 = i0 + kTileRows < K ? i0 + kTileRows : K;
  T* of = out + K * C * f;
  for (int64_t i = i0; i < i1; ++i) {
    const T ri = s_rc[i];
    const T ui = vf[C + i];
    const T pi = vf[3 * C + i];
    const T* trow = total + i * C;
    T* orow = of + i * C;
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      const T val = trow[j] * (ri * s_rc[j]) - ui * s_v[j] - pi * s_q[j];
      __stcs(orow + j, val);
    }
  }
}

template <typename T>
int launch_loocv(const int64_t* rows, const T* total, const T* xw,
                 const T* xu, const T* yu, const T* yw, const T* gx,
                 const T* gy, const T* scal, T* vec, T* out, int64_t F,
                 int64_t K, int64_t M, int flags, double resolution,
                 int device, void* stream) {
  if (F <= 0 || K <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t C = K + M;
  loocv_vectors_kernel<T><<<static_cast<unsigned>(F), kVecThreads, 0, s>>>(
      rows, xw, xu, yu, yw, gx, gy, scal, vec, K, M, flags,
      static_cast<T>(resolution));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(F),
                  static_cast<unsigned>((K + kTileRows - 1) / kTileRows));
  const size_t smem = 3 * C * sizeof(T);
  loocv_tile_kernel<T><<<grid, kTileThreads, smem, s>>>(total, vec, out, K,
                                                        C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both phases on `stream`. Pointers are device pointers; yu, yw and
// gy may be null when flags lacks kWithY (then M must be 0). vec is
// caller-allocated scratch of F*5*(K+M) elements, out of F*K*(K+M).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int cvm_loocv_f64(
    const int64_t* rows, const double* total, const double* xw,
    const double* xu, const double* yu, const double* yw, const double* gx,
    const double* gy, const double* scal, double* vec, double* out,
    int64_t F, int64_t K, int64_t M, int flags, double resolution,
    int device, void* stream) {
  return launch_loocv<double>(rows, total, xw, xu, yu, yw, gx, gy, scal, vec,
                              out, F, K, M, flags, resolution, device,
                              stream);
}

// The float32 kernel (port of fused_loocv_f32): every operand float32; the
// resolution is rounded to float32 as the TPU kernel rounds it.
extern "C" int cvm_loocv_f32(
    const int64_t* rows, const float* total, const float* xw,
    const float* xu, const float* yu, const float* yw, const float* gx,
    const float* gy, const float* scal, float* vec, float* out, int64_t F,
    int64_t K, int64_t M, int flags, double resolution, int device,
    void* stream) {
  return launch_loocv<float>(rows, total, xw, xu, yu, yw, gx, gy, scal, vec,
                             out, F, K, M, flags, resolution, device, stream);
}
