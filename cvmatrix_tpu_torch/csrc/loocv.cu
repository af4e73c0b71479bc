// Leave-one-out downdate in float64 and float32 for Hopper (sm_90a).
//
// Replaces five TPU kernels of cvmatrix_tpu/ops/kernels.py:
//
//   cvm_loocv_f64      <- fused_loocv_df64 (float64 carried as f32 (hi, lo)
//                         pairs on padded 128-wide tiles), and with
//                         folds_per_block = 2 fused_loocv_df64x2
//   cvm_loocv_f32      <- fused_loocv_f32 (the same math in plain f32), and
//                         with folds_per_block = 2 fused_loocv_f32x2
//   cvm_loocv_sym_f64  <- fused_loocv_df64_sym (upper tiles computed, the
//                         strictly lower ones transposed)
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
// With a non-null stats (F, 2, C), the vector phase also stores each fold's
// training statistics: row 0 the mean, row 1 the std clamped as
// core/fold._train_std clamps it (1 where it is <= resolution; 1 on a side
// that is not scaled, and a mean of 0 where none is needed), columns [0, K)
// of X and [K, C) of Y. The matrices are the same, bit for bit, with or
// without it.
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
// Two folds per block (the TPU's x2 kernels halve its per-grid-step cost,
// which Hopper does not have): the same two phases with grid F/2, a block
// writing the same rows of two folds, so each total element is read from
// L2 once for two folds. The stores, which bound the kernel, do not change;
// the arithmetic is the same expression, so the result is bit for bit that
// of one fold per block. An odd F leaves the last block one fold.
//
// Symmetric (float64 only, as in the JAX package): the X block of a fold is
// symmetric up to rounding, so its strictly lower triangle is written as
// the mirror of the upper one, at element granularity: out[f][j][i] =
// out[f][i][j] for i < j < K, which makes each fold's X block exactly
// symmetric. Blocks cover the 32 x 32 tiles on or above the diagonal of the
// (K, C) output, every XTY column included (a tile below the diagonal holds
// X columns only); each tile is computed once, stored row by row, staged in
// shared memory and stored again transposed into its mirror, so both
// stores are coalesced. Diagonal tiles compute j >= i and mirror j > i; a
// tile across column K mirrors its X part only (the JAX kernel's Y columns
// mirror into padding rows, which the port does not have). The bytes
// written are the same as the full kernel's and the arithmetic 1/2 to 1/4
// less; on this card the kernel is bound by the stores, so the cut buys
// little by itself.
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

// Downdated mean, clamped std and its reciprocal of one column.
template <typename T>
__device__ __forceinline__ void column_stats(
    T g_sum, T g_sq, T w, T u, T sw, T rsw, T rdv, bool need_mean,
    bool need_std, T resolution, T* mean, T* std, T* recip) {
  T m = T(0);
  T sc = T(1);
  T r = T(1);
  if (need_mean || need_std) {
    const T st = g_sum - w;
    m = st * rsw;
    if (need_std) {
      const T ss = g_sq - w * u;
      const T var = (T(-2) * m * st + sw * (m * m) + ss) * rdv;
      // NaN propagates, as in torch.clamp and the JAX kernel.
      const T sd = sqrt_t(var < T(0) ? T(0) : var);
      const bool flat = sd <= resolution;
      sc = flat ? T(1) : sd;
      r = flat ? T(1) : T(1) / sd;
    }
  }
  *mean = m;
  *std = sc;
  *recip = r;
}

// Vector phase: block b writes rc, u, v, p, q (rows 0..4 of vec[f], each
// C long; u and p use the first K entries) of folds f = b*FPB .. +FPB, and
// where stats is not null the mean and std (rows 0 and 1 of stats[f]).
template <typename T, int FPB>
__global__ void loocv_vectors_kernel(
    const int64_t* __restrict__ rows, const T* __restrict__ xw,
    const T* __restrict__ xu, const T* __restrict__ yu,
    const T* __restrict__ yw, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ scal,
    T* __restrict__ vec, T* __restrict__ stats, int64_t F, int64_t K,
    int64_t M, int flags, T resolution) {
  const int64_t C = K + M;
  const bool center_xtx = flags & kCenterXTX;
  const bool with_y = flags & kWithY;
  const bool center_xty = with_y && (flags & kCenterXTY);
  const bool scale_x = flags & kScaleX;
  const bool scale_y = with_y && (flags & kScaleY);
  const bool center = center_xtx || center_xty;
  const bool need_x_mean = center || scale_x;
  const bool need_y_mean = center_xty || scale_y;

#pragma unroll
  for (int s = 0; s < FPB; ++s) {
    const int64_t f = static_cast<int64_t>(blockIdx.x) * FPB + s;
    if (f >= F) break;
    const int64_t r = rows[f];
    const T sw = scal[3 * f];
    const T rsw = scal[3 * f + 1];
    const T rdv = scal[3 * f + 2];
    T* rc = vec + 5 * C * f;
    T* u = rc + C;
    T* v = rc + 2 * C;
    T* p = rc + 3 * C;
    T* q = rc + 4 * C;
    T* st = stats == nullptr ? nullptr : stats + 2 * C * f;
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      T m, sd, ri;
      if (j < K) {
        const T a = xw[r * K + j];
        const T b = xu[r * K + j];
        column_stats(gx[j], gx[K + j], a, b, sw, rsw, rdv, need_x_mean,
                     scale_x, resolution, &m, &sd, &ri);
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
                     scale_y, resolution, &m, &sd, &ri);
        rc[j] = ri;
        v[j] = b * ri;
        q[j] = center_xty ? m * ri : T(0);
      }
      if (st != nullptr) {
        st[j] = m;
        st[C + j] = sd;
      }
    }
  }
}

// One output element: the factor form of the header.
template <typename T>
__device__ __forceinline__ T loocv_value(T t, T ri, T rj, T ui, T vj, T pi,
                                         T qj) {
  return t * (ri * rj) - ui * vj - pi * qj;
}

// Tile phase: block (b, strip) writes rows [strip*ROWS, +ROWS) of out[f]
// for folds f = b*FPB .. +FPB, reading each total element once.
template <typename T, int FPB>
__global__ void loocv_tile_kernel(
    const T* __restrict__ total, const T* __restrict__ vec,
    T* __restrict__ out, int64_t F, int64_t K, int64_t C) {
  // One untyped buffer: extern shared arrays of two element types in one
  // translation unit would clash.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_rc = reinterpret_cast<T*>(smem_raw);   // [FPB][C] each
  T* s_v = s_rc + FPB * C;
  T* s_q = s_rc + 2 * FPB * C;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * FPB;
  const int nf = F - f0 < FPB ? static_cast<int>(F - f0) : FPB;
  for (int s = 0; s < nf; ++s) {
    const T* vf = vec + 5 * C * (f0 + s);
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      s_rc[s * C + j] = vf[j];
      s_v[s * C + j] = vf[2 * C + j];
      s_q[s * C + j] = vf[4 * C + j];
    }
  }
  __syncthreads();

  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTileRows;
  const int64_t i1 = i0 + kTileRows < K ? i0 + kTileRows : K;
  for (int64_t i = i0; i < i1; ++i) {
    T ri[FPB], ui[FPB], pi[FPB];
#pragma unroll
    for (int s = 0; s < FPB; ++s) {
      if (s < nf) {
        const T* vf = vec + 5 * C * (f0 + s);
        ri[s] = s_rc[s * C + i];
        ui[s] = vf[C + i];
        pi[s] = vf[3 * C + i];
      }
    }
    const T* trow = total + i * C;
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      const T t = trow[j];
#pragma unroll
      for (int s = 0; s < FPB; ++s) {
        if (s < nf) {
          __stcs(out + K * C * (f0 + s) + i * C + j,
                 loocv_value(t, ri[s], s_rc[s * C + j], ui[s],
                             s_v[s * C + j], pi[s], s_q[s * C + j]));
        }
      }
    }
  }
}

constexpr int kSymTile = 32;
constexpr int kSymRows = kSymTile * kSymTile / kTileThreads;  // per thread

// Symmetric tile phase (float64): block (f, t) covers tile t of the upper
// tiles of out[f], numbered row by row: tile row ti holds tile columns
// ti .. n_ct - 1. Threads: tx = column in the tile, ty = row group.
__global__ void __launch_bounds__(kTileThreads)
loocv_sym_tile_kernel(const double* __restrict__ total,
                      const double* __restrict__ vec,
                      double* __restrict__ out, int64_t K, int64_t C,
                      int n_ct, int n_upper) {
  __shared__ double tile[kSymTile][kSymTile + 1];
  const int64_t f = blockIdx.x / n_upper;
  int t = blockIdx.x % n_upper;
  int ti = 0;
  while (t >= n_ct - ti) {
    t -= n_ct - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int64_t k0 = static_cast<int64_t>(ti) * kSymTile;
  const int64_t c0 = static_cast<int64_t>(tj) * kSymTile;
  const bool diagonal = ti == tj;
  const int tx = threadIdx.x % kSymTile;
  const int ty = threadIdx.x / kSymTile;
  const double* vf = vec + 5 * C * f;
  double* of = out + K * C * f;

  const int64_t c = c0 + tx;
  double rj = 0.0, vj = 0.0, qj = 0.0;
  if (c < C) {
    rj = vf[c];
    vj = vf[2 * C + c];
    qj = vf[4 * C + c];
  }
#pragma unroll
  for (int a = 0; a < kSymRows; ++a) {
    const int li = ty + a * (kTileThreads / kSymTile);
    const int64_t i = k0 + li;
    // A diagonal tile computes only j >= i of its X part; the rest of it
    // is the mirror.
    if (i < K && c < C && !(diagonal && c < K && c < i)) {
      const double val = loocv_value(total[i * C + c], vf[i], rj,
                                     vf[C + i], vj, vf[3 * C + i], qj);
      __stcs(of + i * C + c, val);
      tile[li][tx] = val;
    }
  }
  __syncthreads();
  // The mirror: out[c0 + a][k0 + tx] = value(k0 + tx, c0 + a), for the X
  // columns of the tile and strictly above the diagonal.
#pragma unroll
  for (int a = 0; a < kSymRows; ++a) {
    const int lc = ty + a * (kTileThreads / kSymTile);
    const int64_t cm = c0 + lc;           // source column = mirror row
    const int64_t im = k0 + tx;           // source row = mirror column
    if (cm < K && im < cm) of[cm * C + im] = tile[tx][lc];
  }
}

template <typename T, int FPB>
int launch_loocv(const int64_t* rows, const T* total, const T* xw,
                 const T* xu, const T* yu, const T* yw, const T* gx,
                 const T* gy, const T* scal, T* vec, T* stats, T* out,
                 int64_t F, int64_t K, int64_t M, int flags,
                 double resolution, cudaStream_t s) {
  const int64_t C = K + M;
  const int64_t blocks = (F + FPB - 1) / FPB;
  loocv_vectors_kernel<T, FPB><<<static_cast<unsigned>(blocks), kVecThreads,
                                 0, s>>>(
      rows, xw, xu, yu, yw, gx, gy, scal, vec, stats, F, K, M, flags,
      static_cast<T>(resolution));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((K + kTileRows - 1) / kTileRows));
  const size_t smem = 3 * FPB * C * sizeof(T);
  loocv_tile_kernel<T, FPB><<<grid, kTileThreads, smem, s>>>(total, vec, out,
                                                             F, K, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_loocv_fpb(const int64_t* rows, const T* total, const T* xw,
                     const T* xu, const T* yu, const T* yw, const T* gx,
                     const T* gy, const T* scal, T* vec, T* stats, T* out,
                     int64_t F, int64_t K, int64_t M, int flags,
                     double resolution, int folds_per_block, int device,
                     void* stream) {
  if (F <= 0 || K <= 0) return 0;
  if (folds_per_block != 1 && folds_per_block != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (folds_per_block == 2) {
    return launch_loocv<T, 2>(rows, total, xw, xu, yu, yw, gx, gy, scal, vec,
                              stats, out, F, K, M, flags, resolution, s);
  }
  return launch_loocv<T, 1>(rows, total, xw, xu, yu, yw, gx, gy, scal, vec,
                            stats, out, F, K, M, flags, resolution, s);
}

}  // namespace

// Launch both phases on `stream`. Pointers are device pointers; yu, yw and
// gy may be null when flags lacks kWithY (then M must be 0). vec is
// caller-allocated scratch of F*5*(K+M) elements, out of F*K*(K+M); stats
// is null, or receives F*2*(K+M) elements (the statistics of the header).
// folds_per_block is 1 or 2. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int cvm_loocv_f64(
    const int64_t* rows, const double* total, const double* xw,
    const double* xu, const double* yu, const double* yw, const double* gx,
    const double* gy, const double* scal, double* vec, double* stats,
    double* out, int64_t F, int64_t K, int64_t M, int flags,
    double resolution, int folds_per_block, int device, void* stream) {
  return launch_loocv_fpb<double>(rows, total, xw, xu, yu, yw, gx, gy, scal,
                                  vec, stats, out, F, K, M, flags,
                                  resolution, folds_per_block, device,
                                  stream);
}

// The float32 kernel (port of fused_loocv_f32 and, with folds_per_block 2,
// fused_loocv_f32x2): every operand float32; the resolution is rounded to
// float32 as the TPU kernel rounds it.
extern "C" int cvm_loocv_f32(
    const int64_t* rows, const float* total, const float* xw,
    const float* xu, const float* yu, const float* yw, const float* gx,
    const float* gy, const float* scal, float* vec, float* stats,
    float* out, int64_t F, int64_t K, int64_t M, int flags,
    double resolution, int folds_per_block, int device, void* stream) {
  return launch_loocv_fpb<float>(rows, total, xw, xu, yu, yw, gx, gy, scal,
                                 vec, stats, out, F, K, M, flags, resolution,
                                 folds_per_block, device, stream);
}

// The symmetric kernel (port of fused_loocv_df64_sym): the vector phase,
// then the upper-tile phase with mirrored stores. Same arguments as
// cvm_loocv_f64 without folds_per_block.
extern "C" int cvm_loocv_sym_f64(
    const int64_t* rows, const double* total, const double* xw,
    const double* xu, const double* yu, const double* yw, const double* gx,
    const double* gy, const double* scal, double* vec, double* stats,
    double* out, int64_t F, int64_t K, int64_t M, int flags,
    double resolution, int device, void* stream) {
  if (F <= 0 || K <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t C = K + M;
  loocv_vectors_kernel<double, 1><<<static_cast<unsigned>(F), kVecThreads,
                                    0, s>>>(
      rows, xw, xu, yu, yw, gx, gy, scal, vec, stats, F, K, M, flags,
      resolution);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = static_cast<int>((K + kSymTile - 1) / kSymTile);
  const int n_ct = static_cast<int>((C + kSymTile - 1) / kSymTile);
  // Tile rows ti < n_kt, columns tj >= ti: n_kt rows of n_ct - ti tiles.
  const int n_upper = n_kt * n_ct - n_kt * (n_kt - 1) / 2;
  if (F * n_upper > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  loocv_sym_tile_kernel<<<static_cast<unsigned>(F * n_upper), kTileThreads,
                          0, s>>>(total, vec, out, K, C, n_ct, n_upper);
  return static_cast<int>(cudaGetLastError());
}
