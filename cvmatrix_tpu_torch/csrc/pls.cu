// IKPLS Algorithm #2 on every fold of a chunk, in float64, for Hopper (sm_90a).
//
// The port's own kernel: the JAX package fits no per-fold model, so no TPU
// kernel stands behind it. Its plain twin is ops/pls.ikpls2_reference.
//
// One block a fold, one launch a chunk. From the fold's training XTX (K, K)
// and XTY (K, M) alone (Dayal & MacGregor, J. Chemometrics 11:73-85, 1997,
// Algorithm 2, as the ikpls package runs it), component a = 0 .. A-1:
//
//   S   = XTY^T XTY (M, M); q its dominant eigenvector (cyclic Jacobi)
//   w   = XTY q / ||XTY q||
//   r   = w - sum_{j<a} (p_j . w) r_j
//   t   = r^T XTX;  tt = t . r;  p = t / tt;  q_a = XTY^T r / tt
//   XTY = XTY - (p q_a^T) tt
//
// and the fold's validation rows are scored as the components come:
// yhat += (x~ . r) q_a^T with x~ = (x - X_mean) / X_std, the prediction
// yhat * Y_std + Y_mean (a flag that is off drops its term), and
// press[a][m] = sum_l w_l mask_l (y_lm - pred_lm)^2.
//
// What bounds it: t = r^T XTX reads the fold's whole XTX once a component,
// 2.0 MB at K=500, A times; everything else reads K*M, a*K or L*K values.
// The product runs with threads along the columns (coalesced rows, 128
// threads x 4 columns, two row groups summed at the end). XTY lives in a
// global (M, K) scratch, transposed so that every pass over it is a
// coalesced row walk; the p and r of earlier components in a global (2, A,
// K) scratch; w, r and t in shared memory.
//
// The M x M eigenproblem is solved to float64 precision by warp 0: cyclic
// Jacobi in round-robin order (index 0 fixed, the others rotated), up to
// M/2 disjoint rotations a round, until the off-diagonal part's squared
// Frobenius norm is at most eps^2 times the matrix's (or kMaxSweeps
// sweeps). A rotation of (p, q): theta = (S_qq - S_pp) / (2 S_pq),
// t = sign(theta) / (|theta| + sqrt(theta^2 + 1)) (0 where S_pq is 0),
// c = 1 / sqrt(t^2 + 1), s = t c; the round's columns of S and V, then its
// rows of S, then each pair's 2 x 2 block set to (S_pp - t S_pq, 0; 0,
// S_qq + t S_pq). The vector is V's column of the largest diagonal entry.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 32;
constexpr int kMaxPairs = kMaxM / 2;
constexpr int kMaxSweeps = 30;
constexpr int kColThreads = 128;
constexpr int kRowGroups = kThreads / kColThreads;
constexpr int kColSlots = 4;

enum : int { kCenterX = 1, kCenterY = 2, kScaleX = 4, kScaleY = 8 };

struct Args {
  const double* xtx;     // fold f, row i, column j at f*xtx_sf + i*xtx_sr + j
  const double* xty;     // likewise with xty_sf, xty_sr
  const double* xv;      // (F, L, K) validation rows of X
  const double* yv;      // (F, L, M) validation rows of Y
  const double* wv;      // (F, L) weights, or null
  const double* mv;      // (F, L) mask, or null
  const double* x_mean;  // fold f at f*x_mean_sf, K values; null unless used
  const double* x_std;
  const double* y_mean;  // M values
  const double* y_std;
  double* g;             // (F, M, K) scratch: XTY transposed, deflated
  double* pr;            // (F, 2, A, K) scratch: p, then r, of each component
  double* yhat;          // (F, L, M) scratch: the running prediction
  double* press;         // (F, A, M) output
  int64_t K, M, L, A;
  int64_t xtx_sf, xtx_sr, xty_sf, xty_sr;
  int64_t x_mean_sf, x_std_sf, y_mean_sf, y_std_sf;
  int flags;
};

struct Rot {
  int p[kMaxPairs], q[kMaxPairs];
  double c[kMaxPairs], s[kMaxPairs], t[kMaxPairs];
  double app[kMaxPairs], aqq[kMaxPairs], apq[kMaxPairs];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, the same value in every thread; red: kWarps doubles.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

__device__ __forceinline__ int rr_pos(int j, int r, int mp) {
  return j == 0 ? 0 : 1 + (j - 1 + r) % (mp - 1);
}

// Warp 0: the dominant eigenvector of S (M x M, shared, overwritten) into q.
__device__ void jacobi_dominant(double* S, double* V, double* q, int M,
                                Rot* rot) {
  const int lane = threadIdx.x & 31;
  const int MM = M * M;
  for (int i = lane; i < MM; i += 32) V[i] = (i / M == i % M) ? 1.0 : 0.0;
  double n2 = 0.0;
  for (int i = lane; i < MM; i += 32) n2 += S[i] * S[i];
  n2 = warp_sum(n2);
  __syncwarp();
  const int mp = M + (M & 1);
  const int np = mp / 2;
  for (int sweep = 0; sweep < kMaxSweeps && M > 1; ++sweep) {
    double off = 0.0;
    for (int i = lane; i < MM; i += 32) {
      if (i / M != i % M) off += S[i] * S[i];
    }
    off = warp_sum(off);
    if (off <= DBL_EPSILON * DBL_EPSILON * n2) break;
    for (int r = 0; r < mp - 1; ++r) {
      if (lane < np) {
        const int a = rr_pos(lane, r, mp);
        const int b = rr_pos(mp - 1 - lane, r, mp);
        const int p = min(a, b), qq = max(a, b);
        double app = 0.0, aqq = 0.0, apq = 0.0, t = 0.0;
        if (qq < M) {
          app = S[p * M + p];
          aqq = S[qq * M + qq];
          apq = S[p * M + qq];
          if (apq != 0.0) {
            const double th = (aqq - app) / (2.0 * apq);
            t = copysign(1.0, th) / (fabs(th) + sqrt(th * th + 1.0));
          }
        }
        const double c = 1.0 / sqrt(t * t + 1.0);
        rot->p[lane] = qq < M ? p : -1;
        rot->q[lane] = qq;
        rot->c[lane] = c;
        rot->s[lane] = t * c;
        rot->t[lane] = t;
        rot->app[lane] = app;
        rot->aqq[lane] = aqq;
        rot->apq[lane] = apq;
      }
      __syncwarp();
      for (int it = lane; it < np * M; it += 32) {  // columns of S and V
        const int i = it / M, k = it % M;
        const int p = rot->p[i];
        if (p < 0) continue;
        const int qq = rot->q[i];
        const double c = rot->c[i], s = rot->s[i];
        const double sp = S[k * M + p], sq = S[k * M + qq];
        S[k * M + p] = c * sp - s * sq;
        S[k * M + qq] = s * sp + c * sq;
        const double vp = V[k * M + p], vq = V[k * M + qq];
        V[k * M + p] = c * vp - s * vq;
        V[k * M + qq] = s * vp + c * vq;
      }
      __syncwarp();
      for (int it = lane; it < np * M; it += 32) {  // rows of S
        const int i = it / M, k = it % M;
        const int p = rot->p[i];
        if (p < 0) continue;
        const int qq = rot->q[i];
        const double c = rot->c[i], s = rot->s[i];
        const double sp = S[p * M + k], sq = S[qq * M + k];
        S[p * M + k] = c * sp - s * sq;
        S[qq * M + k] = s * sp + c * sq;
      }
      __syncwarp();
      if (lane < np && rot->p[lane] >= 0) {
        const int p = rot->p[lane], qq = rot->q[lane];
        const double t = rot->t[lane], apq = rot->apq[lane];
        S[p * M + p] = rot->app[lane] - t * apq;
        S[qq * M + qq] = rot->aqq[lane] + t * apq;
        S[p * M + qq] = 0.0;
        S[qq * M + p] = 0.0;
      }
      __syncwarp();
    }
  }
  int top = 0;
  double best = S[0];
  for (int m = 1; m < M; ++m) {
    if (S[m * M + m] > best) {
      best = S[m * M + m];
      top = m;
    }
  }
  for (int m = lane; m < M; m += 32) q[m] = V[m * M + top];
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) ikpls2_kernel(const Args a) {
  extern __shared__ double sh[];
  __shared__ Rot rot;
  __shared__ double red[kWarps];
  const int64_t K = a.K, L = a.L;
  const int M = static_cast<int>(a.M), A = static_cast<int>(a.A);
  const int64_t f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  double* w = sh;            // K
  double* r = w + K;         // K
  double* t = r + K;         // K: r^T XTX, then p
  double* S = t + K;         // M * M
  double* V = S + M * M;     // M * M
  double* q = V + M * M;     // M: eigenvector, then q_a
  double* d = q + M;         // A: p_j . w
  double* part = d + A;      // kWarps * M: PRESS by warp

  const double* xtx = a.xtx + f * a.xtx_sf;
  const double* xty = a.xty + f * a.xty_sf;
  double* g = a.g + f * M * K;
  double* P = a.pr + f * 2 * A * K;
  double* R = P + A * K;
  double* yhat = a.yhat + f * L * M;
  const double* xv = a.xv + f * L * K;
  const double* yv = a.yv + f * L * M;
  const double* wv = a.wv ? a.wv + f * L : nullptr;
  const double* mv = a.mv ? a.mv + f * L : nullptr;
  const double* xm = (a.flags & kCenterX) ? a.x_mean + f * a.x_mean_sf
                                          : nullptr;
  const double* xs = (a.flags & kScaleX) ? a.x_std + f * a.x_std_sf : nullptr;
  const double* ym = (a.flags & kCenterY) ? a.y_mean + f * a.y_mean_sf
                                          : nullptr;
  const double* ys = (a.flags & kScaleY) ? a.y_std + f * a.y_std_sf : nullptr;
  double* press = a.press + f * A * M;

  for (int64_t i = tid; i < K * M; i += kThreads) {
    const int64_t m = i / K, k = i % K;
    g[i] = xty[k * a.xty_sr + m];
  }
  for (int64_t i = tid; i < L * M; i += kThreads) yhat[i] = 0.0;
  __syncthreads();

  const int n_sym = M * (M + 1) / 2;
  for (int c = 0; c < A; ++c) {
    // S = XTY^T XTY: a warp a pair i <= j.
    for (int pi = warp; pi < n_sym; pi += kWarps) {
      int i = 0, rem = pi;
      while (rem >= M - i) {
        rem -= M - i;
        ++i;
      }
      const int j = i + rem;
      const double* gi = g + i * K;
      const double* gj = g + j * K;
      double s = 0.0;
      for (int64_t k = lane; k < K; k += 32) s += gi[k] * gj[k];
      s = warp_sum(s);
      if (lane == 0) {
        S[i * M + j] = s;
        S[j * M + i] = s;
      }
    }
    __syncthreads();
    if (warp == 0) jacobi_dominant(S, V, q, M, &rot);
    __syncthreads();

    // w = XTY q / ||XTY q||
    double nn = 0.0;
    for (int64_t k = tid; k < K; k += kThreads) {
      double v = 0.0;
      for (int m = 0; m < M; ++m) v += g[m * K + k] * q[m];
      w[k] = v;
      nn += v * v;
    }
    const double nrm = sqrt(block_sum(nn, red));
    for (int64_t k = tid; k < K; k += kThreads) w[k] = w[k] / nrm;
    __syncthreads();

    // r = w - sum_j (p_j . w) r_j
    for (int j = warp; j < c; j += kWarps) {
      double s = 0.0;
      for (int64_t k = lane; k < K; k += 32) s += P[j * K + k] * w[k];
      s = warp_sum(s);
      if (lane == 0) d[j] = s;
    }
    __syncthreads();
    for (int64_t k = tid; k < K; k += kThreads) {
      double v = w[k];
      for (int j = 0; j < c; ++j) v -= d[j] * R[j * K + k];
      r[k] = v;
    }
    __syncthreads();

    // t = r^T XTX: row group 0 into t, row group 1 into w (free now).
    {
      const int cj = tid % kColThreads, rg = tid / kColThreads;
      double* dst = rg == 0 ? t : w;
      for (int64_t c0 = 0; c0 < K; c0 += kColThreads * kColSlots) {
        double acc[kColSlots];
#pragma unroll
        for (int s = 0; s < kColSlots; ++s) acc[s] = 0.0;
        const int64_t j0 = c0 + cj;
#pragma unroll 4
        for (int64_t i = rg; i < K; i += kRowGroups) {
          const double ri = r[i];
          const double* row = xtx + i * a.xtx_sr;
#pragma unroll
          for (int s = 0; s < kColSlots; ++s) {
            const int64_t j = j0 + s * kColThreads;
            if (j < K) acc[s] += ri * __ldg(row + j);
          }
        }
#pragma unroll
        for (int s = 0; s < kColSlots; ++s) {
          const int64_t j = j0 + s * kColThreads;
          if (j < K) dst[j] = acc[s];
        }
      }
      __syncthreads();
      for (int64_t k = tid; k < K; k += kThreads) t[k] += w[k];
      __syncthreads();
    }

    double tr = 0.0;
    for (int64_t k = tid; k < K; k += kThreads) tr += t[k] * r[k];
    const double tt = block_sum(tr, red);

    // p = t / tt (into t), kept with r; q_a = XTY^T r / tt
    for (int64_t k = tid; k < K; k += kThreads) {
      const double p = t[k] / tt;
      t[k] = p;
      P[c * K + k] = p;
      R[c * K + k] = r[k];
    }
    for (int m = warp; m < M; m += kWarps) {
      double s = 0.0;
      for (int64_t k = lane; k < K; k += 32) s += g[m * K + k] * r[k];
      s = warp_sum(s);
      if (lane == 0) q[m] = s / tt;
    }
    for (int i = tid; i < kWarps * M; i += kThreads) part[i] = 0.0;
    __syncthreads();

    // XTY -= (p q_a^T) tt
    for (int64_t i = tid; i < K * M; i += kThreads) {
      const int64_t m = i / K, k = i % K;
      g[i] = g[i] - (t[k] * q[m]) * tt;
    }

    // The validation rows: a warp a row.
    for (int64_t l = warp; l < L; l += kWarps) {
      const double* x = xv + l * K;
      double z = 0.0;
      for (int64_t k = lane; k < K; k += 32) {
        double v = x[k];
        if (xm) v = v - xm[k];
        if (xs) v = v / xs[k];
        z += v * r[k];
      }
      z = warp_sum(z);
      double wl = wv ? wv[l] : 1.0;
      if (mv) wl = wl * mv[l];
      for (int m = lane; m < M; m += 32) {
        const double yh = yhat[l * M + m] + z * q[m];
        yhat[l * M + m] = yh;
        double pred = yh;
        if (ys) pred = pred * ys[m];
        if (ym) pred = pred + ym[m];
        const double e = yv[l * M + m] - pred;
        part[warp * M + m] += wl * (e * e);
      }
    }
    __syncthreads();
    for (int m = tid; m < M; m += kThreads) {
      double s = 0.0;
      for (int i = 0; i < kWarps; ++i) s += part[i * M + m];
      press[c * M + m] = s;
    }
  }
}

}  // namespace

// Every fold's IKPLS #2 solve and weighted PRESS: F blocks of kThreads.
// Returns a cudaError_t (0 on success).
extern "C" int cvm_ikpls2_f64(
    const double* xtx, const double* xty, const double* xv, const double* yv,
    const double* wv, const double* mv, const double* x_mean,
    const double* x_std, const double* y_mean, const double* y_std,
    double* g, double* pr, double* yhat, double* press, int64_t F, int64_t K,
    int64_t M, int64_t L, int64_t A, int64_t xtx_sf, int64_t xtx_sr,
    int64_t xty_sf, int64_t xty_sr, int64_t x_mean_sf, int64_t x_std_sf,
    int64_t y_mean_sf, int64_t y_std_sf, int flags, int device,
    void* stream) {
  if (F <= 0 || A <= 0) return 0;
  if (K < 1 || M < 1 || M > kMaxM || L < 1 || F > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem =
      sizeof(double) * (3 * K + 2 * M * M + M + A + kWarps * M);
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(ikpls2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{xtx,    xty,    xv,     yv,     wv,     mv,     x_mean,
         x_std,  y_mean, y_std,  g,      pr,     yhat,   press,
         K,      M,      L,      A,      xtx_sf, xtx_sr, xty_sf,
         xty_sr, x_mean_sf, x_std_sf, y_mean_sf, y_std_sf, flags};
  ikpls2_kernel<<<static_cast<unsigned>(F), kThreads, shmem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
