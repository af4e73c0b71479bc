// IKPLS Algorithm #2 on every fold of a chunk, in float64, for Hopper (sm_90a):
// four routes, two on the folds' formed training matrices (one block a fold
// up to K = 8,192; the whole card on the chunk at any K) and two that form
// none (one-row folds; folds of any L, the whole card on the chunk).
//
// The port's own kernels: the JAX package fits no per-fold model, so no TPU
// kernel stands behind them. Their plain twins are ops/pls.ikpls2_reference
// (both formed routes), ops/pls.ikpls2_operator_reference and
// ops/pls.ikpls2_wide_op_reference.
//
// ikpls2_kernel (cvm_ikpls2_f64): one block a fold, one launch a chunk. From
// the fold's training XTX (K, K) and XTY (K, M) alone (Dayal & MacGregor, J.
// Chemometrics 11:73-85, 1997, Algorithm 2, as the ikpls package runs it),
// component a = 0 .. A-1:
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
//
// ikpls2_op_kernel (cvm_ikpls2_op_f64): the same components and scores for
// one-row (LOOCV) folds, one launch a chunk, no fold matrix formed. A fold's
// training XTX differs from the fitted total by its validation row's
// rank-one term and its own centring and scaling (ops/loocv.loocv_reference):
//
//   XTX_f r = r1 (.) (XTX_total (r1 (.) r)) - u (v . r) - p (q . r)
//
// with r1 = 1 / X std, u = w_i x r1, v = x r1, p = sw mean r1 and q = mean
// r1 (p 0 uncentred, q 0 unless X is centred), the statistics from the
// fit's sums less the row, as the LOOCV kernels' vector phase computes them;
// XTY_f is formed the same way into a (K, M) global scratch.
//
// Layout: a block holds kOpSlots = 4 folds of kOpFold = 128 threads (named
// barriers 1-4), a cluster of 2 blocks 8 folds, the n of the FP64 tensor
// cores' mma.sync m16n8k8. Each component every fold writes r1 (.) r into
// B (K8 x 8, shared) of both blocks, the cluster syncs, each block
// multiplies its half of the total's rows by B (A from L2, B from shared
// memory) and writes row i of column j into fold j's t, and the cluster
// syncs again. The total (2 MB at K=500) is shared by every fold and stays
// in L2: a chunk of 511 folds reads it 64 times a component, 2.6 GB from L2
// over 20 components, where ikpls2_kernel read 21 GB of formed fold
// matrices from HBM.
//
// Per fold and component otherwise: S = XTY^T XTY on the tensor cores, XTY
// staged through shared memory (cp.async) and deflated by the last
// component on the way (and stored back); the Jacobi above, warm-started
// from the last component's eigenvectors (in their basis the deflated S
// differs from a diagonal matrix in one row and column: 3.9 sweeps a
// component at K=500, M=10 against 6 cold), each round's rotations and
// 2 x 2 blocks computed by all the fold's threads from one buffer of S into
// the other, one barrier a round; q_a = S q / (||XTY q|| tt) (= XTY^T r / tt
// in exact arithmetic: the deflated XTY is orthogonal to every earlier r);
// the p and r of earlier components in a global scratch, streamed with
// evict-first hints.
//
// What bounds it (PERF.md): a fold's chain of dependent steps, 20 times. At
// K=500, M=10 a component takes about 90 us: Jacobi's 35 rounds of about
// 0.8 us (40%), the product (22%: each block reads 1 MB of the total from
// L2) and the Gram matrix (12%). Limits: float64, M <= 32, K <= 768 (shared
// memory at M = 32), any A.

// The wide kernels (cvm_ikpls2_wide_f64): the same components and scores on
// formed fold matrices of any K, for a chunk of few wide folds, where one
// block a fold would leave most SMs idle and three K-vectors overflow shared
// memory. 2 A + 2 launches a chunk, in stream order:
//
//   ikpls2_wide_prep_kernel: the validation rows' x~ (centred and scaled),
//     transposed to (K, L) a fold, so that their scores x~ . r are column
//     sums of the same kind as t = r^T XTX;
//   ikpls2_wide_step_kernel (c = -1): XTY into g, component 0's w and r;
//   then a component c = 0 .. A-1:
//   ikpls2_wide_product_kernel: [t | z] = r^T [XTX | x~^T], split by rows:
//     a block is 256 rows by 1,024 columns of one fold, each entry read once
//     with streaming loads (4 rows of 4 columns in flight a thread), its
//     column sums written to a (S, K + L) scratch a fold, S = K / 256;
//   ikpls2_wide_step_kernel (c): a cluster of 8 blocks a fold, each a slice
//     of the K columns and L rows: t and z from the split sums, tt, p, q_c,
//     the deflation, the prediction and PRESS, then component c + 1's S,
//     Jacobi (as ikpls2_kernel, every block alike), w and Gram-Schmidt r.
//     Its sums meet through distributed shared memory (4 cluster syncs a
//     component), added in rank order: no atomics, the same bits each run.
//
// What bounds it: the product reads each fold's XTX once a component,
// 3.2 GB at K = 20,000, A times; it is HBM-bound (PERF.md). The steps read
// L2-resident K-vectors on 8 SMs a fold. Limits: float64, M <= 32, any K
// and A, at most 65,535 folds a chunk.
//
// The wide operator kernels (cvm_ikpls2_wide_op_f64): the same components
// and scores for folds of any L and K with no fold matrix formed, from the
// fitted XTX and XTY (read in place), rows and sums. A fold's training XTX
// is the total less its rows' rank-L term; with X centred it is taken
// about the fitted mean m0 = sum_X / sum_w, so that no sum carries the
// large mean term (c_l a row's weight times mask, sw the training weight
// sum, r1 = 1 / X std):
//
//   XTX_f r = r1 (.) (C y - sum_l c_l u_l d_l - (u_d / sw) delta)
//   C = XTX - sum_w m0 m0^T, y = r1 (.) r, d_l = x_l - m0,
//   delta = sum_l c_l d_l, u_l = d_l . y, u_d = delta . y
//
// (uncentred, m0 and delta are 0), and row l's score is u_l + u_d / sw.
// 3 A + 2 launches a chunk, in stream order:
//
//   ikpls2_wide_op_prep_kernel: each fold's statistics from the fit's sums
//     less its rows' (the LOOCV kernels' formulas), its XTY into the
//     step's g, delta and r1, its rows of Y and weights for the step;
//   ikpls2_wide_step_kernel (c = -1), as above, g already written;
//   then a component c = 0 .. A-1:
//   ikpls2_wide_op_product_kernel: C y of every fold of a group of up to 4
//     from one pass over the total's upper triangle (a tile of 256 rows by
//     512 columns a block, each entry giving its column's sum and, off
//     the diagonal, its row's; the next rows' loads issued before a row's
//     sums), and the scores u of the folds' rows (score blocks first);
//   ikpls2_wide_op_correct_kernel: t and z from the product's sums, the
//     rows' correction, a second read of the rows;
//   ikpls2_wide_step_kernel (c) on t and z as one split.
//
// What bounds it: the product reads half the total once a chunk and
// component for all the chunk's folds (1.68 GB at K = 20,000), against
// 3.2 GB a fold for the formed route; the rows are read twice a component.
// No atomics: the same inputs give the same bits. Limits as the wide
// kernels'.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The operator kernel (ikpls2_op_kernel): one-row folds, no fold matrix
// formed. See the file's comment.

constexpr int kOpFold = 128;                      // threads a fold
constexpr int kOpFoldWarps = kOpFold / 32;
constexpr int kOpSlots = 4;                       // folds a block
constexpr int kOpCluster = 2;                     // blocks a cluster
constexpr int kOpGroup = kOpSlots * kOpCluster;   // folds a cluster: MMA n
constexpr int kOpThreads = kOpFold * kOpSlots;
constexpr int kOpWarps = kOpThreads / 32;
constexpr int kOpMinB = kOpWarps * 128;  // doubles of B at least: partials
constexpr int kOpUnroll = 4;     // k-steps of A loads in flight a warp
constexpr int kOpStage = 2048;   // doubles of a fold's XTY staged, at most
constexpr int kOpRows = 4;       // rows of a thread in flight (r, p_j . w)
constexpr int kOpShmem = 227 * 1024 - 8192;  // dynamic shared memory, most
constexpr int kOpDots = 4;       // p_j . w sums a pass
constexpr int kOpGramTiles = 2;  // Gram tiles a warp: 8 at M = 32, 4 warps
constexpr int kOpJacItems = 6;   // Jacobi items a thread: np^2 + M np <= 768
static_assert(kOpGramTiles * kOpFoldWarps >= 8, "Gram tiles at M = 32");
static_assert(kOpJacItems * kOpFold >= kMaxM * kMaxM * 3 / 4, "items");
static_assert(kOpGroup == 8, "a cluster's folds are the MMA's n");

struct OpArgs {
  const double* xtx;       // (K, K) fitted total, row stride ld_xtx
  const double* xty;       // (K, M), row stride ld_xty
  const double* X;         // (N, K), row stride ld_x
  const double* Y;         // (N, M), row stride ld_y
  const double* wts;       // (N, 1) weights, row stride ld_w, or null
  const double* sum_x;     // K; null unless a flag needs it
  const double* sum_sq_x;  // K
  const double* sum_y;     // M
  const double* sum_sq_y;  // M
  const double* sum_w;     // 1
  const int64_t* nnz;      // 1
  const int64_t* rows;     // (F,) the folds' validation rows
  double* g;               // (F, K, M) scratch: the fold's XTY, deflated
  double* pr;              // (F, 2, A, K) scratch: p, then r
  double* vec;             // (F, 3, K) scratch: X mean, 1 / X std, x~
  double* aux;             // (F, M M + A) scratch: S kept, p_j . w
  double* press;           // (F, A, M) output
  int64_t F, N, K, M, A;
  int64_t ld_xtx, ld_xty, ld_x, ld_y, ld_w, ddof;
  double resolution;
  int flags;
  int64_t K8;    // K rounded up to 8 (the MMA's k)
  int64_t rs;    // product rows a block owns, a multiple of 16
  int64_t nB;     // doubles of B
  int64_t slot;   // doubles of a fold's shared memory
  int64_t stage;  // of which XTY staged (Gram)
};

// The named barrier of one fold's kOpFold threads (barrier 0 is the
// block's).
__device__ __forceinline__ void ikpls2_fold_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(kOpFold) : "memory");
}

// One fold's sum of v, the same in its every thread; red: kOpFoldWarps doubles.
__device__ double ikpls2_fold_sum(double v, double* red, int slot) {
  v = warp_sum(v);
  ikpls2_fold_sync(slot);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) % kOpFoldWarps] = v;
  ikpls2_fold_sync(slot);
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kOpFoldWarps; ++i) s += red[i];
  return s;
}

// One fold's sums of v0, v1, v2; red: 3 kOpFoldWarps doubles.
__device__ void ikpls2_fold_sum3(double& v0, double& v1, double& v2,
                                 double* red, int slot) {
  v0 = warp_sum(v0);
  v1 = warp_sum(v1);
  v2 = warp_sum(v2);
  ikpls2_fold_sync(slot);
  if ((threadIdx.x & 31) == 0) {
    const int w = (threadIdx.x >> 5) % kOpFoldWarps;
    red[w] = v0;
    red[kOpFoldWarps + w] = v1;
    red[2 * kOpFoldWarps + w] = v2;
  }
  ikpls2_fold_sync(slot);
  v0 = v1 = v2 = 0.0;
#pragma unroll
  for (int i = 0; i < kOpFoldWarps; ++i) {
    v0 += red[i];
    v1 += red[kOpFoldWarps + i];
    v2 += red[2 * kOpFoldWarps + i];
  }
}

// mma.sync.aligned.m16n8k8 f64, D += A B (lane = 4 g + t): A holds A[g + 8
// (r % 2)][t + 4 (r / 2)], B holds B[t + 4 r][g], D holds D[g + 8 (r /
// 2)][2 t + r % 2].
__device__ __forceinline__ void ikpls2_dmma(double (&d)[4], const double* a,
                                            const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// An 8-byte cp.async from global to shared memory, and the wait for all of
// the thread's.
__device__ __forceinline__ void ikpls2_cp8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ikpls2_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 1 / x and 1 / sqrt(x) to about an ulp: the hardware's approximations, then
// two Newton steps each.
__device__ __forceinline__ double ikpls2_rcp(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  y = fma(y, e, y);
  e = fma(-x, y, 1.0);
  return fma(y, e, y);
}

__device__ __forceinline__ double ikpls2_rsqrt(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double h = 0.5 * x;
  y = y * fma(-h * y, y, 1.5);
  return y * fma(-h * y, y, 1.5);
}

// S = G^T G (M x M) of one fold's (K, M) XTY g, where deflate deflated
// first by the last component (g - (p_k qa_m) tt) and stored so: g passes
// through stg (stage doubles) in chunks of whole rows, copied with
// cp.async, and each chunk's G_c^T G_c runs on the FP64 tensor cores: the
// (16 x 8) tiles of S, split with the k-steps over the fold's warps where
// there are fewer tiles than warps; the k-parts meet in stg, summed in order.
// S is made symmetric from its upper triangle. t: the fold's thread.
__device__ void ikpls2_gram(double* g, const double* p, const double* qa,
                            double tt, bool deflate, int64_t K, int M,
                            double* S, double* stg, int64_t stage, int t,
                            int slot) {
  const int rows = static_cast<int>(stage / M);
  const int mt = (M + 15) / 16, nt = (M + 7) / 8, tiles = mt * nt;
  const int kp = tiles >= kOpFoldWarps ? 1 : kOpFoldWarps / tiles;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  double acc[kOpGramTiles][4];
#pragma unroll
  for (int n = 0; n < kOpGramTiles; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.0;
  const int dk = kOpFold / M, dm = kOpFold % M;  // one stride of t in (k, m)
  for (int64_t k0 = 0; k0 < K; k0 += rows) {
    const int nr = static_cast<int>(K - k0 < rows ? K - k0 : rows);
    const int n_el = nr * M;
    double* gc = g + k0 * M;
    for (int e = t; e < n_el; e += kOpFold) ikpls2_cp8(stg + e, gc + e);
    ikpls2_cp_wait();
    ikpls2_fold_sync(slot);
    if (deflate) {
      int k = static_cast<int>(k0) + t / M, m = t % M;
      for (int e0 = t; e0 < n_el; e0 += 4 * kOpFold) {  // the loads first
        double v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kOpFold;
          v[u] = e < n_el ? stg[e] - (p[k] * qa[m]) * tt : 0.0;
          k += dk;
          m += dm;
          if (m >= M) {
            m -= M;
            ++k;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kOpFold;
          if (e < n_el) {
            stg[e] = v[u];
            gc[e] = v[u];
          }
        }
      }
      ikpls2_fold_sync(slot);
    }
    const int nks = (nr + 7) / 8, ksp = (nks + kp - 1) / kp;
#pragma unroll
    for (int n = 0; n < kOpGramTiles; ++n) {
      const int item = warp + n * kOpFoldWarps;  // tile + tiles * k-part
      if (item >= tiles * kp) continue;
      const int tile = item % tiles, part = item / tiles;
      const int m0 = 16 * (tile / nt), n0 = 8 * (tile % nt);
      const int ks1 = min(nks, (part + 1) * ksp);
      for (int ks = part * ksp; ks < ks1; ++ks) {
        const int k = 8 * ks;
        double av[4], bv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // A = G_c^T: A[m][k] = G_c[k][m]
          const int m = m0 + gq + 8 * (r % 2), kk = k + tq + 4 * (r / 2);
          av[r] = m < M && kk < nr ? stg[kk * M + m] : 0.0;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // B = G_c
          const int kk = k + tq + 4 * r, c = n0 + gq;
          bv[r] = c < M && kk < nr ? stg[kk * M + c] : 0.0;
        }
        ikpls2_dmma(acc[n], av, bv);
      }
    }
    ikpls2_fold_sync(slot);
  }
  // S[i][j] = S[j][i] from the tiles' entries i <= j: straight from the
  // accumulators with one k-part, else the k-parts meet in stg first
  if (kp == 1) {
#pragma unroll
    for (int n = 0; n < kOpGramTiles; ++n) {
      const int tile = warp + n * kOpFoldWarps;
      if (tile >= tiles) continue;
      const int m0 = 16 * (tile / nt), n0 = 8 * (tile % nt);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m0 + gq + 8 * (r / 2), j = n0 + 2 * tq + r % 2;
        if (i <= j && j < M) {
          S[i * M + j] = acc[n][r];
          S[j * M + i] = acc[n][r];
        }
      }
    }
    ikpls2_fold_sync(slot);
    return;
  }
  if (warp < tiles * kp) {
#pragma unroll
    for (int r = 0; r < 4; ++r) stg[warp * 128 + r * 32 + lane] = acc[0][r];
  }
  ikpls2_fold_sync(slot);
  for (int i = t; i < M * M; i += kOpFold) {
    const int a = i / M, b = i % M;
    const int row = min(a, b), col = max(a, b);
    const int tile = (row / 16) * nt + col / 8;
    const int rr = row % 16, cc = col % 8;
    const int at = 2 * (rr / 8) + cc % 2, al = 4 * (rr % 8) + cc / 2;
    double v = 0.0;
    for (int q = 0; q < kp; ++q) v += stg[(q * tiles + tile) * 128 + at * 32 + al];
    S[i] = v;
  }
  ikpls2_fold_sync(slot);
}

// Jacobi's rotation of pair slot i in round r of a sweep over S (M x M):
// the indices at tournament positions i and mp - 1 - i (jacobi_dominant's
// round_robin_pairs), q = -1 where p is paired with no index (the
// identity), and t = sign(d) 2 a_pq / (|d| + sqrt(d^2 + 4 a_pq^2)), d = a_qq
// - a_pp (jacobi_dominant's t), c = 1 / sqrt(t^2 + 1), s = t c.
struct OpRot {
  int p, q;
  double c, s, t, app, aqq, apq;
};

__device__ __forceinline__ OpRot ikpls2_rotation(const double* S, int M,
                                                 int mp, int i, int r) {
  OpRot o;
  int a = 0;
  if (i > 0) {
    a = i - 1 + r;
    if (a >= mp - 1) a -= mp - 1;
    a += 1;
  }
  int b = mp - 2 - i + r;  // position mp - 1 - i, never 0
  if (b >= mp - 1) b -= mp - 1;
  b += 1;
  o.p = min(a, b);
  const int qq = max(a, b);
  const bool real = qq < M;
  o.q = real ? qq : -1;
  // no branch: a fold's two rotations of a block interleave; t = 0 where
  // a_pq = 0 (then z is taken as 1), and for p paired with no index
  const int qs = real ? qq : o.p;
  o.app = S[o.p * M + o.p];
  o.aqq = real ? S[qs * M + qs] : 0.0;
  o.apq = real ? S[o.p * M + qs] : 0.0;
  const double d = o.aqq - o.app;
  double z = fma(d, d, 4.0 * (o.apq * o.apq));
  z = o.apq != 0.0 ? z : 1.0;
  o.t = copysign(1.0, d) * (2.0 * o.apq) *
        ikpls2_rcp(fabs(d) + z * ikpls2_rsqrt(z));
  const double c = ikpls2_rsqrt(fma(o.t, o.t, 1.0));
  o.c = o.t != 0.0 ? c : 1.0;  // exactly the identity where t = 0
  o.s = o.t * o.c;
  return o;
}

// The dominant eigenvector of the symmetric S (M x M, shared) into q, by the
// cyclic Jacobi of jacobi_dominant, warm-started: the sweeps start from
// V^T S V, V (shared) holding the last component's eigenvectors (the
// identity where cold), and V ends holding the eigenvectors found. S and Sx
// take turns as a round's input and output: in a round every thread
// computes the rotations of its items from the input and writes its items
// of the output, every 2 x 2 block of S (the rows of one pair and the
// columns of another, rotated by the columns' pair, then by the rows') and
// the pairs' columns of V (in place), so a round takes one barrier.
// t: the fold's thread.
__device__ void ikpls2_jacobi(double* S, double* Sx, double* V, double* q,
                              int M, bool warm, double* red, int t,
                              int slot) {
  const int MM = M * M;
  if (!warm) {
    for (int i = t; i < MM; i += kOpFold) V[i] = (i / M == i % M) ? 1.0 : 0.0;
  } else {
    for (int i = t; i < MM; i += kOpFold) {  // Sx = V^T S
      const int r = i / M, c = i % M;
      double s = 0.0;
      for (int k = 0; k < M; ++k) s += V[k * M + r] * S[k * M + c];
      Sx[i] = s;
    }
    ikpls2_fold_sync(slot);
    for (int i = t; i < MM; i += kOpFold) {  // S = Sx V
      const int r = i / M, c = i % M;
      double s = 0.0;
      for (int k = 0; k < M; ++k) s += Sx[r * M + k] * V[k * M + c];
      S[i] = s;
    }
  }
  ikpls2_fold_sync(slot);
  double n2 = 0.0;
  for (int i = t; i < MM; i += kOpFold) n2 += S[i] * S[i];
  n2 = ikpls2_fold_sum(n2, red, slot);
  const int mp = M + (M & 1);
  const int np = mp / 2;
  const int nblk = np * np;
  // a thread's items of a round, the same in every round: block (bi, bj),
  // or with bi = -1 - k row k of V and pair bj
  int ib[kOpJacItems], jb[kOpJacItems];
#pragma unroll
  for (int n = 0; n < kOpJacItems; ++n) {
    const int it = t + n * kOpFold;
    ib[n] = jb[n] = -1;
    if (it < nblk) {
      ib[n] = it / np;
      jb[n] = it - ib[n] * np;
    } else if (it < nblk + M * np) {
      const int k = (it - nblk) / np;
      ib[n] = -1 - k;
      jb[n] = it - nblk - k * np;
    }
  }
  double* cur = S;
  double* nxt = Sx;
  for (int sweep = 0; sweep < kMaxSweeps && M > 1; ++sweep) {
    double off = 0.0;
    for (int i = t; i < MM; i += kOpFold) {
      if (i / M != i % M) off += cur[i] * cur[i];
    }
    off = ikpls2_fold_sum(off, red, slot);
    if (off <= DBL_EPSILON * DBL_EPSILON * n2) break;
    for (int r = 0; r < mp - 1; ++r) {
#pragma unroll
      for (int n = 0; n < kOpJacItems; ++n) {
        if (jb[n] < 0) continue;
        // straight-line: both rotations (the same one for a V row or a
        // diagonal block) and the loads interleave; an index paired with
        // none reads its own entry and rotates by the identity
        const bool blk = ib[n] >= 0;
        const OpRot rj = ikpls2_rotation(cur, M, mp, jb[n], r);
        const OpRot ri = ikpls2_rotation(cur, M, mp, blk ? ib[n] : jb[n], r);
        const int pj = rj.p, qj = rj.q >= 0 ? rj.q : rj.p;
        if (blk) {  // the block of rows pair bi, columns pair bj
          const int pi = ri.p, qi = ri.q >= 0 ? ri.q : ri.p;
          const double s0 = cur[pi * M + pj], s1 = cur[pi * M + qj];
          const double s2 = cur[qi * M + pj], s3 = cur[qi * M + qj];
          const double xp = rj.c * s0 - rj.s * s1;  // the columns
          const double yp = rj.s * s0 + rj.c * s1;
          const double xq = rj.c * s2 - rj.s * s3;
          const double yq = rj.s * s2 + rj.c * s3;
          nxt[pi * M + pj] = ri.c * xp - ri.s * xq;  // the rows
          if (ri.q >= 0) nxt[qi * M + pj] = ri.s * xp + ri.c * xq;
          if (rj.q >= 0) nxt[pi * M + qj] = ri.c * yp - ri.s * yq;
          if (ri.q >= 0 && rj.q >= 0) nxt[qi * M + qj] = ri.s * yp + ri.c * yq;
          if (ib[n] == jb[n] && ri.q >= 0) {
            nxt[pi * M + pi] = ri.app - ri.t * ri.apq;
            nxt[qi * M + qi] = ri.aqq + ri.t * ri.apq;
            nxt[pi * M + qi] = 0.0;
            nxt[qi * M + pi] = 0.0;
          }
        } else if (rj.q >= 0) {  // row k of V, the columns of pair bj
          const int k = -1 - ib[n];
          const double vp = V[k * M + pj], vq = V[k * M + qj];
          V[k * M + pj] = rj.c * vp - rj.s * vq;
          V[k * M + qj] = rj.s * vp + rj.c * vq;
        }
      }
      ikpls2_fold_sync(slot);
      double* sw = cur;
      cur = nxt;
      nxt = sw;
    }
  }
  int top = 0;
  double best = cur[0];
  for (int m = 1; m < M; ++m) {
    if (cur[m * M + m] > best) {
      best = cur[m * M + m];
      top = m;
    }
  }
  for (int m = t; m < M; m += kOpFold) q[m] = V[m * M + top];
  ikpls2_fold_sync(slot);
}

// The block's rows [row0, row0 + rs) of T = XTX B, B the cluster's (K8, 8)
// (r1 (.) r) columns in this block's shared memory, pushed to each column's
// fold: row i of column j into t of fold j % kOpSlots of block j /
// kOpSlots. Warps take (m-tile, k-part) items; with k-parts (fewer m-tiles
// than warps) the partials meet in B's first doubles once every warp has
// read B, summed in k-part order.
__device__ void ikpls2_product(const OpArgs& a, double* B, double* sh,
                               cg::cluster_group& cluster, int rank) {
  const int64_t K = a.K;
  const int64_t row0 = rank * a.rs;
  const int n_mt = row0 < K ? static_cast<int>(a.rs / 16) : 0;
  const int nks = static_cast<int>(a.K8 / 8);
  const int kp_n = n_mt == 0 || n_mt >= kOpWarps ? 1 : kOpWarps / n_mt;
  const int ksp = (nks + kp_n - 1) / kp_n;
  const int nfull = static_cast<int>(K / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int items = n_mt * kp_n;
  auto push = [&](int mt, const double (&acc)[4]) {
    const int64_t i0 = row0 + 16 * mt;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = i0 + gq + 8 * (r / 2);
      const int col = 2 * tq + r % 2;
      if (row < K) {
        double* t = sh + a.nB + (col % kOpSlots) * a.slot;
        cluster.map_shared_rank(t, col / kOpSlots)[row] = acc[r];
      }
    }
  };
  int mt = 0, kp = 0;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  bool mine = false;
  for (int item = warp; item < items; item += kOpWarps) {
    mt = item % n_mt;
    kp = item / n_mt;
    mine = true;
    const int64_t i0 = row0 + 16 * mt;
    const int64_t ra = i0 + gq < K ? i0 + gq : 0;  // rows past K: any row,
    const int64_t rb = i0 + gq + 8 < K ? i0 + gq + 8 : 0;  // never pushed
    const double* pa = a.xtx + ra * a.ld_xtx + tq;
    const double* pb = a.xtx + rb * a.ld_xtx + tq;
    const double* bs = B + tq * kOpGroup + gq;
    const int ks0 = kp * ksp;
    const int ks1 = min(nks, ks0 + ksp);
    const int kfull = min(ks1, nfull);
    int ks = ks0;
    for (; ks + kOpUnroll <= kfull; ks += kOpUnroll) {
      double av[kOpUnroll][4], bv[kOpUnroll][2];
#pragma unroll
      for (int u = 0; u < kOpUnroll; ++u) {
        const int64_t k = 8 * static_cast<int64_t>(ks + u);
        av[u][0] = __ldg(pa + k);
        av[u][1] = __ldg(pb + k);
        av[u][2] = __ldg(pa + k + 4);
        av[u][3] = __ldg(pb + k + 4);
        bv[u][0] = bs[k * kOpGroup];
        bv[u][1] = bs[(k + 4) * kOpGroup];
      }
#pragma unroll
      for (int u = 0; u < kOpUnroll; ++u) ikpls2_dmma(acc, av[u], bv[u]);
    }
    for (; ks < ks1; ++ks) {  // the rest, columns past K read as 0
      const int64_t k = 8 * static_cast<int64_t>(ks);
      const bool c0 = k + tq < K, c1 = k + tq + 4 < K;
      double av[4], bv[2];
      av[0] = c0 ? __ldg(pa + k) : 0.0;
      av[1] = c0 ? __ldg(pb + k) : 0.0;
      av[2] = c1 ? __ldg(pa + k + 4) : 0.0;
      av[3] = c1 ? __ldg(pb + k + 4) : 0.0;
      bv[0] = bs[k * kOpGroup];
      bv[1] = bs[(k + 4) * kOpGroup];
      ikpls2_dmma(acc, av, bv);
    }
    if (kp_n == 1) {  // whole rows: push now (kp_n > 1: one item a warp)
      push(mt, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = 0.0;
    }
  }
  if (kp_n > 1) {
    __syncthreads();  // every warp has read B
    if (mine && kp > 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        B[((kp - 1) * n_mt + mt) * 128 + r * 32 + lane] = acc[r];
    }
    __syncthreads();
    if (mine && kp == 0) {
      for (int q = 1; q < kp_n; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] += B[((q - 1) * n_mt + mt) * 128 + r * 32 + lane];
      }
      push(mt, acc);
    }
  }
}

// One-row folds: a block kOpSlots folds of kOpFold threads each, a cluster
// of kOpCluster blocks a group of kOpGroup folds (slots past F only take
// part in the product).
__global__ void __cluster_dims__(kOpCluster, 1, 1)
    __launch_bounds__(kOpThreads, 1) ikpls2_op_kernel(const OpArgs a) {
  extern __shared__ double sh[];
  __shared__ double reds[kOpSlots][3 * kOpFoldWarps];
  __shared__ double scs[kOpSlots][4];  // w_i, sw, 1 / sw, 1 / divisor
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slot = threadIdx.x / kOpFold;
  const int tid = threadIdx.x % kOpFold;
  const int lane = tid & 31, warp = tid >> 5;
  const int col = rank * kOpSlots + slot;  // the fold's column of B
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kOpSlots + slot;
  const bool live = f < a.F;
  const int64_t K = a.K;
  const int M = static_cast<int>(a.M), A = static_cast<int>(a.A);
  const bool cx = a.flags & kCenterX, cy = a.flags & kCenterY;
  const bool scx = a.flags & kScaleX, scy = a.flags & kScaleY;
  const bool center = cx || cy;
  double* red = reds[slot];
  double* sc = scs[slot];

  double* B = sh;                            // (K8, 8): the r1 (.) r
  double* wt = sh + a.nB + slot * a.slot;    // K: w, then T and t, then p
  double* r = wt + K;     // K
  double* S = r + K;      // M * M: the Gram matrix, Jacobi's work
  double* Sx = S + M * M; // M * M: Jacobi's work
  double* V = Sx + M * M; // M * M: eigenvectors, kept for the warm start
  double* q = V + M * M;  // M: eigenvector
  double* qa = q + M;     // M: q_a
  double* yh = qa + M;    // M: running prediction
  double* yr = yh + M;    // M: the validation row's y
  double* my = yr + M;    // M: Y mean
  double* sy = my + M;    // M: Y std
  double* part = sy + M;  // kOpFold: Gram partials
  double* stg = part + kOpFold;  // stage: XTY staged (Gram)

  const int64_t fl = live ? f : 0;
  const int64_t row = live ? a.rows[fl] : 0;
  const double* x = a.X + row * a.ld_x;
  double* g = a.g + fl * K * M;
  double* P = a.pr + fl * 2 * A * K;
  double* R = P + A * K;
  double* mx = a.vec + fl * 3 * K;
  double* r1v = mx + K;
  double* xt = r1v + K;
  double* S0 = a.aux + fl * (M * M + A);  // M * M: S kept
  double* d = S0 + M * M;                   // A: p_j . w
  double* press = a.press + fl * A * M;

  for (int64_t i = K * kOpGroup + threadIdx.x; i < kOpGroup * a.K8;
       i += kOpThreads)
    B[i] = 0.0;
  cluster.sync();  // every block has started: its shared memory takes writes

  double nrm = 0.0, tt = 0.0;
  if (live) {
    if (tid == 0) {
      const double wi = a.wts ? a.wts[row * a.ld_w] : 1.0;
      double sw = 0.0, rsw = 0.0, rdv = 0.0;
      if (center || scx || scy) {
        double nnz_t;
        if (a.wts) {
          sw = *a.sum_w - wi;
          nnz_t = static_cast<double>(*a.nnz - (wi != 0.0 ? 1 : 0));
        } else {
          sw = static_cast<double>(a.N - 1);
          nnz_t = sw;
        }
        const double divisor = (nnz_t - a.ddof) * sw / nnz_t;
        rsw = 1.0 / sw;
        rdv = 1.0 / divisor;
      }
      sc[0] = wi;
      sc[1] = sw;
      sc[2] = rsw;
      sc[3] = rdv;
    }
    ikpls2_fold_sync(slot);
    const double wi = sc[0], sw = sc[1], rsw = sc[2], rdv = sc[3];
    // training mean and std of a column (ops.loocv.side_mean_std)
    auto stats = [&](double u, const double* sum, const double* sq,
                     bool need_mean, bool need_std, int64_t c, double& m,
                     double& sd) {
      const double uw = a.wts ? u * wi : u;
      m = 0.0;
      sd = 1.0;
      if (need_mean || need_std) {
        const double st = sum[c] - uw;
        m = st * rsw;
        if (need_std) {
          const double ss = sq[c] - uw * u;
          double var = (-2.0 * m * st + sw * (m * m) + ss) * rdv;
          var = var < 0.0 ? 0.0 : var;  // NaN passes
          sd = sqrt(var);
          sd = sd <= a.resolution ? 1.0 : sd;
        }
      }
    };
    for (int64_t k = tid; k < K; k += kOpFold) {
      const double xk = x[k];
      double m, sd;
      stats(xk, a.sum_x, a.sum_sq_x, center || scx, scx, k, m, sd);
      mx[k] = m;
      r1v[k] = 1.0 / sd;
      double v = xk;
      if (cx) v = v - m;
      if (scx) v = v / sd;
      xt[k] = v;
    }
    for (int c = tid; c < M; c += kOpFold) {
      const double yc = a.Y[row * a.ld_y + c];
      double m, sd;
      stats(yc, a.sum_y, a.sum_sq_y, center || scy, scy, c, m, sd);
      yr[c] = yc;
      my[c] = m;
      sy[c] = sd;
      yh[c] = 0.0;
    }
    ikpls2_fold_sync(slot);
    // XTY_f = XTY (.) (r1 r2^T) - u vy^T - p qy^T
    for (int64_t i = tid; i < K * M; i += kOpFold) {
      const int64_t k = i / M;
      const int c = static_cast<int>(i % M);
      const double r1 = r1v[k], r2 = 1.0 / sy[c];
      const double xk = x[k];
      const double u = (a.wts ? xk * wi : xk) * r1;
      const double p = center ? sw * (mx[k] * r1) : 0.0;
      const double qy = center ? my[c] * r2 : 0.0;
      g[i] = a.xty[k * a.ld_xty + c] * (r1 * r2) - u * (yr[c] * r2) - p * qy;
    }
    ikpls2_fold_sync(slot);
    ikpls2_gram(g, wt, qa, 0.0, false, K, M, S, stg, a.stage, tid, slot);
  }

  for (int c = 0; c < A; ++c) {
    for (int64_t i = K * kOpGroup + threadIdx.x; i < kOpGroup * a.K8;
         i += kOpThreads)
      B[i] = 0.0;  // the pad rows (the partials may have used them)
    double za = 0.0, zb = 0.0, zz = 0.0;
    if (live) {
      // XTY deflated by the last component (and stored), its Gram matrix
      if (c > 0) {
        ikpls2_gram(g, wt, qa, tt, true, K, M, S, stg, a.stage, tid, slot);
      }
      for (int i = tid; i < M * M; i += kOpFold) S0[i] = S[i];
      ikpls2_jacobi(S, Sx, V, q, M, c > 0, red, tid, slot);
      // w = XTY q
      double nn = 0.0;
      for (int64_t k = tid; k < K; k += kOpFold) {
        const double* gk = g + k * M;
        double v = 0.0;
        for (int m = 0; m < M; ++m) v += gk[m] * q[m];
        wt[k] = v;
        nn += v * v;
      }
      nrm = sqrt(ikpls2_fold_sum(nn, red, slot));
      for (int64_t k = tid; k < K; k += kOpFold) wt[k] = wt[k] / nrm;
      ikpls2_fold_sync(slot);
      // r = w - sum_j (p_j . w) r_j
      // p_j . w, kOpDots j at a time: each thread's share of the rows, then
      // the warps' partials (part: kOpFoldWarps x 32) summed in order
      for (int j0 = 0; j0 < c; j0 += 32) {
        const int nj = c - j0 < 32 ? c - j0 : 32;
        for (int jj = 0; jj < nj; jj += kOpDots) {
          double s[kOpDots];
#pragma unroll
          for (int u = 0; u < kOpDots; ++u) s[u] = 0.0;
          for (int64_t k0 = tid; k0 < K; k0 += kOpFold * kOpRows) {
            double pv[kOpDots][kOpRows];
#pragma unroll
            for (int u = 0; u < kOpDots; ++u) {
#pragma unroll
              for (int i = 0; i < kOpRows; ++i) {
                const int64_t k = k0 + i * kOpFold;
                pv[u][i] = jj + u < nj && k < K
                               ? __ldcs(P + (j0 + jj + u) * K + k)
                               : 0.0;
              }
            }
#pragma unroll
            for (int i = 0; i < kOpRows; ++i) {
              const int64_t k = k0 + i * kOpFold;
              if (k < K) {
                const double wk = wt[k];
#pragma unroll
                for (int u = 0; u < kOpDots; ++u) s[u] += pv[u][i] * wk;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kOpDots; ++u) {
            const double v = warp_sum(s[u]);
            if (lane == 0 && jj + u < nj) part[warp * 32 + jj + u] = v;
          }
        }
        ikpls2_fold_sync(slot);
        if (tid < nj) {
          double v = 0.0;
          for (int w8 = 0; w8 < kOpFoldWarps; ++w8) v += part[w8 * 32 + tid];
          d[j0 + tid] = v;
        }
        ikpls2_fold_sync(slot);
      }
      for (int64_t k0 = tid; k0 < K; k0 += kOpFold * kOpRows) {
        double vr[kOpRows];
#pragma unroll
        for (int i = 0; i < kOpRows; ++i) {
          const int64_t k = k0 + i * kOpFold;
          vr[i] = k < K ? wt[k] : 0.0;
        }
        for (int j = 0; j < c; j += kOpDots) {
          double rv[kOpDots][kOpRows];
#pragma unroll
          for (int u = 0; u < kOpDots; ++u) {
#pragma unroll
            for (int i = 0; i < kOpRows; ++i) {
              const int64_t k = k0 + i * kOpFold;
              rv[u][i] = j + u < c && k < K ? __ldcs(R + (j + u) * K + k)
                                            : 0.0;
            }
          }
#pragma unroll
          for (int u = 0; u < kOpDots; ++u) {
            if (j + u < c) {
              const double du = d[j + u];
#pragma unroll
              for (int i = 0; i < kOpRows; ++i) vr[i] -= du * rv[u][i];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kOpRows; ++i) {
          const int64_t k = k0 + i * kOpFold;
          if (k < K) r[k] = vr[i];
        }
      }
      for (int64_t k = tid; k < K; k += kOpFold) {
        const double v = r[k];
        const double r1 = r1v[k];
        const double dr = r1 * v;
        for (int b = 0; b < kOpCluster; ++b)
          cluster.map_shared_rank(B, b)[k * kOpGroup + col] = dr;
        za += (x[k] * r1) * v;
        if (cx) zb += (mx[k] * r1) * v;
        zz += xt[k] * v;
      }
      ikpls2_fold_sum3(za, zb, zz, red, slot);
    } else {
      // a slot past F: its column is 0 (written each component, as the
      // product's partials may have used the first rows of B)
      for (int64_t k = tid; k < K; k += kOpFold) {
        for (int b = 0; b < kOpCluster; ++b)
          cluster.map_shared_rank(B, b)[k * kOpGroup + col] = 0.0;
      }
    }
    cluster.sync();  // every block holds the cluster's eight r1 (.) r
    ikpls2_product(a, B, sh, cluster, rank);
    cluster.sync();  // every fold holds its T = XTX (r1 (.) r)
    if (!live) continue;
    const double wi = sc[0], sw = sc[1];
    // t = r1 (.) T - u (v . r) - p (q . r)
    double tr = 0.0;
    for (int64_t k = tid; k < K; k += kOpFold) {
      const double r1 = r1v[k];
      const double xk = x[k];
      const double u = (a.wts ? xk * wi : xk) * r1;
      double t = r1 * wt[k] - u * za;
      if (center) t = t - (sw * (mx[k] * r1)) * zb;
      wt[k] = t;
      tr += t * r[k];
    }
    tt = ikpls2_fold_sum(tr, red, slot);
    for (int64_t k = tid; k < K; k += kOpFold) {
      const double pk = wt[k] / tt;
      wt[k] = pk;
      __stcs(P + c * K + k, pk);
      __stcs(R + c * K + k, r[k]);
    }
    for (int m = tid; m < M; m += kOpFold) {
      double s = 0.0;
      for (int j = 0; j < M; ++j) s += S0[m * M + j] * q[j];
      const double qm = s / (nrm * tt);
      qa[m] = qm;
      const double yhm = yh[m] + zz * qm;
      yh[m] = yhm;
      double pred = yhm;
      if (scy) pred = pred * sy[m];
      if (cy) pred = pred + my[m];
      const double e = yr[m] - pred;
      press[c * M + m] = a.wts ? wi * (e * e) : e * e;
    }
    ikpls2_fold_sync(slot);
  }
}

// ---------------------------------------------------------------------------
// The wide kernels (cvm_ikpls2_wide_f64): formed fold matrices of any K, the
// whole card on a chunk of folds. See the file's comment.

constexpr int kWideThreads = 256;
constexpr int kWideCols = 4;                         // product columns a thread
constexpr int kWideTile = kWideThreads * kWideCols;  // product columns a block
constexpr int kWideRows = 256;                       // rows of a split
constexpr int kWideUnroll = 4;                       // rows in flight a thread
constexpr int kWideCluster = 8;                      // step blocks a fold
constexpr int kStepThreads = 512;                    // threads a step block
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepLanes = 4;                        // split sums in flight
constexpr int kWideRed = kMaxM * (kMaxM + 1) / 2 + kMaxM;  // sums a sync
constexpr int kWideT = 32;                           // transpose tile edge
// the step kernel's dynamic shared memory, in doubles: the warps' partials,
// two exchange buffers and the sums, then S and V (M x M), q and q_a
constexpr int kWideShmem =
    (kStepWarps + 3) * kWideRed + 2 * kMaxM * kMaxM + 2 * kMaxM;

struct WideArgs {
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
  double* xst;           // (F, K, L) scratch: the rows' x~, transposed
  double* part;          // (F, S, C) scratch: the product's split sums
  double* g;             // (F, M, K) scratch: XTY transposed, deflated
  double* pr;            // (F, 2, A, K) scratch: p, then r, of each component
  double* yhat;          // (F, L, M) scratch: the running prediction
  double* z;             // (F, L) scratch: the rows' scores of a component
  double* press;         // (F, A, M) output
  int64_t K, M, L, A;
  int64_t S, C;          // splits of the K rows; C = K + L product columns
  int64_t xtx_sf, xtx_sr, xty_sf, xty_sr;
  int64_t x_mean_sf, x_std_sf, y_mean_sf, y_std_sf;
  int flags;
};

// xst[f][k][l]: validation row l's column k centred and scaled as the flags
// say, transposed so that the product streams the rows' scores beside XTX.
// A block (kWideT, 8) threads is one kWideT x kWideT tile of one fold.
__global__ void __launch_bounds__(kWideT * 8)
    ikpls2_wide_prep_kernel(const WideArgs a) {
  __shared__ double tile[kWideT][kWideT + 1];
  const int64_t f = blockIdx.z, K = a.K, L = a.L;
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * kWideT;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kWideT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const double* xm = (a.flags & kCenterX) ? a.x_mean + f * a.x_mean_sf
                                          : nullptr;
  const double* xs = (a.flags & kScaleX) ? a.x_std + f * a.x_std_sf : nullptr;
  const double* xv = a.xv + f * L * K;
  const int64_t k = k0 + tx;
  for (int i = ty; i < kWideT; i += 8) {
    const int64_t l = l0 + i;
    if (l < L && k < K) {
      double v = xv[l * K + k];
      if (xm) v = v - xm[k];
      if (xs) v = v / xs[k];
      tile[i][tx] = v;
    }
  }
  __syncthreads();
  double* xst = a.xst + f * K * L;
  const int64_t l = l0 + tx;
  for (int i = ty; i < kWideT; i += 8) {
    const int64_t kk = k0 + i;
    if (l < L && kk < K) xst[kk * L + l] = tile[tx][i];
  }
}

// part[f][s][j] = sum over the rows i of split s of r_i B[i][j], with B =
// [XTX_f | xst_f] (K x C) and r = R[c] of fold f: a block is one split's
// kWideRows rows by kWideTile columns of one fold, each entry read once,
// kWideUnroll rows of kWideCols columns in flight a thread. Rows are summed
// in order; no atomics, so the same inputs give the same bits.
__global__ void __launch_bounds__(kWideThreads)
    ikpls2_wide_product_kernel(const WideArgs a, const int c) {
  __shared__ double rs[kWideRows];
  const int64_t f = blockIdx.z, K = a.K, L = a.L;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kWideRows;
  const int n = static_cast<int>(min(static_cast<int64_t>(kWideRows), K - i0));
  const int64_t tiles_x = (K + kWideTile - 1) / kWideTile;
  const double* src;
  int64_t ld, ncol, col0, out0;
  if (blockIdx.x < tiles_x) {
    src = a.xtx + f * a.xtx_sf;
    ld = a.xtx_sr;
    ncol = K;
    col0 = static_cast<int64_t>(blockIdx.x) * kWideTile;
    out0 = col0;
  } else {
    src = a.xst + f * K * L;
    ld = L;
    ncol = L;
    col0 = (static_cast<int64_t>(blockIdx.x) - tiles_x) * kWideTile;
    out0 = K + col0;
  }
  const double* r = a.pr + (f * 2 + 1) * a.A * K + c * K + i0;
  for (int i = threadIdx.x; i < n; i += kWideThreads) rs[i] = r[i];
  __syncthreads();
  const int64_t j0 = col0 + threadIdx.x;
  bool ok[kWideCols];
#pragma unroll
  for (int s = 0; s < kWideCols; ++s) ok[s] = j0 + s * kWideThreads < ncol;
  double acc[kWideCols];
#pragma unroll
  for (int s = 0; s < kWideCols; ++s) acc[s] = 0.0;
  const double* base = src + i0 * ld + j0;
  int i = 0;
  for (; i + kWideUnroll <= n; i += kWideUnroll) {
    double v[kWideUnroll][kWideCols];
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kWideCols; ++s)
        v[u][s] = ok[s] ? __ldcs(base + (i + u) * ld + s * kWideThreads) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      const double ri = rs[i + u];
#pragma unroll
      for (int s = 0; s < kWideCols; ++s) acc[s] += ri * v[u][s];
    }
  }
  for (; i < n; ++i) {
    const double ri = rs[i];
#pragma unroll
    for (int s = 0; s < kWideCols; ++s)
      if (ok[s]) acc[s] += ri * __ldcs(base + i * ld + s * kWideThreads);
  }
  double* out = a.part + (f * a.S + blockIdx.y) * a.C + out0 + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kWideCols; ++s)
    if (ok[s]) out[s * kWideThreads] = acc[s];
}

// A thread's part of sum number idx: the warp's sum into wred.
__device__ __forceinline__ void wide_part(double v, double* wred, int idx) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) wred[(threadIdx.x >> 5) * kWideRed + idx] = v;
}

// The cluster's sums of the n values every warp has put in wred: the
// block's sums into buf, then every block's buf, in rank order, into out,
// the same bits in every block. buf alternates between two buffers from
// one call to the next, so that no block writes a buffer another may still
// read.
__device__ void wide_cluster_sum(cg::cluster_group& cl, const double* wred,
                                 double* buf, double* out, int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kStepThreads) {
    double s = 0.0;
    for (int w = 0; w < kStepWarps; ++w) s += wred[w * kWideRed + i];
    buf[i] = s;
  }
  cl.sync();
  for (int i = threadIdx.x; i < n; i += kStepThreads) {
    double s = 0.0;
    for (int b = 0; b < kWideCluster; ++b) s += cl.map_shared_rank(buf, b)[i];
    out[i] = s;
  }
  __syncthreads();
}

// One component's vector work on every fold of the chunk: a cluster of
// kWideCluster blocks a fold, each a slice of the K columns and of the L
// validation rows. c >= 0 finishes component c from the product's split
// sums (t, tt, p and q_c, the deflation of XTY, the rows' scores and PRESS)
// and, below A - 1, starts component c + 1 (S, Jacobi, w, Gram-Schmidt: r
// into R[c + 1], which the next product reads); c = -1 copies XTY into g,
// zeroes yhat and starts component 0 (with a null xty it copies nothing:
// the wide operator route's prep has written the folds' XTY into g).
__global__ void __cluster_dims__(kWideCluster, 1, 1)
    __launch_bounds__(kStepThreads) ikpls2_wide_step_kernel(const WideArgs a,
                                                            const int c) {
  extern __shared__ double sh[];
  __shared__ Rot rot;
  cg::cluster_group cl = cg::this_cluster();
  const int64_t rank = cl.block_rank();
  const int64_t f = blockIdx.x / kWideCluster;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t K = a.K, L = a.L, S = a.S, C = a.C;
  const int M = static_cast<int>(a.M), A = static_cast<int>(a.A);
  double* wred = sh;                          // kStepWarps x kWideRed
  double* bufs[2] = {wred + kStepWarps * kWideRed,
                     wred + (kStepWarps + 1) * kWideRed};
  double* sum = wred + (kStepWarps + 2) * kWideRed;
  double* Sm = sum + kWideRed;                // M x M
  double* V = Sm + kMaxM * kMaxM;             // M x M
  double* q = V + kMaxM * kMaxM;              // M: eigenvector
  double* qa = q + kMaxM;                     // M: q_c
  int nb = 0;

  const int64_t ks = (K + kWideCluster - 1) / kWideCluster;
  const int64_t k0 = rank * ks, k1 = min(K, k0 + ks);
  const int64_t ls = (L + kWideCluster - 1) / kWideCluster;
  const int64_t l0 = rank * ls, l1 = min(L, l0 + ls);
  double* g = a.g + f * M * K;
  double* P = a.pr + f * 2 * A * K;
  double* R = P + A * K;
  double* yhat = a.yhat + f * L * M;
  double* z = a.z + f * L;

  int off = 0;  // where the Gram matrix's sums start
  if (c < 0) {
    // null xty: g holds the folds' XTY already (the operator route's prep)
    if (a.xty) {
      const double* xty = a.xty + f * a.xty_sf;
      for (int64_t k = k0 + tid; k < k1; k += kStepThreads)
        for (int m = 0; m < M; ++m) g[m * K + k] = xty[k * a.xty_sr + m];
    }
    for (int64_t i = l0 * M + tid; i < l1 * M; i += kStepThreads) yhat[i] = 0.0;
  } else {
    // t = r^T XTX from the split sums (into P[c]); tt and XTY^T r
    double* t = P + c * K;
    const double* r = R + c * K;
    const double* part = a.part + f * S * C;
    // kStepLanes of a thread's columns at once, each summed in split order
    double ttp = 0.0;
    for (int64_t kb = k0 + tid; kb < k1; kb += kStepLanes * kStepThreads) {
      double s[kStepLanes];
#pragma unroll
      for (int u = 0; u < kStepLanes; ++u) s[u] = 0.0;
#pragma unroll 4
      for (int64_t si = 0; si < S; ++si) {
        const double* ps = part + si * C;
#pragma unroll
        for (int u = 0; u < kStepLanes; ++u) {
          const int64_t k = kb + u * kStepThreads;
          if (k < k1) s[u] += ps[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kStepLanes; ++u) {
        const int64_t k = kb + u * kStepThreads;
        if (k < k1) {
          t[k] = s[u];
          ttp += s[u] * r[k];
        }
      }
    }
    wide_part(ttp, wred, 0);
    for (int m = 0; m < M; ++m) {
      double v = 0.0;
      for (int64_t k = k0 + tid; k < k1; k += kStepThreads)
        v += g[m * K + k] * r[k];
      wide_part(v, wred, 1 + m);
    }
    wide_cluster_sum(cl, wred, bufs[nb++ & 1], sum, M + 1);
    const double tt = sum[0];
    if (tid < M) qa[tid] = sum[1 + tid] / tt;
    __syncthreads();

    // p = t / tt (into P[c]); XTY -= (p q_c^T) tt
    for (int64_t k = k0 + tid; k < k1; k += kStepThreads) {
      const double p = t[k] / tt;
      t[k] = p;
      for (int m = 0; m < M; ++m) g[m * K + k] = g[m * K + k] - (p * qa[m]) * tt;
    }
    // the rows' scores z = x~ . r, the prediction and PRESS
    for (int64_t l = l0 + tid; l < l1; l += kStepThreads) {
      double s = 0.0;
#pragma unroll 8
      for (int64_t si = 0; si < S; ++si) s += part[si * C + K + l];
      z[l] = s;
    }
    const double* yv = a.yv + f * L * M;
    const double* wv = a.wv ? a.wv + f * L : nullptr;
    const double* mv = a.mv ? a.mv + f * L : nullptr;
    const double* ym = (a.flags & kCenterY) ? a.y_mean + f * a.y_mean_sf
                                            : nullptr;
    const double* ys = (a.flags & kScaleY) ? a.y_std + f * a.y_std_sf
                                           : nullptr;
    for (int m = 0; m < M; ++m) {
      double e2 = 0.0;
      for (int64_t l = l0 + tid; l < l1; l += kStepThreads) {
        const double yh = yhat[l * M + m] + z[l] * qa[m];
        yhat[l * M + m] = yh;
        double pred = yh;
        if (ys) pred = pred * ys[m];
        if (ym) pred = pred + ym[m];
        const double e = yv[l * M + m] - pred;
        double wl = wv ? wv[l] : 1.0;
        if (mv) wl = wl * mv[l];
        e2 += wl * (e * e);
      }
      wide_part(e2, wred, m);
    }
    off = M;
  }

  const bool next = c + 1 < A;
  const int n_sym = M * (M + 1) / 2;
  if (next) {
    // S = XTY^T XTY of the deflated XTY
    for (int pi = 0; pi < n_sym; ++pi) {
      int i = 0, rem = pi;
      while (rem >= M - i) {
        rem -= M - i;
        ++i;
      }
      const int j = i + rem;
      double v = 0.0;
      for (int64_t k = k0 + tid; k < k1; k += kStepThreads)
        v += g[i * K + k] * g[j * K + k];
      wide_part(v, wred, off + pi);
    }
  }
  wide_cluster_sum(cl, wred, bufs[nb++ & 1], sum, off + (next ? n_sym : 0));
  if (c >= 0 && rank == 0 && tid < M) a.press[(f * A + c) * M + tid] = sum[tid];
  if (!next) {
    cl.sync();  // no block leaves while another reads its shared memory
    return;
  }
  for (int pi = tid; pi < n_sym; pi += kStepThreads) {
    int i = 0, rem = pi;
    while (rem >= M - i) {
      rem -= M - i;
      ++i;
    }
    const int j = i + rem;
    Sm[i * M + j] = sum[off + pi];
    Sm[j * M + i] = sum[off + pi];
  }
  __syncthreads();
  if (warp == 0) jacobi_dominant(Sm, V, q, M, &rot);
  __syncthreads();

  // w = XTY q (unnormalised, into R[c + 1]); ||w|| and p_j . w (j <= c),
  // at most kWideRed sums a sync; r = w / ||w|| - sum_j (p_j . w / ||w||) r_j
  double* rn = R + (c + 1) * K;
  double nn = 0.0;
  for (int64_t k = k0 + tid; k < k1; k += kStepThreads) {
    double v = 0.0;
    for (int m = 0; m < M; ++m) v += g[m * K + k] * q[m];
    rn[k] = v;
    nn += v * v;
  }
  double nrm = 0.0;
  int j = 0;
  for (bool first = true; first || j <= c; first = false) {
    int n = 0;
    if (first) wide_part(nn, wred, n++);
    const int jb = j;
    for (; j <= c && n < kWideRed; ++j, ++n) {
      double v = 0.0;
      for (int64_t k = k0 + tid; k < k1; k += kStepThreads) {
        double wk = rn[k];
        if (!first) {
          wk = 0.0;
          for (int m = 0; m < M; ++m) wk += g[m * K + k] * q[m];
        }
        v += P[j * K + k] * wk;
      }
      wide_part(v, wred, n);
    }
    wide_cluster_sum(cl, wred, bufs[nb++ & 1], sum, n);
    const int s0 = first ? 1 : 0;
    if (first) nrm = sqrt(sum[0]);
    for (int64_t k = k0 + tid; k < k1; k += kStepThreads) {
      double rk = first ? rn[k] / nrm : rn[k];
      for (int jj = jb; jj < j; ++jj)
        rk = rk - (sum[s0 + jj - jb] / nrm) * R[jj * K + k];
      rn[k] = rk;
    }
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// The wide operator kernels (cvm_ikpls2_wide_op_f64): the wide route's
// components and scores with no fold matrix formed, for folds of any L at
// any K. See the file's comment.

constexpr int kWopThreads = 128;  // columns a prep or correction block
constexpr int kWopStage = 128;    // validation rows staged a pass
constexpr int kWopRows = 8;       // validation rows a score block
constexpr int kWopWarps = kWideThreads / 32;
constexpr int kWopStrip = 256;    // rows of a product tile
constexpr int kWopCols = 2;       // product columns a thread
constexpr int kWopTile = kWideThreads * kWopCols;  // columns of a tile
static_assert(kWideUnroll == 4, "the product's row sums take four rows");
static_assert(kWopTile % kWopStrip == 0, "a strip lies in one tile");

struct WopArgs {
  const double* xtx;       // fitted total, row i at i * ld_xtx
  const double* xty;       // (K, M) fitted, row k at k * ld_xty
  const double* X;         // (N, K) fitted rows, row n at n * ld_x
  const double* Y;         // (N, M), row n at n * ld_y
  const double* wts;       // weights, row n at n * ld_w; null unweighted
  const double* sum_x;     // (K) the fit's sums; null where no flag needs one
  const double* sum_sq_x;  // (K)
  const double* sum_y;     // (M)
  const double* sum_sq_y;  // (M)
  const double* sum_w;     // scalar
  const int64_t* nnz;      // scalar
  const int64_t* rows;     // (F, L) each fold's validation rows, in [0, N)
  const double* mask;      // (F, L) 0/1, or null
  double* vec;             // (F, 2, K) scratch: delta, then r1 = 1 / X std
  double* ystat;           // (F, 2, M) scratch: Y mean, then Y std
  double* scal;            // (F) scratch: the training weight sum
  double* g;               // (F, M, K) scratch: the folds' XTY (the step's)
  double* yv;              // (F, L, M) scratch: the validation rows of Y
  double* wv;              // (F, L) scratch: their weights, or null
  double* colpart;         // (F, S, K) scratch: the product's column sums
  double* rowpart;         // (F, NT, K) scratch: the product's row sums
  double* u;               // (F, L + 1) scratch: d_l . y, then delta . y
  double* part;            // (F, K + L) scratch: t and z (the step's, S = 1)
  const double* pr;        // (F, 2, A, K): the step's p and r
  int64_t F, K, M, L, A, S, NT;
  int64_t ld_xtx, ld_xty, ld_x, ld_y, ld_w;
  int64_t ddof;
  double resolution;
  int flags;
};

// Validation row l of fold f: its weight times its mask (1 where neither).
__device__ __forceinline__ double wop_coef(const WopArgs& a, int64_t f,
                                           int64_t l, int64_t row) {
  double c = a.wts ? a.wts[row * a.ld_w] : 1.0;
  if (a.mask) c = c * a.mask[f * a.L + l];
  return c;
}

// The centring point m0 = sum_X / sum_w of column k; 0 uncentred.
__device__ __forceinline__ double wop_m0(const WopArgs& a, int64_t k) {
  return (a.flags & kCenterX) ? a.sum_x[k] / a.sum_w[0] : 0.0;
}

// y = r1 (.) r of component c of fold f, entry k.
__device__ __forceinline__ double wop_y(const WopArgs& a, int64_t f, int c,
                                        int64_t k) {
  return a.vec[(f * 2 + 1) * a.K + k] * a.pr[((f * 2 + 1) * a.A + c) * a.K + k];
}

// Each fold's statistics, its XTY and the m0-centred sum of its validation
// rows: a block is kWopThreads columns of one fold, each column summed over
// the fold's rows in order, kWopStage rows staged at a time. Every block
// sums the fold's scalars and Y side in the same order, so all hold the
// same bits.
__global__ void __launch_bounds__(kWopThreads)
    ikpls2_wide_op_prep_kernel(const WopArgs a) {
  __shared__ int64_t rs[kWopStage];
  __shared__ double cs[kWopStage];
  __shared__ double ys[kWopStage * kMaxM];
  __shared__ double fy[4 * kMaxM + 4];  // Y sums, squared sums; mY, sY; sv, nv
  const int64_t f = blockIdx.y, K = a.K, L = a.L;
  const int M = static_cast<int>(a.M);
  const int tid = threadIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWopThreads + tid;
  const bool cx = a.flags & kCenterX, cy = a.flags & kCenterY;
  const bool sx = a.flags & kScaleX, sy = a.flags & kScaleY;
  const bool stats = cx || cy || sx || sy;
  const int64_t* frows = a.rows + f * L;

  // the fold's scalars and Y sums: one quantity a thread, rows in order
  if (tid < M || (tid >= kMaxM && tid < kMaxM + M) || tid == 2 * kMaxM ||
      tid == 2 * kMaxM + 1) {
    const int m = tid < kMaxM ? tid : tid - kMaxM;
    double s = 0.0;
    for (int64_t l = 0; l < L; ++l) {
      const int64_t row = frows[l];
      const double c = wop_coef(a, f, l, row);
      if (tid == 2 * kMaxM) {
        s += c;
      } else if (tid == 2 * kMaxM + 1) {
        s += c != 0.0 ? 1.0 : 0.0;
      } else if (stats && a.sum_y) {
        const double y = a.Y[row * a.ld_y + m];
        s += tid < kMaxM ? c * y : (c * y) * y;
      }
    }
    if (tid < kMaxM) fy[tid] = s;
    else if (tid < 2 * kMaxM) fy[kMaxM + m] = s;
    else fy[4 * kMaxM + tid - 2 * kMaxM] = s;
  }
  __syncthreads();
  // the scalars and formulas of ops/loocv.side_mean_std
  double sw = 0.0, rsw = 0.0, rdv = 0.0;
  if (stats) {
    sw = a.sum_w[0] - fy[4 * kMaxM];
    const double nt =
        a.wts ? static_cast<double>(a.nnz[0] -
                                    static_cast<int64_t>(fy[4 * kMaxM + 1]))
              : sw;
    rsw = 1.0 / sw;
    rdv = 1.0 / ((nt - static_cast<double>(a.ddof)) * sw / nt);
  }
  if (tid < M) {
    double my = 0.0, sdy = 1.0;
    if (cx || cy || sy) {
      const double st = a.sum_y[tid] - fy[tid];
      my = st * rsw;
      if (sy) {
        double var = (-2.0 * my * st + sw * (my * my) +
                      (a.sum_sq_y[tid] - fy[kMaxM + tid])) * rdv;
        var = var < 0.0 ? 0.0 : var;
        sdy = sqrt(var);
        if (sdy <= a.resolution) sdy = 1.0;
      }
    }
    fy[2 * kMaxM + tid] = my;
    fy[3 * kMaxM + tid] = sdy;
    if (blockIdx.x == 0) {
      a.ystat[(f * 2) * M + tid] = my;
      a.ystat[(f * 2 + 1) * M + tid] = sdy;
    }
  }
  if (blockIdx.x == 0 && tid == 0) a.scal[f] = sw;
  // the step's validation rows of Y and their weights, spread over blocks
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWopThreads + tid;
       i < L * M; i += static_cast<int64_t>(gridDim.x) * kWopThreads) {
    const int64_t l = i / M;
    a.yv[f * L * M + i] = a.Y[frows[l] * a.ld_y + (i - l * M)];
    if (a.wts && i - l * M == 0) a.wv[f * L + l] = a.wts[frows[l] * a.ld_w];
  }

  // the column's sums over the fold's rows, in order
  const double m0 = k < K ? wop_m0(a, k) : 0.0;
  double s1 = 0.0, s2 = 0.0, sd = 0.0;
  double sxy[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) sxy[m] = 0.0;
  for (int64_t l0 = 0; l0 < L; l0 += kWopStage) {
    const int n = static_cast<int>(min(static_cast<int64_t>(kWopStage), L - l0));
    __syncthreads();
    for (int i = tid; i < n; i += kWopThreads) {
      const int64_t row = frows[l0 + i];
      rs[i] = row;
      cs[i] = wop_coef(a, f, l0 + i, row);
    }
    for (int i = tid; i < n * M; i += kWopThreads) {
      const int li = i / M;
      ys[i] = a.Y[frows[l0 + li] * a.ld_y + (i - li * M)];
    }
    __syncthreads();
    if (k < K) {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const double x = a.X[rs[i] * a.ld_x + k];
        const double cxv = cs[i] * x;
        s1 += cxv;
        s2 += cxv * x;
        sd += cs[i] * (x - m0);
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < M) sxy[m] += cxv * ys[i * M + m];
      }
    }
  }
  if (k >= K) return;
  double mx = 0.0, sdx = 1.0;
  if (cx || cy || sx) {
    const double st = a.sum_x[k] - s1;
    mx = st * rsw;
    if (sx) {
      double var = (-2.0 * mx * st + sw * (mx * mx) + (a.sum_sq_x[k] - s2)) *
                   rdv;
      var = var < 0.0 ? 0.0 : var;
      sdx = sqrt(var);
      if (sdx <= a.resolution) sdx = 1.0;
    }
  }
  a.vec[(f * 2) * K + k] = cx ? sd : 0.0;
  a.vec[(f * 2 + 1) * K + k] = sx ? 1.0 / sdx : 1.0;
  const double* xty = a.xty + k * a.ld_xty;
  double* g = a.g + f * M * K + k;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m < M) {
      double v = xty[m] - sxy[m];
      if (cx || cy) v = v - sw * (mx * fy[2 * kMaxM + m]);
      if (sx && sy) {
        v = v / (sdx * fy[3 * kMaxM + m]);
      } else if (sx) {
        v = v / sdx;
      } else if (sy) {
        v = v / fy[3 * kMaxM + m];
      }
      g[m * K] = v;
    }
  }
}

// One component's product for a group of G folds, read from the upper
// triangle of the total: C y_f with C = XTX - sum_w m0 m0^T (centred on
// the fly, m0 = 0 uncentred) and y_f = r1 (.) r. A tile block is one
// strip of kWopStrip rows I by kWopTile columns jt at or right of the
// diagonal; its entries (i, j), j >= i, are read once, each giving
// C_ij y_i to column j's sum and, off the diagonal, C_ij y_j to row i's.
// colpart[f][I][j] holds the strip's column sums, rowpart[f][jt][i] the
// tile's row sums (each row's warp sums in warp order). Score blocks (before
// the tiles) each hold kWopRows of a fold's validation rows and, as row L,
// its delta: u[f][l] = (x_l - m0) . y_f, the whole K a block. Rows and
// warps are summed in order: the same inputs give the same bits.
template <int G>
__global__ void __launch_bounds__(kWideThreads)
    ikpls2_wide_op_product_kernel(const WopArgs a, const int c) {
  extern __shared__ double dsh[];
  const int64_t K = a.K, NT = a.NT;
  const int64_t b = blockIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cx = a.flags & kCenterX;

  const int64_t nrb = (a.L + 1 + kWopRows - 1) / kWopRows;
  if (b < G * nrb) {
    // score block: kWopRows rows of fold f, each over the whole K
    const int64_t f = f0 + b / nrb;
    if (f >= a.F) return;
    const int64_t l0 = (b % nrb) * kWopRows;
    const double* src[kWopRows];
#pragma unroll
    for (int q = 0; q < kWopRows; ++q) {
      const int64_t l = l0 + q;
      src[q] = l < a.L ? a.X + a.rows[f * a.L + l] * a.ld_x
                       : (l == a.L && cx ? a.vec + f * 2 * K : nullptr);
    }
    double acc[kWopRows];
#pragma unroll
    for (int q = 0; q < kWopRows; ++q) acc[q] = 0.0;
    for (int64_t k = tid; k < K; k += kWideThreads) {
      const double y = wop_y(a, f, c, k);
      const double m0 = wop_m0(a, k);
#pragma unroll
      for (int q = 0; q < kWopRows; ++q) {
        if (src[q]) {
          // row L is delta itself, centred already
          const double x = l0 + q < a.L ? src[q][k] - m0 : src[q][k];
          acc[q] += x * y;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kWopRows; ++q) {
      const double v = warp_sum(acc[q]);
      if (lane == 0) dsh[warp * kWopRows + q] = v;
    }
    __syncthreads();
    if (tid < kWopRows && l0 + tid <= a.L) {
      double s = 0.0;
      for (int w = 0; w < kWopWarps; ++w) s += dsh[w * kWopRows + tid];
      a.u[f * (a.L + 1) + l0 + tid] = s;
    }
    return;
  }

  const int64_t I = (b - G * nrb) / NT, jt = (b - G * nrb) % NT;
  if (I > (jt + 1) * (kWopTile / kWopStrip) - 1) return;  // below the diagonal
  const int64_t i0 = I * kWopStrip;
  const int n = static_cast<int>(min(static_cast<int64_t>(kWopStrip), K - i0));
  const int64_t j0 = jt * kWopTile + tid;
  double* ysh = dsh;                    // G x kWopStrip: y of the strip's rows
  double* msh = dsh + G * kWopStrip;    // kWopStrip: sum_w m0 of those rows
  double* rowbuf = msh + kWopStrip;     // G x kWopWarps x kWopStrip
  for (int i = tid; i < kWopStrip; i += kWideThreads) {
    msh[i] = i < n && cx ? a.sum_w[0] * wop_m0(a, i0 + i) : 0.0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      ysh[g * kWopStrip + i] =
          i < n && f0 + g < a.F ? wop_y(a, f0 + g, c, i0 + i) : 0.0;
  }
  bool ok[kWopCols];
  double mc[kWopCols], yc[G][kWopCols], acc[G][kWopCols];
#pragma unroll
  for (int s = 0; s < kWopCols; ++s) {
    const int64_t j = j0 + s * kWideThreads;
    ok[s] = j < K;
    mc[s] = ok[s] ? wop_m0(a, j) : 0.0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      yc[g][s] = ok[s] && f0 + g < a.F ? wop_y(a, f0 + g, c, j) : 0.0;
      acc[g][s] = 0.0;
    }
  }
  __syncthreads();
  const double* base = a.xtx + i0 * a.ld_xtx + j0;
  // rows i .. i + 3 as stored (0 off the upper triangle and past K): the
  // loads of the next rows are issued before this rows' sums
  auto load = [&](double (&v)[kWideUnroll][kWopCols], int i) {
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kWopCols; ++s)
        v[u][s] = ok[s] && i + u < n && j0 + s * kWideThreads >= i0 + i + u
                      ? __ldcs(base + (i + u) * a.ld_xtx + s * kWideThreads)
                      : 0.0;
    }
  };
  // their column sums into acc and row sums into rowbuf, centred on m0
  auto consume = [&](double (&v)[kWideUnroll][kWopCols], int i) {
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kWopCols; ++s)
        v[u][s] = ok[s] && i + u < n && j0 + s * kWideThreads >= i0 + i + u
                      ? fma(-msh[i + u], mc[s], v[u][s])
                      : 0.0;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      double p[kWideUnroll];
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) {
        const int64_t row = i0 + i + u;
        const double yr = ysh[g * kWopStrip + i + u];
        double pu = 0.0;
#pragma unroll
        for (int s = 0; s < kWopCols; ++s) {
          acc[g][s] += yr * v[u][s];
          if (j0 + s * kWideThreads > row) pu += v[u][s] * yc[g][s];
        }
        p[u] = pu;
      }
      // the four rows' sums over the warp, halving the rows a lane holds
      // at each of the first two exchanges: lane l ends with the sum of
      // row 2 (l >> 4 & 1) + (l >> 3 & 1)
      const bool hi = lane & 16, mid = lane & 8;
      double k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 16);
      k1 += __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 16);
      double kk = mid ? k1 : k0;
      kk += __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
      kk += __shfl_xor_sync(0xffffffffu, kk, 4);
      kk += __shfl_xor_sync(0xffffffffu, kk, 2);
      kk += __shfl_xor_sync(0xffffffffu, kk, 1);
      if ((lane & 7) == 0)
        rowbuf[(g * kWopWarps + warp) * kWopStrip + i + (hi ? 2 : 0) +
               (mid ? 1 : 0)] = kk;
    }
  };
  double va[kWideUnroll][kWopCols], vb[kWideUnroll][kWopCols];
  load(va, 0);
  for (int i = 0; i < n; i += 2 * kWideUnroll) {
    if (i + kWideUnroll < n) load(vb, i + kWideUnroll);
    consume(va, i);
    if (i + kWideUnroll >= n) break;
    if (i + 2 * kWideUnroll < n) load(va, i + 2 * kWideUnroll);
    consume(vb, i + kWideUnroll);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (f0 + g < a.F) {
      double* out = a.colpart + ((f0 + g) * a.S + I) * K + j0;
#pragma unroll
      for (int s = 0; s < kWopCols; ++s)
        if (ok[s]) out[s * kWideThreads] = acc[g][s];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * kWopStrip; idx += kWideThreads) {
    const int g = idx / kWopStrip, i = idx - g * kWopStrip;
    if (f0 + g < a.F && i < n) {
      double s = 0.0;
      for (int w = 0; w < kWopWarps; ++w)
        s += rowbuf[(g * kWopWarps + w) * kWopStrip + i];
      a.rowpart[((f0 + g) * NT + jt) * K + i0 + i] = s;
    }
  }
}

// t and z of one component for the step (part, one split): a block is
// kWopThreads columns of one fold. Column k: C y from the product's sums
// (the strips at or above row k, the tiles at or right of column k), less
// the correction sum_l w_l u_l (x_l - m0)_k + u_delta delta_k / sw, times
// r1_k; the first block of a fold writes z_l = u_l + u_delta / sw.
__global__ void __launch_bounds__(kWopThreads)
    ikpls2_wide_op_correct_kernel(const WopArgs a) {
  __shared__ int64_t rs[kWopStage];
  __shared__ double vs[kWopStage];
  const int64_t f = blockIdx.y, K = a.K, L = a.L;
  const int tid = threadIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWopThreads + tid;
  const bool cx = a.flags & kCenterX;
  const double* u = a.u + f * (L + 1);
  const double ud = cx ? u[L] / a.scal[f] : 0.0;
  const int64_t* frows = a.rows + f * L;
  const double m0 = k < K ? wop_m0(a, k) : 0.0;
  double corr = 0.0;
  for (int64_t l0 = 0; l0 < L; l0 += kWopStage) {
    const int n = static_cast<int>(min(static_cast<int64_t>(kWopStage), L - l0));
    __syncthreads();
    for (int i = tid; i < n; i += kWopThreads) {
      const int64_t row = frows[l0 + i];
      rs[i] = row;
      vs[i] = wop_coef(a, f, l0 + i, row) * u[l0 + i];
    }
    __syncthreads();
    if (k < K) {
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        corr += vs[i] * (a.X[rs[i] * a.ld_x + k] - m0);
    }
  }
  double* part = a.part + f * (K + L);
  if (blockIdx.x == 0)
    for (int64_t l = tid; l < L; l += kWopThreads) part[K + l] = u[l] + ud;
  if (k >= K) return;
  if (cx) corr += ud * a.vec[f * 2 * K + k];
  const int64_t strips = k / kWopStrip + 1;
  const double* cp = a.colpart + f * a.S * K + k;
  double t = 0.0;
  for (int64_t si = 0; si < strips; ++si) t += cp[si * K];
  const double* rp = a.rowpart + f * a.NT * K + k;
  for (int64_t jt = k / kWopTile; jt < a.NT; ++jt) t += rp[jt * K];
  part[k] = a.vec[(f * 2 + 1) * K + k] * (t - corr);
}

// One component's product for a group of G folds: its dynamic shared
// memory set once a call, then the launch.
template <int G>
size_t wop_product_shmem() {
  return sizeof(double) * ((G + 1) * kWopStrip + G * kWopWarps * kWopStrip);
}

template <int G>
cudaError_t wop_product_attr() {
  return cudaFuncSetAttribute(ikpls2_wide_op_product_kernel<G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(wop_product_shmem<G>()));
}

template <int G>
void wop_product(const WopArgs& a, int c, cudaStream_t st) {
  const int64_t nrb = (a.L + 1 + kWopRows - 1) / kWopRows;
  const dim3 grid(static_cast<unsigned>(a.S * a.NT + G * nrb),
                  static_cast<unsigned>((a.F + G - 1) / G));
  ikpls2_wide_op_product_kernel<G>
      <<<grid, kWideThreads, wop_product_shmem<G>(), st>>>(a, c);
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

namespace {

// The operator kernel's shared memory, in doubles: B, then kOpSlots folds'
// own, each with kOpStage doubles of staging or what is left (at least
// 4 kOpFold: the Gram tiles' k-parts at M <= 16).
void op_layout(int64_t K, int64_t M, int64_t* k8, int64_t* nb,
               int64_t* slot, int64_t* stage) {
  *k8 = (K + 7) / 8 * 8;
  *nb = kOpGroup * *k8 > kOpMinB ? kOpGroup * *k8 : kOpMinB;
  const int64_t base = 2 * K + 3 * M * M + 6 * M + kOpFold;
  int64_t left = (kOpShmem / 8 - *nb) / kOpSlots - base;
  left = left < kOpStage ? left : kOpStage;
  *stage = left > 4 * kOpFold ? left : 4 * kOpFold;
  *slot = base + *stage;
}

size_t op_shmem(int64_t K, int64_t M) {
  int64_t k8, nb, slot, stage;
  op_layout(K, M, &k8, &nb, &slot, &stage);
  return sizeof(double) * (nb + kOpSlots * slot);
}

}  // namespace

// Every one-row fold's IKPLS #2 solve and weighted PRESS with no fold matrix
// formed: F folds in blocks of kOpSlots, rounded up to clusters of
// kOpCluster blocks. Returns a cudaError_t (0 on success).
extern "C" int cvm_ikpls2_op_f64(
    const double* xtx, const double* xty, const double* X, const double* Y,
    const double* wts, const double* sum_x, const double* sum_sq_x,
    const double* sum_y, const double* sum_sq_y, const double* sum_w,
    const int64_t* nnz, const int64_t* rows, double* g, double* pr,
    double* vec, double* aux, double* press, int64_t F, int64_t N, int64_t K,
    int64_t M, int64_t A, int64_t ld_xtx, int64_t ld_xty, int64_t ld_x,
    int64_t ld_y, int64_t ld_w, int64_t ddof, double resolution, int flags,
    int device, void* stream) {
  if (F <= 0 || A <= 0) return 0;
  if (K < 1 || M < 1 || M > kMaxM || F > 0x7ffffff0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem = op_shmem(K, M);
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(ikpls2_op_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t k8, nb, slot, stage;
  op_layout(K, M, &k8, &nb, &slot, &stage);
  if (shmem > kOpShmem) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rs = ((K + kOpCluster - 1) / kOpCluster + 15) / 16 * 16;
  OpArgs a{xtx,  xty,    X,      Y,      wts,  sum_x, sum_sq_x, sum_y,
           sum_sq_y, sum_w, nnz, rows,   g,    pr,    vec,      aux,
           press, F,     N,      K,      M,    A,     ld_xtx,   ld_xty,
           ld_x, ld_y,   ld_w,   ddof,   resolution, flags, k8, rs,
           nb,   slot,   stage};
  const int64_t blocks =
      (F + kOpGroup - 1) / kOpGroup * kOpCluster;
  ikpls2_op_kernel<<<static_cast<unsigned>(blocks), kOpThreads, shmem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the operator kernel the card holds at once for
// (K, M); 0, and a cudaError_t in *err_out, on failure.
extern "C" int cvm_ikpls2_op_clusters(int64_t K, int64_t M, int* err_out,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  const size_t shmem = op_shmem(K, M);
  if (err == cudaSuccess && shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(ikpls2_op_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
  }
  int n = 0;
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kOpCluster * 1024, 1, 1);
    cfg.blockDim = dim3(kOpThreads, 1, 1);
    cfg.dynamicSmemBytes = shmem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kOpCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, ikpls2_op_kernel, &cfg);
  }
  *err_out = static_cast<int>(err);
  return err == cudaSuccess ? n : 0;
}

// Every fold's IKPLS #2 solve and weighted PRESS on formed fold matrices of
// any K, the whole card on the chunk: the rows' transpose, component 0's
// start, then a product and a step a component (2 A + 2 launches, in
// stream order). Returns a cudaError_t (0 on success).
extern "C" int cvm_ikpls2_wide_f64(
    const double* xtx, const double* xty, const double* xv, const double* yv,
    const double* wv, const double* mv, const double* x_mean,
    const double* x_std, const double* y_mean, const double* y_std,
    double* xst, double* part, double* g, double* pr, double* yhat,
    double* z, double* press, int64_t F, int64_t K, int64_t M, int64_t L,
    int64_t A, int64_t xtx_sf, int64_t xtx_sr, int64_t xty_sf,
    int64_t xty_sr, int64_t x_mean_sf, int64_t x_std_sf, int64_t y_mean_sf,
    int64_t y_std_sf, int flags, int device, void* stream) {
  if (F <= 0 || A <= 0) return 0;
  const int64_t S = (K + kWideRows - 1) / kWideRows;
  const int64_t tiles = (K + kWideTile - 1) / kWideTile +
                        (L + kWideTile - 1) / kWideTile;
  if (K < 1 || M < 1 || M > kMaxM || L < 1 || F > 65535 || S > 65535 ||
      (K + kWideT - 1) / kWideT > 65535 || A > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shmem = static_cast<int>(sizeof(double) * kWideShmem);
  err = cudaFuncSetAttribute(ikpls2_wide_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  WideArgs a{xtx,    xty,    xv,        yv,       wv,        mv,
             x_mean, x_std,  y_mean,    y_std,    xst,       part,
             g,      pr,     yhat,      z,        press,     K,
             M,      L,      A,         S,        K + L,     xtx_sf,
             xtx_sr, xty_sf, xty_sr,    x_mean_sf, x_std_sf, y_mean_sf,
             y_std_sf, flags};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 prep((L + kWideT - 1) / kWideT, (K + kWideT - 1) / kWideT, F);
  ikpls2_wide_prep_kernel<<<prep, dim3(kWideT, 8), 0, st>>>(a);
  const unsigned steps = static_cast<unsigned>(F * kWideCluster);
  ikpls2_wide_step_kernel<<<steps, kStepThreads, shmem, st>>>(a, -1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(S),
                  static_cast<unsigned>(F));
  for (int c = 0; c < A; ++c) {
    ikpls2_wide_product_kernel<<<grid, kWideThreads, 0, st>>>(a, c);
    ikpls2_wide_step_kernel<<<steps, kStepThreads, shmem, st>>>(a, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// Every fold's IKPLS #2 solve and weighted PRESS with no fold matrix formed,
// folds of any L at any K, the whole card on the chunk: the prep, component
// 0's start, then a product, a correction and a step a component (3 A + 2
// launches, in stream order). Returns a cudaError_t (0 on success).
extern "C" int cvm_ikpls2_wide_op_f64(
    const double* xtx, const double* xty, const double* X, const double* Y,
    const double* wts, const double* sum_x, const double* sum_sq_x,
    const double* sum_y, const double* sum_sq_y, const double* sum_w,
    const int64_t* nnz, const int64_t* rows, const double* mask, double* vec,
    double* ystat, double* scal, double* g, double* yv, double* wv,
    double* colpart, double* rowpart, double* u, double* part, double* pr,
    double* yhat, double* z, double* press, int64_t F, int64_t K, int64_t M,
    int64_t L, int64_t A, int64_t ld_xtx, int64_t ld_xty, int64_t ld_x,
    int64_t ld_y, int64_t ld_w, int64_t ddof, double resolution, int flags,
    int device, void* stream) {
  if (F <= 0 || A <= 0) return 0;
  const int64_t S = (K + kWopStrip - 1) / kWopStrip;
  const int64_t NT = (K + kWopTile - 1) / kWopTile;
  if (K < 1 || M < 1 || M > kMaxM || L < 1 || F > 65535 ||
      S * NT + 4 * ((L + kWopRows) / kWopRows) > 0x7fffffff ||
      A > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = F == 1 ? 1 : (F == 2 ? 2 : 4);
  err = G == 1 ? wop_product_attr<1>()
               : (G == 2 ? wop_product_attr<2>() : wop_product_attr<4>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shmem = static_cast<int>(sizeof(double) * kWideShmem);
  err = cudaFuncSetAttribute(ikpls2_wide_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  WopArgs w{xtx,     xty,     X,    Y,      wts,  sum_x, sum_sq_x, sum_y,
            sum_sq_y, sum_w,  nnz,  rows,   mask, vec,   ystat,    scal,
            g,       yv,      wv,   colpart, rowpart, u,  part,     pr,
            F,       K,       M,    L,      A,    S,     NT,       ld_xtx,
            ld_xty,  ld_x,    ld_y, ld_w,   ddof, resolution, flags};
  // the step reads the folds' XTY from g (xty null), t and z from part as
  // one split, the rows' Y and weights gathered by the prep
  WideArgs a{nullptr, nullptr, nullptr, yv,      wv,    mask,  nullptr,
             nullptr, ystat,   ystat + M, nullptr, part, g,     pr,
             yhat,    z,       press,   K,       M,     L,     A,
             1,       K + L,   0,       0,       0,     0,     0,
             0,       2 * M,   2 * M,   flags};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 cols(static_cast<unsigned>((K + kWopThreads - 1) / kWopThreads),
                  static_cast<unsigned>(F));
  ikpls2_wide_op_prep_kernel<<<cols, kWopThreads, 0, st>>>(w);
  const unsigned steps = static_cast<unsigned>(F * kWideCluster);
  ikpls2_wide_step_kernel<<<steps, kStepThreads, shmem, st>>>(a, -1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = 0; c < A; ++c) {
    if (G == 1) {
      wop_product<1>(w, c, st);
    } else if (G == 2) {
      wop_product<2>(w, c, st);
    } else {
      wop_product<4>(w, c, st);
    }
    ikpls2_wide_op_correct_kernel<<<cols, kWopThreads, 0, st>>>(w);
    ikpls2_wide_step_kernel<<<steps, kStepThreads, shmem, st>>>(a, c);
  }
  return static_cast<int>(cudaGetLastError());
}
