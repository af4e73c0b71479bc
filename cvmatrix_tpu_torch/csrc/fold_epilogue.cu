// Reference-form fold epilogue in float64 for Hopper (sm_90a), in place.
//
// Replaces the TPU kernel fused_epilogue_df64 (cvmatrix_tpu/ops/kernels.py),
// which applies, per fold f, to a downdate product computed outside it:
//
//   prod[f] <- (total - (prod[f] + p (x) q)) (.) (i1 (x) i2)      (K, C)
//
// with kvec[f] = [p, i1] (2, K) and cvec[f] = [q, i2] (2, C). The TPU kernel
// aliases its output to the product's buffer (input_output_aliases) so that
// a second (F, K, C) buffer is never allocated; this one writes in place for
// the same reason. The TPU kernel reads and writes f32 (hi, lo) pairs on
// padded tiles; here every value is float64 on the unpadded shape, each
// entry d = fma(p_i, q_j, prod_ij), then (total_ij - d) i1_i i2_j.
//
// What bounds it: it is elementwise, reading the product and writing it
// back (16 bytes per entry) and reading total (8 bytes per entry), so it is
// bound by device-memory traffic: 9.6 GB, 2.87 ms at 3.35 TB/s for one fold
// at K = 20,000, C = 20,001.
//
// Design: a column-stationary stream. A block owns a tile of one fold:
// kRows rows by a strip of up to 512 columns, threads along the columns,
// two adjacent columns a thread. Each thread reads its columns' q and i2
// into registers once, issues every row's product and total loads (and the
// row's p and i1) before its first store, so kRows x 32 bytes are in flight
// a thread, then stores and leaves: one row group a block, so the block
// scheduler keeps the loads of many short blocks in flight (blocks that
// walked bands of 8 to 64 rows, a group at a time, were slower at wide K,
// the more so the taller the band). The product is touched once, so it is
// loaded and stored with the evict-first hint (ld/st.global.cs), and total
// is streamed the same way.
//
// Alignment: C may be odd (C = K + 1 at M = 1), so only some rows start
// 16-byte aligned, and fold-offset views of the product shift every row.
// Each row takes 16-byte accesses where its product and total addresses
// allow (the choice is the same for every thread of the row, since each
// thread's first column is even), else two 8-byte ones.
//
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// fold_downdate.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a block, at most
constexpr int kRows = 4;        // rows a block, all in flight
constexpr int kMinBlocks = 3;   // blocks an SM: at most 80 registers

// Block b writes rows k0 .. k0 + kRows of fold f, columns c0 .. c0 + 2
// blockDim.x, where b = (f n_groups + k0 / kRows) n_strips + strip.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fold_epilogue_kernel(const double* __restrict__ total,
                     double* __restrict__ prod,
                     const double* __restrict__ kvec,
                     const double* __restrict__ cvec, int64_t K, int64_t C,
                     int64_t n_groups, int64_t n_strips) {
  const int64_t blk = blockIdx.x;
  const int64_t fg = blk / n_strips;
  const int64_t f = fg / n_groups;
  const int64_t k0 = fg % n_groups * kRows;
  const int64_t c =
      (blk % n_strips * blockDim.x + static_cast<int64_t>(threadIdx.x)) * 2;
  if (c >= C) return;  // no barrier below: a thread past the row leaves
  const bool pair = c + 1 < C;
  const double* kv = kvec + 2 * K * f;
  const double* cv = cvec + 2 * C * f;
  const double q0 = __ldg(cv + c);
  const double s0 = __ldg(cv + C + c);
  const double q1 = pair ? __ldg(cv + c + 1) : 0.0;
  const double s1 = pair ? __ldg(cv + C + c + 1) : 0.0;
  double* pf = prod + K * C * f + c;
  const double* tf = total + c;

  double2 pv[kRows], tv[kRows];
  double pk[kRows], ik[kRows];
  bool vec[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t k = k0 + r;
    vec[r] = false;
    if (k < K) {
      const double* pr = pf + k * C;
      const double* tr = tf + k * C;
      vec[r] = pair && ((reinterpret_cast<uintptr_t>(pr) |
                         reinterpret_cast<uintptr_t>(tr)) & 15) == 0;
      pk[r] = __ldg(kv + k);
      ik[r] = __ldg(kv + K + k);
      if (vec[r]) {
        pv[r] = __ldcs(reinterpret_cast<const double2*>(pr));
        tv[r] = __ldcs(reinterpret_cast<const double2*>(tr));
      } else {
        pv[r].x = __ldcs(pr);
        tv[r].x = __ldcs(tr);
        pv[r].y = pair ? __ldcs(pr + 1) : 0.0;
        tv[r].y = pair ? __ldcs(tr + 1) : 0.0;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t k = k0 + r;
    if (k >= K) break;
    double* pr = pf + k * C;
    double2 o;
    o.x = (tv[r].x - fma(pk[r], q0, pv[r].x)) * ik[r] * s0;
    o.y = (tv[r].y - fma(pk[r], q1, pv[r].y)) * ik[r] * s1;
    if (vec[r]) {
      __stcs(reinterpret_cast<double2*>(pr), o);
    } else {
      __stcs(pr, o.x);
      if (pair) __stcs(pr + 1, o.y);
    }
  }
}

}  // namespace

// In place over prod (F, K, C) on `stream`; all pointers are device
// pointers. Returns the cudaError_t of the launch (0 on success).
extern "C" int cvm_fold_epilogue_f64(
    const double* total, double* prod, const double* kvec,
    const double* cvec, int64_t F, int64_t K, int64_t C, int device,
    void* stream) {
  if (F <= 0 || K <= 0 || C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Threads along the columns, two columns each: a multiple of 32 up to
  // kThreads; wider rows take several strips.
  const int64_t n_pairs = (C + 1) / 2;
  const int threads = static_cast<int>(
      n_pairs < kThreads ? (n_pairs + 31) / 32 * 32 : kThreads);
  const int64_t n_strips = (n_pairs + threads - 1) / threads;
  const int64_t n_groups = (K + kRows - 1) / kRows;
  const int64_t blocks = F * n_groups * n_strips;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fold_epilogue_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      total, prod, kvec, cvec, K, C, n_groups, n_strips);
  return static_cast<int>(cudaGetLastError());
}
