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
// padded tiles; here every value is float64 on the unpadded shape.
//
// What bounds it: it is elementwise, reading the product and writing it
// back (16 bytes per element) and reading total from L2, so it is bound by
// device-memory traffic. Grid (F, ceil(K/8)): each block streams 8 output
// rows with threads along the columns, so each warp reads and writes 256
// contiguous bytes; the per-fold vectors come through the read-only cache
// (no shared-memory copy, so any C fits, wide K included).
//
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// fold_downdate.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void fold_epilogue_kernel(const double* __restrict__ total,
                                     double* __restrict__ prod,
                                     const double* __restrict__ kvec,
                                     const double* __restrict__ cvec,
                                     int64_t K, int64_t C) {
  const int64_t f = blockIdx.x;
  const double* kv = kvec + 2 * K * f;
  const double* cv = cvec + 2 * C * f;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t i1 = i0 + kRows < K ? i0 + kRows : K;
  for (int64_t i = i0; i < i1; ++i) {
    const double pi = __ldg(kv + i);
    const double si = __ldg(kv + K + i);
    const double* trow = total + i * C;
    double* row = prod + (f * K + i) * C;
    for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
      const double d = fma(pi, __ldg(cv + j), row[j]);
      row[j] = (__ldg(trow + j) - d) * si * __ldg(cv + C + j);
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
  const dim3 grid(static_cast<unsigned>(F),
                  static_cast<unsigned>((K + kRows - 1) / kRows));
  fold_epilogue_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      total, prod, kvec, cvec, K, C);
  return static_cast<int>(cudaGetLastError());
}
