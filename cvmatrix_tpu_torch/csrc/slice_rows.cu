// Mantissa slicer for Hopper (sm_90a): f32 (hi, lo) pair rows -> int8 slices.
//
// Replaces slice_rows of cvmatrix_tpu/ops/kernels.py (its math is
// _slice_rows_math). Each element x = xh + xl of an (N, K) pair of planes is
// scaled by the exact powers of two pows[0][k] pows[1][k] of its column, then
// cut into n_slices int8 slices of 6 bits each: per round both halves are
// multiplied by 64, q0 = round(r_h) (to nearest, ties to even), adj =
// round((r_h - q0) + r_l) corrects q0 by the pair's tail, q0 + adj is stored,
// and two_sum((r_h - q0) - adj, r_l) carries the rest exactly, so the slices
// stay within [-65, 65] and sum to the scaled pair within about
// 2^-(6 n_slices + 1).
//
// Layouts: row_major writes out[n][s][k] (N, S, K), else out[s][n][k]
// (S, N, K).
//
// Every f32 operation is the correctly rounded one, as in the JAX kernel:
// __fadd_rn, __fsub_rn and __fmul_rn are never contracted into FMAs, which
// nvcc otherwise does by default, and rintf rounds ties to even as
// jnp.round does (roundf would round them away from zero).
//
// What bounds it: each element reads 8 bytes and writes n_slices bytes for
// about 12 n_slices flops, so it is bound by device-memory traffic (0.9 GB,
// 0.27 ms at 3.35 TB/s for 100,000 x 500 elements and 10 slices). One thread
// per element, neighbouring threads on neighbouring columns, so every load
// and every slice's store is coalesced; the rounds run in registers. The
// TPU kernel's row blocks (block_rows) have no counterpart on the grid.
//
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// slice_rows.py); the entry launches on the caller's stream and returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSliceScale = 64.0f;  // 2^6: one slice's bits

__global__ void slice_rows_kernel(const float* __restrict__ xh,
                                  const float* __restrict__ xl,
                                  const float* __restrict__ pows,
                                  int8_t* __restrict__ out, int64_t N,
                                  int64_t K, int n_slices, bool row_major) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= N * K) return;
  const int64_t n = e / K;
  const int64_t k = e % K;
  const float p1 = __ldg(pows + k);
  const float p2 = __ldg(pows + K + k);
  float r_h = __fmul_rn(__fmul_rn(__ldg(xh + e), p1), p2);
  float r_l = __fmul_rn(__fmul_rn(__ldg(xl + e), p1), p2);
  // slice s of element (n, k) lands at base + s * step
  const int64_t base = row_major ? n * n_slices * K + k : e;
  const int64_t step = row_major ? K : N * K;
  for (int s = 0; s < n_slices; ++s) {
    r_h = __fmul_rn(r_h, kSliceScale);
    r_l = __fmul_rn(r_l, kSliceScale);
    const float q0 = rintf(r_h);
    const float adj = rintf(__fadd_rn(__fsub_rn(r_h, q0), r_l));
    out[base + s * step] =
        static_cast<int8_t>(static_cast<int>(__fadd_rn(q0, adj)));
    // two_sum(a, r_l): a + r_l == t + err exactly
    const float a = __fsub_rn(__fsub_rn(r_h, q0), adj);
    const float t = __fadd_rn(a, r_l);
    const float bb = __fsub_rn(t, a);
    const float err =
        __fadd_rn(__fsub_rn(a, __fsub_rn(t, bb)), __fsub_rn(r_l, bb));
    r_h = t;
    r_l = err;
  }
}

}  // namespace

// xh, xl (N, K) float32 planes, pows (2, K) float32, out int8 (N, S, K) if
// row_major else (S, N, K); all device pointers.
extern "C" int cvm_slice_rows_f32(const float* xh, const float* xl,
                                  const float* pows, int8_t* out, int64_t N,
                                  int64_t K, int n_slices, int row_major,
                                  int device, void* stream) {
  if (N <= 0 || K <= 0 || n_slices <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (N * K + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  slice_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xh, xl, pows, out, N, K, n_slices, row_major != 0);
  return static_cast<int>(cudaGetLastError());
}
