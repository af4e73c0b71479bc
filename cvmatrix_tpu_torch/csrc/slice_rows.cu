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
// What bounds it: each element reads 8 bytes and writes n_slices bytes, so
// device-memory traffic bounds it (0.9 GB, 0.27 ms at 3.35 TB/s for
// 100,000 x 500 elements and 10 slices); each round also takes three
// conversions (two rintf, one float-to-int), which Hopper issues at a
// quarter of its float32 rate, so the conversions come close to that bound.
//
// Design: a 2-D grid, blockIdx.x over bands of rows and blockIdx.y over
// groups of columns, so a thread's row and columns come without a division.
// Each thread takes kG = 4 adjacent columns of one row: one 16-byte load of
// xh, of xl and of each pows row, all four elements' rounds in registers,
// and each slice stored as one 4-byte word (coalesced: a warp writes 128
// contiguous bytes a slice). That needs K % 4 == 0 and aligned planes; any
// other shape (a ragged K, offset views of the planes) takes the same
// kernel's scalar path, element by element. The planes are read once, so
// they are loaded with the evict-first hint, and the slices stored with it.
//
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// slice_rows.py); the entry launches on the caller's stream and returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 4;                 // columns a thread
constexpr float kSliceScale = 64.0f;  // 2^6: one slice's bits

// One round of the slicer on a scaled pair (r_h, r_l): its slice, and the
// pair carried to the next round.
__device__ __forceinline__ int slice_round(float& r_h, float& r_l) {
  r_h = __fmul_rn(r_h, kSliceScale);
  r_l = __fmul_rn(r_l, kSliceScale);
  const float q0 = rintf(r_h);
  const float adj = rintf(__fadd_rn(__fsub_rn(r_h, q0), r_l));
  const int v = static_cast<int>(__fadd_rn(q0, adj));
  // two_sum(a, r_l): a + r_l == t + err exactly
  const float a = __fsub_rn(__fsub_rn(r_h, q0), adj);
  const float t = __fadd_rn(a, r_l);
  const float bb = __fsub_rn(t, a);
  const float err =
      __fadd_rn(__fsub_rn(a, __fsub_rn(t, bb)), __fsub_rn(r_l, bb));
  r_h = t;
  r_l = err;
  return v;
}

// Thread (x, y) of block (bx, by) slices row bx blockDim.y + y, columns
// (by blockDim.x + x) kG .. + kG. kVec: 16-byte loads and 4-byte stores
// (K % kG == 0, the planes and pows 16-byte aligned, out 4-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
slice_rows_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                  const float* __restrict__ pows, int8_t* __restrict__ out,
                  int64_t N, int64_t K, int n_slices, bool row_major) {
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int64_t k0 =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * kG;
  if (n >= N || k0 >= K) return;
  const int64_t e = n * K + k0;
  float r_h[kG], r_l[kG];
  if constexpr (kVec) {
    const float4 h = __ldcs(reinterpret_cast<const float4*>(xh + e));
    const float4 l = __ldcs(reinterpret_cast<const float4*>(xl + e));
    const float4 p1 = __ldg(reinterpret_cast<const float4*>(pows + k0));
    const float4 p2 = __ldg(reinterpret_cast<const float4*>(pows + K + k0));
    const float hs[kG] = {h.x, h.y, h.z, h.w};
    const float ls[kG] = {l.x, l.y, l.z, l.w};
    const float p1s[kG] = {p1.x, p1.y, p1.z, p1.w};
    const float p2s[kG] = {p2.x, p2.y, p2.z, p2.w};
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      r_h[g] = __fmul_rn(__fmul_rn(hs[g], p1s[g]), p2s[g]);
      r_l[g] = __fmul_rn(__fmul_rn(ls[g], p1s[g]), p2s[g]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      r_h[g] = r_l[g] = 0.0f;
      if (k0 + g < K) {
        const float p1 = __ldg(pows + k0 + g);
        const float p2 = __ldg(pows + K + k0 + g);
        r_h[g] = __fmul_rn(__fmul_rn(__ldcs(xh + e + g), p1), p2);
        r_l[g] = __fmul_rn(__fmul_rn(__ldcs(xl + e + g), p1), p2);
      }
    }
  }
  // slice s of element (n, k0) lands at base + s * step
  const int64_t base = row_major ? n * n_slices * K + k0 : e;
  const int64_t step = row_major ? K : N * K;
  for (int s = 0; s < n_slices; ++s) {
    int v[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) v[g] = slice_round(r_h[g], r_l[g]);
    int8_t* o = out + base + s * step;
    if constexpr (kVec) {
      // the four int8 values, column k0 in the lowest byte
      const unsigned word = (static_cast<unsigned>(v[0]) & 0xffu) |
                            (static_cast<unsigned>(v[1]) & 0xffu) << 8 |
                            (static_cast<unsigned>(v[2]) & 0xffu) << 16 |
                            static_cast<unsigned>(v[3]) << 24;
      __stcs(reinterpret_cast<unsigned*>(o), word);
    } else {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (k0 + g < K) o[g] = static_cast<int8_t>(v[g]);
      }
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
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
  // Threads along a row's column groups (a multiple of 32 up to kThreads),
  // the rest of the block along the rows.
  const int64_t n_groups = (K + kG - 1) / kG;
  const int tx = static_cast<int>(
      n_groups < kThreads ? (n_groups + 31) / 32 * 32 : kThreads);
  const int ty = kThreads / tx;
  const int64_t gx = (N + ty - 1) / ty;
  const int64_t gy = (n_groups + tx - 1) / tx;
  if (gx > 0x7fffffff || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(tx, ty);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = K % kG == 0 && aligned(xh, 16) && aligned(xl, 16) &&
                   aligned(pows, 16) && aligned(out, 4);
  if (vec) {
    slice_rows_kernel<true><<<grid, block, 0, s>>>(xh, xl, pows, out, N, K,
                                                   n_slices, row_major != 0);
  } else {
    slice_rows_kernel<false><<<grid, block, 0, s>>>(xh, xl, pows, out, N, K,
                                                    n_slices, row_major != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
