// K-fold downdates in float64 and float32 for Hopper (sm_90a).
//
// Replaces seven TPU kernels of cvmatrix_tpu/ops/kernels.py, all of which
// compute, per fold f of L validation rows, the product
//
//   D[f] = Xv_w[f]^T [Xv_u[f] | Yv_u[f]]                          (K, C)
//
// and then an epilogue on the fold's (K, C) output:
//
//   cvm_fold_packed_f64       <- fused_downdate_df64_packed (factor form)
//   cvm_fold_packed_f32       <- fused_downdate_f32_packed  (factor form)
//       out = total (.) (i1 (x) i2) - (D + p (x) q),  D = sum_l u_l (x) v_l
//       over the prepared factor-scaled streams u (F, L, K), v (F, L, C).
//   cvm_fold_downdate_f32     <- fused_downdate (reference form)
//       out = ((total - D) - p (x) q) (.) (i1 (x) i2)
//       over the contiguous streams xv = Xv_w (F, L, K), weighted and
//       masked, and m2 = [Xv_u | Yv_u] (F, L, C), unweighted.
//   cvm_fold_ozaki_df64_f64   <- fused_ozaki_downdate_df64 (reference form)
//       out = (total - (D + p (x) q)) (.) (i1 (x) i2)
//       rows gathered by index: Xv_w = xw[rows] * mask, [xu | yu][rows].
//   cvm_fold_v3_f64           <- fused_ozaki_downdate_v3, and with sym
//                                set fused_ozaki_downdate_v3_sym
//       the reference form above, after a vector phase that derives the
//       fold's X-side vectors as the TPU kernel does (see below).
//   cvm_fold_smallfold_f64    <- fused_smallfold_df64 (and _f32 for the
//                                f32 engine's sources)
//       the same, after a vector phase that derives both sides' vectors
//       from the gathered rows alone (see below).
//
// kvec (F, 2, K) holds [p, i1] and cvec (F, 2, C) holds [q, i2]; p, q are
// zero without centring and i1, i2 one without scaling, so every epilogue
// applies all four and the tile kernels need no flags. The TPU kernels
// carry float64 as f32 pairs and form D from int8 mantissa slices on the
// MXU because the TPU has no float64; the H100 has, so D is accumulated
// here in the element type (float64 or float32) on the unpadded shape and
// each output is written once with row stride C. The reference form is
// evaluated in two orders: in float64 (total - fma(p, q, D)) i1 i2, in
// float32 fused_downdate's ((total - D) - p q)(i1 i2), since in float32 the
// two orders differ by a few ulps of total. Float32 products stay in
// float32 on FP32 FMA, never on TF32 tensor cores.
//
// Per fold the product costs 2 L K C flops and the output K C sizeof(T)
// bytes of writes: folds of a few rows are bound by the stores, folds of
// hundreds of rows by the product. Three tile kernels, one per kind of
// operand and bound:
//
//   gather_mma_kernel, the gathered float64 product on the FP64 tensor
//       cores: cvm_fold_ozaki_df64_f64, and cvm_fold_v3_f64 with and
//       without sym. FLOP-bound at L = 100-1,000, store-bound at L = 10.
//   stream_f32_kernel, the float32 stream product on FP32 FMA:
//       cvm_fold_downdate_f32 (L >= 32 by the routing gate). FLOP-bound.
//   rowstream_kernel, whole output rows from registers: cvm_fold_packed_f64/
//       _f32 and cvm_fold_smallfold_f64/_f32, folds of a few rows, bound by
//       the stores.
//
// The tensor-core tile (gather_mma_kernel). A CUDA-core tile reached
// 9-11 TFLOP/s on the FLOP-bound float64 chunks against 67 TFLOP/s for
// FP64 on the tensor cores, held back by synchronous staging, 4 FMAs per
// staged value and a 64-register cap. This one:
//   - forms D with mma.sync.aligned.m16n8k8 f64 (DMMA; wgmma has no f64
//     form). Of the four f64 shapes of sm_90 (m8n8k4, m16n8k4, m16n8k8,
//     m16n8k16), m16n8k8 was the fastest measured on the FLOP-bound chunks,
//     m16n8k4 close behind (PERF.md). Each warp holds a
//     32 x 32 piece of the tile: 2 x 4 fragments of 16 x 8, 4 doubles a
//     thread each, at the 128-register cap.
//   - uses 64 x 64 output tiles, 4 warps, 4 blocks an SM: measured faster
//     than 64 x 128 (2 blocks an SM), 128 x 128 (16 warps, 1 block) and
//     128 x 64 at all three fold sizes, although a 128 x 128 tile reads
//     twice the FLOPs a byte out of L2. More blocks an SM keep one block's
//     copies and stores in flight while another multiplies.
//   - stages 16-row slabs of the gathered rows with cp.async (16-byte copies
//     where K and M are even and every operand is 16-byte aligned, 8-byte
//     ones otherwise), three slabs in flight, so the next slabs arrive while
//     one is multiplied. Each copying thread serves one row of a slab and
//     reads that row's index for the next slab one slab ahead; the slab's
//     mask comes with it (8-byte copies). Rows past L and columns past K or
//     C are zero-filled by the copy (src-size 0), so ragged L, K and C need
//     no other case. Each staged row is padded by 4 doubles, so that the
//     lanes that read one fragment and the four rows they span fall on
//     distinct banks.
//   - applies the 0/1 mask to the A fragment as it leaves shared memory
//     (exact; padded rows carry mask 0 and zero data), only in the masked
//     instance.
//   - stages the finished accumulators through shared memory, 32 rows at a
//     time, and writes each output row piece coalesced with 16-byte
//     streaming stores (8-byte where C is odd), reading total from L2 in the
//     same pattern; blocks are numbered tile-major within a fold, so blocks
//     that run together write neighbouring pieces of the same rows.
//   - symmetric v3 (sym): each fold's X block is symmetric up to rounding,
//     so only the tiles with tile row <= tile column are launched, numbered
//     row by row (tile row ti holds tile columns ti .. n_ct - 1; C >= K), 36
//     of 64 at K=500, M=10; every tile that holds XTY columns is among them.
//     Each tile runs the full tile's MMA sequence over the same slabs, so a
//     stored upper entry is the full tile's bit for bit. The epilogue
//     stages all 64 rows at once, and the finished values go back to the
//     staged rows; an upper tile's X columns are then also stored
//     transposed into the mirror tile, a warp writing 32 consecutive
//     doubles of one mirror row a step, read down a column of the staged
//     rows (an XOR swizzle of their column pairs keeps that read at 2 lanes
//     a bank and the fragment writes and row reads conflict-free). Staging
//     32 rows a pass with 8-byte mirror stores of 4 doubles a row was
//     measured slower at L = 10 than the CUDA-core tile it replaced. A
//     diagonal tile stores j >= i of its X part (element by element where a
//     16-byte pair straddles the diagonal) and mirrors j > i, so
//     out[f][j][i] = out[f][i][j] for i < j < K exactly. Where the product
//     bounds the kernel (L = 100) this cuts its work to 36/64; where the
//     stores do (L = 10) the bytes written stay the same.
// The product is summed over the rows in order, one FMA a row and output
// (as the row-stream tile and the twin's float64 torch.bmm); the epilogue
// is the float64 reference form.
//
// The float32 stream tile (stream_f32_kernel), the port of fused_downdate.
// A CUDA-core tile reached 17.7 TFLOP/s on it (67 TFLOP/s of FP32 FMA on
// the card): 16 FMAs a thread a row cost 8 scalar shared loads, so shared-
// memory issue bound its loop. This one:
//   - uses 128 x 128 output tiles, 256 threads, 8 x 8 accumulators a thread
//     (rows ty * 4 + i and 64 + ty * 4 + i, columns likewise from tx), read
//     from shared memory as float4: 64 FMAs for 4 shared loads a row. The
//     A loads of a warp are broadcasts, the B loads contiguous. 2 blocks an
//     SM at the 128-register cap.
//   - stages 16-row slabs of both streams with cp.async, three in flight,
//     16-byte copies where K and C are multiples of 4 and every operand is
//     16-byte aligned, 8-byte where they are even (m2 rows of C = 510
//     floats start 8-byte aligned), else 4-byte; one width for every copy,
//     load and store (the copies are about 1% of the instructions of a
//     slab's FMAs). Rows past L and columns past K or C are zero-filled.
//   - stages each 64-row half of the finished tile through shared memory
//     and writes each output row piece coalesced with streaming stores,
//     reading total from L2, in fused_downdate's order.
//   - splits each fold's L rows across S blocks when few folds leave the
//     SMs idle (P = 3: three folds of 33,334 rows are 48 tiles for 132
//     SMs). The caller picks S (ops/fold_downdate.downdate_f32_splits, a
//     function of F, K, C, L and the SM count) and passes an (S, F, K, C)
//     workspace: each block writes the raw partial product of its rows
//     there (kept in L2), and split_reduce_f32_kernel sums the S partials
//     in a fixed order and applies the epilogue. No atomics, so a call
//     gives the same bits every time.
//
// The row-stream tile (rowstream_kernel), for the packed and small-fold
// routes (L = 4 on the main path, L < 32 on any route): per fold it writes
// K C sizeof(T) bytes and reads L rows, so the stores bound it. It streams
// whole output rows, as the LOOCV kernel's tile phase does:
//   - a block writes 32 rows of one fold (a band of 256 V columns of them
//     where C is wider), threads along the columns, V elements each; blocks
//     are numbered row band by row band within a fold. A warp's store
//     covers 32 V consecutive elements of one row (512 bytes at V = 2 in
//     float64), so only a row's first and last sector are shared, with the
//     same block's next row.
//   - each thread sums a[l][k] b[l][c] for a group of rows at a time in
//     registers, over the fold's rows in order (one FMA a row, from 0): b is
//     read once a group from L1/L2, a (the band's rows) is staged once in
//     shared memory, 32 fold rows a slab (restaged a group only where
//     L > 32), and read as a broadcast.
//   - V is the widest of 16 bytes, 8 (float32) and one element that C
//     (and where gathered K and M) and the alignment of total, b, yb, cvec
//     and out allow, so fold-offset views of a batch take narrower stores;
//     rows of C = 510 floats start 8-byte aligned, so the float32 main path
//     stores 8 bytes a thread (256 bytes a warp).
//   - total is read along the rows, V wide, from L2 (2 MB in float64).
//   - each block's first loads (indices, then gathered rows, then total)
//     wait on memory, so the blocks in flight set the rate: float32 keeps 8
//     rows in registers at a 64-register cap (4 blocks an SM), float64 4
//     rows at 80 (3 blocks), both without spills. Without a cap the
//     compiler took more registers and the chunks took longer; 8 float64
//     rows under 64 registers spill.
// Measured against it on the main path's chunks, in variant builds that
// are not kept: 8 and 16 rows a block (slower), 64 (no faster), the other
// register rules, and 1-D bulk copies (cp.async.bulk) of each row group
// staged in shared memory in place of the threads' stores (slower at every
// chunk).
//
// v3's vector phase (grid F) runs before its tile and forms, per fold
// and X column j, the weighted squared sum sum_l mask xw xu of the gathered
// rows (the X-block diagonal of D, which the TPU kernel reads off its
// product), then the downdated mean
// (g_sum - sxv) / sw, the clamped reciprocal std, p = sw mX, q = [mX | the
// Y part of yvec], i1 = r1 and i2 = [r1 | the Y part of yvec], into kvec
// and cvec scratch that the tile phase then reads.
//
// The small-fold vector phase (grid F; the TPU kernel accumulates the same
// sums in VMEM scratch over an (F, L) grid and finalises on the last row)
// forms, per column of either side, sum_l m xw and sum_l m xw xu over the
// fold's L gathered rows (yw, yu on the Y side; m the row mask), then the
// downdated means, the clamped reciprocal stds, p = sw mX, q = [mX or 0 |
// mY or 0] and i1, i2 into kvec and cvec. The TPU kernel's padded Y columns
// get i2 = 1 from zero global sums through the std clamp; the unpadded
// kernel writes the 1 itself (r stays 1 on a side that is not scaled). The
// tile phase is the row-stream tile's gathered reference form, templated on
// T: a float32 batch runs in float32. Per fold it writes the same K C
// sizeof(T) bytes as the packed kernel and reads L rows twice, so
// at L = 4 it is bound by the stores like the packed route, which reads
// prepared streams instead of gathering.
//
// Rows are int64 and range-checked on the host before any launch.
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// fold_downdate.py); every entry launches on the caller's stream and
// returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecThreads = 256;

constexpr int kCenterXTX = 1;
constexpr int kCenterXTY = 2;
constexpr int kScaleX = 4;
constexpr int kScaleY = 8;
constexpr int kWithY = 16;

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }

// Downdated mean and clamped reciprocal std of one column from the fold's
// weighted sum s and weighted squared sum sq (core/fold._train_std); the
// mean stays 0 and the reciprocal std 1 where they are not needed.
template <typename T>
__device__ __forceinline__ void column_stats(
    T g_sum, T g_sq, T s, T sq, T sw, T rsw, T rdv, bool need_mean,
    bool need_std, T resolution, T* mean, T* recip) {
  T m = T(0);
  T r = T(1);
  if (need_mean || need_std) {
    const T st = g_sum - s;
    m = st * rsw;
    if (need_std) {
      const T ss = g_sq - sq;
      const T var = (T(-2) * m * st + sw * (m * m) + ss) * rdv;
      // NaN propagates, as in torch.clamp and the JAX kernel.
      const T sd = sqrt_t(var < T(0) ? T(0) : var);
      r = sd <= resolution ? T(1) : T(1) / sd;
    }
  }
  *mean = m;
  *recip = r;
}

template <typename T>
struct TileArgs {
  const T* total;       // (K, C)
  const T* a;           // streams: u (F, L, K);  gather: xw (N, K)
  const T* b;           // streams: v (F, L, C);  gather: xu (N, K)
                        // or null
  const T* yb;          // gather: yu (N, M) or null
  const int64_t* rows;  // gather: (F, L)
  const T* mask;        // gather: (F, L) or null
  const T* kvec;        // (F, 2, K): [p, i1]
  const T* cvec;        // (F, 2, C): [q, i2]
  T* out;               // (F, K, C)
  int64_t L, K, C, KX, M;
};

// ---- the store-bound row-stream tile (packed and small-fold entries) -----

// The row-stream tile's shape: a block writes kRowBand whole rows of one
// fold (a band of up to kRowThreads V columns of them where C is wider),
// RowShape::kRegRows rows at a time from registers, under a register cap
// of RowShape::kMinBlocks blocks an SM; the fold's rows are staged kRowSlab
// at a time; the fastest shape measured without spills (see the file's
// comment).
constexpr int kRowBand = 32;
constexpr int kRowThreads = 256;
constexpr int kRowSlab = 32;

// Float32 keeps 8 rows in registers (4 at 16-byte vectors) at 64 registers,
// 4 blocks an SM; float64 keeps 4 at 80 registers, 3 blocks an SM.
template <typename T, int V>
struct RowShape {
  static constexpr int kRegRows = sizeof(T) == sizeof(float) && V <= 2 ? 8 : 4;
  static constexpr int kMinBlocks = sizeof(T) == sizeof(float) ? 4 : 3;
  static_assert(kRowBand % kRegRows == 0, "whole register row groups");
};

// V elements of T as one load or store.
template <typename T, int V>
struct Vec;
template <>
struct Vec<double, 1> {
  using type = double;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};
template <>
struct Vec<float, 1> {
  using type = float;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};

template <int V, typename T>
__device__ __forceinline__ void unpack_v(T (&d)[V],
                                        const typename Vec<T, V>::type v) {
  if constexpr (V == 1) {
    d[0] = v;
  } else if constexpr (V == 2) {
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  }
}

// V elements from shared memory, and through the read-only path.
template <int V, typename T>
__device__ __forceinline__ void load_v(T (&d)[V], const T* src) {
  unpack_v<V, T>(d, *reinterpret_cast<const typename Vec<T, V>::type*>(src));
}

template <int V, typename T>
__device__ __forceinline__ void ldg_v(T (&d)[V], const T* src) {
  unpack_v<V, T>(d,
                 __ldg(reinterpret_cast<const typename Vec<T, V>::type*>(src)));
}

template <int V, typename T>
__device__ __forceinline__ typename Vec<T, V>::type pack_v(const T (&d)[V]) {
  typename Vec<T, V>::type v;
  if constexpr (V == 1) {
    v = d[0];
  } else if constexpr (V == 2) {
    v.x = d[0], v.y = d[1];
  } else {
    v.x = d[0], v.y = d[1], v.z = d[2], v.w = d[3];
  }
  return v;
}

// One output from its product sum d: the factor form, or the reference
// form in its dtype's order (see the file's comment).
template <typename T, bool kRefForm>
__device__ __forceinline__ T fold_value(T t, T d, T pk, T q, T i1, T i2) {
  if constexpr (!kRefForm) {
    return t * (i1 * i2) - fma_t(pk, q, d);
  } else if constexpr (sizeof(T) == sizeof(double)) {
    return (t - fma_t(pk, q, d)) * i1 * i2;
  } else {
    return ((t - d) - pk * q) * (i1 * i2);
  }
}

// Block b writes rows k0 .. k0 + kRowBand of fold f, columns c0 .. c0 +
// blockDim.x V of them, where b = (f n_bands + band) n_cb + column band, so
// blocks that run together write neighbouring rows of one fold. Thread t
// takes columns c0 + t V .. + V: for RowShape::kRegRows rows at a time it
// sums a[l][k] b[l][c] over the fold's rows in order (one FMA a row, from 0),
// then stores the epilogue's values V wide with an evict-first hint.
// kGather: rows gathered by index, a = xw[row] mask and
// b = [xu | yu][row] (else the streams a = u, b = v); kRefForm: the
// reference-form epilogue (else the factor form). V: elements a load and
// store (C, and where gathered K and M, multiples of V; total, b, yb, cvec
// and out V-aligned).
template <typename T, bool kGather, bool kRefForm, int V>
__global__ void __launch_bounds__(kRowThreads, RowShape<T, V>::kMinBlocks)
rowstream_kernel(const TileArgs<T> p, int64_t n_bands, int64_t n_cb) {
  constexpr int R = RowShape<T, V>::kRegRows;
  __shared__ T sa[kRowSlab][kRowBand];
  __shared__ int64_t srow[kRowSlab];

  const int64_t blk = blockIdx.x;
  const int64_t f = blk / n_cb / n_bands;
  const int64_t k0 = blk / n_cb % n_bands * kRowBand;
  const int64_t c0 = blk % n_cb * blockDim.x * V;
  const int64_t L = p.L, K = p.K, C = p.C;
  const int tid = threadIdx.x;
  const int64_t c = c0 + static_cast<int64_t>(tid) * V;
  const bool col_live = c < C;
  const int nb = static_cast<int>(K - k0 < kRowBand ? K - k0 : kRowBand);
  const T* kv = p.kvec + 2 * K * f;
  T* of = p.out + K * C * f;
  // the thread's column of b: row l at bcol + l bld (the row's index where
  // gathered, l counted from the fold's first row in the streams)
  const T* bcol = !kGather ? p.b + L * C * f + c
                           : c < p.KX ? p.b + c : p.yb + (c - p.KX);
  const int64_t bld = !kGather ? C : c < p.KX ? K : p.M;
  T q[V], i2[V];
  if (col_live) {
    ldg_v<V>(q, p.cvec + 2 * C * f + c);
    ldg_v<V>(i2, p.cvec + 2 * C * f + C + c);
  }
  const bool one_slab = L <= kRowSlab;  // staged once for the whole band

  for (int g = 0; g < nb; g += R) {
    T acc[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = T(0);
    for (int64_t l0 = 0; l0 < L; l0 += kRowSlab) {
      const int nl = static_cast<int>(L - l0 < kRowSlab ? L - l0 : kRowSlab);
      if (g == 0 || !one_slab) {
        if (g > 0 || l0 > 0) __syncthreads();  // the last slab is read
        // fold rows l0 .. l0 + nl: a of the band's rows into sa (zero past
        // K), and where gathered their indices into srow
        for (int e = tid; e < nl * kRowBand; e += blockDim.x) {
          const int li = e / kRowBand;
          const int r = e % kRowBand;
          const int64_t fl = f * L + l0 + li;
          T va = T(0);
          if constexpr (kGather) {
            const int64_t row = __ldg(p.rows + fl);
            if (r == 0) srow[li] = row;
            if (r < nb) {
              va = __ldg(p.a + row * K + k0 + r) *
                   (p.mask ? __ldg(p.mask + fl) : T(1));
            }
          } else if (r < nb) {
            va = __ldg(p.a + fl * K + k0 + r);
          }
          sa[li][r] = va;
        }
        __syncthreads();
      }
      if (!col_live) continue;
#pragma unroll 4
      for (int li = 0; li < nl; ++li) {
        T bv[V];
        ldg_v<V>(bv, bcol + (kGather ? srow[li] : l0 + li) * bld);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T av = sa[li][g + r];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fma_t(av, bv[v], acc[r][v]);
        }
      }
    }

    const int nr = nb - g < R ? nb - g : R;  // live rows of the group
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr || !col_live) break;
      const int64_t k = k0 + g + r;
      const T pk = __ldg(kv + k);
      const T i1 = __ldg(kv + K + k);
      T val[V];
      ldg_v<V>(val, p.total + k * C + c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        val[v] = fold_value<T, kRefForm>(val[v], acc[r][v], pk, q[v], i1,
                                         i2[v]);
      }
      __stcs(reinterpret_cast<typename Vec<T, V>::type*>(of + k * C + c),
             pack_v<V>(val));
    }
  }
}

// ---- the gathered float64 tile on the FP64 tensor cores ------------------

// The tensor-core tile's shape: 64 x 64 outputs a block, 16-row slabs,
// three in flight (the fastest measured; PERF.md).
constexpr int kMmaTileM = 64;   // output tile height (K), a multiple of 32
constexpr int kMmaTileN = 64;   // output tile width (C), a multiple of 32
constexpr int kMmaSlab = 16;    // gathered rows per cp.async slab
constexpr int kMmaStages = 3;   // slabs in flight
constexpr int kMmaWarpTile = 32;  // each warp holds 32 x 32 outputs
constexpr int kMmaThreads = kMmaTileM * kMmaTileN / kMmaWarpTile;
constexpr int kMmaPad = 4;        // doubles of padding per staged row
constexpr int kMmaOutLd = kMmaTileN + 8;  // row stride of the staged output
// A slab: BK rows of A (tile height + pad), of B (width + pad), the mask.
constexpr int kMmaSlabDoubles =
    kMmaSlab * (kMmaTileM + kMmaPad + kMmaTileN + kMmaPad + 1);
constexpr size_t kMmaSmemBytes =
    sizeof(double) * kMmaStages * kMmaSlabDoubles;
// 32 x 32 warp tiles need about 120 registers a thread: cap at 128.
constexpr int kMmaMinBlocks = 65536 / (kMmaThreads * 128);

// cp.async of one 16-, 8- or 4-byte piece; src-size 0 writes zeros and
// reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// mma.sync.aligned.m16n8k8 f64, D += A B over one 16 x 8 x 8 step
// (lane = 4 g + t): A holds A[g + 8 (r % 2)][t + 4 (r / 2)], r < 4; B holds
// B[t + 4 r][g], r < 2; D holds D[g + 8 (r / 2)][2 t + r % 2], r < 4.
struct Dmma {
  static constexpr int kM = 16, kK = 8, kA = 4, kB = 2, kC = 4;
  __device__ __forceinline__ static void run(double (&d)[kC],
                                             const double (&a)[kA],
                                             const double (&b)[kB]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

// Block b computes tile t = b % n_tiles of fold f = b / n_tiles in the
// float64 reference form: tiles row-major, kMmaTileM x kMmaTileN each, or
// with kSym only those on or above the diagonal, row by row, with the X
// columns mirrored (see the file's comment). kVec: 16-byte copies, loads
// and stores (K, M even and every operand 16-byte aligned), else 8-byte
// ones; kMasked: the rows carry a 0/1 mask.
template <bool kVec, bool kMasked, bool kSym>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
gather_mma_kernel(const TileArgs<double> p, int64_t n_ct, int64_t n_tiles) {
  constexpr int BM = kMmaTileM;
  constexpr int BN = kMmaTileN;
  constexpr int BK = kMmaSlab;
  constexpr int LDA = BM + kMmaPad;
  constexpr int LDB = BN + kMmaPad;
  constexpr int kWarpsN = BN / kMmaWarpTile;
  using Op = Dmma;
  constexpr int FM = kMmaWarpTile / Op::kM;  // fragments along k
  constexpr int FN = kMmaWarpTile / 8;       // fragments along c
  constexpr int V = kVec ? 2 : 1;  // doubles per copy, load and store
  constexpr int kAPieces = BM / V;
  constexpr int kPieces = kAPieces + BN / V;
  static_assert(BM % kMmaWarpTile == 0 && BN % kMmaWarpTile == 0,
                "whole warp tiles");
  static_assert(BK % Op::kK == 0, "a slab holds whole MMA steps");
  static_assert(kMmaStages * kMmaSlabDoubles >= kMmaWarpTile * kMmaOutLd,
                "a staged row of warp tiles must fit the slab buffers");
  static_assert(!kSym || BM == BN, "the mirror of a tile is a tile");

  extern __shared__ __align__(16) unsigned char smem[];
  double* slabs = reinterpret_cast<double*>(smem);

  const int64_t f = blockIdx.x / n_tiles;
  int64_t t = blockIdx.x % n_tiles;
  int64_t ti, tj;
  if constexpr (kSym) {
    ti = 0;
    while (t >= n_ct - ti) {
      t -= n_ct - ti;
      ++ti;
    }
    tj = ti + t;
  } else {
    ti = t / n_ct;
    tj = t % n_ct;
  }
  const int64_t k0 = ti * BM;
  const int64_t c0 = tj * BN;
  const bool diagonal = kSym && ti == tj;
  const int64_t L = p.L, K = p.K, C = p.C, KX = p.KX, M = p.M;
  const int64_t* rows = p.rows + f * L;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / kWarpsN;  // warp row: k0 + 32 wm
  const int wn = warp % kWarpsN;  // warp column: c0 + 32 wn
  const int g = lane >> 2;
  const int tq = lane & 3;

  double acc[FM][FN][Op::kC];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int r = 0; r < Op::kC; ++r) acc[i][j][r] = 0.0;

  // Slab s: rows 16 s .. +16 of the fold, A = xw[row][k0 ..], B = [xu |
  // yu][row][c0 ..] and the rows' mask, into buffer s % kMmaStages. Each
  // thread copies pieces of one row; it reads the index of its row in the
  // next slab through L1 one slab ahead (slabs are issued in order).
  constexpr int kRowThreads = kMmaThreads / BK;
  constexpr int kThreadPieces = kPieces / kRowThreads;
  static_assert(kMmaThreads % BK == 0 && kPieces % kRowThreads == 0,
                "whole rows a thread group");
  const int li = tid / kRowThreads;
  const int lp = tid % kRowThreads;
  int64_t r_next = li < L ? __ldg(rows + li) : 0;
  auto issue = [&](int s) {
    double* sa = slabs + (s % kMmaStages) * kMmaSlabDoubles;
    double* sb = sa + BK * LDA;
    const int64_t l = static_cast<int64_t>(s) * BK + li;
    const bool live_row = l < L;
    const int64_t r = r_next;
    r_next = l + BK < L ? __ldg(rows + l + BK) : 0;
#pragma unroll
    for (int i = 0; i < kThreadPieces; ++i) {
      const int pc = lp + i * kRowThreads;
      const double* src = p.total;  // any valid address when not live
      double* dst;
      bool live;
      if (pc < kAPieces) {
        const int64_t col = k0 + pc * V;
        live = live_row && col < K;
        if (live) src = p.a + r * K + col;
        dst = sa + li * LDA + pc * V;
      } else {
        const int64_t col = c0 + (pc - kAPieces) * V;
        live = live_row && col < C;
        if (live) {
          src = col < KX ? p.b + r * K + col : p.yb + r * M + (col - KX);
        }
        dst = sb + li * LDB + (pc - kAPieces) * V;
      }
      cp_async<V * 8>(dst, src, live);
    }
    if (kMasked && lp == 0) {
      cp_async<8>(sb + BK * LDB + li, live_row ? p.mask + f * L + l : p.total,
                  live_row);
    }
  };

  const int n_slabs = static_cast<int>((L + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_slabs) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // slab s landed; slab s - 1's buffer is free
    if (s + kMmaStages - 1 < n_slabs) issue(s + kMmaStages - 1);
    cp_async_commit();
    const double* sa = slabs + (s % kMmaStages) * kMmaSlabDoubles;
    const double* sb = sa + BK * LDA;
    const double* sm = sb + BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += Op::kK) {
      // The fold's last slab: no MMA step over rows past L (all zero).
      if (static_cast<int64_t>(s) * BK + kk >= L) break;
      constexpr int kQ = Op::kK / 4;  // 4-row groups in one MMA step
      double m[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) m[q] = kMasked ? sm[kk + tq + 4 * q] : 1.0;
      double b[FN][Op::kB];
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int r = 0; r < Op::kB; ++r)
          b[j][r] = sb[(kk + tq + 4 * r) * LDB + wn * 32 + j * 8 + g];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        double a[Op::kA];
#pragma unroll
        for (int r = 0; r < Op::kA; ++r) {
          const int q = r / 2;
          a[r] = sa[(kk + tq + 4 * q) * LDA + wm * 32 + i * Op::kM + g +
                    8 * (r % 2)];
          if (kMasked) a[r] *= m[q];
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) Op::run(acc[i][j], a, b[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the slab buffers

  // Epilogue, kStagedRows rows at a time: the accumulators to shared
  // memory, then coalesced row pieces out. The full tile stages one row of
  // warp tiles (32 rows, the warps of row wm = h) a pass, with the row
  // stride padded to kMmaOutLd. The symmetric tile stages all 64 rows at
  // once, unpadded, with each row's column pairs XOR-swizzled within groups
  // of 8 pairs by the row's last 3 bits (swz), so that the fragment writes
  // and the row reads fall on distinct banks and the mirror's reads down a
  // column on 2 lanes a bank. A thread keeps one column piece (the thread
  // count is a multiple of the pieces a row has), so it reads that piece's
  // q and i2 once.
  constexpr int kStagedRows = kSym ? BM : kMmaWarpTile;
  constexpr int kLd = kSym ? BN : kMmaOutLd;
  static_assert(kMmaStages * kMmaSlabDoubles >= kStagedRows * kLd,
                "the staged rows must fit the slab buffers");
  auto at = [](int row, int col) {  // (row, col) of the staged rows
    if constexpr (kSym) {
      const int swz = ((row & 1) << 2) | ((row >> 1) & 3);
      return row * kLd + (((col >> 1) ^ swz) << 1) + (col & 1);
    } else {
      return row * kLd + col;
    }
  };
  double* so = slabs;
  const double* kv = p.kvec + 2 * K * f;
  const double* cv = p.cvec + 2 * C * f;
  double* of = p.out + K * C * f;
  constexpr int kRowPieces = BN / V;
  constexpr int kRowsPerPass = kMmaThreads / kRowPieces;
  static_assert(kMmaThreads % kRowPieces == 0 &&
                    kStagedRows % kRowsPerPass == 0,
                "whole rows a pass");
  const int cc = (tid % kRowPieces) * V;
  const int64_t c = c0 + cc;
  const bool col_live = c < C;
  // kSym: the tile holds X columns, so its X part is mirrored.
  const bool mirror = kSym && c0 < K;
  double q[V], i2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    q[v] = col_live ? __ldg(cv + c + v) : 0.0;
    i2[v] = col_live ? __ldg(cv + C + c + v) : 0.0;
  }
#pragma unroll
  for (int h = 0; h < BM / kStagedRows; ++h) {
    if (wm * kMmaWarpTile / kStagedRows == h) {
      const int row0 = wm * kMmaWarpTile - h * kStagedRows;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < Op::kC; r += 2) {
            double* d = so + at(row0 + i * Op::kM + g + 8 * (r / 2),
                                wn * 32 + j * 8 + 2 * tq);
            *reinterpret_cast<double2*>(d) =
                make_double2(acc[i][j][r], acc[i][j][r + 1]);
          }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kStagedRows / kRowsPerPass; ++it) {
      const int r = tid / kRowPieces + it * kRowsPerPass;
      const int64_t k = k0 + h * kStagedRows + r;
      if (!col_live || k >= K) continue;
      const double pk = __ldg(kv + k);
      const double i1 = __ldg(kv + K + k);
      double* d = so + at(r, cc);
      // A diagonal tile's X part below the diagonal is the mirror's
      // (k < K here, so c + v < k means an X column).
      const bool store0 = !(diagonal && c < k);
      if constexpr (kVec) {
        const double2 tt =
            __ldg(reinterpret_cast<const double2*>(p.total + k * C + c));
        const double2 v = *reinterpret_cast<const double2*>(d);
        const double2 val =
            make_double2((tt.x - fma(pk, q[0], v.x)) * i1 * i2[0],
                         (tt.y - fma(pk, q[V - 1], v.y)) * i1 * i2[V - 1]);
        if (store0) {
          __stcs(reinterpret_cast<double2*>(of + k * C + c), val);
        } else if (!(diagonal && c + 1 < k)) {  // the pair straddles it
          __stcs(of + k * C + c + 1, val.y);
        }
        if (kSym) *reinterpret_cast<double2*>(d) = val;
      } else {
        const double tt = __ldg(p.total + k * C + c);
        const double val = (tt - fma(pk, q[0], *d)) * i1 * i2[0];
        if (store0) __stcs(of + k * C + c, val);
        if (kSym) *d = val;
      }
    }
    if (mirror) {
      __syncthreads();  // the tile's finished values are staged
      // out[c0 + a][k0 + b] = value(k0 + b, c0 + a) for the X columns
      // c0 + a right of the row; a warp writes 32 consecutive b of one
      // mirror row (256 bytes) a step.
      for (int e = tid; e < BN * kStagedRows; e += kMmaThreads) {
        const int a = e / kStagedRows;
        const int b = e % kStagedRows;
        const int64_t cm = c0 + a;  // source column = mirror row
        const int64_t km = k0 + h * kStagedRows + b;  // source row
        if (cm < K && km < cm) __stcs(of + cm * C + km, so[at(b, a)]);
      }
    }
    __syncthreads();  // the next pass overwrites the staged rows
  }
}

// ---- the float32 stream tile on FP32 FMA (fused_downdate) ---------------

// The float32 stream tile's shape: 128 x 128 outputs a block, 8 x 8 a
// thread, 16-row slabs three in flight, 2 blocks an SM.
constexpr int kF32Tile = 128;     // output tile edge (K and C)
constexpr int kF32Half = kF32Tile / 2;
constexpr int kF32Slab = 16;      // stream rows per cp.async slab
constexpr int kF32Stages = 3;     // slabs in flight
constexpr int kF32Threads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kF32BlocksPerSM = 2;  // caps registers at 128
constexpr int kF32SlabFloats = 2 * kF32Slab * kF32Tile;  // A and B rows
constexpr int kF32OutLd = kF32Tile + 4;  // row stride of a staged half
constexpr int kF32SmemFloats =
    kF32Stages * kF32SlabFloats > kF32Half * kF32OutLd
        ? kF32Stages * kF32SlabFloats
        : kF32Half * kF32OutLd;
constexpr size_t kF32SmemBytes = sizeof(float) * kF32SmemFloats;

struct F32Args {
  const float* total;  // (K, C)
  const float* xv;     // (F, L, K)
  const float* m2;     // (F, L, C)
  const float* kvec;   // (F, 2, K): [p, i1]
  const float* cvec;   // (F, 2, C): [q, i2]
  float* out;          // (F, K, C)
  float* work;         // (S, F, K, C) partial products, or null (S = 1)
  int64_t F, L, K, C;
  int64_t per;         // rows of a fold a split block multiplies
};

template <int V>
using VecF = Vec<float, V>;

// fused_downdate's epilogue, in its order.
__device__ __forceinline__ float downdate_f32(float t, float d, float pk,
                                              float q, float i1, float i2) {
  return ((t - d) - pk * q) * (i1 * i2);
}

// Block b computes tile t = b % n_tiles of fold f and split s, where
// b / n_tiles = s F + f (tiles row-major, 128 x 128 each): with kSplit the
// raw product of rows s per .. (s + 1) per of the fold into work[s][f],
// else the whole fold's product through the epilogue into out[f]. V: floats
// per copy, load and store (K and C multiples of V, operands aligned).
template <int V, bool kSplit>
__global__ void __launch_bounds__(kF32Threads, kF32BlocksPerSM)
stream_f32_kernel(const F32Args p, int64_t n_ct, int64_t n_tiles) {
  constexpr int BT = kF32Tile;
  constexpr int BK = kF32Slab;
  constexpr int kAPieces = BT / V;
  constexpr int kPieces = 2 * kAPieces;
  constexpr int kRowThreads = kF32Threads / BK;
  constexpr int kThreadPieces = kPieces / kRowThreads;
  static_assert(kF32Threads == 16 * 16 && BT == 2 * 4 * 16,
                "16 x 16 threads, 8 x 8 outputs each");
  static_assert(kF32Threads % BK == 0 && kPieces % kRowThreads == 0,
                "whole rows a thread group");

  extern __shared__ __align__(16) unsigned char smem[];
  float* slabs = reinterpret_cast<float*>(smem);

  const int64_t t = blockIdx.x % n_tiles;
  const int64_t sf = blockIdx.x / n_tiles;
  const int64_t f = sf % p.F;
  const int64_t s = sf / p.F;
  const int64_t k0 = (t / n_ct) * BT;
  const int64_t c0 = (t % n_ct) * BT;
  const int64_t L = p.L, K = p.K, C = p.C;
  const int64_t l_begin = kSplit ? s * p.per : 0;
  const int64_t l_end = kSplit ? (l_begin + p.per < L ? l_begin + p.per : L)
                               : L;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Slab s: rows l_begin + 16 s .. +16, A = xv[f][row][k0 ..], B =
  // m2[f][row][c0 ..], into buffer s % kF32Stages. Each thread copies
  // pieces of one row.
  const int li = tid / kRowThreads;
  const int lp = tid % kRowThreads;
  auto issue = [&](int si) {
    float* sa = slabs + (si % kF32Stages) * kF32SlabFloats;
    float* sb = sa + BK * BT;
    const int64_t l = l_begin + static_cast<int64_t>(si) * BK + li;
    const bool live_row = l < l_end;
    const float* arow = p.xv + (f * L + l) * K;
    const float* brow = p.m2 + (f * L + l) * C;
#pragma unroll
    for (int i = 0; i < kThreadPieces; ++i) {
      const int pc = lp + i * kRowThreads;
      const float* src = p.total;  // any valid address when not live
      float* dst;
      bool live;
      if (pc < kAPieces) {
        const int64_t col = k0 + pc * V;
        live = live_row && col < K;
        if (live) src = arow + col;
        dst = sa + li * BT + pc * V;
      } else {
        const int64_t col = c0 + (pc - kAPieces) * V;
        live = live_row && col < C;
        if (live) src = brow + col;
        dst = sb + li * BT + (pc - kAPieces) * V;
      }
      cp_async<V * 4>(dst, src, live);
    }
  };

  const int64_t n_rows = l_end > l_begin ? l_end - l_begin : 0;
  const int n_slabs = static_cast<int>((n_rows + BK - 1) / BK);
#pragma unroll
  for (int si = 0; si < kF32Stages - 1; ++si) {
    if (si < n_slabs) issue(si);
    cp_async_commit();
  }
  for (int si = 0; si < n_slabs; ++si) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // slab si landed; slab si - 1's buffer is free
    if (si + kF32Stages - 1 < n_slabs) issue(si + kF32Stages - 1);
    cp_async_commit();
    const float* sa = slabs + (si % kF32Stages) * kF32SlabFloats;
    const float* sb = sa + BK * BT;
    const int64_t live = n_rows - static_cast<int64_t>(si) * BK;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      if (r >= live) break;  // the last slab: rows past the end are zero
      const float4 a0 = *reinterpret_cast<const float4*>(sa + r * BT + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sa + r * BT + kF32Half + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + r * BT + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + r * BT + kF32Half + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the slab buffers

  // Epilogue, one 64-row half of the tile at a time (thread rows ty * 4 +
  // i, then 64 + ty * 4 + i): the accumulators to shared memory, then
  // coalesced row pieces out. A thread keeps one column piece, so it reads
  // that piece's q and i2 once.
  float* so = slabs;
  constexpr int kRowPieces = BT / V;
  constexpr int kRowsPerPass = kF32Threads / kRowPieces;
  static_assert(kF32Threads % kRowPieces == 0 &&
                    kF32Half % kRowsPerPass == 0,
                "whole rows a pass");
  const int cc = (tid % kRowPieces) * V;
  const int64_t c = c0 + cc;
  const bool col_live = c < C;
  const float* kv = p.kvec + 2 * K * f;
  float q[V], i2[V];
  if (!kSplit && col_live) {
    ldg_v<V>(q, p.cvec + 2 * C * f + c);
    ldg_v<V>(i2, p.cvec + 2 * C * f + C + c);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* d = so + (ty * 4 + i) * kF32OutLd + tx * 4;
      const int ai = 4 * h + i;
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[ai][0], acc[ai][1], acc[ai][2], acc[ai][3]);
      *reinterpret_cast<float4*>(d + kF32Half) =
          make_float4(acc[ai][4], acc[ai][5], acc[ai][6], acc[ai][7]);
    }
    __syncthreads();
#pragma unroll 4
    for (int it = 0; it < kF32Half / kRowsPerPass; ++it) {
      const int r = tid / kRowPieces + it * kRowsPerPass;
      const int64_t k = k0 + h * kF32Half + r;
      if (!col_live || k >= K) continue;
      float d[V];
      load_v<V>(d, so + r * kF32OutLd + cc);
      if constexpr (kSplit) {
        // kept in L2 for split_reduce_f32_kernel
        *reinterpret_cast<typename VecF<V>::type*>(
            p.work + ((s * p.F + f) * K + k) * C + c) = pack_v<V>(d);
      } else {
        const float pk = __ldg(kv + k);
        const float i1 = __ldg(kv + K + k);
        float tt[V];
        ldg_v<V>(tt, p.total + k * C + c);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          d[v] = downdate_f32(tt[v], d[v], pk, q[v], i1, i2[v]);
        }
        __stcs(reinterpret_cast<typename VecF<V>::type*>(
                   p.out + (f * K + k) * C + c),
               pack_v<V>(d));
      }
    }
    __syncthreads();  // the next half overwrites the staged rows
  }
}

// The split path's second kernel: out = the epilogue of the S partial
// products, summed in split order, V floats a thread.
template <int V>
__global__ void split_reduce_f32_kernel(const F32Args p, int64_t splits) {
  const int64_t K = p.K, C = p.C;
  const int64_t fkc = p.F * K * C;
  const int64_t n = fkc / V;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t o = e * V;
    const int64_t c = o % C;
    const int64_t k = (o / C) % K;
    const int64_t f = o / (K * C);
    float d[V], w[V], tt[V], q[V], i2[V];
    load_v<V>(d, p.work + o);
    for (int64_t s = 1; s < splits; ++s) {
      load_v<V>(w, p.work + s * fkc + o);
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] += w[v];
    }
    ldg_v<V>(tt, p.total + k * C + c);
    ldg_v<V>(q, p.cvec + 2 * C * f + c);
    ldg_v<V>(i2, p.cvec + 2 * C * f + C + c);
    const float pk = __ldg(p.kvec + 2 * K * f + k);
    const float i1 = __ldg(p.kvec + 2 * K * f + K + k);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      d[v] = downdate_f32(tt[v], d[v], pk, q[v], i1, i2[v]);
    }
    __stcs(reinterpret_cast<typename VecF<V>::type*>(p.out + o),
           pack_v<V>(d));
  }
}

struct V3Args {
  const double* xw;     // (N, K)
  const double* xu;     // (N, K)
  const int64_t* rows;  // (F, L)
  const double* mask;   // (F, L) or null
  const double* gx;     // (2, K): [sum_X, sum_sq_X]
  const double* sxv;    // (F, K): column sums of the fold's weighted rows
  const double* yvec;   // (F, 2, C): Y columns hold [q part, i2 part]
  const double* scal;   // (F, 3): [sw, 1/sw, 1/divisor]
  double* kvec;         // (F, 2, K) out
  double* cvec;         // (F, 2, C) out
  int64_t L, K, C;
  int flags;
  double resolution;
};

// v3 vector phase: block f writes kvec[f] and cvec[f].
__global__ void v3_vectors_kernel(const V3Args p) {
  const int64_t f = blockIdx.x;
  const int64_t L = p.L, K = p.K, C = p.C;
  const double sw = p.scal[3 * f];
  const double rsw = p.scal[3 * f + 1];
  const double rdv = p.scal[3 * f + 2];
  const bool center_xtx = p.flags & kCenterXTX;
  const bool with_y = p.flags & kWithY;
  const bool center_xty = with_y && (p.flags & kCenterXTY);
  const bool scale_x = p.flags & kScaleX;
  const bool scale = scale_x || (with_y && (p.flags & kScaleY));
  const bool center = center_xtx || center_xty;
  const int64_t* rows = p.rows + f * L;
  const double* mask = p.mask ? p.mask + f * L : nullptr;
  double* kv = p.kvec + 2 * K * f;
  double* cv = p.cvec + 2 * C * f;
  const double* yv = p.yvec + 2 * C * f;

  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    if (j < K) {
      double sq = 0.0;
      if (scale_x) {
        for (int64_t l = 0; l < L; ++l) {
          const int64_t row = rows[l];
          const double w = mask ? mask[l] : 1.0;
          sq = fma(__ldg(p.xw + row * K + j) * w, __ldg(p.xu + row * K + j),
                   sq);
        }
      }
      double m, r;
      column_stats(p.gx[j], p.gx[K + j], p.sxv[f * K + j], sq, sw, rsw, rdv,
                   center, scale_x, p.resolution, &m, &r);
      kv[j] = center ? sw * m : 0.0;
      kv[K + j] = r;
      cv[j] = center_xtx ? m : 0.0;
      cv[C + j] = r;
    } else {
      cv[j] = center_xty ? yv[j] : 0.0;
      cv[C + j] = scale ? yv[C + j] : 1.0;
    }
  }
}

template <typename T>
struct SmallfoldArgs {
  const T* xw;          // (N, K) weighted X rows (X when unweighted)
  const T* xu;          // (N, K) unweighted X rows
  const T* yu;          // (N, M) Y rows or null
  const T* yw;          // (N, M) weighted Y rows or null (may alias yu)
  const int64_t* rows;  // (F, L)
  const T* mask;        // (F, L) or null
  const T* gx;          // (2, K): [sum_X, sum_sq_X], zeros where unused
  const T* gy;          // (2, M): [sum_Y, sum_sq_Y] or null
  const T* scal;        // (F, 3): [sw, 1/sw, 1/divisor]
  T* kvec;              // (F, 2, K) out
  T* cvec;              // (F, 2, C) out
  int64_t L, K, M;
  int flags;
  T resolution;
};

// Small-fold vector phase: block f sums, per column, the fold's masked
// weighted rows and their products with the unweighted ones, on both sides,
// then writes kvec[f] = [p, i1] and cvec[f] = [q, i2]. The mask multiplies
// the weighted factor only; a masked-out slot (index 0 in a padded batch)
// adds exactly 0.
template <typename T>
__global__ void smallfold_vectors_kernel(const SmallfoldArgs<T> p) {
  const int64_t f = blockIdx.x;
  const int64_t L = p.L, K = p.K, M = p.M, C = K + M;
  const T sw = p.scal[3 * f];
  const T rsw = p.scal[3 * f + 1];
  const T rdv = p.scal[3 * f + 2];
  const bool center_xtx = p.flags & kCenterXTX;
  const bool with_y = p.flags & kWithY;
  const bool center_xty = with_y && (p.flags & kCenterXTY);
  const bool scale_x = p.flags & kScaleX;
  const bool scale_y = with_y && (p.flags & kScaleY);
  const bool center = center_xtx || center_xty;
  const int64_t* rows = p.rows + f * L;
  const T* mask = p.mask ? p.mask + f * L : nullptr;
  T* kv = p.kvec + 2 * K * f;
  T* cv = p.cvec + 2 * C * f;

  for (int64_t j = threadIdx.x; j < C; j += blockDim.x) {
    const bool x_col = j < K;
    const int64_t w = x_col ? K : M;  // row stride of this side
    const int64_t jj = x_col ? j : j - K;
    const T* wt = x_col ? p.xw : p.yw;
    const T* ut = x_col ? p.xu : p.yu;
    const T* g = x_col ? p.gx : p.gy;
    // The Y mean is needed where XTY is centred (center_X or center_Y).
    const bool need_mean = x_col ? center || scale_x : center_xty || scale_y;
    const bool need_std = x_col ? scale_x : scale_y;
    T s = T(0);
    T sq = T(0);
    if (need_mean || need_std) {
      for (int64_t l = 0; l < L; ++l) {
        const int64_t row = rows[l];
        const T a = __ldg(wt + row * w + jj) * (mask ? mask[l] : T(1));
        s += a;
        if (need_std) sq = fma_t(a, __ldg(ut + row * w + jj), sq);
      }
    }
    T m, r;
    column_stats(need_mean || need_std ? g[jj] : T(0),
                 need_std ? g[w + jj] : T(0), s, sq, sw, rsw, rdv, need_mean,
                 need_std, p.resolution, &m, &r);
    // r is 1 on a side that is not scaled: i1 and i2 need no other case.
    if (x_col) {
      kv[j] = center ? sw * m : T(0);
      kv[K + j] = r;
      cv[j] = center_xtx ? m : T(0);
    } else {
      cv[j] = center_xty ? m : T(0);
    }
    cv[C + j] = r;
  }
}

template <bool kVec, bool kMasked, bool kSym>
int launch_gather_mma_vm(const TileArgs<double>& a, int64_t F,
                         void* stream) {
  const int64_t n_ct = (a.C + kMmaTileN - 1) / kMmaTileN;
  const int64_t n_kt = (a.K + kMmaTileM - 1) / kMmaTileM;
  // kSym: tile rows ti < n_kt hold columns ti .. n_ct - 1 (C >= K).
  const int64_t n_tiles =
      kSym ? n_kt * n_ct - n_kt * (n_kt - 1) / 2 : n_ct * n_kt;
  if (F * n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mma_kernel<kVec, kMasked, kSym>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_mma_kernel<kVec, kMasked, kSym>
      <<<static_cast<unsigned>(F * n_tiles), kMmaThreads, kMmaSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(a, n_ct, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T, bool kGather, bool kRefForm, int V>
int launch_rowstream_v(const TileArgs<T>& a, int64_t F, cudaStream_t s) {
  // Threads along the columns: a multiple of 32 up to kRowThreads, V
  // columns each; wider rows take several column bands.
  const int64_t n_vec = a.C / V;
  const int threads = static_cast<int>(
      n_vec < kRowThreads ? (n_vec + 31) / 32 * 32 : kRowThreads);
  const int64_t n_cb = (n_vec + threads - 1) / threads;
  const int64_t n_bands = (a.K + kRowBand - 1) / kRowBand;
  if (F * n_bands * n_cb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rowstream_kernel<T, kGather, kRefForm, V>
      <<<static_cast<unsigned>(F * n_bands * n_cb), threads, 0, s>>>(
          a, n_bands, n_cb);
  return static_cast<int>(cudaGetLastError());
}

// The row-stream tile, V as wide as C (and where gathered K and M) and the
// alignment of total, b, yb, cvec and out allow: 16 bytes, else 8 (float32),
// else one element.
template <typename T, bool kGather, bool kRefForm>
int launch_rowstream(const TileArgs<T>& a, int64_t F, int device,
                     void* stream) {
  if (F <= 0 || a.K <= 0 || a.C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto fits = [&](int v) {
    const int bytes = v * static_cast<int>(sizeof(T));
    return a.C % v == 0 && (!kGather || (a.K % v == 0 && a.M % v == 0)) &&
           aligned(a.total, bytes) && aligned(a.b, bytes) &&
           aligned(a.yb, bytes) && aligned(a.cvec, bytes) &&
           aligned(a.out, bytes);
  };
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == sizeof(float)) {
    if (fits(4)) return launch_rowstream_v<T, kGather, kRefForm, 4>(a, F, st);
  }
  if (fits(2)) return launch_rowstream_v<T, kGather, kRefForm, 2>(a, F, st);
  return launch_rowstream_v<T, kGather, kRefForm, 1>(a, F, st);
}

// The tensor-core tile for a gathered reference-form batch (kSym: the
// symmetric v3 tiles, C >= K).
template <bool kSym>
int launch_gather_mma(const TileArgs<double>& a, int64_t F, int device,
                      void* stream) {
  if (F <= 0 || a.K <= 0 || a.C <= 0) return 0;
  if (kSym && a.C < a.K) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = a.K % 2 == 0 && a.M % 2 == 0 && aligned(a.total, 16) &&
                   aligned(a.a, 16) && aligned(a.b, 16) &&
                   aligned(a.yb, 16) && aligned(a.kvec, 16) &&
                   aligned(a.cvec, 16) && aligned(a.out, 16);
  if (vec) {
    return a.mask ? launch_gather_mma_vm<true, true, kSym>(a, F, stream)
                  : launch_gather_mma_vm<true, false, kSym>(a, F, stream);
  }
  return a.mask ? launch_gather_mma_vm<false, true, kSym>(a, F, stream)
                : launch_gather_mma_vm<false, false, kSym>(a, F, stream);
}

template <int V>
int launch_stream_f32_v(F32Args a, int64_t splits, cudaStream_t stream) {
  const int64_t n_ct = (a.C + kF32Tile - 1) / kF32Tile;
  const int64_t n_tiles = n_ct * ((a.K + kF32Tile - 1) / kF32Tile);
  if (splits * a.F * n_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(splits * a.F * n_tiles);
  const int smem = static_cast<int>(kF32SmemBytes);
  if (splits == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_f32_kernel<V, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    stream_f32_kernel<V, false>
        <<<blocks, kF32Threads, smem, stream>>>(a, n_ct, n_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  // Rows a split takes: whole slabs, the last split the rest.
  const int64_t per = (a.L + splits - 1) / splits;
  a.per = (per + kF32Slab - 1) / kF32Slab * kF32Slab;
  cudaError_t err = cudaFuncSetAttribute(
      stream_f32_kernel<V, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_f32_kernel<V, true>
      <<<blocks, kF32Threads, smem, stream>>>(a, n_ct, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = a.F * a.K * a.C / V;
  const int64_t grid = (n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536;
  split_reduce_f32_kernel<V>
      <<<static_cast<unsigned>(grid), 256, 0, stream>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}

// The float32 stream tile, in S = splits blocks a fold (work (S, F, K, C)
// when S > 1).
int launch_stream_f32(const F32Args& a, int64_t splits, int device,
                      void* stream) {
  if (a.F <= 0 || a.K <= 0 || a.C <= 0) return 0;
  if (splits < 1 || (splits > 1 && !a.work)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto fits = [&](int v) {
    const int bytes = 4 * v;
    return a.K % v == 0 && a.C % v == 0 && aligned(a.total, bytes) &&
           aligned(a.xv, bytes) && aligned(a.m2, bytes) &&
           aligned(a.cvec, bytes) && aligned(a.out, bytes) &&
           aligned(a.work, bytes);
  };
  const auto st = static_cast<cudaStream_t>(stream);
  if (fits(4)) return launch_stream_f32_v<4>(a, splits, st);
  if (fits(2)) return launch_stream_f32_v<2>(a, splits, st);
  return launch_stream_f32_v<1>(a, splits, st);
}

}  // namespace

// Factor-form downdate of the prepared streams (port of
// fused_downdate_df64_packed), on the row-stream tile: L = 4 at P = 25,000,
// bound by its stores. All pointers are device pointers.
extern "C" int cvm_fold_packed_f64(
    const double* total, const double* u, const double* v,
    const double* kvec, const double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t C, int device, void* stream) {
  TileArgs<double> a{total, u, v, nullptr, nullptr, nullptr, kvec, cvec,
                     out, L, K, C, 0, 0};
  return launch_rowstream<double, false, false>(a, F, device, stream);
}

// The same factor form in float32 (port of fused_downdate_f32_packed), on
// the row-stream tile in float32, likewise bound by its stores.
extern "C" int cvm_fold_packed_f32(
    const float* total, const float* u, const float* v, const float* kvec,
    const float* cvec, float* out, int64_t F, int64_t L, int64_t K,
    int64_t C, int device, void* stream) {
  TileArgs<float> a{total, u, v, nullptr, nullptr, nullptr, kvec, cvec, out,
                    L, K, C, 0, 0};
  return launch_rowstream<float, false, false>(a, F, device, stream);
}

// Reference-form downdate of the contiguous streams xv (F, L, K) and
// m2 (F, L, C) in float32 (port of fused_downdate); kvec = [a1, inv1],
// cvec = [mb, inv2]. Runs the float32 stream tile, FLOP-bound on FP32 FMA
// (folds of at least 32 rows): 8 x 8 outputs a thread from float4 shared
// loads and cp.async slabs. With splits > 1 each fold's rows are shared by
// that many blocks, whose partial products go to work (splits, F, K, C)
// and are summed by a second kernel; work may be null when splits is 1.
extern "C" int cvm_fold_downdate_f32(
    const float* total, const float* xv, const float* m2, const float* kvec,
    const float* cvec, float* out, float* work, int64_t F, int64_t L,
    int64_t K, int64_t C, int64_t splits, int device, void* stream) {
  F32Args a{total, xv, m2, kvec, cvec, out, work, F, L, K, C, L};
  return launch_stream_f32(a, splits, device, stream);
}

// Gathered product + reference-form epilogue (port of
// fused_ozaki_downdate_df64), on the tensor-core tile: FLOP-bound at
// L = 1,000. The product's right side is [xu | yu] with KX (K or 0) X
// columns and M Y columns; xu may be null when KX is 0, yu when M is 0;
// mask may be null.
extern "C" int cvm_fold_ozaki_df64_f64(
    const double* total, const double* xw, const double* xu,
    const double* yu, const int64_t* rows, const double* mask,
    const double* kvec, const double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t KX, int64_t M, int device, void* stream) {
  TileArgs<double> a{total, xw, xu, yu, rows, mask, kvec, cvec, out,
                     L, K, KX + M, KX, M};
  return launch_gather_mma<false>(a, F, device, stream);
}

// v3 (port of fused_ozaki_downdate_v3, and with sym != 0 of
// fused_ozaki_downdate_v3_sym): the vector phase into the caller's kvec
// (F, 2, K) and cvec (F, 2, K + M) scratch, then the tensor-core tile, all
// tiles or with sym the upper ones and the X block's mirror. FLOP-bound at
// L = 100 (P = 1,000), store-bound at L = 10 (P = 10,000). yu may be null
// when M is 0, mask may be null.
extern "C" int cvm_fold_v3_f64(
    const double* total, const double* xw, const double* xu,
    const double* yu, const int64_t* rows, const double* mask,
    const double* gx, const double* sxv, const double* yvec,
    const double* scal, double* kvec, double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t M, int flags, double resolution, int sym,
    int device, void* stream) {
  if (F <= 0 || K <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t C = K + M;
  V3Args v{xw, xu, rows, mask, gx, sxv, yvec, scal, kvec, cvec,
           L, K, C, flags, resolution};
  v3_vectors_kernel<<<static_cast<unsigned>(F), kVecThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  TileArgs<double> a{total, xw, xu, yu, rows, mask, kvec, cvec, out,
                     L, K, C, K, M};
  return sym ? launch_gather_mma<true>(a, F, device, stream)
             : launch_gather_mma<false>(a, F, device, stream);
}

namespace {

template <typename T>
int smallfold(const T* total, const T* xw, const T* xu, const T* yu,
              const T* yw, const int64_t* rows, const T* mask, const T* gx,
              const T* gy, const T* scal, T* kvec, T* cvec, T* out, int64_t F,
              int64_t L, int64_t K, int64_t M, int flags, double resolution,
              int device, void* stream) {
  if (F <= 0 || K <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SmallfoldArgs<T> v{xw, xu, yu, yw, rows, mask, gx, gy, scal, kvec, cvec,
                     L, K, M, flags, static_cast<T>(resolution)};
  smallfold_vectors_kernel<T><<<static_cast<unsigned>(F), kVecThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  TileArgs<T> a{total, xw, xu, yu, rows, mask, kvec, cvec, out,
                L, K, K + M, K, M};
  return launch_rowstream<T, true, true>(a, F, device, stream);
}

}  // namespace

// Masked multi-row LOOCV sources (port of fused_smallfold_df64): the
// small-fold vector phase into the caller's kvec (F, 2, K) and cvec
// (F, 2, K + M) scratch, then the row-stream tile's gathered reference form,
// bound by its stores at L = 4. yu, yw and gy may be null when M is 0, mask
// may be null.
extern "C" int cvm_fold_smallfold_f64(
    const double* total, const double* xw, const double* xu,
    const double* yu, const double* yw, const int64_t* rows,
    const double* mask, const double* gx, const double* gy,
    const double* scal, double* kvec, double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t M, int flags, double resolution,
    int device, void* stream) {
  return smallfold<double>(total, xw, xu, yu, yw, rows, mask, gx, gy, scal,
                           kvec, cvec, out, F, L, K, M, flags, resolution,
                           device, stream);
}

// The same in float32 (the JAX kernel on the f32 engine's (x, 0) pairs),
// computed in float32 on FP32 FMA.
extern "C" int cvm_fold_smallfold_f32(
    const float* total, const float* xw, const float* xu, const float* yu,
    const float* yw, const int64_t* rows, const float* mask, const float* gx,
    const float* gy, const float* scal, float* kvec, float* cvec, float* out,
    int64_t F, int64_t L, int64_t K, int64_t M, int flags, double resolution,
    int device, void* stream) {
  return smallfold<float>(total, xw, xu, yu, yw, rows, mask, gx, gy, scal,
                          kvec, cvec, out, F, L, K, M, flags, resolution,
                          device, stream);
}
