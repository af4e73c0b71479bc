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
// here in the element type T (float64 or float32) on the unpadded shape and
// each output is written once with row stride C. Two tile kernels:
//
//   gather_mma_kernel (the gathered float64 product on the FP64 tensor
//       cores): cvm_fold_ozaki_df64_f64 and cvm_fold_v3_f64 without sym,
//       the ports of fused_ozaki_downdate_df64 and fused_ozaki_downdate_v3.
//   fold_tile_kernel (FMA on the CUDA cores): every other entry, templated
//       on T, on where the rows come from (streams or a gather by index),
//       on the epilogue form and on the symmetric mode. The float32 entries
//       compute in float32 on FP32 FMA, never on TF32 tensor cores.
//
// The tensor-core tile. Per fold the product costs 2 L K C flops and the
// output K C 8 bytes of writes: at L = 1,000 (Ozaki-df64) and L = 100 (v3)
// the FLOPs bound it, at L = 10 (v3 at P = 10,000) the stores. The CUDA-core
// tile reached 9-11 TFLOP/s on the FLOP-bound chunks against 67 TFLOP/s for
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
//     same pattern; blocks stay tile-major within a fold (below).
// The product is summed in another order than the CUDA-core tile's or the
// twin's torch.bmm; the epilogue is the float64 reference form below.
//
// The reference form is evaluated in two orders. In float64 it is
// (total - fma(p, q, D)) i1 i2; in float32 it follows fused_downdate's
// order, ((total - D) - p q)(i1 i2), since in float32 the two orders
// differ by a few ulps of total.
//
// What bounds the CUDA-core tile: per fold the product costs 2 L K C flops
// and the output K C sizeof(T) bytes of writes, so folds of a few rows (the
// packed routes, the small-fold route at L = 4) are bound by device-memory
// writes and folds of hundreds of rows by FMA throughput. It covers both: one
// block of 256 threads per (fold, 64 x 64 output tile), each thread holding
// a 4 x 4 block of the tile in registers; row blocks of up to 16 rows of
// both operands are staged in shared memory, so each staged value feeds 4
// FMAs from registers; the epilogue reads total (2 MB at K=500, M=10,
// resident in L2) and stores with an evict-first hint. Two choices measured
// on the card: blocks are numbered tile-major within a fold, so blocks that
// run together write neighbouring pieces of the same rows (rows of C = 510
// doubles are not 128-byte aligned, and a fold-major order left partial
// sectors to be evicted apart), and registers are capped at 64 for four
// blocks per SM (a few bytes spill); together they cut a float64 chunk's
// time by 27-37% at L = 4-1,000 (K=500, M=10, H100 80GB HBM3 at 700 W).
// Edge tiles (C = 510 is no multiple of 64) are guarded on load and store.
//
// v3's vector phase (grid F) runs before either tile and forms, per fold
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
// tile phase is the CUDA-core tile's gathered reference form, templated on
// T: a float32 batch runs in float32. Per fold it writes the same K C
// sizeof(T) bytes as the packed kernel and reads L rows twice, so
// at L = 4 it is bound by the stores like the packed route, which reads
// prepared streams instead of gathering.
//
// Symmetric v3 (the port of fused_ozaki_downdate_v3_sym): each fold's X
// block is symmetric up to rounding, so only the 64 x 64 tiles with tile
// row <= tile column are launched (every tile that holds XTY columns is
// among them: a tile below the diagonal holds X columns only), 36 of 64 at
// K=500, M=10. An upper tile stores its X columns a second time, transposed
// into the mirror tile, through shared memory so that both stores are
// coalesced; a diagonal tile stores j >= i of its X part and mirrors j > i,
// so out[f][j][i] = out[f][i][j] for i < j < K exactly. The vector phase
// is unchanged. Where the product's FMAs bound the kernel (hundreds of
// rows a fold) this cuts the work to 36/64; where the stores do (L = 10),
// the bytes written stay the same.
//
// Rows are int64 and range-checked on the host before any launch.
// Plain C interface, bound with ctypes (cvmatrix_tpu_torch/ops/
// fold_downdate.py); every entry launches on the caller's stream and
// returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // output tile edge (K and C)
constexpr int kStage = 16;      // rows per shared-memory stage
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBlocksPerSM = 4;  // caps registers at 64 for occupancy
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
  const T* a;           // streams: u or xv (F, L, K);  gather: xw (N, K)
  const T* b;           // streams: v or m2 (F, L, C);  gather: xu (N, K)
                        // or null
  const T* yb;          // gather: yu (N, M) or null
  const int64_t* rows;  // gather: (F, L)
  const T* mask;        // gather: (F, L) or null
  const T* kvec;        // (F, 2, K): [p, i1]
  const T* cvec;        // (F, 2, C): [q, i2]
  T* out;               // (F, K, C)
  int64_t L, K, C, KX, M;
};

// Block b writes tile t = b % n_tiles of fold f = b / n_tiles, tiles in
// row-major order: out[f][k0 .. +64][c0 .. +64]. Neighbouring blocks, which
// run at nearly the same time, so write neighbouring parts of the same rows.
// kGather: rows gathered by index (else the contiguous (F, L, .) streams);
// kRefForm: the reference-form epilogue (else the factor form); kSym: the
// tiles are only those on or above the diagonal, numbered row by row (tile
// row ti holds tile columns ti .. n_ct - 1), and X columns are mirrored.
template <typename T, bool kGather, bool kRefForm, bool kSym>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fold_tile_kernel(const TileArgs<T> p, int64_t n_ct, int64_t n_tiles) {
  // The staged rows, and for kSym the output tile once the product is done.
  constexpr size_t kStageBytes = 2 * kStage * kTile * sizeof(T);
  constexpr size_t kMirrorBytes = kTile * (kTile + 1) * sizeof(T);
  constexpr size_t kBytes =
      kSym && kMirrorBytes > kStageBytes ? kMirrorBytes : kStageBytes;
  __shared__ __align__(16) unsigned char smem[kBytes];
  T (*sa)[kTile] = reinterpret_cast<T (*)[kTile]>(smem);
  T (*sb)[kTile] = sa + kStage;
  __shared__ int64_t srow[kStage];
  __shared__ T smask[kStage];

  const int64_t f = blockIdx.x / n_tiles;
  int64_t t = blockIdx.x % n_tiles;
  int64_t ti, tj;
  if (kSym) {
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
  const int64_t k0 = ti * kTile;
  const int64_t c0 = tj * kTile;
  const bool diagonal = kSym && ti == tj;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t L = p.L, K = p.K, C = p.C;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int64_t l0 = 0; l0 < L; l0 += kStage) {
    const int nl = static_cast<int>(L - l0 < kStage ? L - l0 : kStage);
    if (kGather) {
      if (threadIdx.x < kStage) {
        const int li = threadIdx.x;
        const int64_t fl = f * L + l0 + li;
        srow[li] = li < nl ? p.rows[fl] : 0;
        smask[li] = li < nl ? (p.mask ? p.mask[fl] : T(1)) : T(0);
      }
      __syncthreads();
    }
    // Only the stage's live rows are staged: the FMA loop reads no others.
    for (int e = threadIdx.x; e < nl * kTile; e += kThreads) {
      const int li = e / kTile;
      const int j = e % kTile;
      const int64_t ka = k0 + j;
      const int64_t cb = c0 + j;
      T va = T(0);
      T vb = T(0);
      if (kGather) {
        const int64_t r = srow[li];
        if (ka < K) va = __ldg(p.a + r * K + ka) * smask[li];
        if (cb < C) {
          vb = cb < p.KX ? __ldg(p.b + r * K + cb)
                         : __ldg(p.yb + r * p.M + (cb - p.KX));
        }
      } else {
        const int64_t fl = f * L + l0 + li;
        if (ka < K) va = __ldg(p.a + fl * K + ka);
        if (cb < C) vb = __ldg(p.b + fl * C + cb);
      }
      sa[li][j] = va;
      sb[li][j] = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int li = 0; li < nl; ++li) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[li][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[li][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // kSym: the tile's values staged for the mirror (the staging buffers
  // are free after the last __syncthreads of the loop).
  T (*stile)[kTile + 1] = reinterpret_cast<T (*)[kTile + 1]>(smem);
  const T* kv = p.kvec + 2 * K * f;
  const T* cv = p.cvec + 2 * C * f;
  T* of = p.out + K * C * f;
  T qc[4], i2c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t c = c0 + tx + 16 * j;
    qc[j] = c < C ? __ldg(cv + c) : T(0);
    i2c[j] = c < C ? __ldg(cv + C + c) : T(0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t k = k0 + ty + 16 * i;
    if (k >= K) continue;
    const T pk = __ldg(kv + k);
    const T i1 = __ldg(kv + K + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = c0 + tx + 16 * j;
      if (c >= C) continue;
      // A diagonal tile's X part below the diagonal is the mirror's.
      if (diagonal && c < K && c < k) continue;
      const T t = __ldg(p.total + k * C + c);
      T val;
      if constexpr (!kRefForm) {
        val = t * (i1 * i2c[j]) - fma_t(pk, qc[j], acc[i][j]);
      } else if constexpr (sizeof(T) == sizeof(double)) {
        val = (t - fma_t(pk, qc[j], acc[i][j])) * i1 * i2c[j];
      } else {
        val = ((t - acc[i][j]) - pk * qc[j]) * (i1 * i2c[j]);
      }
      __stcs(of + k * C + c, val);
      if (kSym) stile[ty + 16 * i][tx + 16 * j] = val;
    }
  }
  if (kSym) {
    __syncthreads();
    // out[c0 + a][k0 + b] = value(k0 + b, c0 + a) for the tile's X columns
    // strictly above the diagonal; consecutive threads take consecutive b.
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int a = e / kTile;
      const int b = e % kTile;
      const int64_t cm = c0 + a;   // source column = mirror row
      const int64_t km = k0 + b;   // source row = mirror column
      if (cm < K && km < cm) __stcs(of + cm * C + km, stile[b][a]);
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

// cp.async of one 16- or 8-byte piece; src-size 0 writes zeros and reads
// nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
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

// Block b computes tile t = b % n_tiles of fold f = b / n_tiles (tiles
// row-major, kMmaTileM x kMmaTileN each) in the float64 reference form.
// kVec: 16-byte copies, loads and stores (K, M even and every operand
// 16-byte aligned), else 8-byte ones; kMasked: the rows carry a 0/1 mask.
template <bool kVec, bool kMasked>
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

  extern __shared__ __align__(16) unsigned char smem[];
  double* slabs = reinterpret_cast<double*>(smem);

  const int64_t f = blockIdx.x / n_tiles;
  const int64_t t = blockIdx.x % n_tiles;
  const int64_t k0 = (t / n_ct) * BM;
  const int64_t c0 = (t % n_ct) * BN;
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

  // Epilogue, one row of warp tiles (32 rows, the warps of row wm = h) at
  // a time: the accumulators to shared memory, then coalesced row pieces
  // out. A thread keeps one column piece (the thread count is a multiple of
  // the pieces a row has), so it reads that piece's q and i2 once.
  double* so = slabs;
  const double* kv = p.kvec + 2 * K * f;
  const double* cv = p.cvec + 2 * C * f;
  double* of = p.out + K * C * f;
  constexpr int kRowPieces = BN / V;
  constexpr int kRowsPerPass = kMmaThreads / kRowPieces;
  static_assert(kMmaThreads % kRowPieces == 0 &&
                    kMmaWarpTile % kRowsPerPass == 0,
                "whole rows a pass");
  const int cc = (tid % kRowPieces) * V;
  const int64_t c = c0 + cc;
  const bool col_live = c < C;
  double q[V], i2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    q[v] = col_live ? __ldg(cv + c + v) : 0.0;
    i2[v] = col_live ? __ldg(cv + C + c + v) : 0.0;
  }
#pragma unroll
  for (int h = 0; h < BM / kMmaWarpTile; ++h) {
    if (wm == h) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int r = 0; r < Op::kC; r += 2) {
            double* d = so + (i * Op::kM + g + 8 * (r / 2)) * kMmaOutLd +
                        wn * 32 + j * 8 + 2 * tq;
            *reinterpret_cast<double2*>(d) =
                make_double2(acc[i][j][r], acc[i][j][r + 1]);
          }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kMmaWarpTile / kRowsPerPass; ++it) {
      const int r = tid / kRowPieces + it * kRowsPerPass;
      const int64_t k = k0 + h * kMmaWarpTile + r;
      if (!col_live || k >= K) continue;
      const double pk = __ldg(kv + k);
      const double i1 = __ldg(kv + K + k);
      const double* d = so + r * kMmaOutLd + cc;
      if constexpr (kVec) {
        const double2 tt =
            __ldg(reinterpret_cast<const double2*>(p.total + k * C + c));
        const double2 v = *reinterpret_cast<const double2*>(d);
        __stcs(reinterpret_cast<double2*>(of + k * C + c),
               make_double2((tt.x - fma(pk, q[0], v.x)) * i1 * i2[0],
                            (tt.y - fma(pk, q[V - 1], v.y)) * i1 * i2[V - 1]));
      } else {
        const double tt = __ldg(p.total + k * C + c);
        __stcs(of + k * C + c, (tt - fma(pk, q[0], *d)) * i1 * i2[0]);
      }
    }
    __syncthreads();  // the next pass overwrites the staged rows
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

template <typename T, bool kGather, bool kRefForm, bool kSym = false>
int launch_tile(const TileArgs<T>& a, int64_t F, int device, void* stream) {
  if (F <= 0 || a.K <= 0 || a.C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_ct = (a.C + kTile - 1) / kTile;
  const int64_t n_kt = (a.K + kTile - 1) / kTile;
  // kSym: tile rows ti < n_kt hold columns ti .. n_ct - 1 (C >= K).
  const int64_t n_tiles =
      kSym ? n_kt * n_ct - n_kt * (n_kt - 1) / 2 : n_ct * n_kt;
  if (F * n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fold_tile_kernel<T, kGather, kRefForm, kSym>
      <<<static_cast<unsigned>(F * n_tiles), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(a, n_ct, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, bool kMasked>
int launch_gather_mma_vm(const TileArgs<double>& a, int64_t F,
                         void* stream) {
  const int64_t n_ct = (a.C + kMmaTileN - 1) / kMmaTileN;
  const int64_t n_tiles = n_ct * ((a.K + kMmaTileM - 1) / kMmaTileM);
  if (F * n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mma_kernel<kVec, kMasked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_mma_kernel<kVec, kMasked>
      <<<static_cast<unsigned>(F * n_tiles), kMmaThreads, kMmaSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(a, n_ct, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The tensor-core tile for a gathered reference-form batch.
int launch_gather_mma(const TileArgs<double>& a, int64_t F, int device,
                      void* stream) {
  if (F <= 0 || a.K <= 0 || a.C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = a.K % 2 == 0 && a.M % 2 == 0 && aligned16(a.total) &&
                   aligned16(a.a) && aligned16(a.b) && aligned16(a.yb) &&
                   aligned16(a.kvec) && aligned16(a.cvec) && aligned16(a.out);
  if (vec) {
    return a.mask ? launch_gather_mma_vm<true, true>(a, F, stream)
                  : launch_gather_mma_vm<true, false>(a, F, stream);
  }
  return a.mask ? launch_gather_mma_vm<false, true>(a, F, stream)
                : launch_gather_mma_vm<false, false>(a, F, stream);
}

}  // namespace

// Factor-form downdate of the prepared streams (port of
// fused_downdate_df64_packed). All pointers are device pointers.
extern "C" int cvm_fold_packed_f64(
    const double* total, const double* u, const double* v,
    const double* kvec, const double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t C, int device, void* stream) {
  TileArgs<double> a{total, u, v, nullptr, nullptr, nullptr, kvec, cvec,
                     out, L, K, C, 0, 0};
  return launch_tile<double, false, false>(a, F, device, stream);
}

// The same factor form in float32 (port of fused_downdate_f32_packed).
extern "C" int cvm_fold_packed_f32(
    const float* total, const float* u, const float* v, const float* kvec,
    const float* cvec, float* out, int64_t F, int64_t L, int64_t K,
    int64_t C, int device, void* stream) {
  TileArgs<float> a{total, u, v, nullptr, nullptr, nullptr, kvec, cvec, out,
                    L, K, C, 0, 0};
  return launch_tile<float, false, false>(a, F, device, stream);
}

// Reference-form downdate of the contiguous streams xv (F, L, K) and
// m2 (F, L, C) in float32 (port of fused_downdate); kvec = [a1, inv1],
// cvec = [mb, inv2].
extern "C" int cvm_fold_downdate_f32(
    const float* total, const float* xv, const float* m2, const float* kvec,
    const float* cvec, float* out, int64_t F, int64_t L, int64_t K,
    int64_t C, int device, void* stream) {
  TileArgs<float> a{total, xv, m2, nullptr, nullptr, nullptr, kvec, cvec,
                    out, L, K, C, 0, 0};
  return launch_tile<float, false, true>(a, F, device, stream);
}

// Gathered product + reference-form epilogue (port of
// fused_ozaki_downdate_df64), on the tensor-core tile. The product's right
// side is [xu | yu] with KX (K or 0) X columns and M Y columns; xu may be
// null when KX is 0, yu when M is 0; mask may be null.
extern "C" int cvm_fold_ozaki_df64_f64(
    const double* total, const double* xw, const double* xu,
    const double* yu, const int64_t* rows, const double* mask,
    const double* kvec, const double* cvec, double* out, int64_t F,
    int64_t L, int64_t K, int64_t KX, int64_t M, int device, void* stream) {
  TileArgs<double> a{total, xw, xu, yu, rows, mask, kvec, cvec, out,
                     L, K, KX + M, KX, M};
  return launch_gather_mma(a, F, device, stream);
}

// v3 (port of fused_ozaki_downdate_v3, and with sym != 0 of
// fused_ozaki_downdate_v3_sym): the vector phase into the caller's kvec
// (F, 2, K) and cvec (F, 2, K + M) scratch, then the gathered tile phase:
// the tensor-core tile, or with sym the CUDA-core tile's symmetric mode.
// yu may be null when M is 0, mask may be null.
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
  if (sym) return launch_tile<double, true, true, true>(a, F, device, stream);
  return launch_gather_mma(a, F, device, stream);
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
  return launch_tile<T, true, true>(a, F, device, stream);
}

}  // namespace

// Masked multi-row LOOCV sources (port of fused_smallfold_df64): the
// small-fold vector phase into the caller's kvec (F, 2, K) and cvec
// (F, 2, K + M) scratch, then the gathered reference-form tile phase. yu, yw
// and gy may be null when M is 0, mask may be null.
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
