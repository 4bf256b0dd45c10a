// Gram assembly kernel K1 for Hopper (sm_90a).
//
// Replaces nonlinpdes_gpsolver_tpu/ops/pallas_gram.py::_tile_kernel, the
// Pallas TPU kernel of the JAX package, which evaluates one derivative-kernel
// Gram block per pallas_call:
//
//     out[i, j] = sum_beta c_beta * prod_k p_{beta_k}(u_k) * exp(-sum_k a_k u_k^2),
//     u = x_i - y_j.
//
// Here one launch assembles a whole matrix from a launch plan built by
// ops/gram_tile.py: every block of a Gram matrix (the upper blocks, their
// mirrors, and only the upper tiles of each symmetric diagonal block), or
// every block of a cross-Gram. Each block names its row and column point
// sets, its offsets in the output and its operator pair's term table.
//
// What bounds it on the H100. The inputs are O(n + m) coordinates and the
// output is n * m entries, so the floor is the output bytes at 3.35 TB/s;
// the operations (a few Horner steps per derivative order, a Cody-Waite exp
// of about 17 instructions) are below that floor only if few instructions
// are spent per output, and in practice instruction issue is what the
// kernel waits on. There is no contraction (dim <= 3), so wgmma and the
// tensor cores have no role, and TMA loads gain nothing for inputs this
// small. At the canonical sizes the launch itself is the floor.
//
// What the design does about it.
// - One launch per matrix: persistent CTAs (as many as fit on the SMs)
//   walk a flat list of 64 x 64 output tiles over all blocks; a CTA finds
//   a tile's block from the tile prefix sums. One launch latency per
//   matrix instead of one per block, and the SMs stay full when single
//   blocks are small. The next tile's coordinates are copied into shared
//   memory with cp.async while the current tile is computed.
// - Every byte written once: a finished tile is staged in shared memory
//   (padded to 65 columns against bank conflicts) and stored row by row,
//   as 16-byte vectors for full tiles of aligned blocks; the tile's
//   transpose is stored the same way into the mirror block. Symmetric
//   diagonal blocks compute only the tiles with tile_col >= tile_row; a
//   tile on the diagonal writes its lower half from the transposed stage.
//   Theta is exactly symmetric.
// - Coefficients out of the inner loop: each thread holds 16 outputs
//   (8 rows x 2 columns) and loops term -> dimension -> Horner step -> its
//   16 outputs, so each coefficient and degree is read once per term per
//   thread, and the next term's are read ahead. Degrees are uniform within
//   a CTA, so the loops do not diverge. p_b has the parity of b, so Horner
//   runs in s = u^2 (times u for odd b): half the steps of Horner in u.
// - The plan (descriptors, term tables, Horner coefficients, point
//   pointers) is one kernel parameter (__grid_constant__, read by broadcast
//   from the constant bank), packed once per plan and dtype: no
//   host-to-device copy and no sync per launch. It fits the classic 4 KB
//   parameter limit (static_assert below).
//
// K2: the equilibrated Gram strip kernel, gram_equilibrated_kernel. It
// replaces the XLA strips of the JAX package's mesh path,
// nonlinpdes_gpsolver_tpu/parallel/fused.py:188 (_fused_chol_kernel, the
// superblock column strip) and parallel/gram.py:109 (_assembly_kernel, the
// two-pass strip), which evaluate the closed form on a strip, scale it by
// d_r[i] d_c[j] and write an exact unit diagonal:
//
//     out[i, j] = 1 if i == j else d_r[i] * d_c[j] * K[i, j]
//
// The view `out` starts on the matrix's diagonal (a factor's column panel
// L[c0:, c0:c0+S], or the whole padded matrix), so its row i and column j
// are the same global index exactly when i == j. K2 walks the same plans as
// K1 and shares eval_tile and exp_neg with it. Fill blocks (flag kFill)
// evaluate nothing: they cover the padding rows and columns, 0 off the
// diagonal and 1 on it. A K2 plan has no mirrored or symmetric blocks (a
// strip below its top S x S is not symmetric), so every entry is computed
// and written once; the epilogue multiplies by d_r[i] * d_c[j] formed
// first, as the JAX package does.
//
// What bounds it on the H100. The bytes are K1's (each output written
// once: 3.7 GB over mesh_solve's 21 f32 windows, 1.16 ms at 3.35 TB/s), but
// it spends twice K1's instructions a byte, since it evaluates every entry
// it writes. scripts/torch_k2_split.py on those windows (NVIDIA H100 80GB
// HBM3, 700 W): K2 as a second instantiation of K1's loop took 2.85 ms,
// 2.37 ms without its global stores and 1.70 ms without its evaluation.
// The stores ran after the evaluation, not beside it, and the evaluation
// alone (with an epilogue that loaded its scales from global memory and
// mapped every row again for each entry) was below half the bound.
//
// What the design does about it.
// - Stores beside evaluation. A tile is staged in one of two dense 64 x 64
//   stages in shared memory and written by one TMA store
//   (cp.async.bulk.tensor.2d, its own bulk async-group) through a
//   CUtensorMap of the out view, while the CTA evaluates the next tile into
//   the other stage. The map is encoded per launch with
//   cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (the
//   library does not link libcuda), and rides in the kernel parameter
//   (K2Args, 4,032 bytes in f64: the classic 4 KB limit holds). TMA rather
//   than a store warp: the copy costs the compute warps no registers and no
//   issue slots, and those are what the evaluation is short of.
// - One barrier a tile (K1 has two). After it, thread 0 issues the last
//   tile's store; before the next, it waits until that store has read its
//   stage (cp.async.bulk.wait_group.read), which the tile after next
//   overwrites. The same barrier publishes the next tile's inputs, so no
//   mbarrier is needed: there is no producer warp to hand off to.
// - A box starts on a 16-byte boundary and clips only at the map's edge. A
//   tile cut short inside the view (a segment end, a fill block) or one
//   whose first column is no 16-byte multiple (a segment that starts there)
//   is stored by the threads from their registers, each warp to 32
//   consecutive entries of a row, and so is every tile of a view whose base
//   or row stride is no 16-byte multiple.
// - The epilogue's inputs come with the tile: its rows' window rows (the
//   row map evaluated once a row), their d_r and the columns' d_c are copied
//   into shared memory by the cp.async prefetch of its coordinates. The
//   barrier ORs the rows' diagonal hits, and only a tile that holds the unit
//   diagonal compares rows with columns entry by entry.
// - Two CTAs an SM in f32 at 127 registers (one CTA an SM, 255 registers:
//   2.86 ms); f64 keeps one CTA. The split of the new kernel: 2.14 ms (54%
//   of the bound), 2.13 ms without its stores, 1.37 ms without its
//   evaluation. Its outputs are bitwise those of the K1-shaped loop.
//
// K2 on a rank's block-cyclic rows. Across P ranks, rank p holds the global
// row blocks g = j * P + p of the factor (B rows each) as its slots j, so a
// superblock window's rows on that rank are every P-th block of the window,
// and each observable's segment falls into up to nbl pieces. A rank-mapped
// plan keeps the window's segments in global coordinates and describes each
// block's rows by their run of local rows: the rows a rank owns of any
// global interval are one contiguous run of its local rows. The kernel
// walks, evaluates and stores in local rows (the out view is the rank's
// column panel) and maps a local row v back to its window row
//
//     w(v) = ((L0 + v) / B) * P * B + (L0 + v) % B + shift,
//
// (L0 the view's first local row, shift = p * B - c0), which picks the
// row's point (x_row0 is the window row of the block's first point) and its
// scale d_r[w], and places the unit diagonal where w equals the window
// column. The map is a template flag of K2 (kMap); without it w(v) = v.
//
// Measurement switches, for scripts/torch_k1_split.py and
// scripts/torch_k2_split.py only (the library is never built with them):
// K1_SPLIT_NO_EVAL replaces the evaluation by a coordinate difference and
// K1_SPLIT_NO_STORE drops the global stores, in both kernels;
// K2_CTAS_PER_SM sets K2's f32 CTAs an SM.
//
// Precision. In f32 the exponential is the same Cody-Waite routine as
// ops/kernels.py::exp_neg_accurate (rintf, the LN2_HI/LN2_LO split, the
// degree-7 Horner, 2^-k from the exponent bits): the TPU's fast exp pushed
// Gram eigenvalues negative, so no fast-math exp is used and the library
// is never built with -use_fast_math. In f64 it is exp(). Terms are summed
// in the order of _combined_terms, as the plain version does; Horner in u^2,
// q = sum_k a_k (u_k^2) and the fused multiply-adds round differently from
// the plain version, within 1e-5 (f32) and 1e-12 (f64) of a block's scale.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 3;
constexpr int kMaxDeg = 8;
constexpr int kMaxTerms = 64;       // merged terms of one operator pair
constexpr int kMaxPlanTerms = 128;  // all tables of one plan together
constexpr int kMaxSets = 8;         // point sets of one plan
constexpr int kMaxBlocks = 36;      // 8 observables: 36 upper blocks
constexpr int kMaxTables = 36;
constexpr int kSteps = kMaxDeg / 2 + 1;  // Horner coefficients in u^2 per degree
constexpr int kPolyLen = (kMaxDeg + 1) * kSteps;
constexpr int kTile = 64;           // rows and columns of a CTA's tile
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kThreadsY;  // rows per thread (8)
constexpr int kCols = kTile / kThreadsX;  // columns per thread (2)

constexpr int kBlockInts = 10;  // ints per block descriptor from the host
constexpr int kMirror = 1;     // also write the transposed tile
constexpr int kSymmetric = 2;  // same operator, same points: upper tiles only
constexpr int kAligned = 4;    // set by the launcher: 16-byte vector stores fit
constexpr int kFill = 8;       // K2 padding: no evaluation, zeros (and the unit diagonal)

// 16-byte vectors for the stores of full tiles.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

struct BlockDesc {
  int row_off, col_off;  // the block's first row and column in out
  int n, m;              // rows (x points) and columns (y points)
  int tile_start;        // first flat tile index of the block
  int tiles_n;           // tiles along the columns
  float inv_tiles_n;     // 1 / tiles_n
  int x_row0;            // window row of the row points' first point (K2)
  unsigned char x_set, y_set, table, flags;
};

template <typename T>
struct Params {
  T* out;
  long long ldo;
  const T* d_r;  // K2 only: the row and column scales, indexed like out
  const T* d_c;
  const T* pts[kMaxSets];
  T inv_sq[kMaxDim];
  // p_b for dimension k (it depends only on (k, b)) has the parity of b:
  // poly[k][b][i] is its coefficient of u^(b - 2 i), zero past the end.
  T poly[kMaxDim][kMaxDeg + 1][kSteps];
  T coef[kMaxPlanTerms + 1];              // one spare entry: read ahead
  unsigned short degs[kMaxPlanTerms + 1];  // 4 bits per dimension
  unsigned char term_start[kMaxTables + 1];
  int dim, n_sets, n_blocks;
  int n_tiles;  // tiles of all blocks together
  int map_P, map_B, map_L0, map_shift;  // K2 on a rank's rows; map_P = 0: no map
  BlockDesc blk[kMaxBlocks];
};

static_assert(sizeof(Params<double>) <= 4096, "plan exceeds the 4 KB parameter limit");

__device__ __forceinline__ float exp_neg(float q) {
  // f32 constants of ops/kernels.py, written as exact hex floats.
  const float kInvLn2 = 0x1.715476p+0f;
  const float kLn2Hi = 0x1.63p-1f;
  const float kLn2Lo = -0x1.bd0106p-13f;
  float k = rintf(q * kInvLn2);  // round half to even, like torch/jnp.round
  float t = (q - k * kLn2Hi) - k * kLn2Lo;
  float p = -0x1.a01a02p-13f;    // -1/5040
  p = p * t + 0x1.6c16c2p-10f;   // 1/720
  p = p * t - 0x1.111112p-7f;    // -1/120
  p = p * t + 0x1.555556p-5f;    // 1/24
  p = p * t - 0x1.555556p-3f;    // -1/6
  p = p * t + 0.5f;
  p = p * t - 1.0f;
  p = p * t + 1.0f;
  k = fminf(fmaxf(k, -126.0f), 126.0f);
  return p * __int_as_float((127 - static_cast<int>(k)) << 23);
}

__device__ __forceinline__ double exp_neg(double q) { return exp(-q); }

// The window row of row v of the out view: v itself unless the plan is
// mapped to a rank's block-cyclic rows (see the note at the top).
template <bool kMap, typename T>
__device__ __forceinline__ int window_row(const Params<T>& p, int v) {
  if (!kMap) return v;
  const int l = p.map_L0 + v;
  return (l / p.map_B) * p.map_P * p.map_B + l % p.map_B + p.map_shift;
}

// Where one tile of the flat tile list lies.
struct TileLoc {
  int blk, table, r0, c0, rows, cols;
  bool diag;    // a diagonal tile of a symmetric block
  bool mirror;  // also store the transpose
  bool vec;     // a full tile of an aligned block: 16-byte stores
  bool fill;    // a K2 padding tile: nothing to evaluate
};

template <typename T>
__device__ __forceinline__ TileLoc locate(const Params<T>& p, int tile, int b = 0) {
  // b: a block at or before the tile's (tiles are walked in order)
  while (b + 1 < p.n_blocks && tile >= p.blk[b + 1].tile_start) ++b;
  const BlockDesc& d = p.blk[b];
  const int local = tile - d.tile_start;
  const bool sym = d.flags & kSymmetric;
  int tr, tc;
  if (sym) {
    // Upper triangle by columns: column tc holds tiles tr = 0..tc.
    tc = static_cast<int>((sqrtf(8.0f * local + 1.0f) - 1.0f) * 0.5f);
    while (tc * (tc + 1) / 2 > local) --tc;
    while ((tc + 1) * (tc + 2) / 2 <= local) ++tc;
    tr = local - tc * (tc + 1) / 2;
  } else {
    tr = static_cast<int>(local * d.inv_tiles_n);
    while (tr * d.tiles_n > local) --tr;
    while ((tr + 1) * d.tiles_n <= local) ++tr;
    tc = local - tr * d.tiles_n;
  }
  TileLoc t;
  t.blk = b;
  t.table = d.table;
  t.r0 = tr * kTile;
  t.c0 = tc * kTile;
  t.rows = min(kTile, d.n - t.r0);
  t.cols = min(kTile, d.m - t.c0);
  t.diag = sym && tr == tc;
  t.mirror = (d.flags & kMirror) || (sym && tr != tc);
  t.vec = (d.flags & kAligned) && t.rows == kTile && t.cols == kTile;
  t.fill = d.flags & kFill;
  return t;
}

// Coordinates of a tile's 64 rows and 64 columns in shared memory:
// coords[0][k][r] = x_{r0 + r, k}, coords[1][k][c] = y_{c0 + c, k}, zero past
// the block's edge (those outputs are never stored).
template <typename T, int DIM>
using Coords = T[2][DIM][kTile];

// Start the asynchronous copy (cp.async, no registers held) of a tile's
// coordinates; the caller waits with cp_async_wait() and a barrier.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  // valid: copy *src; else zero-fill dst (src is not read)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)), "r"(valid ? static_cast<int>(sizeof(T)) : 0));
}

template <typename T, int DIM>
__device__ __forceinline__ void fetch_coords(const Params<T>& p, const TileLoc& t,
                                             Coords<T, DIM>& c, int tid) {
  const BlockDesc& d = p.blk[t.blk];
#pragma unroll
  for (int e = tid; e < 2 * DIM * kTile; e += kThreads) {
    const int side = e / (DIM * kTile), rem = e % (DIM * kTile);
    const int r = rem / DIM, k = rem % DIM;
    const T* src = p.pts[side ? d.y_set : d.x_set];
    const int row = (side ? t.c0 : t.r0) + r;
    const bool valid = row < (side ? d.m : d.n);
    cp_async(&c[side][k][r], valid ? src + static_cast<int64_t>(row) * DIM + k : src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The thread's 16 outputs of table `table`: term -> dimension -> Horner
// step -> outputs, so each coefficient is read once per term. p_b has the
// parity of b, so it is evaluated by Horner in s = u^2 (times u if b is
// odd), and q = sum_k a_k s_k.
template <typename T, int DIM>
__device__ __forceinline__ void eval_tile(const Params<T>& p, int table, const Coords<T, DIM>& c,
                                          T (&val)[kRows][kCols]) {
  auto u = [&](int i, int j, int k) {
    return c[0][k][threadIdx.y + i * kThreadsY] - c[1][k][threadIdx.x + j * kThreadsX];
  };
  T s[kRows][kCols][DIM];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        const T uk = u(i, j, k);
        s[i][j][k] = uk * uk;
      }
      val[i][j] = T(0);
    }

  // acc = p_deg(u) for dimension k, deg > 0: Horner in s over the
  // coefficients of u^deg, u^(deg - 2), ..., all loaded at once.
  auto horner = [&](int k, int deg, T (&acc)[kRows][kCols]) {
    T cf[kSteps];
#pragma unroll
    for (int e = 0; e < kSteps; ++e) cf[e] = p.poly[k][deg][e];
    const int steps = deg / 2;
    if (steps == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = cf[0];
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = cf[0] * s[i][j][k] + cf[1];
#pragma unroll
      for (int e = 2; e < kSteps; ++e) {
        if (e > steps) break;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = acc[i][j] * s[i][j][k] + cf[e];
      }
    }
    if (deg & 1) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] *= u(i, j, k);
    }
  };

  // The next term's coefficient and degrees are read one term ahead.
  int t = p.term_start[table];
  const int t_end = p.term_start[table + 1];
  T coef = p.coef[t];
  unsigned dg = p.degs[t];
  for (; t < t_end; ++t) {
    const T coef_next = p.coef[t + 1];
    const unsigned dg_next = p.degs[t + 1];
    if (dg == 0) {  // no derivative factor
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) val[i][j] += coef;
    } else {
      T prod[kRows][kCols];
      bool started = false;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        const int deg = (dg >> (4 * k)) & 15;
        if (deg == 0) continue;
        if (!started) {
          horner(k, deg, prod);
          started = true;
        } else {
          T acc[kRows][kCols];
          horner(k, deg, acc);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) prod[i][j] *= acc[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) val[i][j] = coef * prod[i][j] + val[i][j];
    }
    coef = coef_next;
    dg = dg_next;
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      T q = T(0);
#pragma unroll
      for (int k = 0; k < DIM; ++k) q += p.inv_sq[k] * s[i][j][k];
      val[i][j] *= exp_neg(q);
    }
}

// Store a staged tile row by row (a warp store covers consecutive
// entries of a row), its lower half from the transpose on a diagonal tile,
// then its transpose into the mirror block the same way. Full tiles of
// aligned blocks go out as 16-byte vectors; other tiles entry by entry.
template <typename T>
__device__ __forceinline__ void store_tile(const Params<T>& p, const TileLoc& t,
                                           const T (&stage)[kTile][kTile + 1], int warp,
                                           int lane) {
  const BlockDesc& d = p.blk[t.blk];
  const int64_t ldo = p.ldo;
  T* base = p.out + static_cast<int64_t>(d.row_off + t.r0) * ldo + d.col_off + t.c0;
  T* mbase = p.out + static_cast<int64_t>(d.col_off + t.c0) * ldo + d.row_off + t.r0;
  if (t.vec) {
    using V = typename Vec16<T>::type;
    constexpr int kVec = sizeof(V) / sizeof(T);        // entries per vector
    constexpr int kPerRow = kTile / kVec;              // vectors per row
    constexpr int kRowsPerPass = kWarps * 32 / kPerRow;
    const int q = (warp * 32 + lane) % kPerRow, r_in = (warp * 32 + lane) / kPerRow;
#pragma unroll
    for (int pass = 0; pass < kTile / kRowsPerPass; ++pass) {
      const int rr = r_in + pass * kRowsPerPass;
      V v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int l = 0; l < kVec; ++l) {
        const int cc = q * kVec + l;
        e[l] = (t.diag && cc < rr) ? stage[cc][rr] : stage[rr][cc];
      }
      *reinterpret_cast<V*>(base + rr * ldo + q * kVec) = v;
    }
    if (!t.mirror) return;
#pragma unroll
    for (int pass = 0; pass < kTile / kRowsPerPass; ++pass) {
      const int cc = r_in + pass * kRowsPerPass;
      V v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int l = 0; l < kVec; ++l) e[l] = stage[q * kVec + l][cc];
      *reinterpret_cast<V*>(mbase + cc * ldo + q * kVec) = v;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i) {
    const int rr = warp + i * kWarps;
    if (rr >= t.rows) break;
    T* dst = base + rr * ldo;
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      const int cc = lane + 32 * j;
      if (cc < t.cols) dst[cc] = (t.diag && cc < rr) ? stage[cc][rr] : stage[rr][cc];
    }
  }
  if (!t.mirror) return;
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i) {
    const int cc = warp + i * kWarps;
    if (cc >= t.cols) break;
    T* dst = mbase + cc * ldo;
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      const int rr = lane + 32 * j;
      if (rr < t.rows) dst[rr] = stage[rr][cc];
    }
  }
}

#ifdef K1_SPLIT_NO_EVAL
// The measurement builds' stand-in for eval_tile: a coordinate difference.
template <typename T, int DIM>
__device__ __forceinline__ void split_no_eval(const Coords<T, DIM>& c, T (&val)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      val[i][j] = c[0][0][threadIdx.y + i * kThreadsY] - c[1][0][threadIdx.x + j * kThreadsX];
}
#endif

// K1: a persistent CTA walks the tile list with stride gridDim.x; the next
// tile's coordinates are copied into the other buffer while the current
// tile is computed.
// In f32 two CTAs fit on an SM (at most 128 registers a thread); in f64
// the doubled registers would spill, so one.
template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
gram_plan_kernel(const __grid_constant__ Params<T> p) {
  __shared__ T stage[kTile][kTile + 1];
  __shared__ Coords<T, DIM> coords[2];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  int tile = static_cast<int>(blockIdx.x), buf = 0;
  TileLoc cur = locate(p, tile);
  fetch_coords<T, DIM>(p, cur, coords[0], tid);
  for (;;) {
    // The barrier also orders the previous tile's stores (reads of the
    // stage) before this tile's writes to it.
    cp_async_wait();
    __syncthreads();
    const int next = tile + static_cast<int>(gridDim.x);
    const bool more = next < p.n_tiles;
    TileLoc nxt = cur;
    if (more) {
      nxt = locate(p, next, cur.blk);
      fetch_coords<T, DIM>(p, nxt, coords[buf ^ 1], tid);
    }
    T val[kRows][kCols];
#ifdef K1_SPLIT_NO_EVAL
    split_no_eval<T, DIM>(coords[buf], val);
#else
    eval_tile<T, DIM>(p, cur.table, coords[buf], val);
#endif
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        stage[threadIdx.y + i * kThreadsY][threadIdx.x + j * kThreadsX] = val[i][j];
    __syncthreads();
#ifdef K1_SPLIT_NO_STORE
    if (p.ldo < 0)  // never: the stage writes stay, the stores go
#endif
      store_tile(p, cur, stage, warp, lane);
    if (!more) break;
    tile = next;
    cur = nxt;
    buf ^= 1;
  }
}

// ---- K2 ---------------------------------------------------------------------

#ifndef K2_CTAS_PER_SM
#define K2_CTAS_PER_SM 2  // in f32; f64 takes one (its registers)
#endif

// K2's shared memory: the ring of two dense output stages (the sources of
// the TMA stores) and, per buffer, one tile's coordinates, scales and window
// rows.
template <typename T, int DIM>
struct K2Smem {
  T stage[2][kTile][kTile];
  Coords<T, DIM> coords[2];
  T d_r[2][kTile];     // d_r at the tile rows' window rows
  T d_c[2][kTile];     // d_c at the tile's columns
  int wrow[2][kTile];  // the tile rows' window rows
};

// K2's kernel parameter: the plan, and the out view as a TMA tensor map.
template <typename T>
struct K2Args {
  CUtensorMap out_map;  // rows x cols, row stride ldo, 64 x 64 boxes (zero without tma)
  Params<T> p;
  int rows, cols;  // the out view: the union of the plan's blocks
  int tma;         // the view takes TMA stores (16-byte aligned base and row stride)
};

static_assert(sizeof(K2Args<double>) <= 4096, "K2's parameter exceeds the 4 KB limit");

// Start the cp.async copies of a K2 tile's inputs into buffer b. Thread
// r < 64 maps tile row r to its window row w (once per row and tile),
// keeps w and copies the row's point and d_r[w]; thread 64 + c copies
// column c's point and d_c. Fill tiles, and rows or columns past the
// block's edge, get zeros. Returns whether the thread's row meets the unit
// diagonal inside the tile.
template <typename T, int DIM, bool kMap>
__device__ __forceinline__ bool fetch_k2(const Params<T>& p, const TileLoc& t, K2Smem<T, DIM>& sm,
                                         int b, int tid) {
  const BlockDesc& d = p.blk[t.blk];
  bool hit = false;
  if (tid < kTile) {
    const int r = tid;
    const int w = window_row<kMap>(p, d.row_off + t.r0 + r);
    const int col0 = d.col_off + t.c0;
    sm.wrow[b][r] = w;
    hit = r < t.rows && w >= col0 && w < col0 + t.cols;
    const bool valid = !t.fill && r < t.rows;
    const T* x = p.pts[d.x_set];
    const T* src = x + static_cast<int64_t>(w - d.x_row0) * DIM;  // the row's point
#pragma unroll
    for (int k = 0; k < DIM; ++k) cp_async(&sm.coords[b][0][k][r], valid ? src + k : x, valid);
    cp_async(&sm.d_r[b][r], valid ? p.d_r + w : p.d_r, valid);
  } else if (tid < 2 * kTile) {
    const int c = tid - kTile;
    const bool valid = !t.fill && c < t.cols;
    const T* y = p.pts[d.y_set];
    const T* src = y + static_cast<int64_t>(t.c0 + c) * DIM;
#pragma unroll
    for (int k = 0; k < DIM; ++k) cp_async(&sm.coords[b][1][k][c], valid ? src + k : y, valid);
    cp_async(&sm.d_c[b][c], valid ? p.d_c + d.col_off + t.c0 + c : p.d_c, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return hit;
}

// K2's epilogue on the thread's 16 outputs, from the staged scales: scale
// by d_r[i] d_c[j] in the order of the JAX package (the product of the
// scales first); with kDiag, an exact 1 where the row's window row equals
// the column (col0: the tile's first column in the view). Entries past the
// tile's edge are never stored.
template <bool kDiag, typename T, int DIM>
__device__ __forceinline__ void equilibrate(const K2Smem<T, DIM>& sm, int b, int col0,
                                            T (&val)[kRows][kCols]) {
  T dc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dc[j] = sm.d_c[b][threadIdx.x + j * kThreadsX];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = threadIdx.y + i * kThreadsY;
    const T dr = sm.d_r[b][r];
    const int w = kDiag ? sm.wrow[b][r] : 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      val[i][j] = (kDiag && w == col0 + static_cast<int>(threadIdx.x) + j * kThreadsX)
                      ? T(1) : val[i][j] * (dr * dc[j]);
  }
}

// A fill tile: 0, and 1 where the row's window row equals the column.
template <typename T, int DIM>
__device__ __forceinline__ void fill_tile(const K2Smem<T, DIM>& sm, int b, int col0, bool diag,
                                          T (&val)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int w = sm.wrow[b][threadIdx.y + i * kThreadsY];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      val[i][j] = (diag && w == col0 + static_cast<int>(threadIdx.x) + j * kThreadsX) ? T(1)
                                                                                      : T(0);
  }
}

// A tile the TMA box cannot take, stored by the threads from their
// registers, as store_tile stores a ragged tile: a warp writes 32
// consecutive entries of a row at a time.
template <typename T>
__device__ __forceinline__ void store_direct(const Params<T>& p, const TileLoc& t,
                                             const T (&val)[kRows][kCols]) {
  const BlockDesc& d = p.blk[t.blk];
  const int64_t ldo = p.ldo;
  T* base = p.out + static_cast<int64_t>(d.row_off + t.r0) * ldo + d.col_off + t.c0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = threadIdx.y + i * kThreadsY;
    if (r >= t.rows) break;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = threadIdx.x + j * kThreadsX;
      if (c < t.cols) base[r * ldo + c] = val[i][j];
    }
  }
}

// One TMA store of a staged 64 x 64 tile to (row, col) of the out view,
// clipped at the view's edge, as its own bulk async-group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* stage, int row,
                                          int col) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(stage))), "r"(col), "r"(row)
      : "memory");
}

// K2: K1's plan walk with the equilibrating epilogue, every entry
// computed and written once, its stores asynchronous. Tile k is evaluated
// into stage k % 2; after the barrier that starts tile k + 1, thread 0
// hands stage k % 2 to the TMA unit, which writes it to global memory while
// the CTA evaluates tile k + 1 into the other stage. Before the barrier
// that starts tile k + 2, thread 0 waits until the TMA unit has read the
// stage out (cp.async.bulk.wait_group.read), so the one barrier a tile
// orders the inputs, the stages and the scales; it also ORs the rows'
// diagonal hits, and only a tile that holds a diagonal entry compares
// window rows with columns entry by entry. Tiles the box cannot take,
// and every tile of a view without a tensor map, are stored by the threads.
// kMap maps the view's rows to a rank's block-cyclic rows.
template <typename T, int DIM, bool kMap>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? K2_CTAS_PER_SM : 1)
gram_equilibrated_kernel(const __grid_constant__ K2Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  K2Smem<T, DIM>& sm = *reinterpret_cast<K2Smem<T, DIM>*>(smem);
  const Params<T>& p = a.p;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  int tile = static_cast<int>(blockIdx.x), buf = 0;
  TileLoc cur = locate(p, tile);
  bool hit = fetch_k2<T, DIM, kMap>(p, cur, sm, 0, tid);
  int staged_row = -1, staged_col = 0;  // the last tile's place, if it waits in its stage
  for (;;) {
    cp_async_wait();
    const bool diag = __syncthreads_or(hit);
    const bool issued = staged_row >= 0;
#ifdef K1_SPLIT_NO_STORE
    if (p.ldo < 0)  // never: the stage writes stay, the stores go
#endif
      if (tid == 0 && issued)
        tma_store(&a.out_map, &sm.stage[buf ^ 1][0][0], staged_row, staged_col);
    const int next = tile + static_cast<int>(gridDim.x);
    const bool more = next < p.n_tiles;
    TileLoc nxt = cur;
    if (more) {
      nxt = locate(p, next, cur.blk);
      hit = fetch_k2<T, DIM, kMap>(p, nxt, sm, buf ^ 1, tid);
    }
    const BlockDesc& d = p.blk[cur.blk];
    const int row0 = d.row_off + cur.r0, col0 = d.col_off + cur.c0;
    T val[kRows][kCols];
#ifdef K1_SPLIT_NO_EVAL
    split_no_eval<T, DIM>(sm.coords[buf], val);
    if (diag) equilibrate<true>(sm, buf, col0, val);
    else equilibrate<false>(sm, buf, col0, val);
#else
    if (cur.fill) {
      fill_tile(sm, buf, col0, diag, val);
    } else {
      eval_tile<T, DIM>(p, cur.table, sm.coords[buf], val);
      if (diag) equilibrate<true>(sm, buf, col0, val);
      else equilibrate<false>(sm, buf, col0, val);
    }
#endif
    // The box starts on a 16-byte boundary, and it clips at the view's edge
    // only: it takes a tile that reaches the box's edge or the view's.
    const bool by_tma = a.tma && col0 % (16 / sizeof(T)) == 0 &&
                        (cur.rows == kTile || row0 + cur.rows == a.rows) &&
                        (cur.cols == kTile || col0 + cur.cols == a.cols);
    if (by_tma) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          sm.stage[buf][threadIdx.y + i * kThreadsY][threadIdx.x + j * kThreadsX] = val[i][j];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the TMA unit
    } else {
#ifdef K1_SPLIT_NO_STORE
      if (p.ldo < 0)
#endif
        store_direct(p, cur, val);
    }
    // The store issued above has read the stage that the next tile writes.
    if (tid == 0 && issued) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    staged_row = by_tma ? row0 : -1;
    staged_col = col0;
    if (!more) break;
    tile = next;
    cur = nxt;
    buf ^= 1;
  }
  if (staged_row >= 0) {
    __syncthreads();
#ifdef K1_SPLIT_NO_STORE
    if (p.ldo < 0)
#endif
      if (tid == 0) tma_store(&a.out_map, &sm.stage[buf][0][0], staged_row, staged_col);
  }
  // The stage must outlive the last store's read of it; the writes
  // themselves complete with the grid.
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// CTAs of `kernel` resident on one SM with `smem` bytes of dynamic shared
// memory, times the SMs of the current device (0 on an error).
template <typename K>
int resident_ctas(K kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      (smem > 0 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
           cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// The persistent grids, queried once per process and instantiation.
template <typename T, int DIM>
cudaError_t launch_k1_dim(const Params<T>& p, cudaStream_t stream) {
  static int ctas = 0;
  if (ctas == 0) ctas = resident_ctas(gram_plan_kernel<T, DIM>, 0);
  if (ctas <= 0) return cudaErrorInvalidConfiguration;
  const dim3 block(kThreadsX, kThreadsY);
  gram_plan_kernel<T, DIM><<<ctas < p.n_tiles ? ctas : p.n_tiles, block, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DIM, bool kMap>
cudaError_t launch_k2_dim(const K2Args<T>& a, cudaStream_t stream) {
  constexpr int smem = sizeof(K2Smem<T, DIM>);
  static int ctas = 0;
  if (ctas == 0) ctas = resident_ctas(gram_equilibrated_kernel<T, DIM, kMap>, smem);
  if (ctas <= 0) return cudaErrorInvalidConfiguration;
  const dim3 block(kThreadsX, kThreadsY);
  gram_equilibrated_kernel<T, DIM, kMap>
      <<<ctas < a.p.n_tiles ? ctas : a.p.n_tiles, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k1(const Params<T>& p, cudaStream_t stream) {
  switch (p.dim) {
    case 1: return launch_k1_dim<T, 1>(p, stream);
    case 2: return launch_k1_dim<T, 2>(p, stream);
    case 3: return launch_k1_dim<T, 3>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kMap>
cudaError_t launch_k2_map(const K2Args<T>& a, cudaStream_t stream) {
  switch (a.p.dim) {
    case 1: return launch_k2_dim<T, 1, kMap>(a, stream);
    case 2: return launch_k2_dim<T, 2, kMap>(a, stream);
    case 3: return launch_k2_dim<T, 3, kMap>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime once per
// process (the library does not link against libcuda); null if missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// K2 on the out view of p: its tensor map where TMA can describe the view.
template <typename T>
cudaError_t launch_k2(const Params<T>& p, cudaStream_t stream) {
  K2Args<T> a = {};
  a.p = p;
  for (int b = 0; b < p.n_blocks; ++b) {
    const BlockDesc& d = p.blk[b];
    if (d.row_off + d.n > a.rows) a.rows = d.row_off + d.n;
    if (d.col_off + d.m > a.cols) a.cols = d.col_off + d.m;
  }
  const unsigned long long row_bytes = static_cast<unsigned long long>(p.ldo) * sizeof(T);
  a.tma = reinterpret_cast<uintptr_t>(p.out) % 16 == 0 && row_bytes % 16 == 0;
  if (a.tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.cols), static_cast<cuuint64_t>(a.rows)};
    const cuuint64_t strides[1] = {row_bytes};
    const cuuint32_t box[2] = {kTile, kTile}, unit[2] = {1, 1};
    if (encode(&a.out_map,
               sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
               2, p.out, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return p.map_P ? launch_k2_map<T, true>(a, stream) : launch_k2_map<T, false>(a, stream);
}

// Fill a plan's parameters from the host arrays (once per plan and dtype);
// the launch adds the output, its row stride and the point pointers.
template <typename T>
int pack(int dim, int n_sets, const int* blocks, int n_blocks, const double* inv_sq,
         const double* poly, const double* coef, const int* degs, const int* term_start,
         int n_tables, const int* row_map, Params<T>* out) {
  Params<T> p = {};
  p.dim = dim;
  p.n_sets = n_sets;
  // row_map: P, B, L0, shift of a rank-mapped K2 plan, all 0 without a map
  if (row_map[0] < 0 || (row_map[0] > 0 && (row_map[1] < 1 || row_map[2] < 0)))
    return cudaErrorInvalidValue;
  p.map_P = row_map[0];
  p.map_B = row_map[1];
  p.map_L0 = row_map[2];
  p.map_shift = row_map[3];
  for (int k = 0; k < dim; ++k) {
    p.inv_sq[k] = static_cast<T>(inv_sq[k]);
    for (int i = 0; i < kPolyLen; ++i)
      (&p.poly[k][0][0])[i] = static_cast<T>(poly[k * kPolyLen + i]);
  }
  const int n_terms = term_start[n_tables];
  for (int t = 0; t < n_terms; ++t) {
    p.coef[t] = static_cast<T>(coef[t]);
    unsigned packed = 0;
    for (int k = 0; k < dim; ++k) {
      const int deg = degs[t * dim + k];
      if (deg < 0 || deg > kMaxDeg) return cudaErrorInvalidValue;
      packed |= static_cast<unsigned>(deg) << (4 * k);
    }
    p.degs[t] = static_cast<unsigned short>(packed);
  }
  for (int i = 0; i <= n_tables; ++i) {
    if (term_start[i] < 0 || term_start[i] > n_terms ||
        (i && (term_start[i] < term_start[i - 1] || term_start[i] - term_start[i - 1] > kMaxTerms)))
      return cudaErrorInvalidValue;
    p.term_start[i] = static_cast<unsigned char>(term_start[i]);
  }
  // The tile prefix sums are recomputed here and must match the plan's.
  long long tiles = 0;
  for (int b = 0; b < n_blocks; ++b) {
    // row_off, col_off, n, m, x_set, y_set, table, flags, x_row0, tile_start
    const int* e = blocks + kBlockInts * b;
    const int n = e[2], m = e[3], flags = e[7];
    const bool fill = flags & kFill;  // evaluates nothing: its sets and table are unused
    if (e[0] < 0 || e[1] < 0 || n < 1 || m < 1 ||
        (!fill && (e[4] < 0 || e[4] >= n_sets || e[5] < 0 || e[5] >= n_sets ||
                   e[6] < 0 || e[6] >= n_tables)) ||
        (flags & ~(kMirror | kSymmetric | kFill)) || (fill && (flags & ~kFill)) ||
        ((flags & kSymmetric) && n != m) || e[9] != tiles || e[8] < 0 ||
        (p.map_P == 0 && e[8] != e[0]) || (p.map_P > 0 && (flags & kMirror)))
      return cudaErrorInvalidValue;
    BlockDesc& d = p.blk[b];
    d.row_off = e[0];
    d.col_off = e[1];
    d.n = n;
    d.m = m;
    d.x_set = static_cast<unsigned char>(e[4]);
    d.y_set = static_cast<unsigned char>(e[5]);
    d.table = static_cast<unsigned char>(e[6]);
    d.flags = static_cast<unsigned char>(flags);
    d.x_row0 = e[8];
    d.tile_start = static_cast<int>(tiles);
    const long long tm = (n + kTile - 1) / kTile, tn = (m + kTile - 1) / kTile;
    d.tiles_n = static_cast<int>(tn);
    d.inv_tiles_n = 1.0f / static_cast<float>(tn);
    tiles += (flags & kSymmetric) ? tm * (tm + 1) / 2 : tm * tn;
    if (tiles > INT_MAX) return cudaErrorInvalidValue;
  }
  p.n_blocks = n_blocks;
  p.n_tiles = static_cast<int>(tiles);
  *out = p;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Params<T>& packed, void* out, long long ldo, const void* d_r,
                   const void* d_c, const void* const* pts, int n_sets, cudaStream_t stream) {
  if (n_sets != packed.n_sets || (d_r == nullptr) != (d_c == nullptr)) return cudaErrorInvalidValue;
  const bool epi = d_r != nullptr;
  if (!epi && packed.map_P) return cudaErrorInvalidValue;  // the row map is K2's
  if (packed.n_tiles == 0) return cudaSuccess;
  Params<T> p = packed;
  p.out = static_cast<T*>(out);
  p.ldo = ldo;
  p.d_r = static_cast<const T*>(d_r);
  p.d_c = static_cast<const T*>(d_c);
  for (int s = 0; s < n_sets; ++s) p.pts[s] = static_cast<const T*>(pts[s]);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0 && ldo % kVec == 0;
  for (int b = 0; b < p.n_blocks; ++b) {
    BlockDesc& d = p.blk[b];
    // K2 writes every entry once: no mirrors, no symmetric shortcut; K1 has no fill
    if (epi ? (d.flags & (kMirror | kSymmetric)) : (d.flags & kFill)) return cudaErrorInvalidValue;
    if (aligned && d.row_off % kVec == 0 && d.col_off % kVec == 0) d.flags |= kAligned;
  }
  return epi ? launch_k2(p, stream) : launch_k1(p, stream);
}

}  // namespace

// C interface bound with ctypes by ops/gram_tile.py.
//
// gram_plan_pack fills the parameters of one plan (gram_plan_params_size()
// bytes at `params`, kept by the caller) from: blocks, 10 ints per block
// (row_off, col_off, n, m, x_set, y_set, table, flags, x_row0, tile_start),
// none of them empty, flags a mix of 1 (mirror), 2 (symmetric) and 8 (fill,
// alone: a K2 block of padding, whose sets and table are not read), x_row0
// equal to row_off unless the plan is mapped; row_map, 4 ints (P, B, L0,
// shift) of a K2 plan on a rank's block-cyclic rows, or 4 zeros; the term
// tables, table i owning terms term_start[i] ..
// term_start[i + 1] - 1, each with its coefficient coef[t] and dim degrees
// degs[t * dim + k]; inv_sq; and poly, dim x 45 Horner coefficients (see
// Params::poly). Returns 0, or cudaErrorInvalidValue for what the kernel
// cannot take.
extern "C" int gram_plan_params_size(int is_double) {
  return is_double ? sizeof(Params<double>) : sizeof(Params<float>);
}

extern "C" int gram_plan_pack(int is_double, int dim, int n_sets, const int* blocks,
                              int n_blocks, const double* inv_sq, const double* poly,
                              const double* coef, const int* degs, const int* term_start,
                              int n_tables, const int* row_map, void* params) {
  if (dim < 1 || dim > kMaxDim || n_sets < 1 || n_sets > kMaxSets || n_blocks < 0 ||
      n_blocks > kMaxBlocks || n_tables < 1 || n_tables > kMaxTables ||
      term_start[n_tables] > kMaxPlanTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? pack<double>(dim, n_sets, blocks, n_blocks, inv_sq, poly, coef, degs,
                                  term_start, n_tables, row_map,
                                  static_cast<Params<double>*>(params))
                   : pack<float>(dim, n_sets, blocks, n_blocks, inv_sq, poly, coef, degs,
                                 term_start, n_tables, row_map,
                                 static_cast<Params<float>*>(params));
}

// gram_plan_launch makes one launch of a packed plan: each point set pts[s]
// is (n_s, dim), row-major and contiguous; out has row stride ldo and unit
// column stride, and every block lies inside it. With d_r and d_c null it
// is K1; with both given (one scale per row and per column of out) it is
// K2, the equilibrated strip, for a plan without mirrored or symmetric
// blocks whose out view starts on the matrix's diagonal (TMA stores where
// out's base and ldo are 16-byte multiples). Launches on `stream` and
// returns cudaGetLastError() (0 on success, an error if the tensor map
// cannot be made); it does not synchronise.
extern "C" int gram_plan_launch(int is_double, const void* params, void* out, long long ldo,
                                const void* d_r, const void* d_c, const void* const* pts,
                                int n_sets, void* stream) {
  if (ldo < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch(*static_cast<const Params<double>*>(params), out, ldo, d_r, d_c, pts,
                         n_sets, s)
                : launch(*static_cast<const Params<float>*>(params), out, ldo, d_r, d_c, pts,
                         n_sets, s);
  return static_cast<int>(err);
}

// The limits above, in the order of ops/gram_tile.py::_LIMITS.
extern "C" void gram_plan_limits(int* out) {
  const int v[] = {kMaxDim, kMaxDeg, kMaxTerms, kMaxPlanTerms, kMaxSets,
                   kMaxBlocks, kMaxTables, kTile, kBlockInts};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}
