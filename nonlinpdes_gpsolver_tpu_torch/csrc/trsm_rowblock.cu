// Triangular solves of narrow panels at P = 1: Y = L^{-1} V or Y = L^{-T} V
// for the lower factor L of the mesh path (parallel/cholesky.py), in one
// launch, on sm_90a.
//
// Counterpart of the JAX package's _trsm_kernel and _trsm_t_kernel
// (nonlinpdes_gpsolver_tpu/parallel/cholesky.py:368-465), which are plain JAX
// (a fori_loop of GEMMs), not Pallas: block by block, the right-hand side
// less the product of the solved blocks, finished by one product with the
// factor's Newton-refined diagonal-block inverse, never by substitution.
// Here a step is 256 rows; a factor block of B = 256 r rows gives its r
// diagonal step-blocks of diag_inv as the steps' inverses (the diagonal
// blocks of a lower triangular inverse are the inverses of the diagonal
// blocks, and they are at least as refined as the whole).
//
// What bounds it: reading the lower triangle once (n^2/2 floats) against
// n^2 k multiply-adds. At the Woodbury step's k = 61 the f32 FFMA rate bounds
// it (no tensor cores: TF32 is below the solver's precision); at k = 1 the
// bytes do. cuBLAS runs these panels as a chain of small trsm and GEMM
// launches at a few percent of either bound.
//
// The design: a persistent launch of one block per SM. The first 16 or 32
// blocks to start own the chain: each takes 16 rows of every step (and 32
// of a 64-wide panel's columns, so that a step's diagonal products are
// spread over twice the blocks): first the step's right-hand side
// R_s = V_s - (the bulk sums) - A_{s,s-1} Y_{s-1}, then Y_s = W_s R_s, each
// phase released to the others by a counter (release and acquire at gpu
// scope), its A loaded before the wait and V_s less the sums taken while
// Y_{s-1} is on its way. Every other block takes bulk items by an atomic
// ticket: (row step i, 64-row quarter q, chunk c of the column steps
// j < i - 1, 4,096 rows a chunk), dealt chunk-major, so that an item waits
// only on steps and items dealt before it (no block waits on one that has
// not started, whatever runs beside the launch). An item multiplies its
// tiles as their Y_j are released (cp.async ring of 64-wide chunks, 8 x 8
// register tiles), each tile's products summed apart and the tiles' sums
// added in order (one running total over a chunk lost up to 4x cuBLAS's
// accuracy on the cells' factors), then adds its sum to the row's running
// sum in chunk order (that sum lives in the output rows, which the chain
// overwrites with Y_i once it has read them). Sums are taken in a fixed
// order everywhere: two launches on the same inputs give the same bits. The
// lower triangle is read once per solve; the upper never. Scratch: the
// output (n_pad x 16 or 64), two steps of right-hand sides and the
// counters, all from the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kStep = 256;                   // rows of a step
constexpr int kMaxCols = 64;                 // widest panel
constexpr int kPiece = 16;                   // rows of a chain block's share of a step
constexpr int kQuarter = 64;                 // rows of a bulk item
constexpr int kChunk = 64;                   // inner length of a pipeline stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kLdRow = kChunk + 4;           // row-major A stage: rows of 64 (+4) floats
constexpr int kAStage = 64 * (64 + 4);       // floats of an A stage, either layout

template <int KC>
__host__ __device__ constexpr int stage_floats() { return kAStage + kChunk * KC; }
template <int KC>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_floats<KC>() * 4; }

struct Params {
  const float* L;     // (n_pad, n_pad) lower factor, row-major, row stride ldl
  long long ldl;
  const float* W;     // (n_pad / wblock, wblock, wblock) diagonal-block inverses
  int wblock;
  const float* V;     // (nv, k) right-hand sides, strides (vsr, vsc); rows >= nv read as 0
  long long vsr, vsc;
  int nv;
  float* Y;           // (n_pad, KC) result, row-major; the bulk sums before it
  float* R;           // (2, step, KC) right-hand sides of the last two steps
  int* flags;         // 2 + (2 + step / 64) nb zeroed counters
  int step, nb, k, cw;  // rows a step (kStep), steps, columns, column steps a bulk chunk
  int chain, quarters, chunks;  // chain blocks, step / 64, step / 64
};

struct Tile {
  const float* a;     // A(row, inner) = a[row * lda + inner], or a[inner * lda + row] when TRANS
  long long lda;
  const float* x;     // X(inner, col) = x[inner * KC + col]
  const int* flag;    // released when x is ready (flag >= target), or null
  int target;
  int ch0, ch1;       // 64-wide inner chunks of the tile to multiply
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_wait_pending(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Block-wide: wait until *flag >= target; afterwards every thread sees what
// was released before it. The chain polls without a pause (it is the
// critical path); the bulk blocks pause between polls.
template <bool SPIN = false>
__device__ __forceinline__ void wait_at_least(const int* flag, int target) {
  if (threadIdx.x == 0) {
    while (ld_acquire(flag) < target) {
      if (!SPIN) __nanosleep(32);
    }
  }
  __syncthreads();
}
// Block-wide and uniform: whether *flag >= target now.
__device__ __forceinline__ bool ready(const int* flag, int target, int* word) {
  if (threadIdx.x == 0) *word = ld_acquire(flag) >= target;
  __syncthreads();
  const bool r = *word;
  __syncthreads();
  return r;
}
// Block-wide: release everything the block wrote by one increment of *flag
// (the barrier orders the block's writes before thread 0's release).
__device__ __forceinline__ void signal(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(flag);
}

__device__ __forceinline__ int nchunks(int step, int cw) { return step >= 2 ? (step - 2) / cw + 1 : 0; }

// Into L2: the A tile's H rows of `step` floats, or its `step` rows of H
// floats (64-byte aligned) when TRANS.
template <bool TRANS, int H>
__device__ void prefetch_tile(const Tile& t, int step) {
  if (!TRANS) {
    const int lines = step / 32;
    for (int v = threadIdx.x; v < H * lines; v += kThreads)
      prefetch_l2(t.a + static_cast<long long>(v / lines) * t.lda + (v % lines) * 32);
  } else {
    constexpr int lines = (H * 4 + 127) / 128;
    for (int v = threadIdx.x; v < step * lines; v += kThreads)
      prefetch_l2(t.a + static_cast<long long>(v / lines) * t.lda + (v % lines) * 32);
  }
}

// A of chunk `ch`: H rows of 64 floats, or 64 rows of H floats when TRANS.
template <bool TRANS, int H>
__device__ __forceinline__ void load_a(const Tile& t, int ch, float* stage) {
  const int kb = ch * kChunk;
  if (!TRANS) {
    for (int v = threadIdx.x; v < H * 16; v += kThreads) {
      const int r = v >> 4, q = v & 15;
      cp16(stage + r * kLdRow + 4 * q, t.a + r * t.lda + kb + 4 * q);
    }
  } else {
    constexpr int Q = H / 4;
    for (int v = threadIdx.x; v < 64 * Q; v += kThreads) {
      const int r = v / Q, q = v % Q;
      cp16(stage + r * (H + 4) + 4 * q, t.a + (kb + r) * t.lda + 4 * q);
    }
  }
}

// X of chunk `ch`: 64 rows of the N columns from t.x (row stride KC).
template <int KC, int N>
__device__ __forceinline__ void load_x(const Tile& t, int ch, float* stage) {
  constexpr int Q = N / 4;
  float* xs = stage + kAStage;
  const int kb = ch * kChunk;
  for (int v = threadIdx.x; v < 64 * Q; v += kThreads) {
    const int r = v / Q, q = v % Q;
    cp16(xs + r * N + 4 * q, t.x + (kb + r) * KC + 4 * q);
  }
}

// Threads form G groups of H*N/(TM*TN) threads, each thread a TM x TN tile
// of the H x N product; group g takes its share of every chunk's 64 inner
// indices. A thread's rows are consecutive where A is staged inner-major
// (TRANS), else spread H/TM apart, so that a warp's reads of A hit distinct
// banks either way.
template <bool TRANS, int H, int N, int TM, int TN>
struct Frag {
  static constexpr int TG = H * N / (TM * TN), G = kThreads / TG, KPG = kChunk / G;
  static_assert(G >= 1 && KPG % 4 == 0 && TM % 4 == 0 && TN % 4 == 0, "tile shape");
  __device__ static int row(int ty, int r) { return TRANS ? ty * TM + r : ty + r * (H / TM); }
};

template <bool TRANS, int H, int N, int TM, int TN>
__device__ __forceinline__ void compute_chunk(float (&acc)[TM][TN], const float* stage) {
  using F = Frag<TRANS, H, N, TM, TN>;
  const float* as = stage;
  const float* xs = stage + kAStage;
  const int g = threadIdx.x / F::TG, t = threadIdx.x % F::TG;
  const int ty = t / (N / TN), c0 = (t % (N / TN)) * TN;
#pragma unroll 2
  for (int bb = 0; bb < F::KPG; bb += 4) {
    const int b = g * F::KPG + bb;
    float a[TM][4];
    if (!TRANS) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(as + F::row(ty, r) * kLdRow + b);
        a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(as + (b + u) * (H + 4) + ty * TM + 4 * q);
          a[4 * q][u] = v.x; a[4 * q + 1][u] = v.y; a[4 * q + 2][u] = v.z; a[4 * q + 3][u] = v.w;
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (b + u) * N + c0 + 4 * q);
        x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r][u], x[c], acc[r][c]);
    }
  }
}

// The H x N product into out[0 .. H*N) (row-major), the groups' shares
// summed in group order.
template <bool TRANS, int H, int N, int TM, int TN>
__device__ void store_result(const float (&acc)[TM][TN], float* out) {
  using F = Frag<TRANS, H, N, TM, TN>;
  const int g = threadIdx.x / F::TG, t = threadIdx.x % F::TG;
  const int ty = t / (N / TN), c0 = (t % (N / TN)) * TN;
  float* mine = out + g * H * N;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(mine + F::row(ty, r) * N + c0 + 4 * q) =
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
  if (F::G > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < H * N; e += kThreads) {
      float s = out[e];
      for (int gg = 1; gg < F::G; ++gg) s += out[gg * H * N + e];
      out[e] = s;
    }
  }
  __syncthreads();
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
}

// acc = the sum over the tiles get(0 .. ntiles) of A X, chunk by chunk
// within a tile, and the tiles' sums added in tile order (a sum of a few
// thousand terms in one running total lost up to 4x the accuracy of
// cuBLAS's solve on the cells' factors). A tile's chunks are loaded once its
// flag is released; the loads run up to kStages - 1 chunks ahead of the
// products.
template <bool TRANS, int H, int KC, int N, int TM, int TN, bool SPIN, class Get>
__device__ void mma_run(float (&acc)[TM][TN], int ntiles, Get get, int step, float* smem, int* word) {
  zero(acc);
  if (ntiles <= 0) return;
  int total = 0;
  for (int t = 0; t < ntiles; ++t) {
    const Tile tt = get(t);
    total += tt.ch1 - tt.ch0;
  }
  float part[TM][TN];
  zero(part);
  int done_tile = 0, left = get(0).ch1 - get(0).ch0;  // the compute side's tile
  int issued = 0, it = 0;
  Tile cur = get(0);
  int ic = cur.ch0;
  bool open = cur.flag == nullptr;
  if (ntiles > 1) prefetch_tile<TRANS, H>(get(1), step);
  for (int k = 0; k < total; ++k) {
    while (issued < total && issued < k + kStages) {
      if (!open) {
        if (issued == k) wait_at_least<SPIN>(cur.flag, cur.target);
        else if (!ready(cur.flag, cur.target, word)) break;
        open = true;
      }
      float* stage = smem + (issued % kStages) * stage_floats<KC>();
      load_a<TRANS, H>(cur, ic, stage);
      load_x<KC, N>(cur, ic, stage);
      cp_commit();
      ++issued;
      if (++ic == cur.ch1 && ++it < ntiles) {
        cur = get(it);
        ic = cur.ch0;
        open = cur.flag == nullptr;
        if (it + 1 < ntiles) prefetch_tile<TRANS, H>(get(it + 1), step);
      }
    }
    cp_wait_pending(issued - k - 1);
    __syncthreads();
    compute_chunk<TRANS, H, N, TM, TN>(part, smem + (k % kStages) * stage_floats<KC>());
    __syncthreads();
    if (--left == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] += part[r][c];
      zero(part);
      if (++done_tile < ntiles) left = get(done_tile).ch1 - get(done_tile).ch0;
    }
  }
}

// acc = A X of one chain tile: its A loaded before its flag is waited for,
// its X after, all chunks in flight at once (where they fit the ring).
template <bool TRANS, int H, int KC, int N, int TM, int TN>
__device__ void mma_tile(float (&acc)[TM][TN], const Tile& t, int step, float* smem, int* word) {
  const int nch = t.ch1 - t.ch0;
  if (nch > kStages) {
    prefetch_tile<TRANS, H>(t, step);
    mma_run<TRANS, H, KC, N, TM, TN, true>(acc, 1, [&](int) { return t; }, step, smem, word);
    return;
  }
  zero(acc);
  for (int i = 0; i < nch; ++i) load_a<TRANS, H>(t, t.ch0 + i, smem + i * stage_floats<KC>());
  cp_commit();
  wait_at_least<true>(t.flag, t.target);
  for (int i = 0; i < nch; ++i) {
    load_x<KC, N>(t, t.ch0 + i, smem + i * stage_floats<KC>());
    cp_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_wait_pending(nch - 1 - i);
    __syncthreads();
    compute_chunk<TRANS, H, N, TM, TN>(acc, smem + i * stage_floats<KC>());
  }
  __syncthreads();
}

// Chain block `role`: rows piece*16 .. +16 and the N columns from c0 of
// every step, in step order (N = 32 of a 64-wide panel, so that a step's
// diagonal products are spread over twice the blocks, else the panel).
template <int KC>
__host__ __device__ constexpr int chain_cols() { return KC == 64 ? 32 : KC; }

template <bool TRANS, int KC>
__device__ void chain(const Params& p, int role, float* smem, int* word) {
  constexpr int N = chain_cols<KC>();
  constexpr int kPer = kPiece * N / kThreads;  // entries of a piece per thread
  const int S = p.step, piece = role / (KC / N), c0 = (role % (KC / N)) * N;
  int* flag_r = p.flags + 2;
  int* flag_y = flag_r + p.nb;
  const int* sums = flag_y + p.nb;
  const int per_w = p.wblock / S;
  float acc[4][4];
  for (int s = 0; s < p.nb; ++s) {
    const int blk = TRANS ? p.nb - 1 - s : s;
    const int row0 = blk * S + piece * kPiece;
    // R_s = V_s - (bulk sums) - A_{s,s-1} Y_{s-1}, on this block's entries;
    // the first two terms while Y_{s-1} is on its way, where the sums are in
    const int nch = nchunks(s, p.cw);
    const int* sum_flag = sums + s * p.quarters + piece / (kQuarter / kPiece);
    float base[kPer];
    auto take_base = [&]() {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = threadIdx.x + u * kThreads, row = row0 + e / N, c = c0 + e % N;
        float v = (row < p.nv && c < p.k) ? p.V[row * p.vsr + c * p.vsc] : 0.f;
        if (nch) v -= __ldcg(p.Y + static_cast<long long>(row) * KC + c);
        base[u] = v;
      }
    };
    const bool early = !nch || ready(sum_flag, nch, word);
    if (early) take_base();
    if (s > 0) {
      const int pblk = TRANS ? blk + 1 : blk - 1;
      Tile t;
      t.a = TRANS ? p.L + static_cast<long long>(pblk) * S * p.ldl + row0
                  : p.L + static_cast<long long>(row0) * p.ldl + pblk * S;
      t.lda = p.ldl;
      t.x = p.Y + static_cast<long long>(pblk) * S * KC + c0;
      t.flag = flag_y + s - 1;
      t.target = p.chain;
      t.ch0 = 0;
      t.ch1 = p.chunks;
      mma_tile<TRANS, kPiece, KC, N, 4, 4>(acc, t, S, smem, word);
      store_result<TRANS, kPiece, N, 4, 4>(acc, smem);
    }
    if (!early) {
      wait_at_least<true>(sum_flag, nch);
      take_base();
    }
    float* rs = p.R + (s & 1) * S * KC;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kThreads;
      __stcg(rs + (piece * kPiece + e / N) * KC + c0 + e % N, s > 0 ? base[u] - smem[e] : base[u]);
    }
    signal(flag_r + s);
    // Y_s = W_s R_s on this block's entries (W_s lower: only its nonzero chunks)
    {
      const float* w = p.W + static_cast<long long>(blk / per_w) * p.wblock * p.wblock +
                       static_cast<long long>(blk % per_w) * S * (p.wblock + 1);
      Tile t;
      t.a = TRANS ? w + piece * kPiece : w + static_cast<long long>(piece) * kPiece * p.wblock;
      t.lda = p.wblock;
      t.x = rs + c0;
      t.flag = flag_r + s;
      t.target = p.chain;
      t.ch0 = TRANS ? piece * kPiece / kChunk : 0;
      t.ch1 = TRANS ? p.chunks : piece * kPiece / kChunk + 1;
      mma_tile<TRANS, kPiece, KC, N, 4, 4>(acc, t, S, smem, word);
      store_result<TRANS, kPiece, N, 4, 4>(acc, smem);
      for (int e = threadIdx.x; e < kPiece * N; e += kThreads)
        __stcg(p.Y + static_cast<long long>(row0 + e / N) * KC + c0 + e % N, smem[e]);
      signal(flag_y + s);
    }
  }
}

// Bulk items by ticket, chunk-major: ticket order (c, i, q).
template <bool TRANS, int KC>
__device__ void bulk(const Params& p, float* smem, int* word) {
  const int S = p.step;
  const int* flag_y = p.flags + 2 + p.nb;
  int* sums = p.flags + 2 + 2 * p.nb;
  float acc[8][8];
  for (;;) {
    if (threadIdx.x == 0) word[1] = atomicAdd(p.flags, 1);
    __syncthreads();
    int t = word[1];
    __syncthreads();
    int c = 0, i = -1, q = 0;
    for (;; ++c) {
      const int rows = p.nb - c * p.cw - 2;  // row steps i >= c cw + 2 have a chunk c
      if (rows <= 0) break;
      if (t < p.quarters * rows) {
        i = c * p.cw + 2 + t / p.quarters;
        q = t % p.quarters;
        break;
      }
      t -= p.quarters * rows;
    }
    if (i < 0) return;
    const int blk = TRANS ? p.nb - 1 - i : i;
    const int row0 = blk * S + q * kQuarter;
    const int j0 = c * p.cw, j1 = min(j0 + p.cw, i - 1);
    auto get = [&](int tt) {
      const int j = j0 + tt, cb = TRANS ? p.nb - 1 - j : j;
      Tile x;
      x.a = TRANS ? p.L + static_cast<long long>(cb) * S * p.ldl + row0
                  : p.L + static_cast<long long>(row0) * p.ldl + cb * S;
      x.lda = p.ldl;
      x.x = p.Y + static_cast<long long>(cb) * S * KC;
      x.flag = flag_y + j;
      x.target = p.chain;
      x.ch0 = 0;
      x.ch1 = p.chunks;
      return x;
    };
    prefetch_tile<TRANS, kQuarter>(get(0), S);
    mma_run<TRANS, kQuarter, KC, KC, 8, 8, false>(acc, j1 - j0, get, S, smem, word);
    store_result<TRANS, kQuarter, KC, 8, 8>(acc, smem);
    int* cnt = sums + i * p.quarters + q;
    if (c > 0) wait_at_least(cnt, c);
    for (int e = threadIdx.x; e < kQuarter * KC; e += kThreads) {
      float* y = p.Y + static_cast<long long>(row0) * KC + e;
      __stcg(y, c > 0 ? __ldcg(y) + smem[e] : smem[e]);
    }
    signal(cnt);
  }
}

template <bool TRANS, int KC>
__global__ void __launch_bounds__(kThreads, 1) trsm_rowblock_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int word[2];
  if (threadIdx.x == 0) word[0] = atomicAdd(p.flags + 1, 1);
  __syncthreads();
  const int role = word[0];
  __syncthreads();
  if (role < p.chain) chain<TRANS, KC>(p, role, smem, word);
  else bulk<TRANS, KC>(p, smem, word);
}

template <bool TRANS, int KC>
cudaError_t prepare_one() {
  return cudaFuncSetAttribute(trsm_rowblock_kernel<TRANS, KC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<KC>());
}

template <bool TRANS, int KC>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  trsm_rowblock_kernel<TRANS, KC><<<grid, kThreads, smem_bytes<KC>(), stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// C interface bound with ctypes by ops/trsm_rowblock.py.
//
// trsm_rowblock_prepare sets the launch attributes of every instantiation
// (once, before the first launch). Returns cudaGetLastError()-style codes.
extern "C" int trsm_rowblock_prepare() {
  cudaError_t e = prepare_one<false, 16>();
  if (e == cudaSuccess) e = prepare_one<false, 64>();
  if (e == cudaSuccess) e = prepare_one<true, 16>();
  if (e == cudaSuccess) e = prepare_one<true, 64>();
  return static_cast<int>(e);
}

// trsm_rowblock_launch: Y = L^{-1} V (trans 0) or L^{-T} V (trans 1) in
// steps of kStep (256) rows. L is (n_pad, n_pad) = (256 nb, 256 nb)
// row-major with row stride ldl (a multiple of 4), lower, its padding rows
// the identity; W holds the (n_pad / wblock, wblock, wblock) refined
// inverses of its diagonal blocks (wblock a multiple of 256), contiguous;
// V is (nv, k) with element strides vsr and vsc, 1 <= k <= kc, kc 16 or 64;
// Y is (n_pad, kc) row-major and receives the result (its columns >= k
// zero); R holds 2 256 kc floats; flags holds 2 + (2 + 256 / 64) nb ints,
// all zero; cw >= 1 column steps a bulk chunk; grid > 256 / 16 blocks (one
// an SM). L, W, Y and R 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel cannot
// take); it does not synchronise.
extern "C" int trsm_rowblock_launch(int trans, int kc, const float* L, long long ldl,
                                    const float* W, int wblock, const float* V, long long vsr,
                                    long long vsc, int nv, float* Y, float* R, int* flags,
                                    int nb, int k, int cw, int grid, void* stream) {
  constexpr int step = kStep;
  if ((kc != 16 && kc != 64) || k < 1 || k > kc ||
      nb < 1 || nv < 0 || nv > nb * step || wblock < step || wblock % step ||
      (nb * step) % wblock || ldl < nb * step || ldl % 4 || cw < 1 || grid <= step / kPiece ||
      !aligned(L) || !aligned(W) || !aligned(Y) || !aligned(R) || flags == nullptr ||
      (V == nullptr && nv > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chain = step / kPiece * (kc == 64 ? 64 / chain_cols<64>() : 16 / chain_cols<16>());
  if (grid <= chain) return static_cast<int>(cudaErrorInvalidValue);
  Params p{L, ldl, W, wblock, V, vsr, vsc, nv, Y, R, flags,
           step, nb, k, cw, chain, step / kQuarter, step / kChunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans) return static_cast<int>(kc == 16 ? launch<true, 16>(p, grid, s) : launch<true, 64>(p, grid, s));
  return static_cast<int>(kc == 16 ? launch<false, 16>(p, grid, s) : launch<false, 64>(p, grid, s));
}

// The constants above, in the order of ops/trsm_rowblock.py::_LIMITS.
extern "C" void trsm_rowblock_limits(int* out) {
  const int v[] = {kStep, kMaxCols, kPiece, kQuarter};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}
