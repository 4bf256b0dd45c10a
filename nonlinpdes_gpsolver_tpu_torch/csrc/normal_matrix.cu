// The equilibrated normal matrix of the mesh path's 'normal' Gauss-Newton
// step (solvers/distributed.py::_normal_delta), in one pass over the
// interior inverse blocks, on sm_90a.
//
// For one residual block with S live segments of N interior points, s
// latent slices, its (S, N, S, N) interior inverse block A (the regularized
// kernel inverse on the interior rows, contiguous and exactly symmetric as
// both states leave it: at P = 1 potri's order, across ranks the gathered
// solves mirrored from their lower triangle), the (s, S, N) per-slice
// diagonals Dl of the raw Jacobian and
// the s N equilibration scales sc, the kernel writes into H (s N x s N)
//
//   H[jN+q, kN+p] = sc[jN+q] sc[kN+p] sum_r Dl[j,r,q] sum_s A[r,q,s,p] Dl[k,s,p]
//
// (plus H's own value there, to accumulate a second block or the misfits'
// product), and on request 1 + 32 eps on the diagonal. It replaces no TPU
// kernel: the JAX package forms this matrix with XLA einsums
// (nonlinpdes_gpsolver_tpu/solvers/distributed.py, the 'normal' step). Here
// those einsums were six batched products of inner dimension 4 or 1, their
// permute copies, a cat, two adds and the equilibration's outer product and
// scaled copy: about 14 ms a step at Burgers' shapes (S 4, s 3, N 5,000,
// float32) where the bytes allow half a millisecond.
//
// What bounds it: bytes. Per (q, p) pair it reads S^2 floats of A and
// writes s^2 floats of H for about S^2 s + s^2 S multiply-adds (Burgers: 84
// for 100 bytes). The design:
//  * A is symmetric, A[r,q,s,p] = A[s,p,r,q], so its (q, p) and (p, q)
//    tiles hold the same numbers. A block owns a 32 x 32 tile (q, p) with
//    q-tile >= p-tile and reads only those tiles of A: every needed float of
//    A once, half of A. From them it computes every slice pair (j, k) at
//    (q, p) and writes each value twice, at H[jN+q, kN+p] (its direct place)
//    and at the mirror H[kN+p, jN+q], so H is exactly symmetric. Entry
//    (jN+q, kN+p) is direct where q > p, or q = p and j >= k; the rest are
//    mirrors. Each entry of H is written once.
//  * A thread owns one q and four consecutive p: 16-byte streaming loads of
//    A (read once: evict first), 16-byte stores of the direct values, the
//    mirror values transposed through shared memory so that their stores
//    are whole 128-byte rows too. All S^2 loads of a thread are issued
//    before any arithmetic, and two blocks share an SM, so the loads of
//    one overlap the other's arithmetic and stores. There is no cp.async
//    or TMA pipeline through shared memory: the 64 floats of A a thread
//    holds at S = 4 and the t sums fill the 128 registers that two blocks
//    an SM allow (ptxas spills 196-276 bytes a thread), and at 56% of the
//    byte bound, 0.9 ms of a 45 ms step at Burgers' shapes on an H100, a staged
//    pipeline would win at most 0.4 ms a step.
//  * The sums t_k[r] = sum_s A[r,q,s,p] Dl[k,s,p] are formed first and kept
//    in registers, then each output sum_r Dl[j,r,q] t_k[r]; every sum runs
//    in ascending index order, so two launches give the same bits and a
//    recorded CUDA graph replays them.
// It reads nothing on the host and allocates nothing: H comes from the
// caller (torch.empty). Where N is not a multiple of 4 or a pointer is not
// 16-byte aligned, a second instantiation loads and stores floats one by
// one; ragged edges are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                          // q rows and p columns of a block's tile
constexpr int kLanes = 4;                          // consecutive p a thread owns
constexpr int kThreads = kTile * kTile / kLanes;   // 256
constexpr int kMaxSegments = 4;                    // S: live segments of a block
constexpr int kMaxSlices = 6;                      // s: latent slices

struct Params {
  const float* A;    // (S, N, S, N) contiguous
  const float* Dl;   // (s, S, N) contiguous
  const float* sc;   // (s N)
  float* H;          // (s N, s N) row-major, row stride ld = s N
  long long ld;
  int S, s, N;
  int accumulate;    // add H's value at each direct place
  int floor_diag;    // write `diag` on the diagonal
  float diag;
};

template <bool VEC>
__device__ __forceinline__ void load4(const float* p, bool row_ok, int col, int n, float (&v)[kLanes],
                                      bool stream) {
  if (VEC) {
    if (row_ok && col < n) {
      const float4 x = stream ? __ldcs(reinterpret_cast<const float4*>(p))
                              : __ldg(reinterpret_cast<const float4*>(p));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) v[l] = 0.f;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      v[l] = (row_ok && col + l < n) ? (stream ? __ldcs(p + l) : __ldg(p + l)) : 0.f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) normal_matrix_kernel(Params prm) {
  __shared__ float mir[kMaxSlices][kTile][kTile + 1];
  // the tile (Q, P), Q >= P, from the block's place in the lower triangle of tiles
  const long long b = blockIdx.x;
  long long Q = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (Q * (Q + 1) / 2 > b) --Q;
  while ((Q + 1) * (Q + 2) / 2 <= b) ++Q;
  const long long P = b - Q * (Q + 1) / 2;
  const bool diag_tile = Q == P;

  const int N = prm.N, S = prm.S, ns = prm.s;
  const int ty = threadIdx.x / (kTile / kLanes), tx = threadIdx.x % (kTile / kLanes);
  const int q = static_cast<int>(Q) * kTile + ty;
  const int p0 = static_cast<int>(P) * kTile + kLanes * tx;
  const bool q_ok = q < N;
  const long long NN = static_cast<long long>(N);

  float a[kMaxSegments][kMaxSegments][kLanes];
#pragma unroll
  for (int r = 0; r < kMaxSegments; ++r)
#pragma unroll
    for (int s = 0; s < kMaxSegments; ++s) {
      if (r < S && s < S)
        load4<VEC>(prm.A + ((r * NN + q) * S + s) * NN + p0, q_ok, p0, N, a[r][s], true);
      else
#pragma unroll
        for (int l = 0; l < kLanes; ++l) a[r][s][l] = 0.f;
    }

#pragma unroll
  for (int k = 0; k < kMaxSlices; ++k) {
    if (k >= ns) break;
    float dp[kMaxSegments][kLanes], scp[kLanes], t[kMaxSegments][kLanes];
#pragma unroll
    for (int s = 0; s < kMaxSegments; ++s)
      if (s < S) load4<VEC>(prm.Dl + (k * S + s) * NN + p0, true, p0, N, dp[s], false);
    load4<VEC>(prm.sc + k * NN + p0, true, p0, N, scp, false);
#pragma unroll
    for (int r = 0; r < kMaxSegments; ++r)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxSegments; ++s)
          if (s < S) acc = fmaf(a[r][s][l], dp[s][l], acc);
        t[r][l] = acc;
      }
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j >= ns) break;
      float dq[kMaxSegments];
#pragma unroll
      for (int r = 0; r < kMaxSegments; ++r) dq[r] = (r < S && q_ok) ? __ldg(prm.Dl + (j * S + r) * NN + q) : 0.f;
      const float scq = q_ok ? __ldg(prm.sc + j * NN + q) : 0.f;
      float h[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxSegments; ++r)
          if (r < S) v = fmaf(dq[r], t[r][l], v);
        h[l] = (scq * scp[l]) * v;
      }
      float* row = prm.H + (j * NN + q) * prm.ld + k * NN + p0;  // the direct places
      if (VEC && !diag_tile) {  // every q > p: all four direct
        if (q_ok && p0 < N) {
          if (prm.accumulate) {
            const float4 o = *reinterpret_cast<const float4*>(row);
            h[0] = o.x + h[0]; h[1] = o.y + h[1]; h[2] = o.z + h[2]; h[3] = o.w + h[3];
          }
          *reinterpret_cast<float4*>(row) = make_float4(h[0], h[1], h[2], h[3]);
        }
      } else {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          const int p = p0 + l;
          if (q_ok && p < N && (q > p || (q == p && j >= k))) {
            if (prm.accumulate) h[l] = row[l] + h[l];
            if (prm.floor_diag && q == p && j == k) h[l] = prm.diag;
            row[l] = h[l];
          }
        }
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) mir[j][ty][kLanes * tx + l] = h[l];
    }
    __syncthreads();
    // the mirrors: H[kN+p, jN+q] for the tile's (q, p), a warp on 32 consecutive q
    const int qq = threadIdx.x % kTile;
    const int qg = static_cast<int>(Q) * kTile + qq;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j >= ns) break;
#pragma unroll
      for (int i = 0; i < kTile * kTile / kThreads; ++i) {
        const int pp = threadIdx.x / kTile + i * (kThreads / kTile);
        const int pg = static_cast<int>(P) * kTile + pp;
        if (qg < N && pg < N && (qg > pg || (qg == pg && j > k)))
          prm.H[(k * NN + pg) * prm.ld + j * NN + qg] = mir[j][qq][pp];
      }
    }
    __syncthreads();
  }
}

bool aligned(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// C interface bound with ctypes by ops/normal_matrix.py.
//
// normal_matrix_launch: one block's contribution to the equilibrated normal
// matrix, as the note above says: A (S, N, S, N), Dl (s, S, N) and sc (s N)
// contiguous float32, H (s N, s N) contiguous float32; 1 <= S <= 4,
// 1 <= s <= 6, N >= 1. accumulate: add H's value at each direct place
// (else H's contents are not read); floor_diag: write diag on the diagonal.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for what the kernel cannot take); it does not synchronise.
extern "C" int normal_matrix_launch(const float* A, const float* Dl, const float* sc, float* H,
                                    int S, int s, int N, int accumulate, int floor_diag,
                                    float diag, void* stream) {
  if (A == nullptr || Dl == nullptr || sc == nullptr || H == nullptr || S < 1 ||
      S > kMaxSegments || s < 1 || s > kMaxSlices || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (N + kTile - 1) / kTile;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{A, Dl, sc, H, static_cast<long long>(s) * N, S, s, N,
                   accumulate, floor_diag, diag};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && aligned(A) && aligned(Dl) && aligned(sc) && aligned(H);
  if (vec)
    normal_matrix_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(prm);
  else
    normal_matrix_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// The constants above, in the order of ops/normal_matrix.py::_LIMITS.
extern "C" void normal_matrix_limits(int* out) {
  const int v[] = {kTile, kMaxSegments, kMaxSlices};
  for (int i = 0; i < 3; ++i) out[i] = v[i];
}
