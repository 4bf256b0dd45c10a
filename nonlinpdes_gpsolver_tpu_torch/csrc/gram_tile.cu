// Gram tile kernel K1 for Hopper (sm_90a).
//
// Replaces nonlinpdes_gpsolver_tpu/ops/pallas_gram.py::_tile_kernel, the
// Pallas TPU kernel of the JAX package. It evaluates one derivative-kernel
// Gram block
//
//     out[i, j] = sum_beta c_beta * prod_k p_{beta_k}(u_k) * exp(-sum_k a_k u_k^2),
//     u = x_i - y_j,
//
// from a packed term table (built by ops/gram_tile.py::_packed_table from
// the same _combined_terms as the Pallas kernel): the inverse squared
// lengthscales a_k, then per term its coefficient c_beta and, per
// dimension, the ascending Horner coefficients of p_{beta_k} padded to
// kMaxDeg + 1; a separate int table holds each degree beta_k (0: no factor).
//
// Design. A 2-D grid of 64 x 64 output tiles; each block of 32 x 8 threads
// stages its 64 X rows, its 64 Y columns and the whole table in shared
// memory, then every thread evaluates 16 outputs (2 columns x 8 rows) in
// registers. A warp covers 32 consecutive columns of one row, so the stores
// are coalesced along the column index; the row stride `ldo` lets a block
// land straight inside the preallocated Gram matrix. Ragged edges are
// masked (the Pallas version padded its inputs instead).
//
// Precision. In f32 the exponential is the same Cody-Waite routine as
// ops/kernels.py::exp_neg_accurate (rintf, the LN2_HI/LN2_LO split, the
// degree-7 Horner, 2^-k from the exponent bits): the TPU's fast exp pushed
// Gram eigenvalues negative, so no fast-math exp is used and the library
// is never built with -use_fast_math. In f64 it is exp().
//
// Bound on the H100 SXM. The kernel reads O(n + m) coordinates and writes
// n * m outputs, so its floor is the larger of the output bytes at
// 3.35 TB/s and its arithmetic (a few FMAs per Horner step and term, about
// 20 operations for the exponential) at 67 TFLOP/s in f32 or 34 TFLOP/s in
// f64 (data sheet rates). Every block of the elliptic solve is bound by its
// output bytes, and below about 1000 x 1000 outputs by launch latency; the
// kernel is simple and right first, and tuning it is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 3;
constexpr int kMaxDeg = 8;
constexpr int kStride = kMaxDeg + 1;  // Horner coefficients per (term, dim)
constexpr int kMaxTerms = 64;
constexpr int kTileM = 64;            // rows per block
constexpr int kTileN = 64;            // columns per block
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

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

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                 T* __restrict__ out, int64_t n, int64_t m, int64_t ldo,
                 const T* __restrict__ table, const int* __restrict__ degs,
                 int n_terms) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T xs[DIM][kTileM];
  __shared__ T ys[DIM][kTileN];
  const int term_len = 1 + DIM * kStride;
  const int tab_len = DIM + n_terms * term_len;
  T* tab = reinterpret_cast<T*>(smem_raw);
  int* sdeg = reinterpret_cast<int*>(tab + tab_len);

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTileM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  for (int i = tid; i < tab_len; i += kThreads) tab[i] = table[i];
  for (int i = tid; i < n_terms * DIM; i += kThreads) sdeg[i] = degs[i];
  for (int i = tid; i < kTileM * DIM; i += kThreads) {
    const int r = i / DIM, k = i % DIM;
    xs[k][r] = row0 + r < n ? X[(row0 + r) * DIM + k] : T(0);
  }
  for (int i = tid; i < kTileN * DIM; i += kThreads) {
    const int c = i / DIM, k = i % DIM;
    ys[k][c] = col0 + c < m ? Y[(col0 + c) * DIM + k] : T(0);
  }
  __syncthreads();

  const T* inv_sq = tab;
#pragma unroll
  for (int j = 0; j < kTileN / kThreadsX; ++j) {
    const int c = threadIdx.x + j * kThreadsX;
    if (col0 + c >= m) continue;
    for (int i = 0; i < kTileM / kThreadsY; ++i) {
      const int r = threadIdx.y + i * kThreadsY;
      if (row0 + r >= n) break;
      T u[DIM];
      T q = T(0);
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        u[k] = xs[k][r] - ys[k][c];
        q += inv_sq[k] * u[k] * u[k];
      }
      T total = T(0);
      const T* tp = tab + DIM;
      const int* dp = sdeg;
      for (int t = 0; t < n_terms; ++t, tp += term_len, dp += DIM) {
        T term = tp[0];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const int deg = dp[k];
          if (deg > 0) {
            const T* cf = tp + 1 + k * kStride;
            T acc = cf[deg];
            for (int e = deg - 1; e >= 0; --e) acc = acc * u[k] + cf[e];
            term *= acc;
          }
        }
        total += term;
      }
      out[(row0 + r) * ldo + col0 + c] = total * exp_neg(q);
    }
  }
}

template <typename T, int DIM>
cudaError_t launch(const void* X, const void* Y, void* out, int64_t n,
                   int64_t m, int64_t ldo, const void* table, const int* degs,
                   int n_terms, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(static_cast<unsigned>((m + kTileN - 1) / kTileN),
                  static_cast<unsigned>((n + kTileM - 1) / kTileM));
  const size_t smem = (DIM + n_terms * (1 + DIM * kStride)) * sizeof(T) +
                      n_terms * DIM * sizeof(int);
  gram_tile_kernel<T, DIM><<<grid, block, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y), static_cast<T*>(out),
      n, m, ldo, static_cast<const T*>(table), degs, n_terms);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int dim, const void* X, const void* Y, void* out,
                       int64_t n, int64_t m, int64_t ldo, const void* table,
                       const int* degs, int n_terms, cudaStream_t stream) {
  switch (dim) {
    case 1: return launch<T, 1>(X, Y, out, n, m, ldo, table, degs, n_terms, stream);
    case 2: return launch<T, 2>(X, Y, out, n, m, ldo, table, degs, n_terms, stream);
    case 3: return launch<T, 3>(X, Y, out, n, m, ldo, table, degs, n_terms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes by ops/gram_tile.py. X is (n, dim) and Y
// is (m, dim), both row-major and contiguous; out has row stride ldo >= m
// and unit column stride. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int gram_tile_launch(int is_double, const void* X, const void* Y,
                                void* out, long long n, long long m, int dim,
                                long long ldo, const void* table,
                                const int* degs, int n_terms, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (dim < 1 || dim > kMaxDim || n_terms < 0 || n_terms > kMaxTerms ||
      ldo < m || (n + kTileM - 1) / kTileM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch_dim<double>(dim, X, Y, out, n, m, ldo, table, degs, n_terms, s)
                : launch_dim<float>(dim, X, Y, out, n, m, ldo, table, degs, n_terms, s);
  return static_cast<int>(err);
}

extern "C" int gram_tile_max_terms() { return kMaxTerms; }
extern "C" int gram_tile_max_degree() { return kMaxDeg; }
