// Inverse of a batch of small SPD matrices, for Hopper (sm_90a), in one
// launch and with no host synchronisation.  ops/linalg.py spd_inverse calls
// it for CUDA tensors of n <= 64 (kSpdMaxN).
//
// It replaces no Pallas kernel.  The JAX package inverts these blocks with
// matmuls only (ops/linalg.py spd_inverse_schur, outside any pallas_call);
// the port first took a library chain in their place (cholesky_ex,
// cholesky_solve against the identity, an always-run inv_ex as the fallback,
// two symmetrizations and a where), about 30 launches a call, and
// cholesky_solve and inv_ex's LU factor synchronise the host on every call.
//
// Contract, for each matrix a (n x n) of the batch, float32 or float64,
// computed in float64 whatever the type and rounded once at the end:
//   s = diag(a)^-1/2, a_eq = (a * s_i) * s_j (Jacobi equilibration);
//   the Cholesky factor L of a_eq (lower triangle read, LAPACK dpotf2's
//   order: the pivot less the dot of its row, the column below less the row
//   products, times 1 / L_jj);
//   X = a_eq^-1 by cholesky_solve's order (LAPACK potrs against the
//   identity): each column of the identity solved forward with L and then
//   backward with L^T, dividing by L_ii (dtrsm's order);
//   a matrix whose Cholesky factor fails (a pivot not > 0, or not finite)
//   gets instead the partially pivoted Gauss-Jordan inverse X of the same
//   a_eq (the inverse inv_ex returned), and its refusal flag is 1;
//   out = 0.5 ((X_ij s_i) s_j + (X_ji s_j) s_i): scaled back and exactly
//   symmetric.  A non-finite matrix yields a non-finite inverse in its own
//   place only.
//
// Why float64 inside a float32 call: the block-LDL^T sweep that inverts its
// pivot blocks here applies, in the end, the exact inverse of the matrix
// whose inverse it was given, so the ADMM that follows it sees each
// inverse's rounding as a change of its KKT matrix, and 48 iterations from
// a warm start do not wash it out.  The headline's costs lay 1.6x further
// from the float64 reference than the library chain's did with this
// kernel's arithmetic in float32 as L^-T L^-1 (a product of the triangular
// inverse, LAPACK potri's order), 1.3x with the two solves of the contract
// in float32; the inverse in float64, rounded once, lies 0.6x as far (the
// library chain's own order is not documented).  The float64 arithmetic
// costs ~0.4 ms a call of 40; the bytes read and written keep the call's
// type.
//
// What bounds it on an H100: neither bytes nor operations.  At 6144 x 15x15
// in float32 it reads and writes 11 MB (3.3 us at 3.35 TB/s) and computes
// ~n^3 flops a matrix (0.6 us at 34 TFLOP/s in float64); at 36x36, 64 MB
// (19 us).  A matrix is a chain of n dependent steps in each of three
// phases, so the time is latency: how many matrices are in flight and how
// short a step is.
//
// Design: one warp a matrix, several warps a block, each matrix in shared
// memory (row stride n | 1, odd, so that lanes walking a column hit
// distinct banks): a_eq and then L in one n x n buffer, X in a second, at
// most 2 x 64 x 65 doubles (67 KB) a matrix.  The Cholesky step is one
// warp-synchronous pass (every lane computes the pivot, lanes over the rows
// below), with __syncwarp and no block barrier; in the solves each lane owns
// columns of the identity, reads L (the backward pass the same entry on
// every lane) and writes only its own column of X.  The scaling back uses
// round-to-nearest intrinsics that the compiler does not contract into
// FMAs, so that out_ij and out_ji are the same sum.  The Gauss-Jordan
// fallback is a branch taken by the refused matrices' warps only (the
// refusal is the same for every lane of a warp), after reloading a from
// device memory: its pivot search is a warp reduction, its row swaps and
// eliminations lane-parallel passes over shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSpdMaxN = 64;
constexpr int kWarps = 8;           // matrices a block, at most
constexpr int kDefaultSmem = 48 * 1024;

// Products and sums that are never fused into an FMA (the symmetric
// scaling).
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__host__ __device__ inline int row_stride(int n) { return n | 1; }

// Bytes of shared memory one matrix takes: A and X (n x ld doubles each),
// s and L_jj (n each), the pivot rows (n ints), rounded up to 16.
__host__ __device__ inline size_t matrix_smem_bytes(int n) {
  const size_t b =
      (2 * (size_t)n * row_stride(n) + 2 * (size_t)n) * sizeof(double) +
      (size_t)n * sizeof(int);
  return (b + 15) & ~(size_t)15;
}

inline int warps_a_block(int n) {
  const int w = (int)(kDefaultSmem / matrix_smem_bytes(n));
  return w < 1 ? 1 : (w > kWarps ? kWarps : w);
}

// A <- (a * s_i) * s_j, coalesced over the flat index.
template <typename T>
__device__ void load_equilibrated(const T* __restrict__ am, double* A,
                                  const double* s, int n, int ld, int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    A[i * ld + j] = ((double)am[e] * s[i]) * s[j];
  }
}

// In-place Cholesky of A's lower triangle (dpotf2 order); dg[j] = L_jj.
// The diagonal of A is left as it was.  False (the same on every lane) when
// a pivot is not > 0 or not finite.
__device__ bool cholesky(double* A, double* dg, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    const double* rj = A + j * ld;
    double dot = 0.0;
    for (int k = 0; k < j; ++k) dot = fma(rj[k], rj[k], dot);
    const double d = rj[j] - dot;
    if (!(d > 0.0) || isinf(d)) return false;
    const double ljj = sqrt(d);
    const double r = 1.0 / ljj;
    for (int i = j + 1 + lane; i < n; i += 32) {
      double* ri = A + i * ld;
      double t = ri[j];
      for (int k = 0; k < j; ++k) t = fma(-ri[k], rj[k], t);
      ri[j] = t * r;
    }
    if (lane == 0) dg[j] = ljj;
    __syncwarp();
  }
  return true;
}

// X = a_eq^-1 into X (n x ld), column c by lane c: L z = e_c forward, then
// L^T x = z backward, x over z in place.  Lanes read L (strictly lower, and
// dg) and write only their own columns.
__device__ void solve_identity(const double* A, const double* dg, double* X,
                               int n, int ld, int lane) {
  for (int c = lane; c < n; c += 32) {
    for (int i = 0; i < c; ++i) X[i * ld + c] = 0.0;
    X[c * ld + c] = 1.0 / dg[c];
    for (int i = c + 1; i < n; ++i) {
      const double* li = A + i * ld;
      double t = 0.0;
      for (int k = c; k < i; ++k) t = fma(-li[k], X[k * ld + c], t);
      X[i * ld + c] = t / dg[i];
    }
    for (int i = n - 1; i >= 0; --i) {
      double t = X[i * ld + c];
      for (int k = i + 1; k < n; ++k)
        t = fma(-A[k * ld + i], X[k * ld + c], t);
      X[i * ld + c] = t / dg[i];
    }
  }
  __syncwarp();
}

// out_ij = 0.5 ((X_ij s_i) s_j + (X_ji s_j) s_i), the same sum for out_ji,
// rounded once to the output's type.
template <typename T>
__device__ void write_scaled_symmetric(const double* X, const double* s,
                                       T* __restrict__ om, int n, int ld,
                                       int lane) {
  for (int i = 0; i < n; ++i)
    for (int j = lane; j < n; j += 32)
      om[i * n + j] = (T)mul_rn(
          0.5, add_rn(mul_rn(mul_rn(X[i * ld + j], s[i]), s[j]),
                      mul_rn(mul_rn(X[j * ld + i], s[j]), s[i])));
}

// Partially pivoted Gauss-Jordan inverse of A in place (the pivot: the
// first row of largest magnitude in the column, as LAPACK's i?amax).
__device__ void gauss_jordan(double* A, int* piv, int n, int ld, int lane) {
  for (int k = 0; k < n; ++k) {
    double best = -1.0;
    int row = k;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(A[i * ld + k]);
      if (v > best) { best = v; row = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int orow = __shfl_xor_sync(0xffffffffu, row, off);
      if (ob > best || (ob == best && orow < row)) { best = ob; row = orow; }
    }
    if (row != k) {
      for (int j = lane; j < n; j += 32) {
        const double t = A[k * ld + j];
        A[k * ld + j] = A[row * ld + j];
        A[row * ld + j] = t;
      }
    }
    if (lane == 0) piv[k] = row;
    __syncwarp();
    const double rp = 1.0 / A[k * ld + k];
    __syncwarp();
    for (int j = lane; j < n; j += 32)
      A[k * ld + j] = (j == k ? 1.0 : A[k * ld + j]) * rp;
    __syncwarp();
    const double* rk = A + k * ld;
    for (int i = lane; i < n; i += 32) {
      if (i == k) continue;
      double* ri = A + i * ld;
      const double f = ri[k];
      for (int j = 0; j < n; ++j) ri[j] = (j == k ? 0.0 : ri[j]) - f * rk[j];
    }
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    const int p = piv[k];
    if (p != k) {
      for (int i = lane; i < n; i += 32) {
        const double t = A[i * ld + k];
        A[i * ld + k] = A[i * ld + p];
        A[i * ld + p] = t;
      }
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spd_inverse_kernel(const T* __restrict__ a, T* __restrict__ out,
                   int* __restrict__ refused, int batch, int n, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * per_block + warp;
  if (m >= batch) return;                  // the whole warp: no block barrier
  const int ld = row_stride(n);
  double* A = reinterpret_cast<double*>(smem + warp * matrix_smem_bytes(n));
  double* X = A + n * ld;
  double* s = X + n * ld;
  double* dg = s + n;
  int* piv = reinterpret_cast<int*>(dg + n);
  const T* am = a + (size_t)m * n * n;
  T* om = out + (size_t)m * n * n;

  for (int i = lane; i < n; i += 32) s[i] = rsqrt((double)am[i * n + i]);
  __syncwarp();
  load_equilibrated(am, A, s, n, ld, lane);
  __syncwarp();
  const bool ok = cholesky(A, dg, n, ld, lane);
  __syncwarp();
  if (ok) {
    solve_identity(A, dg, X, n, ld, lane);
    write_scaled_symmetric(X, s, om, n, ld, lane);
  } else {
    load_equilibrated(am, A, s, n, ld, lane);
    __syncwarp();
    gauss_jordan(A, piv, n, ld, lane);
    write_scaled_symmetric(A, s, om, n, ld, lane);
  }
  if (lane == 0) refused[m] = ok ? 0 : 1;
}

template <typename T>
int launch(const void* a, void* out, int* refused, int batch, int n,
           cudaStream_t stream) {
  const int w = warps_a_block(n);
  const size_t smem = (size_t)w * matrix_smem_bytes(n);
  const int grid = (batch + w - 1) / w;
  if (smem > (size_t)kDefaultSmem) {        // from n = 55: one warp
    const cudaError_t e = cudaFuncSetAttribute(
        spd_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spd_inverse_kernel<T><<<grid, w * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), refused, batch, n, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Inverts `batch` contiguous n x n matrices of a (elt 4: float, 8: double)
// into out, and writes each matrix's refusal flag (1: the Cholesky factor
// failed and the pivoted Gauss-Jordan inverse was taken) to refused, on
// `stream`.  Returns the CUDA error code of the launch (0 on success); does
// not synchronise.
extern "C" int spd_inverse_launch(const void* a, void* out, int* refused,
                                  int batch, int n, int elt, void* stream) {
  if (n < 1 || n > kSpdMaxN || batch < 1 || (elt != 4 && elt != 8))
    return (int)cudaErrorInvalidValue;
  if (elt == 4)
    return launch<float>(a, out, refused, batch, n, (cudaStream_t)stream);
  return launch<double>(a, out, refused, batch, n, (cudaStream_t)stream);
}
