// The block-tridiagonal band of the Gram G^T G of the tube-constrained QCQP,
// per scenario, for Hopper (sm_90a).  Three entry points of one kernel:
//
//   gram_band_launch          replaces the Pallas TPU kernel
//       _kernel_gram_band of the JAX package's ops/admm_kernel.py
//       (gram_band; both of its per_block code paths compute the same band);
//   gram_band_factors_launch  replaces _kernel_gram_band_factors
//       (gram_band_factors): the KKT band db = pb_d + rho gd + sigma I,
//       ub = pb_u + rho gu, added as the band is stored;
//   gram_band_factors_ew_launch  replaces _kernel_gram_band_factors_ew
//       (gram_band_factors_ew): the same KKT band with G^T given as its
//       rank-1 row factors e (nfd/3, m_p) and w (3, m_p),
//       gt[p*3 + d, l] = e[p, l] * w[d, l].  Only the slab loads differ: a
//       slab entry is that product rounded once (__fmul_rn), so on the same
//       inputs it gives the bits of gram_band_factors on the expanded G^T.
//       A 15-row block is 5 free derivatives x 3 dimensions.
//
// With A_r = gt[r*blk:(r+1)*blk, :] (blk rows of G^T, m_p lanes):
//   gd[r] = A_r A_r^T          (r = 0 .. m_blk-1)
//   gu[r] = A_r A_{r+1}^T      (r = 0 .. m_blk-2)
// Only these 2 m_blk - 1 blocks are formed (17 of the 81 at the flagship
// shape), never the full (nfd, nfd) Gram.
//
// Design.  One thread block per scenario reads its G^T (or its factors) once: a window of
// two blk x m_p row slabs in shared memory (2 x 30 KB at blk 15, m_p 512),
// slab r+1 loaded while slab r is still current.  A thread owns entry
// (i, j) of both blocks of a step and reduces over the lanes, four
// interleaved partial sums combined as (p0 + p1) + (p2 + p3): a fixed order,
// no atomics, the same bits on every run.  Slab rows are stored with a
// stride of m_p + 1 floats, so the rows a warp reads at one lane fall in
// different banks.
//
// What bounds it on an H100: G^T is read once (1.7 GB at batch 6144), and
// the work is 2 blk^2 m_p multiply-adds a block pair (about 4.4 MFLOP a
// scenario at the flagship shape), so by its inputs it is bound by bytes.
// As built every multiply-add reads two operands from shared memory (one is
// shared with the other block), which bounds it on shared-memory bandwidth
// instead; a register tile per thread would lift that and is left for later.
// The ew entry point reads the factors, 48 of G^T's 135 rows' worth of bytes,
// so by its inputs it is bound by operations; as built, by the same
// shared-memory reads.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct GramArgs {
  const float* gt;    // (B, nfd, m_p), or null (ew)
  const float* e;     // (B, nfd/3, m_p)        ew: G^T's row factors
  const float* w;     // (B, 3, m_p)            ew
  const float* pb_d;  // (B, m_blk, blk, blk) or null (gram_band)
  const float* pb_u;  // (B, m_blk-1, blk, blk) or null
  const float* rho;   // (B) or null
  float* d;           // (B, m_blk, blk, blk): gd, or db
  float* u;           // (B, m_blk-1, blk, blk): gu, or ub
  int nfd, m_p, blk;
  float sigma;
};

// Dimensions of the problem: rows of w, and G^T rows per free derivative.
constexpr int kDims = 3;

// G^T of one scenario as stored, (nfd, m_p) row-major.
struct GtStored {
  const float* gt;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return gt[(size_t)r * m_p + l];
  }
};

// G^T of one scenario from its row factors e (nfd/3, m_p) and w (3, m_p).
struct GtFactors {
  const float* e;
  const float* w;
  __device__ __forceinline__ float at(int r, int l, int m_p) const {
    return __fmul_rn(e[(size_t)(r / kDims) * m_p + l], w[(r % kDims) * m_p + l]);
  }
};

template <class G>
__device__ __forceinline__ void load_slab(const G& gt, float* slab, int row0,
                                          int blk, int m_p, int ld) {
  for (int idx = threadIdx.x; idx < blk * m_p; idx += blockDim.x) {
    const int i = idx / m_p, l = idx - i * m_p;
    slab[i * ld + l] = gt.at(row0 + i, l, m_p);
  }
}

// The band of scenario blockIdx.x, G^T from `gt`.
template <class G>
__device__ __forceinline__ void band(const GramArgs& a, const G& gt) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int blk = a.blk, m_p = a.m_p, ld = m_p + 1;
  const int m_blk = a.nfd / blk, bb = blk * blk;
  const bool factors = a.pb_d != nullptr;
  const float rho = factors ? a.rho[s] : 1.0f;
  float* slab[2] = {smem, smem + blk * ld};

  load_slab(gt, slab[0], 0, blk, m_p, ld);
  for (int r = 0; r < m_blk; ++r) {
    const float* cur = slab[r & 1];
    float* nxt = slab[(r + 1) & 1];
    const bool upper = r + 1 < m_blk;
    if (upper) load_slab(gt, nxt, (r + 1) * blk, blk, m_p, ld);
    __syncthreads();
    for (int e = threadIdx.x; e < bb; e += blockDim.x) {
      const int i = e / blk, j = e - i * blk;
      const float* ai = cur + i * ld;
      const float* aj = cur + j * ld;
      const float* bj = nxt + j * ld;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
      float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f, u3 = 0.0f;
      if (upper) {
        for (int l = 0; l < m_p; l += 4) {
          const float x0 = ai[l], x1 = ai[l + 1], x2 = ai[l + 2],
                      x3 = ai[l + 3];
          d0 = fmaf(x0, aj[l], d0);
          d1 = fmaf(x1, aj[l + 1], d1);
          d2 = fmaf(x2, aj[l + 2], d2);
          d3 = fmaf(x3, aj[l + 3], d3);
          u0 = fmaf(x0, bj[l], u0);
          u1 = fmaf(x1, bj[l + 1], u1);
          u2 = fmaf(x2, bj[l + 2], u2);
          u3 = fmaf(x3, bj[l + 3], u3);
        }
      } else {
        for (int l = 0; l < m_p; l += 4) {
          d0 = fmaf(ai[l], aj[l], d0);
          d1 = fmaf(ai[l + 1], aj[l + 1], d1);
          d2 = fmaf(ai[l + 2], aj[l + 2], d2);
          d3 = fmaf(ai[l + 3], aj[l + 3], d3);
        }
      }
      const float gd = (d0 + d1) + (d2 + d3);
      const size_t od = ((size_t)s * m_blk + r) * bb + e;
      if (factors) {
        float v = a.pb_d[od] + rho * gd;
        if (i == j) v += a.sigma;
        a.d[od] = v;
      } else {
        a.d[od] = gd;
      }
      if (upper) {
        const float gu = (u0 + u1) + (u2 + u3);
        const size_t ou = ((size_t)s * (m_blk - 1) + r) * bb + e;
        a.u[ou] = factors ? a.pb_u[ou] + rho * gu : gu;
      }
    }
    // the next step loads into the slab read here
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) gram_band_kernel(GramArgs a) {
  band(a, GtStored{a.gt + (size_t)blockIdx.x * a.nfd * a.m_p});
}

__global__ void __launch_bounds__(1024) gram_band_ew_kernel(GramArgs a) {
  const size_t s = blockIdx.x;
  band(a, GtFactors{a.e + s * (a.nfd / kDims) * a.m_p,
                    a.w + s * kDims * a.m_p});
}

bool bad_shape(int batch, int nfd, int m_p, int blk, int threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0 || batch < 1 ||
         blk < 1 || nfd < blk || nfd % blk != 0 || m_p < 4 || m_p % 4 != 0;
}

size_t smem_of(int m_p, int blk) {
  return (size_t)2 * blk * (m_p + 1) * sizeof(float);
}

cudaError_t launch(void (*kernel)(GramArgs), const GramArgs& a, int batch,
                   int threads, void* stream) {
  const size_t smem = smem_of(a.m_p, a.blk);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int gram_band_smem_bytes(int m_p, int blk) {
  return (int)smem_of(m_p, blk);
}

// gd (B, m_blk, blk, blk), gu (B, m_blk-1, blk, blk) from gt (B, nfd, m_p).
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int gram_band_launch(const float* gt, float* gd, float* gu,
                                int batch, int nfd, int m_p, int blk,
                                int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, blk, threads))
    return (int)cudaErrorInvalidValue;
  GramArgs a = {};
  a.gt = gt; a.d = gd; a.u = gu;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = 0.0f;
  return (int)launch(gram_band_kernel, a, batch, threads, stream);
}

// db = pb_d + rho gd + sigma I, ub = pb_u + rho gu; rho is (B).
extern "C" int gram_band_factors_launch(
    const float* gt, const float* pb_d, const float* pb_u, const float* rho,
    float* db, float* ub, int batch, int nfd, int m_p, int blk, float sigma,
    int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, blk, threads))
    return (int)cudaErrorInvalidValue;
  GramArgs a = {};
  a.gt = gt; a.pb_d = pb_d; a.pb_u = pb_u; a.rho = rho; a.d = db; a.u = ub;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = sigma;
  return (int)launch(gram_band_kernel, a, batch, threads, stream);
}

// The same band with G^T given as its row factors e (B, nfd/3, m_p) and
// w (B, 3, m_p).
extern "C" int gram_band_factors_ew_launch(
    const float* e, const float* w, const float* pb_d, const float* pb_u,
    const float* rho, float* db, float* ub, int batch, int nfd, int m_p,
    int blk, float sigma, int threads, void* stream) {
  if (bad_shape(batch, nfd, m_p, blk, threads) || nfd % kDims != 0)
    return (int)cudaErrorInvalidValue;
  GramArgs a = {};
  a.e = e; a.w = w; a.pb_d = pb_d; a.pb_u = pb_u; a.rho = rho; a.d = db;
  a.u = ub;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.sigma = sigma;
  return (int)launch(gram_band_ew_kernel, a, batch, threads, stream);
}
