// y = G v for a batch of scenarios, for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel _matvec_kernel (gt_matvec) of the JAX package's
// ops/ipm_kernel.py.
//
// gt (B, nfd, m_p), v (B, nfd) -> out (B, m_p): a reduction over the nfd
// rows of each scenario's matrix.
//
// What bounds it on an H100: 2 flops per 4 bytes read, so the bytes of G^T
// (178 MB at tier 1's 645 rows, nfd 135, m_p 512) over the memory rate.  The
// kernel reads every byte once and keeps nothing.  To come near that rate
// at every batch the strict path calls it with (645, 128 and 1 rows), each
// scenario's lanes are split over several blocks: the grid is (batch,
// chunks), a block covering `chunk` float4 columns (chunk in 8, 16, 32; the
// caller picks it so that the grid fills the card, ops/ipm_kernel.py
// matvec_chunk).  Within a block, 256 / chunk row groups each sum rows r = g,
// g + groups, ...; a thread owns four neighbouring lanes (16-byte loads,
// neighbouring threads on neighbouring addresses) and keeps four rows'
// loads in flight.  v is read from shared memory.  The groups' partial sums
// are added in a fixed order (g = 0, 1, ...): no atomics, so two runs give
// the same bits.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gt_matvec_kernel(const float* __restrict__ gt, const float* __restrict__ v,
                 float* __restrict__ out, int nfd, int m_p, int chunk) {
  __shared__ float4 part[kThreads];
  extern __shared__ __align__(16) float v_s[];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  for (int r = t; r < nfd; r += kThreads) v_s[r] = v[(size_t)s * nfd + r];
  __syncthreads();
  const int nl4 = m_p >> 2;
  const int groups = kThreads / chunk;
  const int lq = t % chunk, g = t / chunk;
  const int l4 = blockIdx.y * chunk + lq;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (l4 < nl4) {
    const float4* col =
        reinterpret_cast<const float4*>(gt) + (size_t)s * nfd * nl4 + l4;
    int r = g;
    for (; r + 3 * groups < nfd; r += 4 * groups) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = __ldg(col + (size_t)(r + i * groups) * nl4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float vr = v_s[r + i * groups];
        acc.x = fmaf(a[i].x, vr, acc.x);
        acc.y = fmaf(a[i].y, vr, acc.y);
        acc.z = fmaf(a[i].z, vr, acc.z);
        acc.w = fmaf(a[i].w, vr, acc.w);
      }
    }
    for (; r < nfd; r += groups) {
      const float4 a = __ldg(col + (size_t)r * nl4);
      const float vr = v_s[r];
      acc.x = fmaf(a.x, vr, acc.x);
      acc.y = fmaf(a.y, vr, acc.y);
      acc.z = fmaf(a.z, vr, acc.z);
      acc.w = fmaf(a.w, vr, acc.w);
    }
  }
  part[t] = acc;
  __syncthreads();
  if (t < chunk && l4 < nl4) {
    float4 sum = part[t];
    for (int gg = 1; gg < groups; ++gg) {
      const float4 p = part[gg * chunk + t];
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    reinterpret_cast<float4*>(out)[(size_t)s * nl4 + l4] = sum;
  }
}

}  // namespace

// Launches the matvec for `batch` scenarios on `stream`, `chunk` float4
// columns a block (8, 16 or 32).  Returns the CUDA error code of the launch
// (0 on success); does not synchronise.
extern "C" int gt_matvec_launch(const float* gt, const float* v, float* out,
                                int batch, int nfd, int m_p, int chunk,
                                void* stream) {
  if ((chunk != 8 && chunk != 16 && chunk != 32) || m_p % 4 != 0 ||
      batch < 1 || nfd < 1)
    return (int)cudaErrorInvalidValue;
  const int nl4 = m_p / 4;
  const dim3 grid(batch, (nl4 + chunk - 1) / chunk, 1);
  const size_t smem = (size_t)nfd * sizeof(float);
  gt_matvec_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      gt, v, out, nfd, m_p, chunk);
  return (int)cudaGetLastError();
}
