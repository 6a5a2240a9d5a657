// y = G v for a batch of scenarios, for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel _matvec_kernel (gt_matvec) of the JAX package's
// ops/ipm_kernel.py.
//
// gt (B, nfd, m_p), v (B, nfd) -> out (B, m_p): a reduction over the nfd
// rows of each scenario's matrix.  One thread block per scenario; the rows
// are split over a few thread groups, each thread owning four neighbouring
// lanes (16-byte loads, neighbouring threads on neighbouring addresses), and
// the groups' partial sums are added in a fixed order: no atomics, so two
// runs give the same bits.
//
// What bounds it on an H100: 2 flops per 4 bytes read, so the bytes of G^T
// (1.7 GB at batch 6144, nfd 135, m_p 512) over the memory rate.  The kernel
// reads every byte once and keeps nothing.

#include "ipm_common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
gt_matvec_kernel(const float* __restrict__ gt, const float* __restrict__ v,
                 float* __restrict__ out, int nfd, int m_p, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;
  float* part_s = smem + ipm::round4(nfd);
  const int s = blockIdx.x;
  for (int r = threadIdx.x; r < nfd; r += blockDim.x)
    v_s[r] = v[(size_t)s * nfd + r];
  __syncthreads();
  ipm::cols_dot(gt + (size_t)s * nfd * m_p, v_s, part_s, nfd, m_p, groups);
  __syncthreads();
  for (int l = threadIdx.x; l < m_p; l += blockDim.x)
    out[(size_t)s * m_p + l] = ipm::gather_groups(part_s, l, m_p, groups);
}

}  // namespace

// Launches the matvec for `batch` scenarios on `stream`.  Returns the CUDA
// error code of the launch (0 on success); does not synchronise.
extern "C" int gt_matvec_launch(const float* gt, const float* v, float* out,
                                int batch, int nfd, int m_p, int threads,
                                void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || m_p % 4 != 0 ||
      batch < 1 || nfd < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = ipm::row_groups(threads, m_p);
  const size_t smem =
      (size_t)(ipm::round4(nfd) + groups * m_p) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gt_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  gt_matvec_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      gt, v, out, nfd, m_p, groups);
  return (int)cudaGetLastError();
}
