// One fused interior-point evaluation at (x, s, lam) per scenario, for Hopper
// (sm_90a), with the weighted Gram leaving as its block-tridiagonal band or
// whole.  Replaces the Pallas TPU kernels _kernel_band and _kernel
// (ipm_eval_step with band_block set, and with band_block = 0) of the JAX
// package's ops/ipm_kernel.py.
//
// Per scenario (one thread block each): y = G x + b, the constraint values
// c in lane layout, jtwr2 = J^T (w r2) (or J^T max(lam + rho c, 0) under
// phr), jts = J^T (1/s), and the block-tridiagonal band of the weighted
// Gram J^T W J + sum_i lam_i G_i^T G_i as stacked diagonal blocks hd
// (nfd, blk) and super blocks hu (nfd - blk, blk).  The work is in
// ipm_common.cuh (eval_point), which the pipelined step kernel shares.
//
// What bounds it on an H100: per scenario the 2 m - 1 band blocks take
// (2 m - 1) * 2 blk^2 * (m_p + n_ball) flops (4.6 MFLOP at the flagship
// shape) plus three matvecs against G^T, on 0.28 MB of input: with each
// input read once the two limits are close (about 76 ns of float32
// arithmetic against 91 ns of memory traffic a scenario), the bytes a little
// ahead.  One scenario's G^T does not fit a block's shared memory, so the
// block walks it three times (y; the two J^T reductions; the Gram in 64-lane
// tiles) and the second and third walk come from L2 or device memory.
//
// The full Gram (ipm_eval_gram_launch) runs the same walk with every work
// item owning a row and ten of all nfd columns: nfd^2 (m_p + n_ball) multiply-
// adds a scenario (22 MFLOP at the flagship shape, five times the band) and
// an (nfd, nfd) output, so arithmetic bounds it; the tile walk repeats once
// for every 512 work items (four times at nfd = 135).

#include "ipm_common.cuh"

namespace {

struct EvalArgs {
  const float *gt, *b, *rb, *x, *s, *lam;
  float *y, *c, *jtwr2, *jts, *hd, *hu;
  float* gram;      // not null: the whole Gram goes here, hd and hu unused
  int nfd, m_p, blk, nb_p, n_ball, groups, phr;
  float w_cap;
};

struct Layout {
  int b, rb, x, s, lam;
  ipm::EvalLayout ev;
  int total;
};

__host__ __device__ inline Layout make_layout(int nfd, int m_p, int blk,
                                              int nb_p, int groups) {
  Layout L;
  int o = 0;
  L.b = o;   o += m_p;
  L.rb = o;  o += ipm::round4(nb_p);
  L.x = o;   o += ipm::round4(nfd);
  L.s = o;   o += m_p;
  L.lam = o; o += m_p;
  L.ev = ipm::eval_layout(o, nfd, m_p, blk, nb_p, groups);
  L.total = L.ev.total;
  return L;
}

__global__ void __launch_bounds__(512, 2)
ipm_eval_kernel(EvalArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int sc = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, blk = a.blk, nb_p = a.nb_p;
  const Layout L = make_layout(nfd, m_p, blk, nb_p, a.groups);
  float* b_s = smem + L.b;
  float* rb_s = smem + L.rb;
  float* x_s = smem + L.x;
  float* s_s = smem + L.s;
  float* lam_s = smem + L.lam;

  for (int l = tid; l < m_p; l += nt) {
    b_s[l] = a.b[(size_t)sc * m_p + l];
    s_s[l] = a.s[(size_t)sc * m_p + l];
    lam_s[l] = a.lam[(size_t)sc * m_p + l];
  }
  for (int j = tid; j < nb_p; j += nt) rb_s[j] = a.rb[(size_t)sc * nb_p + j];
  for (int r = tid; r < nfd; r += nt) x_s[r] = a.x[(size_t)sc * nfd + r];

  ipm::EvalDims d;
  d.nfd = nfd; d.m_p = m_p; d.blk = blk; d.nb_p = nb_p; d.n_ball = a.n_ball;
  d.groups = a.groups;
  ipm::eval_point(a.gt + (size_t)sc * nfd * m_p, b_s, rb_s, x_s, s_s, lam_s,
                  a.w_cap, a.phr != 0, d, smem, L.ev,
                  a.gram ? nullptr : a.hd + (size_t)sc * nfd * blk,
                  a.gram ? nullptr : a.hu + (size_t)sc * (nfd - blk) * blk,
                  nullptr, nullptr, 0.0f,
                  a.gram ? a.gram + (size_t)sc * nfd * nfd : nullptr);

  for (int l = tid; l < m_p; l += nt) {
    a.y[(size_t)sc * m_p + l] = smem[L.ev.y + l];
    a.c[(size_t)sc * m_p + l] = smem[L.ev.c + l];
  }
  for (int r = tid; r < nfd; r += nt) {
    a.jtwr2[(size_t)sc * nfd + r] = smem[L.ev.jtwr2 + r];
    a.jts[(size_t)sc * nfd + r] = smem[L.ev.jts + r];
  }
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int ipm_eval_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                   int threads) {
  return make_layout(nfd, m_p, blk, nb_p, ipm::row_groups(threads, m_p))
             .total * (int)sizeof(float);
}

namespace {

int launch(EvalArgs a, int batch, int threads, void* stream) {
  if (threads < 64 || threads > 512 || threads % 32 != 0 || a.m_p % 4 != 0 ||
      a.blk < 1 || a.nfd % a.blk != 0 || a.nfd < 2 * a.blk ||
      3 * a.nb_p > a.m_p || a.n_ball < 0 || a.n_ball > a.nb_p || batch < 1)
    return (int)cudaErrorInvalidValue;
  a.groups = ipm::row_groups(threads, a.m_p);
  const size_t smem = (size_t)make_layout(a.nfd, a.m_p, a.blk, a.nb_p,
                                          a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_eval_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the evaluation with band output for `batch` scenarios on `stream`.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int ipm_eval_step_launch(
    const float* gt, const float* b, const float* rb, const float* x,
    const float* s, const float* lam, float* y, float* c, float* jtwr2,
    float* jts, float* hd, float* hu, int batch, int nfd, int m_p, int blk,
    int nb_p, int n_ball, float w_cap, int phr, int threads, void* stream) {
  EvalArgs a;
  a.gt = gt; a.b = b; a.rb = rb; a.x = x; a.s = s; a.lam = lam;
  a.y = y; a.c = c; a.jtwr2 = jtwr2; a.jts = jts; a.hd = hd; a.hu = hu;
  a.gram = nullptr;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.nb_p = nb_p; a.n_ball = n_ball;
  a.phr = phr; a.w_cap = w_cap;
  return launch(a, batch, threads, stream);
}

// The same with the whole (nfd, nfd) weighted Gram as output.  `blk` only
// sizes the tile buffer here: any divisor of nfd with nfd >= 2 blk, 1 will do.
extern "C" int ipm_eval_gram_launch(
    const float* gt, const float* b, const float* rb, const float* x,
    const float* s, const float* lam, float* y, float* c, float* jtwr2,
    float* jts, float* gram, int batch, int nfd, int m_p, int blk, int nb_p,
    int n_ball, float w_cap, int phr, int threads, void* stream) {
  if (gram == nullptr) return (int)cudaErrorInvalidValue;
  EvalArgs a;
  a.gt = gt; a.b = b; a.rb = rb; a.x = x; a.s = s; a.lam = lam;
  a.y = y; a.c = c; a.jtwr2 = jtwr2; a.jts = jts; a.hd = nullptr;
  a.hu = nullptr; a.gram = gram;
  a.nfd = nfd; a.m_p = m_p; a.blk = blk; a.nb_p = nb_p; a.n_ball = n_ball;
  a.phr = phr; a.w_cap = w_cap;
  return launch(a, batch, threads, stream);
}
