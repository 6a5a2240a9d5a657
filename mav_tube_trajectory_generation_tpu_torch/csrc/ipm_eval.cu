// One fused interior-point evaluation at (x, s, lam) per scenario, for Hopper
// (sm_90a), with the weighted Gram leaving as its block-tridiagonal band or
// whole.  Replaces the Pallas TPU kernels _kernel_band and _kernel
// (ipm_eval_step with band_block set, and with band_block = 0) of the JAX
// package's ops/ipm_kernel.py.
//
// Per scenario: y = G x + b, the constraint values c in lane layout,
// jtwr2 = J^T (w r2) (or J^T max(lam + rho c, 0) under phr), jts = J^T (1/s),
// and the block-tridiagonal band of the weighted Gram J^T W J + sum_i lam_i
// G_i^T G_i as stacked diagonal blocks hd (nfd, blk) and super blocks hu
// (nfd - blk, blk).
//
// What bounds it on an H100: per scenario the 2 m - 1 band blocks take
// (2 m - 1) * 2 blk^2 * (m_p + n_ball) flops (4.6 MFLOP at the flagship
// shape) plus three matvecs against G^T, on 0.28 MB of input: with each
// input read once the two limits are close (about 76 ns of float32
// arithmetic against 91 ns of memory traffic a scenario), the bytes a little
// ahead.
//
// Two designs of the band entry point (ipm_eval_design names the one a shape
// takes):
//   cluster  one scenario a cluster of two blocks (ipm_cluster.cuh): each
//            block copies its half of the lanes' G^T once into shared memory
//            (TMA) and reads it there for y, the J^T products and the band,
//            which it forms from only the lanes and Jacobian rows that reach
//            each row block; the blocks add their partials over distributed
//            shared memory.  G^T leaves device memory once.  At tier 1's
//            ~650 rows the grid is ten waves of 66 clusters, each wave's
//            copy a burst of 18 MB, then some twenty barrier-separated
//            phases whose latencies, not bytes or arithmetic, set the time
//            (~0.25 ms against a 0.06 ms byte bound, chip_smoke.py, on an
//            H100 80GB HBM3 at 700 W).
//   stream   one block a scenario (ipm_common.cuh, eval_point), for shapes
//            whose share does not fit: the block walks G^T from L2 / device
//            memory three times (y; the two J^T reductions; the Gram in
//            64-lane tiles).
// The full Gram (ipm_eval_gram_launch, ipm_eval_gram_design) has the same
// two designs.  Dense, it is nfd^2 (m_p + n_ball) multiply-adds a scenario
// (22 MFLOP at the flagship shape, five times the band) and an (nfd, nfd)
// output, so arithmetic bounds it; but a lane of G^T reaches one or two of
// the row blocks of blk rows, so at the flagship 72 of the 81 block pairs
// are exact zeros.  The cluster design (ipmc::gram_rounds) is #9's up to the
// J^T sums, then forms the Gram one row block at a time, each block pair
// (i, j >= i) summed over only the lanes and Jacobian rows that reach both
// (the masks of the band), the row block's partial exchanged over
// distributed shared memory (two receive buffers in turn), rank 0's + rank
// 1's, each block writing its half of the row block and its mirror below the
// diagonal.  The stream body gives every work item a row and ten of all nfd
// columns; its tile walk repeats once for every 512 work items (four times at
// nfd = 135).

#include "ipm_cluster.cuh"
#include "ipm_common.cuh"

namespace {

struct EvalArgs {
  const float *gt, *b, *rb, *x, *s, *lam;
  float *y, *c, *jtwr2, *jts, *hd, *hu;
  float* gram;      // not null: the whole Gram goes here, hd and hu unused
  int nfd, m_p, blk, nb_p, n_ball, groups, phr;
  float w_cap;
  CUtensorMap gt_map;   // G^T for the cluster design's TMA boxes
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
  extern __shared__ __align__(128) float smem[];
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

// The cluster design's start: this block's share of the state (a cp.async
// group), then of G^T (TMA); returns when both have landed and the other
// block has started (the other's shared memory is written next).
__device__ void load_cluster_state(const ipmc::Ctx& C, const EvalArgs& a,
                                   int sc) {
  const ipmc::CLayout& L = C.L;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = a.nfd, m_p = a.m_p, nb_p = a.nb_p;
  float* b_s = C.at(L.b);
  float* s_s = C.at(L.s);
  float* lam_s = C.at(L.lam);
  for (int l = tid; l < 4 * C.n4; l += nt) {
    if (l < C.q.nl) {
      const size_t g = (size_t)sc * m_p + ipmc::lane_of(C.q, l, nb_p);
      ipmc::cp_async4(b_s + l, a.b + g);
      ipmc::cp_async4(s_s + l, a.s + g);
      ipmc::cp_async4(lam_s + l, a.lam + g);
    } else {
      b_s[l] = 0.0f; s_s[l] = 1.0f; lam_s[l] = 0.0f;
    }
  }
  for (int j = tid; j < C.q.hb; j += nt)
    ipmc::cp_async4(C.at(L.rb) + j, a.rb + (size_t)sc * nb_p + C.q.j0 + j);
  for (int r = tid; r < nfd; r += nt)
    ipmc::cp_async4(C.at(L.x) + r, a.x + (size_t)sc * nfd + r);
  for (int l = tid; l < L.ldl; l += nt) C.at(L.lmask)[l] = 0.0f;
  ipmc::cp_async_commit();
  ipmc::start_gt_share(C, &a.gt_map, sc);
  ipmc::cp_async_wait_all();
  ipmc::wait_gt_share(C);
  // Both blocks have started and this block's copies are visible to all
  // its threads.
  cooperative_groups::this_cluster().sync();
}

__device__ ipmc::EvalIO cluster_io(const ipmc::Ctx& C, const EvalArgs& a) {
  ipmc::EvalIO io;
  io.x = C.at(C.L.x); io.s = C.at(C.L.s); io.lam = C.at(C.L.lam);
  io.w_cap = a.w_cap; io.phr = a.phr != 0; io.y_out = C.at(C.L.y);
  io.pe = nullptr; io.reg = 0.0f;
  io.hd = io.hu = io.gram = nullptr;
  return io;
}

// The outputs of the cluster design: y and c of this block's lanes, the
// rows of J^T (w r2) and J^T (1/s) it finished.
__device__ void store_cluster_outputs(const ipmc::Ctx& C, const EvalArgs& a,
                                      int sc) {
  const ipmc::CLayout& L = C.L;
  const int tid = threadIdx.x, nt = blockDim.x, nfd = a.nfd;
  for (int l = tid; l < C.q.nl; l += nt) {
    const size_t g = (size_t)sc * a.m_p + ipmc::lane_of(C.q, l, a.nb_p);
    a.y[g] = C.at(L.y)[l];
    a.c[g] = C.at(L.c)[l];
  }
  const int r0 = C.rank == 0 ? 0 : L.rh, r1 = C.rank == 0 ? L.rh : nfd;
  for (int r = r0 + tid; r < r1; r += nt) {
    a.jtwr2[(size_t)sc * nfd + r] = C.at(L.jtp)[r];
    a.jts[(size_t)sc * nfd + r] = C.at(L.jtp)[L.ldw + r];
  }
}

// The band evaluation in the cluster design: one scenario a cluster of two
// blocks (blockIdx.x / 2).
__global__ void __launch_bounds__(512, 1)
ipm_eval_cluster_kernel(const __grid_constant__ EvalArgs a) {
  extern __shared__ __align__(128) float smem[];
  const ipmc::Ctx C = ipmc::make_ctx(smem, ipmc::kEval, a.nfd, a.m_p, a.blk,
                                     a.nb_p, a.n_ball);
  const int sc = blockIdx.x / ipmc::kCluster;
  load_cluster_state(C, a, sc);
  int xb = 0;
  float ext[1] = {0.0f};
  const int ext_op[1] = {ipmc::kSum};
  ipmc::EvalIO io = cluster_io(C, a);
  io.hd = a.hd + (size_t)sc * a.nfd * a.blk;
  io.hu = a.hu + (size_t)sc * (a.nfd - a.blk) * a.blk;
  ipmc::eval_point_cluster(C, io, ext, ext_op, xb);
  store_cluster_outputs(C, a, sc);
}

// The whole-Gram evaluation in the cluster design (ipmc::gram_rounds): one
// scenario a cluster of two blocks, blk the row blocks of the lane masks.
__global__ void __launch_bounds__(512, 1)
ipm_eval_gram_cluster_kernel(const __grid_constant__ EvalArgs a) {
  extern __shared__ __align__(128) float smem[];
  const ipmc::Ctx C = ipmc::make_ctx(smem, ipmc::kGram, a.nfd, a.m_p, a.blk,
                                     a.nb_p, a.n_ball);
  const int sc = blockIdx.x / ipmc::kCluster;
  load_cluster_state(C, a, sc);
  int xb = 0;
  float ext[1] = {0.0f};
  const int ext_op[1] = {ipmc::kSum};
  ipmc::EvalIO io = cluster_io(C, a);
  io.gram = a.gram + (size_t)sc * a.nfd * a.nfd;
  ipmc::eval_point_cluster<1, ipmc::kOutGram>(C, io, ext, ext_op, xb);
  store_cluster_outputs(C, a, sc);
}

}  // namespace

// Dynamic shared memory, in bytes, that one block takes at these shapes.
extern "C" int ipm_eval_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                   int threads) {
  return make_layout(nfd, m_p, blk, nb_p, ipm::row_groups(threads, m_p))
             .total * (int)sizeof(float);
}

namespace {

bool bad_shape(const EvalArgs& a, int batch, int threads) {
  return threads < 64 || threads > 512 || threads % 32 != 0 || a.m_p % 4 != 0 ||
      a.blk < 1 || a.nfd % a.blk != 0 || a.nfd < 2 * a.blk ||
      3 * a.nb_p > a.m_p || a.n_ball < 0 || a.n_ball > a.nb_p || batch < 1;
}

int launch(EvalArgs a, int batch, int threads, void* stream) {
  if (bad_shape(a, batch, threads)) return (int)cudaErrorInvalidValue;
  a.groups = ipm::row_groups(threads, a.m_p);
  const size_t smem = (size_t)make_layout(a.nfd, a.m_p, a.blk, a.nb_p,
                                          a.groups).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ipm_eval_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The cluster design's kernel and layout for band (gram 0) or whole-Gram
// output.
int kind_of(int gram) { return gram ? ipmc::kGram : ipmc::kEval; }

typedef void (*ClusterKernel)(EvalArgs);
ClusterKernel cluster_kernel(int gram) {
  return gram ? ipm_eval_gram_cluster_kernel : ipm_eval_cluster_kernel;
}

size_t cluster_smem_of(int gram, int nfd, int m_p, int blk, int nb_p) {
  return (size_t)ipmc::make_cluster_layout(kind_of(gram), nfd, m_p, blk,
                                           nb_p).total * sizeof(float);
}

int launch_cluster(EvalArgs a, int batch, int threads, void* stream) {
  const int gram = a.gram != nullptr;
  const size_t smem = cluster_smem_of(gram, a.nfd, a.m_p, a.blk, a.nb_p);
  if (!ipmc::gt_tensor_map(&a.gt_map, a.gt, batch, a.nfd, a.m_p,
                           ipmc::make_cluster_layout(kind_of(gram), a.nfd,
                                                     a.m_p, a.blk, a.nb_p)
                               .lds))
    return (int)cudaErrorNotSupported;
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel(gram), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      ipmc::cluster_config(batch, threads, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, cluster_kernel(gram), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int occupancy(int gram, int nfd, int m_p, int blk, int nb_p, int threads) {
  const size_t smem = cluster_smem_of(gram, nfd, m_p, blk, nb_p);
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel(gram), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      ipmc::cluster_config(1, threads, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, cluster_kernel(gram), &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// The design the band entry point takes at these shapes on the current
// device: 1 the cluster design, 0 the stream design.
extern "C" int ipm_eval_design(int nfd, int m_p, int blk, int nb_p,
                               int threads) {
  return ipmc::cluster_fits(ipmc::kEval, nfd, m_p, blk, nb_p, threads) ? 1
                                                                       : 0;
}

// The same for the whole-Gram entry point, blk its row blocks.
extern "C" int ipm_eval_gram_design(int nfd, int m_p, int blk, int nb_p,
                                    int threads) {
  return ipmc::cluster_fits(ipmc::kGram, nfd, m_p, blk, nb_p, threads) ? 1
                                                                       : 0;
}

// Dynamic shared memory, in bytes, of one block of the cluster design.
extern "C" int ipm_eval_cluster_smem_bytes(int nfd, int m_p, int blk,
                                           int nb_p) {
  return (int)cluster_smem_of(0, nfd, m_p, blk, nb_p);
}

extern "C" int ipm_eval_gram_cluster_smem_bytes(int nfd, int m_p, int blk,
                                                int nb_p) {
  return (int)cluster_smem_of(1, nfd, m_p, blk, nb_p);
}

// The whole-Gram entry point's one-block body takes what the band's does.
extern "C" int ipm_eval_gram_smem_bytes(int nfd, int m_p, int blk, int nb_p,
                                        int threads) {
  return ipm_eval_smem_bytes(nfd, m_p, blk, nb_p, threads);
}

// How many clusters of the cluster design the device holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
extern "C" int ipm_eval_cluster_occupancy(int nfd, int m_p, int blk,
                                          int nb_p, int threads) {
  return occupancy(0, nfd, m_p, blk, nb_p, threads);
}

extern "C" int ipm_eval_gram_cluster_occupancy(int nfd, int m_p, int blk,
                                               int nb_p, int threads) {
  return occupancy(1, nfd, m_p, blk, nb_p, threads);
}

// Launches the evaluation with band output for `batch` scenarios on `stream`,
// in the design ipm_eval_design names.  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
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
  if (bad_shape(a, batch, threads)) return (int)cudaErrorInvalidValue;
  if (ipmc::cluster_fits(ipmc::kEval, nfd, m_p, blk, nb_p, threads))
    return launch_cluster(a, batch, threads, stream);
  return launch(a, batch, threads, stream);
}

// The same with the whole (nfd, nfd) weighted Gram as output, in the design
// ipm_eval_gram_design names.  `blk`, a divisor of nfd, is the size of the
// row blocks of the cluster design's lane masks (exact for any; the fewer
// blocks a lane reaches, the fewer block pairs it is summed into); the
// stream design ignores it.
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
  if (threads < 64 || threads > 512 || threads % 32 != 0 || m_p % 4 != 0 ||
      blk < 1 || nfd % blk != 0 || 3 * nb_p > m_p || n_ball < 0 ||
      n_ball > nb_p || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (ipmc::cluster_fits(ipmc::kGram, nfd, m_p, blk, nb_p, threads))
    return launch_cluster(a, batch, threads, stream);
  // the one-block body sizes its tile buffer by blk: any divisor with
  // nfd >= 2 blk does
  a.blk = 1;
  return launch(a, batch, threads, stream);
}
