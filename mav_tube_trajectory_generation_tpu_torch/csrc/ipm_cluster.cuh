// The cluster design of the interior-point kernels (ipm_eval_step_launch,
// ipm_eval_gram_launch, ipm_pipe_step_launch, ipm_solve_fused_launch):
// device code shared by ipm_eval.cu, ipm_pipe.cu and ipm_solve.cu, the four
// kinds of layout in make_cluster_layout.  The one-block bodies of
// ipm_common.cuh stay for the shapes where a block's share does not fit
// (cluster_fits).
//
// One scenario is a cluster of two blocks on neighbouring SMs.  Each block
// holds, in shared memory, its half of the lanes' columns of G^T (135 x 256
// floats, 138 KB at the flagship shape nfd 135, m_p 512), copied from device
// memory once at entry by the tensor memory accelerator (one 2-D box a
// plane segment, completing on an mbarrier), so that the column solve of
// the pipelined step runs while it lands; every later use of G^T reads it
// there.  (Per-thread 16-byte cp.async landed it ~25k cycles after entry,
// ~11 GB/s an SM, against ~13k by TMA: #8 at batch 6144 on an H100 80GB
// HBM3 at 700 W, stage_profile.py.)
// The lanes split by ball index as kernel 1's cluster design splits them
// (admm_stage.cu, split_of; cluster_lane_split in ops/admm_kernel.py is the
// same map): block 0 holds lanes j < ceil(nb_p / 2) of each ball plane (and
// rb[j]) and the first half (rounded up) of the final half-space plane,
// block 1 the rest, so a ball triple, its radius and its constraint value
// live in one block.  Local lane order [ball-x | ball-y | ball-z | half].
//
// What each block does alone, on its own lanes: y = G x + b, c, the lane
// weights, G dx, the lane updates of a step, and its Jacobian rows
// J_j = sum_c y_jc G^T[:, c nb_p + j] (formed once into shared memory).
// What runs over both blocks' lanes is summed in two stages: each block sums
// its lanes (a fixed order), then the two blocks exchange their partials
// through distributed shared memory (map_shared_rank) and, after a cluster
// barrier, each adds rank 0's partial to rank 1's, in that order:
//   * the scalars of a step (mu, the fraction-to-boundary minima, the
//     finiteness flag, the merit, the snap line search's eight phi sums,
//     max lam): cluster_combine, both blocks get the same bits;
//   * J^T (w r2) and J^T (1/s): each block sends the other the rows the other
//     writes out (rank 0 the first ceil(nfd / 2));
//   * the weighted-Gram band: each block sends the other the entries the
//     other writes out (rank 0 the first half of [hd | hu], rank 1 the rest).
//
// The band, from the lanes that reach each row block.  A constraint lane of
// G^T is a function of one segment's end vertices, so its column is zero
// outside one or two row blocks of blk rows (at the flagship each real lane
// touches exactly one of the nine).  A pass after y = G x + b records, per
// lane, the row blocks where its column is nonzero; a lane whose y or
// weights are not finite counts as reaching every block.
// Warp i then forms the diagonal block i and the super block (i, i + 1), a
// TR x TC tile a thread, summing only over the lanes that reach block i and
// the balls whose Jacobian rows do, in lane order: every term it leaves out
// is (0 * w) * g with w and g finite, an exact zero, so the sum is the one
// over all of the block's lanes in that order.  J^T (w r2) and J^T (1/s)
// take their rows' lane lists the same way, and only the Jacobian rows the
// band reads are formed.  Every term is (G^T[r, l] * w_l) * G^T[c, l] as in
// ipm::eval_point; only the order of the sums differs.

// float32 FMA only (no TF32: it broke feasibility in the reference).  NaN
// and determinism follow ipm_common.cuh: select, never scale; min and max
// keep NaN; fixed reduction orders, no float atomics (the row-block masks
// are integer atomicOr, whose result does not depend on the order).  A
// block writes into the other only before a cluster barrier that both then
// pass (the first barrier also tells each block that the other has
// started), and the last such barrier comes before either block's outputs:
// so no block is written to once it may have left.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "ipm_common.cuh"

namespace ipmc {

namespace cg = cooperative_groups;
using ipm::pmax;
using ipm::pmin;
using ipm::round4;

constexpr int kCluster = 2;
constexpr int BMAX = 16;   // largest band block a thread's register row holds
constexpr int TR = 3;      // band tile rows
constexpr int TC = 5;      // band tile columns
constexpr int KL = 16;     // threads a row of the J^T products
constexpr int RG = 8;      // row groups in col_dots
constexpr int NXCH = 8;    // most scalars one cluster_combine carries
enum { kSum = 0, kMin = 1, kMax = 2 };

// One block's share of the lanes (kernel 1's split_of, copied): hb lanes
// j0 .. j0 + hb - 1 of each ball plane, fb lanes f0 .. f0 + fb - 1 of the
// final plane; nl in all.
struct Split {
  int hb, j0, fb, f0, nl;
};

__host__ __device__ inline Split split_of(int rank, int m_p, int nb_p) {
  const int nh = m_p - 3 * nb_p;
  Split q;
  q.hb = rank == 0 ? (nb_p + 1) / 2 : nb_p / 2;
  q.j0 = rank == 0 ? 0 : (nb_p + 1) / 2;
  q.fb = rank == 0 ? (nh + 1) / 2 : nh / 2;
  q.f0 = rank == 0 ? 0 : (nh + 1) / 2;
  q.nl = 3 * q.hb + q.fb;
  return q;
}

// Global lane of local lane l (comparisons, no division).
__host__ __device__ inline int lane_of(const Split& q, int l, int nb_p) {
  if (l < q.hb) return q.j0 + l;
  if (l < 2 * q.hb) return nb_p + q.j0 + (l - q.hb);
  if (l < 3 * q.hb) return 2 * nb_p + q.j0 + (l - 2 * q.hb);
  return 3 * nb_p + q.f0 + (l - 3 * q.hb);
}

// The four kernels of the cluster design, by the layout each takes.
enum Kind {
  kEval = 0,    // #9, ipm_eval_step with band output
  kPipe = 1,    // #8, ipm_pipe_step: the step's state and pe besides
  kGram = 2,    // #10, ipm_eval_step with the whole Gram: the Gram rounds'
                // staging in place of the band's receive buffer
  kSolve = 3    // #11, ipm_solve_fused: the polish's state, pe, and the
                // whole band with the factors in jr
};

// Shared-memory layout of one block, in floats (ops/ipm_kernel.py,
// cluster_layout, is the same function).  Sized by rank 0's share, the
// larger.
struct CLayout {
  int n4, ldl, nj4, ldj, ldw, nband, eh, rh, per;
  int lds, nseg, tile;                   // G^T share: segment tiles
  int gts, jr;                           // G^T share; Jacobian rows / scratch
  int b, s, lam, y, c, wa, wj, wjs;      // lane vectors (ldl each)
  int act, cw, by, le, se, ye;           // the step's lane vectors
  int rb, wjb;                           // per ball
  int x, bx, dx, u, z, rs, dsc;          // nfd vectors (the steps: more)
  int jtp, jx, brecv, pe;                // J^T and band halves; pe_d | pe_u
  int gst, grecv, gh;                    // the Gram rounds' staging
  int lf, cf;                            // the factor's blocks (in jr)
  int lmask, bmask, llist, blist, cnt;   // row-block masks and lane lists
  int gmask;                             // (#11) G^T's own lane masks
  int red, xch, bar;                     // bar: the share's mbarrier
  int total;
};

__host__ __device__ inline CLayout make_cluster_layout(int kind, int nfd,
                                                       int m_p, int blk,
                                                       int nb_p) {
  CLayout L;
  const Split q = split_of(0, m_p, nb_p);
  const int m_blk = nfd / blk, bb = blk * blk;
  const bool pipe = kind == kPipe, solve = kind == kSolve;
  // odd float4 row strides: rows read at once fall in different bank groups
  L.n4 = (q.nl + 3) / 4;
  L.ldl = 4 * L.n4 + (L.n4 % 2 == 0 ? 4 : 0);
  L.nj4 = (q.hb + 3) / 4;
  L.ldj = 4 * L.nj4 + (L.nj4 % 2 == 0 ? 4 : 0);
  L.ldw = round4(nfd);
  L.nband = nfd * blk + (nfd - blk) * blk;
  L.eh = round4((L.nband + 1) / 2);      // 16-byte aligned halves
  L.rh = (nfd + 1) / 2;
  L.per = ((blk + TR - 1) / TR) * ((blk + TC - 1) / TC);
  // G^T's share as one tile a plane segment (three ball planes, the final
  // plane): nfd rows of lds floats, lds the widest segment rounded to an odd
  // number of float4 (one TMA box), each tile 128-byte aligned
  {
    const int w = q.hb > q.fb ? q.hb : q.fb, w4 = (w + 3) / 4;
    L.lds = 4 * w4 + (w4 % 2 == 0 ? 4 : 0);
  }
  L.nseg = q.fb > 0 ? 4 : 3;
  L.tile = (nfd * L.lds + 31) & ~31;
  // the whole polish keeps the band (hd | hu) and its factors in jr, which
  // is idle from the end of one evaluation to the next: the L_i and the C_i
  // after the band
  L.lf = round4(L.nband);
  L.cf = L.lf + m_blk * bb;
  int jr = nfd * L.ldj > L.nband ? nfd * L.ldj : L.nband;
  if (solve && L.cf + (m_blk - 1) * bb > jr) jr = L.cf + (m_blk - 1) * bb;
  int o = 0;
  L.gts = o;  o += L.nseg * L.tile;
  L.jr = o;   o += round4(jr);
  L.b = o;    o += L.ldl;
  L.s = o;    o += L.ldl;
  L.lam = o;  o += L.ldl;
  L.y = o;    o += L.ldl;
  L.c = o;    o += L.ldl;
  L.wa = o;   o += L.ldl;
  L.wj = o;   o += L.ldl;
  L.wjs = o;  o += L.ldl;
  L.act = L.cw = L.by = L.le = L.se = L.ye = 0;
  if (pipe || solve) {
    L.act = o; o += L.ldl;
    L.cw = o;  o += L.ldl;
    L.by = o;  o += L.ldl;
    if (pipe) {
      L.le = o;  o += L.ldl;
      L.se = o;  o += L.ldl;
    }
    L.ye = o;  o += L.ldl;
  }
  L.rb = o;   o += 4 * L.nj4;
  L.wjb = o;  o += 4 * L.nj4;
  L.x = o;    o += L.ldw;
  L.bx = L.dx = L.u = L.z = L.rs = L.dsc = 0;
  if (pipe || solve) {
    L.bx = o; o += L.ldw;
    L.dx = o; o += L.ldw;
    if (pipe)                            // the polish: the equilibration
      L.u = o;
    else
      L.dsc = o;
    o += L.ldw;
    L.z = o;  o += L.ldw;
    L.rs = o; o += L.ldw;
  }
  L.jtp = o;   o += 2 * L.ldw;
  L.jx = o;    o += 2 * L.ldw;
  L.brecv = L.gst = L.grecv = L.gh = 0;
  if (kind == kGram) {
    // a row block's partial (blk x nfd at most) and two receive buffers of
    // the other block's half, used in turn
    L.gh = round4((bb * m_blk + 1) / 2);
    L.gst = o;   o += round4(bb * m_blk);
    L.grecv = o; o += 2 * L.gh;
  } else {
    // (#11: also the band factor's elimination rows, blk (3 blk + 2))
    const int w = solve ? round4(blk * (3 * blk + 2)) : 0;
    L.brecv = o; o += round4(L.eh) > w ? round4(L.eh) : w;
  }
  L.pe = 0;
  if (pipe || solve) {
    L.pe = o;  o += round4(L.eh);
  }
  L.lmask = o; o += L.ldl;                                  // ints
  L.bmask = o; o += 4 * L.nj4;                              // ints
  L.llist = o; o += round4((m_blk * 4 * L.n4 + 1) / 2);      // shorts
  L.blist = o; o += round4((m_blk * 4 * L.nj4 + 1) / 2);     // shorts
  L.cnt = o;   o += round4(2 * m_blk);                      // ints
  L.gmask = 0;
  if (solve) {
    L.gmask = o; o += L.ldl;                                // ints
  }
  L.red = o;   o += NXCH * 32;
  L.xch = o;   o += 2 * kCluster * NXCH;
  L.bar = o;   o += 4;                                      // 8-aligned
  L.total = o;
  return L;
}

// Whether the cluster design of `kind` takes these shapes on the current
// device: a block's shared memory within the opt-in limit, plane segments of
// whole float4 (nb_p and the final plane's width multiples of 8) no taller
// than a TMA box (nfd <= 256), band blocks a register row holds, a warp for
// each row block with a thread for each tile of its two band blocks,
// row-block masks of 32 bits, (#8) the factor rows of the column solve one
// a thread and (#11) a thread for each entry of a band block and of a row.
inline bool cluster_fits(int kind, int nfd, int m_p, int blk, int nb_p,
                         int threads) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  const CLayout L = make_cluster_layout(kind, nfd, m_p, blk, nb_p);
  const int m_blk = nfd / blk;
  return (size_t)L.total * sizeof(float) <= (size_t)optin &&
         nb_p % 8 == 0 && (m_p - 3 * nb_p) % 8 == 0 && nfd <= 256 &&
         blk <= BMAX &&
         2 * L.per <= 32 && m_blk <= threads / 32 && m_blk <= 32 &&
         threads % 32 == 0 && threads <= 512 &&
         (kind != kPipe || (3 * m_blk - 2) * blk <= threads) &&
         (kind != kSolve || blk * blk + blk <= threads);
}

// The tensor map of G^T for the share's TMA boxes: the batch's G^T as
// (batch nfd) rows of m_p floats, boxes of lds columns by nfd rows, zeros
// past the last column.  cuTensorMapEncodeTiled is looked up at run time
// (cudaGetDriverEntryPointByVersion: no link against libcuda).  False if
// the map is refused.
inline bool gt_tensor_map(CUtensorMap* map, const float* gt, int batch,
                          int nfd, int m_p, int lds) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)m_p, (cuuint64_t)batch * nfd};
  const cuuint64_t strides[1] = {(cuuint64_t)m_p * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)lds, (cuuint32_t)nfd};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(gt), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline cudaLaunchConfig_t cluster_config(int batch, int threads, size_t smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * batch, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Phase profiles of the cluster design (stage_profile.py builds ipm_pipe.cu
// with -DIPM_PIPE_PROFILE, ipm_solve.cu with -DIPM_SOLVE_PROFILE): thread 0
// of two blocks, the grid's first (a scenario of the first wave) and rank 0
// of its middle scenario (a wave in the steady state), adds the clock64
// cycles since its last mark to a shared counter at mark i (IPM_PROF(i); -1
// starts), and IPM_PROF_FLUSH adds the counters to ipm_prof[slot].  Without
// the macros the marks compile to nothing.
#if defined(IPM_PIPE_PROFILE) || defined(IPM_SOLVE_PROFILE)
#define IPM_PROFILE 1
__device__ unsigned long long ipm_prof[2][32];
__shared__ long long ipm_prof_s[33];
__device__ __forceinline__ int ipm_prof_slot() {
  return blockIdx.x == 0 ? 0
         : blockIdx.x == (gridDim.x / 2 / kCluster) * kCluster ? 1 : -1;
}
#define IPM_PROF(i)                                                     \
  do {                                                                  \
    if (threadIdx.x == 0 && ipmc::ipm_prof_slot() >= 0) {               \
      const long long c_ = clock64();                                   \
      if ((i) >= 0) ipmc::ipm_prof_s[(i) < 0 ? 0 : (i)] +=              \
          c_ - ipmc::ipm_prof_s[32];                                    \
      else                                                              \
        for (int k_ = 0; k_ < 32; ++k_) ipmc::ipm_prof_s[k_] = 0;       \
      ipmc::ipm_prof_s[32] = c_;                                        \
    }                                                                   \
  } while (0)
#define IPM_PROF_FLUSH()                                                \
  do {                                                                  \
    const int slot_ = ipmc::ipm_prof_slot();                            \
    if (threadIdx.x == 0 && slot_ >= 0)                                 \
      for (int k_ = 0; k_ < 32; ++k_)                                   \
        ipmc::ipm_prof[slot_][k_] +=                                    \
            (unsigned long long)ipmc::ipm_prof_s[k_];                   \
  } while (0)
#else
#define IPM_PROF(i) do {} while (0)
#define IPM_PROF_FLUSH() do {} while (0)
#endif

// ---- copies ----------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed copy groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The mbarrier the bulk copy of G^T's share completes on (CUTLASS's
// ClusterBarrier protocol): init for one arrival, expect the share's bytes,
// wait for phase 0.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA box of the 2-D tensor `map` (G^T of the batch as (batch nfd)
// rows of m_p floats) at column c0, row r0 into shared dst (128-byte
// aligned), completing on bar.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int c0, int r0,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(r0)
      : "memory");
}

// Waits until the bulk copy has landed (phase 0 of bar complete).  Bounded:
// after about 2^31 polls the kernel traps (an error the launcher's caller
// sees), so a copy that never lands cannot hang the card.
__device__ __forceinline__ void mbar_wait0(unsigned long long* bar) {
  const unsigned a = smem_u32(bar);
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a)
        : "memory");
    if (done) return;
    if (n > (1u << 31)) asm volatile("trap;");
  }
}

// ---- reductions -------------------------------------------------------------

__device__ __forceinline__ float op_apply(int op, float a, float b) {
  return op == kSum ? a + b : op == kMin ? pmin(a, b) : pmax(a, b);
}

__device__ __forceinline__ float op_id(int op) {
  return op == kSum ? 0.0f : op == kMin ? CUDART_INF_F : -CUDART_INF_F;
}

__device__ __forceinline__ float warp_reduce_op(int op, float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op_apply(op, v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// N values over the block at once (warp butterfly, then the warps' results
// in warp order); every thread gets the results.  red holds N x 32 floats.
template <int N>
__device__ void block_reduce_n(float (&v)[N], const int (&op)[N],
                               float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_reduce_op(op[i], v[i]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = warp_reduce_op(op[i], lane < nw ? red[i * 32 + lane] : op_id(op[i]));
}

// The block results v (the same in every thread) combined over the cluster:
// thread 0 stores them to slot `rank` of buffer xb in both blocks; after
// the cluster barrier every thread combines slot 0 with slot 1, in that
// order.  Two buffers in turn: a block writes buffer xb again only after the
// next combine's barrier, which the other block reaches after reading it.
// Must be reached by every thread of both blocks.
template <int N>
__device__ void cluster_combine(float (&v)[N], const int (&op)[N],
                                float* xch, int rank, int& xb) {
  cg::cluster_group cl = cg::this_cluster();
  float* mine = xch + (xb * kCluster + rank) * NXCH;
  if (threadIdx.x == 0) {
    float* theirs = cl.map_shared_rank(mine, rank ^ 1);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mine[i] = v[i];
      theirs[i] = v[i];
    }
  }
  cl.sync();
  const float* s0 = xch + xb * kCluster * NXCH;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = op_apply(op[i], s0[i], s0[NXCH + i]);
  xb ^= 1;
}

// ---- products against the G^T share -----------------------------------------

// y[l] = b[l] + sum_r G[r, l] x[r] (b may be null) for the n4 float4 groups
// of this block's lanes, G^T's share in its segment tiles (gcol): RG row
// groups r = g, g + RG, ..., one lane each of an aligned group of RG lanes,
// four neighbouring columns a thread, the groups' sums added by a
// butterfly.
struct Ctx;
__device__ void col_dots(const Ctx& C, const float* x, const float* b,
                         float* y);

// ---- the block's context ----------------------------------------------------

struct Ctx {
  int rank, nfd, m_p, blk, m_blk, nb_p, n_ball;
  int n4, nj4;       // this rank's float4 groups of lanes and of balls
  Split q;
  CLayout L;
  float* sm;
  __device__ float* at(int off) const { return sm + off; }
};

__device__ inline Ctx make_ctx(float* smem, int kind, int nfd, int m_p,
                               int blk, int nb_p, int n_ball) {
  Ctx C;
  C.rank = (int)cg::this_cluster().block_rank();
  C.nfd = nfd; C.m_p = m_p; C.blk = blk; C.m_blk = nfd / blk;
  C.nb_p = nb_p; C.n_ball = n_ball;
  C.q = split_of(C.rank, m_p, nb_p);
  C.L = make_cluster_layout(kind, nfd, m_p, blk, nb_p);
  C.n4 = (C.q.nl + 3) / 4;
  C.nj4 = (C.q.hb + 3) / 4;
  C.sm = smem;
  return C;
}

// Starts the copy of this block's share of scenario sc's G^T into its
// segment tiles: one TMA box a segment (lds columns from the segment's
// first lane, nfd rows; columns past the segment, from the next plane or
// zero past m_p, are never read), started by thread 0, completing on the
// block's mbarrier.  Must be reached by every thread.
__device__ inline void start_gt_share(const Ctx& C, const CUtensorMap* map,
                                      int sc) {
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(C.at(C.L.bar));
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (unsigned)(C.L.nseg * C.L.lds * C.nfd) * 4u);
    for (int d = 0; d < C.L.nseg; ++d)
      tma_box(C.at(C.L.gts + d * C.L.tile), map,
              d < 3 ? d * C.nb_p + C.q.j0 : 3 * C.nb_p + C.q.f0,
              sc * C.nfd, bar);
  }
}

// Waits until the share has landed (every thread that reads it).
__device__ __forceinline__ void wait_gt_share(const Ctx& C) {
  mbar_wait0(reinterpret_cast<unsigned long long*>(C.at(C.L.bar)));
}

// Offset, in floats from the share's start, of row 0 of local lane l's
// column (rows follow lds apart).
__device__ __forceinline__ int gcol(const Ctx& C, int l) {
  const int hb = C.q.hb;
  const int d = l < hb ? 0 : l < 2 * hb ? 1 : l < 3 * hb ? 2 : 3;
  return d * C.L.tile + l - d * hb;
}

__device__ void col_dots(const Ctx& C, const float* x, const float* b,
                         float* y) {
  const int lds4 = C.L.lds >> 2, rows = C.nfd, n4 = C.n4;
  const float4* G4 = reinterpret_cast<const float4*>(C.at(C.L.gts));
  const int total = n4 * RG;
  for (int b0 = 0; b0 < total; b0 += blockDim.x) {
    const int idx = b0 + threadIdx.x;
    const int l4 = idx / RG, g = idx % RG;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (l4 < n4) {
      const float4* col = G4 + (gcol(C, 4 * l4) >> 2);
      for (int r = g; r < rows; r += RG) {
        const float4 a = col[(size_t)r * lds4];
        const float xr = x[r];
        acc.x = fmaf(a.x, xr, acc.x);
        acc.y = fmaf(a.y, xr, acc.y);
        acc.z = fmaf(a.z, xr, acc.z);
        acc.w = fmaf(a.w, xr, acc.w);
      }
    }
#pragma unroll
    for (int o = RG / 2; o > 0; o >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (l4 < n4 && g == 0) {
      if (b) {
        const float4 bb = reinterpret_cast<const float4*>(b)[l4];
        acc.x += bb.x; acc.y += bb.y; acc.z += bb.z; acc.w += bb.w;
      }
      reinterpret_cast<float4*>(y)[l4] = acc;
    }
  }
}

// mask[l] |= bit i for every row block i (of blk rows) in which column l of
// the share has an entry that is not +0 or -0: a thread for four lanes and
// one row block ORs the entries' bits, then sets the lanes' bits by integer
// atomicOr (OR in any order gives the same word).  mask must start at 0.  An
// entry that is not finite counts as nonzero here; it also makes y[l] not
// finite, which the caller reads as reaching every block.
__device__ void row_block_masks(const Ctx& C, unsigned* mask) {
  const int lds4 = C.L.lds >> 2, n4 = C.n4, blk = C.blk;
  const uint4* G4 = reinterpret_cast<const uint4*>(C.at(C.L.gts));
  for (int t = threadIdx.x; t < n4 * C.m_blk; t += blockDim.x) {
    const int ib = t / n4, l4 = t - ib * n4;
    const uint4* col =
        G4 + (gcol(C, 4 * l4) >> 2) + (size_t)ib * blk * lds4;
    unsigned ox = 0u, oy = 0u, oz = 0u, ow = 0u;
    for (int r = 0; r < blk; ++r) {
      const uint4 v = col[(size_t)r * lds4];
      ox |= v.x; oy |= v.y; oz |= v.z; ow |= v.w;
    }
    const unsigned bit = 1u << ib;
    if (ox << 1) atomicOr(mask + 4 * l4, bit);
    if (oy << 1) atomicOr(mask + 4 * l4 + 1, bit);
    if (oz << 1) atomicOr(mask + 4 * l4 + 2, bit);
    if (ow << 1) atomicOr(mask + 4 * l4 + 3, bit);
  }
}

// Is local lane l a ball row?  j is its ball's local index.
__device__ __forceinline__ bool lball(const Ctx& C, int l, int& j) {
  if (l >= 3 * C.q.hb) {
    j = -1;
    return false;
  }
  const int hb = C.q.hb;
  j = l < hb ? l : l < 2 * hb ? l - hb : l - 2 * hb;
  return C.q.j0 + j < C.n_ball;
}

// Constraint value at local lane l (ipm::c_at on the local layout).
__device__ __forceinline__ float c_loc(const Ctx& C, const float* y,
                                       const float* rb, int l) {
  int j;
  if (lball(C, l, j)) {
    const int hb = C.q.hb;
    const float yx = y[j], yy = y[hb + j], yz = y[2 * hb + j];
    const float r = rb[j];
    return 0.5f * (yx * yx + yy * yy + yz * yz - r * r);
  }
  return y[l];
}

__device__ __forceinline__ float c_loc_moved(const Ctx& C, const float* y,
                                             const float* g, float a,
                                             const float* rb, int l) {
  int j;
  if (lball(C, l, j)) {
    const int hb = C.q.hb;
    const float yx = y[j] + a * g[j];
    const float yy = y[hb + j] + a * g[hb + j];
    const float yz = y[2 * hb + j] + a * g[2 * hb + j];
    const float r = rb[j];
    return 0.5f * (yx * yx + yy * yy + yz * yz - r * r);
  }
  return y[l] + a * g[l];
}

__device__ __forceinline__ float jdx_loc(const Ctx& C, const float* gdx,
                                         const float* y, int l) {
  int j;
  if (lball(C, l, j)) {
    const int hb = C.q.hb;
    return y[j] * gdx[j] + y[hb + j] * gdx[hb + j] +
           y[2 * hb + j] * gdx[2 * hb + j];
  }
  return gdx[l];
}

// ---- the evaluation ---------------------------------------------------------

struct EvalIO {
  const float *x, *s, *lam;   // shared: x (nfd), s and lam (local lanes)
  float w_cap;
  bool phr;
  float* y_out;               // shared, local lanes
  const float* pe;            // shared, this block's half of [pe_d | pe_u]
  float reg;                  // (with pe: added to hd's diagonal)
  float *hd, *hu;             // global, this scenario's (kOutBand)
  float* gram;                // global, this scenario's (kOutGram)
};

// Where eval_point_cluster's weighted Gram goes.
enum Out {
  kOutBand = 0,     // the band, each block its half, to io.hd / io.hu
  kOutShared = 1,   // the band (hd then hu) to jr, and J^T (w r2), J^T (1/s)
                    // to jtp, all of them in both blocks; the lanes' row-block
                    // masks of G^T from gmask (row_block_masks, once)
  kOutGram = 2      // the whole Gram to io.gram (gram_rounds)
};

// The positions (in increasing order) of the n entries of mask, strided by
// `stride` as ints, with bit i set, written to list; returns how many.  Run
// by one whole warp.
__device__ __forceinline__ int warp_compact(const unsigned* mask, int n,
                                            int stride, int i,
                                            unsigned short* list) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int l = c0 + lane;
    const bool has = l < n && ((mask[l * stride] >> i) & 1u);
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (has)
      list[count + __popc(ballot & ((1u << lane) - 1u))] =
          (unsigned short)l;
    count += __popc(ballot);
  }
  return count;
}

// The whole weighted Gram of the scenario to gram (global, nfd x nfd), from
// the lane lists, masks, weights and Jacobian rows eval_point_cluster has
// formed, one row block i at a time.  For each block pair (i, j >= i) a
// thread forms a TR x TC tile, summing, in list order, the lanes of row
// block i's list whose column also reaches block j, then the balls of its
// ball list whose Jacobian row also does: every term it leaves out is an
// exact zero, as in the band.  The row block's partial (blk rows, the
// columns from i blk on) is staged; each block sends the other the half of
// it the other finishes (rank 0 the first half) into one of two receive
// buffers, used in turn; after a cluster barrier each finishes its half,
// rank 0's partial + rank 1's, and writes block (i, j) and, for j > i, its
// transpose as block (j, i).  Must be reached by every thread of both blocks.
__device__ void gram_rounds(const Ctx& C, const EvalIO& io) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nfd = C.nfd, blk = C.blk, m_blk = C.m_blk, rank = C.rank;
  const CLayout& L = C.L;
  const int nj = 4 * C.nj4, per = L.per, ncg = (blk + TC - 1) / TC;
  const float* gts = C.at(L.gts);
  const float* jr = C.at(L.jr);
  const float* wa = C.at(L.wa);
  const float* wjb = C.at(L.wjb);
  const unsigned* lmask = reinterpret_cast<const unsigned*>(C.at(L.lmask));
  const unsigned* bmask = reinterpret_cast<const unsigned*>(C.at(L.bmask));
  const unsigned short* llist =
      reinterpret_cast<const unsigned short*>(C.at(L.llist));
  const unsigned short* blist =
      reinterpret_cast<const unsigned short*>(C.at(L.blist));
  const int* lcnt = reinterpret_cast<const int*>(C.at(L.cnt));
  const int* bcnt = lcnt + m_blk;
  float* gst = C.at(L.gst);
  float* grecv = C.at(L.grecv);
  float* grecv_r = cl.map_shared_rank(grecv, rank ^ 1);
  for (int i = 0; i < m_blk; ++i) {
    const int ncol = nfd - i * blk, n = blk * ncol;
    const int h = round4((n + 1) / 2);          // rank 0 finishes [0, h)
    const unsigned short* lst = llist + i * 4 * C.n4;
    const unsigned short* bl = blist + i * nj;
    const int n_l = lcnt[i], n_b = bcnt[i];
    __syncthreads();               // the last round's finals have read gst
    for (int t = tid; t < (m_blk - i) * per; t += nt) {
      const int j = i + t / per, tile = t % per;
      const int rg = tile / ncg, cg_ = tile - rg * ncg;
      float acc[TR][TC];
      int ro[TR], co[TC];
#pragma unroll
      for (int u = 0; u < TR; ++u) {
        const int rr = TR * rg + u;
        ro[u] = i * blk + (rr < blk ? rr : TR * rg);
#pragma unroll
        for (int k = 0; k < TC; ++k) acc[u][k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const int kk = TC * cg_ + k;
        co[k] = j * blk + (kk < blk ? kk : TC * cg_);
      }
      for (int p = 0; p < n_l; ++p) {
        const int l = lst[p];
        if (!((lmask[l] >> j) & 1u)) continue;
        const float w = wa[l];
        const float* col = gts + gcol(C, l);
        float a[TR], cv[TC];
#pragma unroll
        for (int u = 0; u < TR; ++u) a[u] = col[(size_t)ro[u] * L.lds] * w;
#pragma unroll
        for (int k = 0; k < TC; ++k) cv[k] = col[(size_t)co[k] * L.lds];
#pragma unroll
        for (int u = 0; u < TR; ++u)
#pragma unroll
          for (int k = 0; k < TC; ++k) acc[u][k] = fmaf(a[u], cv[k], acc[u][k]);
      }
      for (int p = 0; p < n_b; ++p) {
        const int jb = bl[p];
        if (!((bmask[jb] >> j) & 1u)) continue;
        const float w = wjb[jb];
        float a[TR], cv[TC];
#pragma unroll
        for (int u = 0; u < TR; ++u) a[u] = jr[(size_t)ro[u] * L.ldj + jb] * w;
#pragma unroll
        for (int k = 0; k < TC; ++k) cv[k] = jr[(size_t)co[k] * L.ldj + jb];
#pragma unroll
        for (int u = 0; u < TR; ++u)
#pragma unroll
          for (int k = 0; k < TC; ++k) acc[u][k] = fmaf(a[u], cv[k], acc[u][k]);
      }
      // entry (rr, column c) of the row block's partial at rr ncol + c - i blk
#pragma unroll
      for (int u = 0; u < TR; ++u) {
        const int rr = TR * rg + u;
#pragma unroll
        for (int k = 0; k < TC; ++k) {
          const int kk = TC * cg_ + k;
          if (rr < blk && kk < blk)
            gst[rr * ncol + (j - i) * blk + kk] = acc[u][k];
        }
      }
    }
    __syncthreads();
    // the half the other block finishes goes there in 16-byte stores
    {
      const int par = (i & 1) * L.gh;
      const float* src = gst + (rank == 0 ? h : 0);
      const int cnt = rank == 0 ? n - h : h;
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(grecv_r + par);
      for (int i4 = tid; i4 < cnt / 4; i4 += nt) dst4[i4] = src4[i4];
      for (int e = 4 * (cnt / 4) + tid; e < cnt; e += nt)
        grecv_r[par + e] = src[e];
    }
    cl.sync();
    {
      const float* recv = grecv + (i & 1) * L.gh;
      const int e0 = rank == 0 ? 0 : h, e1 = rank == 0 ? h : n;
      float* g = io.gram;
      for (int e = e0 + tid; e < e1; e += nt) {
        const float mine = gst[e], theirs = recv[e - e0];
#ifdef IPM_CONTROL_DROP_RANK0
        // negative control (chip_smoke.py): rank 0's partial left out
        const float v = rank == 0 ? theirs : mine;
#else
        const float v = rank == 0 ? mine + theirs : theirs + mine;
#endif
        const int rr = e / ncol, c = i * blk + (e - rr * ncol);
        const int r = i * blk + rr;
        g[(size_t)r * nfd + c] = v;
        if (c >= (i + 1) * blk) g[(size_t)c * nfd + r] = v;
      }
    }
  }
  __syncthreads();
}

// The evaluation at (x, s, lam) on both blocks of the cluster.  G^T's share
// must have landed (and be visible to every thread).  Fills y_out (local
// lanes), c (local lanes), and in jtp (ldw) / jtp + ldw the finished rows of
// J^T (w r2) and J^T (1/s) this block writes out (rank 0 rows < rh, rank 1
// the rest); with OUT kOutBand writes this block's half of the band to hd /
// hu, plus pe (the scenario's [pe_d | pe_u] entries of that half, in shared
// memory) + reg I where pe is not null; with kOutShared puts the same band
// in jr and every row of J^T in jtp, in both blocks; with kOutGram writes the
// whole Gram (gram_rounds).  ext: block results carried over the cluster in
// the same barrier (cluster_combine's rule); they come back combined.  The
// block's lmask must be zero (the caller zeroes it with the state).  Must be
// reached by every thread of both blocks.
template <int NE, int OUT = kOutBand>
__device__ void eval_point_cluster(const Ctx& C, const EvalIO& io,
                                   float (&ext)[NE], const int (&ext_op)[NE],
                                   int& xb) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nfd = C.nfd, blk = C.blk, m_blk = C.m_blk;
  const int rank = C.rank, other = rank ^ 1;
  const CLayout& L = C.L;
  const Split& q = C.q;
  const int hb = q.hb, nl = q.nl, nj = 4 * C.nj4;
  const float inf = CUDART_INF_F;
  const float* gts = C.at(L.gts);
  float* jr = C.at(L.jr);
  float* c_s = C.at(L.c);
  float* wa = C.at(L.wa);
  float* wj = C.at(L.wj);
  float* wjs = C.at(L.wjs);
  float* wjb = C.at(L.wjb);
  const float* rb = C.at(L.rb);
  float* y = io.y_out;
  float* jtp = C.at(L.jtp);
  float* jx_r = cl.map_shared_rank(C.at(L.jx), other);
  float* brecv = C.at(L.brecv);
  float* brecv_r = cl.map_shared_rank(brecv, other);
  unsigned* lmask = reinterpret_cast<unsigned*>(C.at(L.lmask));
  unsigned* bmask = reinterpret_cast<unsigned*>(C.at(L.bmask));
  unsigned short* llist = reinterpret_cast<unsigned short*>(C.at(L.llist));
  unsigned short* blist = reinterpret_cast<unsigned short*>(C.at(L.blist));
  int* lcnt = reinterpret_cast<int*>(C.at(L.cnt));
  int* bcnt = lcnt + m_blk;

  // y = G x + b on this block's lanes, and each lane's row blocks (lmask
  // is zero on entry; kOutShared: the share's, formed once)
  col_dots(C, io.x, C.at(L.b), y);
  if constexpr (OUT == kOutShared) {
    const unsigned* gmask = reinterpret_cast<const unsigned*>(C.at(L.gmask));
    for (int l = tid; l < L.ldl; l += nt) lmask[l] = gmask[l];
  } else {
    row_block_masks(C, lmask);
  }
  __syncthreads();
  IPM_PROF(12);

  // lane weights (pads 0); a lane whose y (so a G^T entry of its column, or
  // x) or weight is not finite reaches every row block
  for (int l = tid; l < 4 * C.n4; l += nt) {
    if (l >= nl) {
      c_s[l] = 0.0f; wj[l] = 0.0f; wjs[l] = 0.0f; wa[l] = 0.0f;
      lmask[l] = 0u;
      continue;
    }
    int j;
    const bool ball = lball(C, l, j);
    const float yl = y[l];
    const float c = c_loc(C, y, rb, l);
    const float sl = io.s[l], ll = io.lam[l];
    const float s_safe = pmax(sl, 1e-14f);
    const float r2 = c + sl;
    const float w = pmin(ll / s_safe, io.w_cap);
    const float ymul = ball ? yl : 1.0f;
    const float wr2 = w * r2;
    const float m_est = pmax(wr2, 0.0f);
    const float v_wj = (io.phr ? m_est : wr2) * ymul;
    const float v_wjs = ymul / s_safe;
    const float v_wa = ball ? (io.phr ? m_est : ll) : w;
    c_s[l] = c;
    wj[l] = v_wj;
    wjs[l] = v_wjs;
    wa[l] = v_wa;
    if (!(fabsf(yl) < inf) || !(fabsf(v_wj) < inf) ||
        !(fabsf(v_wjs) < inf) || !(fabsf(v_wa) < inf))
      lmask[l] = ~0u;
    if (l < hb) wjb[l] = ball ? w : 0.0f;
  }
  for (int j = hb + tid; j < nj; j += nt) wjb[j] = 0.0f;
  __syncthreads();
  IPM_PROF(13);
  // a ball's Jacobian row reaches the row blocks its three lanes reach (all
  // where y or its weight is not finite); rows of the packed half rows are 0
  for (int j = tid; j < nj; j += nt) {
    unsigned m = 0u;
    if (j < hb && q.j0 + j < C.n_ball) {
      m = lmask[j] | lmask[hb + j] | lmask[2 * hb + j];
      if (!(fabsf(y[j]) < inf) || !(fabsf(y[hb + j]) < inf) ||
          !(fabsf(y[2 * hb + j]) < inf) || !(fabsf(wjb[j]) < inf))
        m = ~0u;
    }
    bmask[j] = m;
  }
  __syncthreads();
  // warp i lists the lanes and the balls that reach row block i
  if (warp < m_blk) {
    const int n_l = warp_compact(lmask, nl, 1, warp, llist + warp * 4 * C.n4);
    const int n_b = warp_compact(bmask, hb, 1, warp, blist + warp * nj);
    if (lane == 0) {
      lcnt[warp] = n_l;
      bcnt[warp] = n_b;
    }
  }
  __syncthreads();
  IPM_PROF(5);

  // Jacobian rows where the band reads them (the blocks a ball reaches and
  // the next; the Gram: the blocks it reaches), and this block's partials of
  // J^T (w r2), J^T (1/s): rows it finishes to jtp, the other's rows
  // straight into the other block's jx
  const int jchunks = (hb + 31) / 32;
  for (int task = warp; task < m_blk * jchunks; task += nt >> 5) {
    const int ib = task / jchunks;
    const int j = (task - ib * jchunks) * 32 + lane;
    if (j < hb) {
      const unsigned m = bmask[j];
      if constexpr (OUT == kOutGram) {
        if (!((m >> ib) & 1u)) continue;
      } else {
        if (!(((m >> ib) & 1u) || (ib > 0 && ((m >> (ib - 1)) & 1u))))
          continue;
      }
      const float y0 = y[j], y1 = y[hb + j], y2 = y[2 * hb + j];
      for (int r = ib * blk; r < (ib + 1) * blk; ++r) {
        const float* row = gts + (size_t)r * L.lds + j;
        jr[(size_t)r * L.ldj + j] = row[0] * y0 + row[L.tile] * y1 +
                                     row[2 * L.tile] * y2;
      }
    }
  }
  IPM_PROF(16);
  {
    const int k = tid % KL, rr = tid / KL, nrr = nt / KL;
    float* lo = rank == 0 ? jtp : jx_r;
    float* hi = rank == 0 ? jx_r : jtp;
    for (int r0 = 0; r0 < nfd; r0 += nrr) {
      const int r = r0 + rr;
      const int rs = r < nfd ? r : 0;
      const int ib = rs / blk;
      const unsigned short* lst = llist + ib * 4 * C.n4;
      const int n = lcnt[ib];
      const float* row = gts + (size_t)rs * L.lds;
      float s1 = 0.0f, s2 = 0.0f;
      for (int p = k; p < n; p += KL) {
        const int l = lst[p];
        const float g = row[gcol(C, l)];
        s1 = fmaf(g, wj[l], s1);
        s2 = fmaf(g, wjs[l], s2);
      }
#pragma unroll
      for (int o = KL / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (k == 0 && r < nfd) {
        float* d = r < L.rh ? lo : hi;
        d[r] = s1;
        d[L.ldw + r] = s2;
      }
    }
  }
  __syncthreads();
  IPM_PROF(6);

  if constexpr (OUT == kOutGram) {
    cluster_combine<NE>(ext, ext_op, C.at(L.xch), rank, xb);
    const float* jx = C.at(L.jx);
    const int r0 = rank == 0 ? 0 : L.rh, r1 = rank == 0 ? L.rh : nfd;
    for (int r = r0 + tid; r < r1; r += nt) {
      const float a1 = jtp[r], b1 = jx[r];
      const float a2 = jtp[L.ldw + r], b2 = jx[L.ldw + r];
      jtp[r] = rank == 0 ? a1 + b1 : b1 + a1;
      jtp[L.ldw + r] = rank == 0 ? a2 + b2 : b2 + a2;
    }
    gram_rounds(C, io);
    return;
  }

  // the band: warp i forms the diagonal block i (threads [0, per)) and the
  // super block (i, i + 1) (threads [per, 2 per)), a TR x TC tile a thread
  {
    const int ncg = (blk + TC - 1) / TC, per = L.per;
    const bool sup = lane >= per;
    const int tile = sup ? lane - per : lane;
    const bool active = warp < m_blk && lane < 2 * per &&
                        !(sup && warp + 1 >= m_blk);
    const int i = warp < m_blk ? warp : 0;
    const int rg = tile / ncg, cg_ = tile - rg * ncg;
    float acc[TR][TC];
    int ro[TR], co[TC];
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int rr = TR * rg + t;
      ro[t] = i * blk + (rr < blk ? rr : TR * rg);
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[t][k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const int kk = TC * cg_ + k;
      co[k] = (sup ? i + 1 : i) * blk + (kk < blk ? kk : TC * cg_);
    }
    if (active) {
      const unsigned short* lst = llist + i * 4 * C.n4;
      const int n_l = lcnt[i];
      for (int p = 0; p < n_l; ++p) {
        const int l = lst[p];
        const float w = wa[l];
        const float* col = gts + gcol(C, l);
        float a[TR], cv[TC];
#pragma unroll
        for (int t = 0; t < TR; ++t) a[t] = col[(size_t)ro[t] * L.lds] * w;
#pragma unroll
        for (int k = 0; k < TC; ++k) cv[k] = col[(size_t)co[k] * L.lds];
#pragma unroll
        for (int t = 0; t < TR; ++t)
#pragma unroll
          for (int k = 0; k < TC; ++k) acc[t][k] = fmaf(a[t], cv[k], acc[t][k]);
      }
      const unsigned short* bl = blist + i * nj;
      const int n_b = bcnt[i];
      for (int p = 0; p < n_b; ++p) {
        const int j = bl[p];
        const float w = wjb[j];
        float a[TR], cv[TC];
#pragma unroll
        for (int t = 0; t < TR; ++t) a[t] = jr[(size_t)ro[t] * L.ldj + j] * w;
#pragma unroll
        for (int k = 0; k < TC; ++k) cv[k] = jr[(size_t)co[k] * L.ldj + j];
#pragma unroll
        for (int t = 0; t < TR; ++t)
#pragma unroll
          for (int k = 0; k < TC; ++k) acc[t][k] = fmaf(a[t], cv[k], acc[t][k]);
      }
    }
    IPM_PROF(17);
    __syncthreads();               // every warp is done with jr: scratch
    if (active) {
      float* scratch = jr;
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int rr = TR * rg + t;
#pragma unroll
        for (int k = 0; k < TC; ++k) {
          const int kk = TC * cg_ + k;
          if (rr >= blk || kk >= blk) continue;
          const int r = i * blk + rr;
          scratch[sup ? nfd * blk + r * blk + kk : r * blk + kk] = acc[t][k];
        }
      }
    }
    __syncthreads();
    // the half the other block finishes goes there in 16-byte stores
    // (scattered 4-byte stores into distributed shared memory were slow)
    const float* src = jr + (rank == 0 ? L.eh : 0);
    const int n = rank == 0 ? L.nband - L.eh : L.eh;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(brecv_r);
    for (int i4 = tid; i4 < n / 4; i4 += nt) dst4[i4] = src4[i4];
    for (int e = 4 * (n / 4) + tid; e < n; e += nt) brecv_r[e] = src[e];
  }
  IPM_PROF(7);

  // exchange: the extras ride on the same barrier
  cluster_combine<NE>(ext, ext_op, C.at(L.xch), rank, xb);
  IPM_PROF(8);

  // J^T rows and band entries this block finishes, rank 0's + rank 1's
  // (kOutShared: into both blocks)
  const float* jx = C.at(L.jx);
  const int r0 = rank == 0 ? 0 : L.rh, r1 = rank == 0 ? L.rh : nfd;
  for (int r = r0 + tid; r < r1; r += nt) {
    const float a1 = jtp[r], b1 = jx[r];
    const float a2 = jtp[L.ldw + r], b2 = jx[L.ldw + r];
    jtp[r] = rank == 0 ? a1 + b1 : b1 + a1;
    jtp[L.ldw + r] = rank == 0 ? a2 + b2 : b2 + a2;
    if constexpr (OUT == kOutShared) {
      float* jtp_r = cl.map_shared_rank(jtp, other);
      jtp_r[r] = jtp[r];
      jtp_r[L.ldw + r] = jtp[L.ldw + r];
    }
  }
  IPM_PROF(18);
  const float* scratch = jr;
  const float* pe = io.pe;
  const int e0 = rank == 0 ? 0 : L.eh, e1 = rank == 0 ? L.eh : L.nband;
  const int nhd = nfd * blk;
  // four consecutive entries a thread (e0 and the halves are multiples of
  // 4): the loads of a group come before its stores
  for (int e4 = e0 + 4 * tid; e4 < e1; e4 += 4 * nt) {
    const float4 mine = *reinterpret_cast<const float4*>(scratch + e4);
    const float4 theirs = *reinterpret_cast<const float4*>(brecv + e4 - e0);
    const float4 pv = pe ? *reinterpret_cast<const float4*>(pe + e4 - e0)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float m_[4] = {mine.x, mine.y, mine.z, mine.w};
    const float t_[4] = {theirs.x, theirs.y, theirs.z, theirs.w};
    const float p_[4] = {pv.x, pv.y, pv.z, pv.w};
    // entry e4 + u of hd is row r, column kk of its block; the diagonal is
    // kk == r mod blk
    int r = e4 / blk, kk = e4 - r * blk, rb = r % blk;
    float f_[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e4 + u;
      f_[u] = 0.0f;
      if (e < e1) {
#ifdef IPM_CONTROL_DROP_RANK0
        // negative control (chip_smoke.py): rank 0's partial left out
        float v = rank == 0 ? t_[u] : m_[u];
#else
        float v = rank == 0 ? m_[u] + t_[u] : t_[u] + m_[u];
#endif
        if (pe) v += p_[u];
        if (e < nhd) {
          if (pe && kk == rb) v += io.reg;
          if constexpr (OUT == kOutBand) io.hd[e] = v;
        } else {
          if constexpr (OUT == kOutBand) io.hu[e - nhd] = v;
        }
        f_[u] = v;
      }
      if (++kk == blk) {
        kk = 0;
        ++r;
        if (++rb == blk) rb = 0;
      }
    }
    if constexpr (OUT == kOutShared) {
      // the finished entries over their own partials (this thread read
      // them above), and into the other block's band: past e1 a store
      // touches only the padding before lf
      const float4 f4 = make_float4(f_[0], f_[1], f_[2], f_[3]);
      *reinterpret_cast<float4*>(C.at(L.jr) + e4) = f4;
      *reinterpret_cast<float4*>(cl.map_shared_rank(C.at(L.jr), other) +
                                 e4) = f4;
    }
  }
  IPM_PROF(19);
  if constexpr (OUT == kOutShared)
    cl.sync();
  else
    __syncthreads();
}

// ---- the updates of a step ------------------------------------------------

// The step's shared vectors: nfd ones (x, bx, dx) and this block's lanes.
struct ClVecs {
  float *x, *bx, *dx, *s, *lam, *y, *by, *gdx, *ds, *dlam, *act, *cw, *rb;
  float *red, *xch;
};

// Newton update along (dx, gdx) from the point whose matvec is y_ev (the
// running y itself, or a fresh evaluation of it) on both blocks
// (ipm::newton_update with its lane sums combined over the cluster).
// mu_sum: sum cw s lam over the cluster where the caller has it (the same
// sum in the same order), else null.  Must be reached by every thread of
// both blocks.
__device__ void newton_update_cl(const Ctx& C, const ClVecs& V,
                                 const float* y_ev, float sigma_min, float tau,
                                 float alpha_max, float w_cap, float mc,
                                 float& best_merit, int& xb,
                                 const float* mu_sum = nullptr) {
  const int tid = threadIdx.x, nt = blockDim.x, nl = C.q.nl;
  const float inf = CUDART_INF_F;
  float mu1[1] = {0.0f};
  const int op_sum1[1] = {kSum};
  if (mu_sum) {
    mu1[0] = *mu_sum;
  } else {
    for (int l = tid; l < nl; l += nt) mu1[0] += V.cw[l] * V.s[l] * V.lam[l];
    block_reduce_n<1>(mu1, op_sum1, V.red);
    cluster_combine<1>(mu1, op_sum1, V.xch, C.rank, xb);
  }
  const float mu = mu1[0] / mc;
  const float sig_mu = sigma_min * mu;
  float st[3] = {inf, inf, 1.0f};           // min_s, min_l, finite
  const int op_min3[3] = {kMin, kMin, kMin};
  for (int l = tid; l < nl; l += nt) {
    const float act = V.act[l], sl = V.s[l], ll = V.lam[l];
    const float c = c_loc(C, y_ev, V.rb, l);
    const float r2 = (c + sl) * act;
    const float w = pmin(ll / sl, w_cap);
    const float jdx = jdx_loc(C, V.gdx, y_ev, l);
    const float ds = (-r2 - jdx) * act;
    const float dlam = ((sig_mu - ll * sl) / sl - w * ds) * act;
    V.ds[l] = ds;
    V.dlam[l] = dlam;
    st[0] = pmin(st[0], ds < 0.0f ? -sl / ds : inf);
    st[1] = pmin(st[1], dlam < 0.0f ? -ll / dlam : inf);
    if (!(fabsf(ds) < inf) || !(fabsf(dlam) < inf)) st[2] = 0.0f;
  }
  block_reduce_n<3>(st, op_min3, V.red);
  cluster_combine<3>(st, op_min3, V.xch, C.rank, xb);
  const float alpha =
      pmin(pmin(pmin(1.0f, tau * st[0]), pmin(1.0f, tau * st[1])), alpha_max);
  const bool upd = alpha > 0.0f && st[2] > 0.0f;
  if (upd) {
    for (int r = tid; r < C.nfd; r += nt) V.x[r] = V.x[r] + alpha * V.dx[r];
    for (int l = tid; l < nl; l += nt) {
      V.s[l] = V.s[l] + alpha * V.ds[l];
      if (V.act[l] > 0.0f)
        V.lam[l] = pmax(V.lam[l] + alpha * V.dlam[l], 1e-16f);
      V.y[l] = V.y[l] + alpha * V.gdx[l];
    }
  }
  __syncthreads();
  float m[3] = {-inf, -inf, 0.0f};
  const int op_merit[3] = {kMax, kMax, kSum};
  for (int l = tid; l < nl; l += nt) {
    const float c = c_loc(C, V.y, V.rb, l);
    if (V.act[l] > 0.0f) {
      m[0] = pmax(m[0], pmax(c, 0.0f));
      m[1] = pmax(m[1], fabsf(c + V.s[l]));
    }
    m[2] += V.cw[l] * V.s[l] * V.lam[l];
  }
  block_reduce_n<3>(m, op_merit, V.red);
  cluster_combine<3>(m, op_merit, V.xch, C.rank, xb);
  const float merit = m[0] + m[1] + m[2] / mc;
  if (merit < best_merit) {
    best_merit = merit;
    for (int r = tid; r < C.nfd; r += nt) V.bx[r] = V.x[r];
    for (int l = tid; l < nl; l += nt) V.by[l] = V.y[l];
  }
  __syncthreads();
}

// Snap update of the best iterate along (dx, gdx) on both blocks
// (ipm::snap_update with its eight sums combined over the cluster).
__device__ void snap_update_cl(const Ctx& C, const ClVecs& V, int& xb) {
  const int tid = threadIdx.x, nt = blockDim.x, nl = C.q.nl;
  const float alphas[7] = {1.0f, 0.5f, 0.25f, 0.1f, 0.03f, 0.01f, 0.003f};
  float p[8];
  int ops[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[i] = 0.0f;
    ops[i] = kSum;
  }
  for (int l = tid; l < nl; l += nt) {
    const float cw = V.cw[l];
    float v = pmax(c_loc(C, V.by, V.rb, l), 0.0f);
    p[0] += cw * v * v;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      v = pmax(c_loc_moved(C, V.by, V.gdx, alphas[i], V.rb, l), 0.0f);
      p[i + 1] += cw * v * v;
    }
  }
  IPM_PROF(14);
  block_reduce_n<8>(p, ops, V.red);
  cluster_combine<8>(p, ops, V.xch, C.rank, xb);
  float best_a = 0.0f, best_p = p[0];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (p[i + 1] < best_p) {
      best_a = alphas[i];
      best_p = p[i + 1];
    }
  }
  if (best_a > 0.0f) {
    for (int r = tid; r < C.nfd; r += nt) V.bx[r] = V.bx[r] + best_a * V.dx[r];
    for (int l = tid; l < nl; l += nt) V.by[l] = V.by[l] + best_a * V.gdx[l];
  }
  __syncthreads();
}

}  // namespace ipmc
